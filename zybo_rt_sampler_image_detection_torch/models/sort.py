"""SORT multi-object tracker.

Behavioral parity with the vendored tracker the reference ships
(``image-detection/src/sort/sort.py:94-253``): per-track 7-state constant-
velocity Kalman filter over [cx, cy, area, aspect, vcx, vcy, varea], IoU +
Hungarian assignment, max_age/min_hits track lifecycle, MOT-style 1-based
IDs.  Implemented from scratch on NumPy + scipy (no filterpy): track counts
are O(10), so the host CPU is the right place — the detector feeding it is
the device program.

A copy of ``zybo_rt_sampler_image_detection_tpu/models/sort.py`` (NumPy and
SciPy only), kept so that the port never imports the JAX package.
"""

from __future__ import annotations

from typing import List

import numpy as np
from scipy.optimize import linear_sum_assignment


def iou_batch(bb_test: np.ndarray, bb_gt: np.ndarray) -> np.ndarray:
    """Pairwise IoU (N, M) between xyxy box sets (sort.py:47-63)."""
    bb_gt = np.expand_dims(bb_gt, 0)
    bb_test = np.expand_dims(bb_test, 1)
    xx1 = np.maximum(bb_test[..., 0], bb_gt[..., 0])
    yy1 = np.maximum(bb_test[..., 1], bb_gt[..., 1])
    xx2 = np.minimum(bb_test[..., 2], bb_gt[..., 2])
    yy2 = np.minimum(bb_test[..., 3], bb_gt[..., 3])
    w = np.maximum(0.0, xx2 - xx1)
    h = np.maximum(0.0, yy2 - yy1)
    inter = w * h
    area_t = ((bb_test[..., 2] - bb_test[..., 0])
              * (bb_test[..., 3] - bb_test[..., 1]))
    area_g = ((bb_gt[..., 2] - bb_gt[..., 0])
              * (bb_gt[..., 3] - bb_gt[..., 1]))
    return inter / (area_t + area_g - inter)


def bbox_to_z(bbox) -> np.ndarray:
    w = bbox[2] - bbox[0]
    h = bbox[3] - bbox[1]
    return np.array([bbox[0] + w / 2.0, bbox[1] + h / 2.0,
                     w * h, w / float(h)], dtype=np.float64)


def z_to_bbox(x) -> np.ndarray:
    w = np.sqrt(max(x[2] * x[3], 0.0))
    h = x[2] / w if w > 0 else 0.0
    return np.array([x[0] - w / 2.0, x[1] - h / 2.0,
                     x[0] + w / 2.0, x[1] + h / 2.0], dtype=np.float64)


class KalmanBoxTracker:
    """7-state constant-velocity bbox filter (sort.py:94-151), with the
    same noise shaping: R[2:,2:]*=10, P[4:,4:]*=1000, P*=10,
    Q[-1,-1]*=0.01, Q[4:,4:]*=0.01."""

    count = 0

    def __init__(self, bbox):
        self.F = np.eye(7)
        self.F[0, 4] = self.F[1, 5] = self.F[2, 6] = 1.0
        self.H = np.zeros((4, 7))
        self.H[:4, :4] = np.eye(4)
        self.R = np.eye(4)
        self.R[2:, 2:] *= 10.0
        self.P = np.eye(7)
        self.P[4:, 4:] *= 1000.0
        self.P *= 10.0
        self.Q = np.eye(7)
        self.Q[-1, -1] *= 0.01
        self.Q[4:, 4:] *= 0.01

        self.x = np.zeros(7)
        self.x[:4] = bbox_to_z(bbox)
        self.time_since_update = 0
        self.id = KalmanBoxTracker.count
        KalmanBoxTracker.count += 1
        self.hits = 0
        self.hit_streak = 0
        self.age = 0

    def update(self, bbox) -> None:
        self.time_since_update = 0
        self.hits += 1
        self.hit_streak += 1
        z = bbox_to_z(bbox)
        S = self.H @ self.P @ self.H.T + self.R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ (z - self.H @ self.x)
        self.P = (np.eye(7) - K @ self.H) @ self.P

    def predict(self) -> np.ndarray:
        if self.x[6] + self.x[2] <= 0:       # area would go negative
            self.x[6] = 0.0
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        self.age += 1
        if self.time_since_update > 0:
            self.hit_streak = 0
        self.time_since_update += 1
        return z_to_bbox(self.x)

    def get_state(self) -> np.ndarray:
        return z_to_bbox(self.x)


def associate(detections: np.ndarray, trackers: np.ndarray,
              iou_threshold: float = 0.3):
    """IoU + Hungarian matching (sort.py:154-196)."""
    if len(trackers) == 0:
        return (np.empty((0, 2), int), np.arange(len(detections)),
                np.empty((0,), int))
    iou = iou_batch(detections, trackers)
    if min(iou.shape) > 0:
        a = (iou > iou_threshold).astype(np.int32)
        if a.sum(1).max() == 1 and a.sum(0).max() == 1:
            matched = np.stack(np.where(a), axis=1)
        else:
            r, c = linear_sum_assignment(-iou)
            matched = np.stack([r, c], axis=1)
    else:
        matched = np.empty((0, 2), int)

    unmatched_d = [d for d in range(len(detections))
                   if d not in matched[:, 0]]
    unmatched_t = [t for t in range(len(trackers))
                   if t not in matched[:, 1]]
    matches = []
    for m in matched:
        if iou[m[0], m[1]] < iou_threshold:
            unmatched_d.append(m[0])
            unmatched_t.append(m[1])
        else:
            matches.append(m)
    matches = (np.stack(matches) if matches
               else np.empty((0, 2), int))
    return matches, np.array(unmatched_d), np.array(unmatched_t)


class Sort:
    """Track lifecycle manager (sort.py:199-253)."""

    def __init__(self, max_age: int = 1, min_hits: int = 3,
                 iou_threshold: float = 0.3,
                 report_coasted: bool = False):
        self.max_age = max_age
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        # opt-in beyond the reference: also report the Kalman-predicted
        # box of established tracks during detector dropouts (the
        # reference's update() only emits tracks matched THIS frame,
        # sort.py:245-248, so every dropped detection is a hole in the
        # output even while the track survives internally)
        self.report_coasted = report_coasted
        self.trackers: List[KalmanBoxTracker] = []
        self.frame_count = 0

    def update(self, dets: np.ndarray = None) -> np.ndarray:
        """dets: (N, 5) [x1,y1,x2,y2,score] (empty allowed; call every
        frame).  Returns (K, 5) [x1,y1,x2,y2,track_id] with 1-based ids."""
        if dets is None:
            dets = np.empty((0, 5))
        self.frame_count += 1
        trks = np.zeros((len(self.trackers), 5))
        to_del = []
        for t in range(len(trks)):
            pos = self.trackers[t].predict()
            trks[t, :4] = pos
            if np.any(np.isnan(pos)):
                to_del.append(t)
        trks = trks[~np.isnan(trks).any(axis=1)]
        for t in reversed(to_del):
            self.trackers.pop(t)

        matched, unmatched_d, _ = associate(dets[:, :4] if len(dets) else
                                            np.empty((0, 4)),
                                            trks[:, :4],
                                            self.iou_threshold)
        for m in matched:
            self.trackers[m[1]].update(dets[m[0], :4])
        for i in unmatched_d:
            self.trackers.append(KalmanBoxTracker(dets[i, :4]))

        ret = []
        i = len(self.trackers)
        for trk in reversed(self.trackers):
            d = trk.get_state()
            if trk.time_since_update < 1 and (
                    trk.hit_streak >= self.min_hits
                    or self.frame_count <= self.min_hits):
                ret.append(np.concatenate([d, [trk.id + 1]]))
            elif self.report_coasted \
                    and trk.time_since_update <= self.max_age \
                    and trk.hits >= self.min_hits:
                # coasting: the KF prediction stands in for the missed
                # detection (hits, not hit_streak: the streak resets on
                # the very miss being coasted over)
                ret.append(np.concatenate([d, [trk.id + 1]]))
            i -= 1
            if trk.time_since_update > self.max_age:
                self.trackers.pop(i)
        return np.stack(ret) if ret else np.empty((0, 5))
