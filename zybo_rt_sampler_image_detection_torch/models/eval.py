"""Detection-quality metrics: IoU matching and average precision.

Provides the quantitative gate the reference never had (its verification
was visual — SURVEY.md §4): VOC-style AP at a given IoU threshold over a
held-out set, used by ``tests/test_vision.py`` and the training demo.

A copy of ``zybo_rt_sampler_image_detection_tpu/models/eval.py`` (NumPy
only), kept so that the port never imports the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix (len(a), len(b)) of [x1, y1, x2, y2] boxes."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def average_precision(detections: Sequence[np.ndarray],
                      ground_truths: Sequence[np.ndarray],
                      iou_threshold: float = 0.5) -> float:
    """VOC-style (all-points) AP@iou for one class.

    detections: per image, (k, 5) [x1, y1, x2, y2, conf];
    ground_truths: per image, (m, >=4) [x1, y1, x2, y2, ...].
    Each ground truth can match at most one detection (greedy by
    confidence, the standard protocol).
    """
    rows = []                       # (conf, is_tp)
    n_gt = 0
    for dets, gts in zip(detections, ground_truths):
        dets = np.asarray(dets, np.float64).reshape(-1, 5)
        gts = np.asarray(gts, np.float64).reshape(-1, gts.shape[-1]
                                                  if len(gts) else 4)
        n_gt += len(gts)
        if len(dets) == 0:
            continue
        order = np.argsort(-dets[:, 4])
        taken = np.zeros(len(gts), bool)
        iou = box_iou(dets[:, :4], gts[:, :4]) if len(gts) else None
        for di in order:
            tp = False
            if iou is not None and len(gts):
                j = int(np.argmax(np.where(taken, -1.0, iou[di])))
                if not taken[j] and iou[di, j] >= iou_threshold:
                    taken[j] = True
                    tp = True
            rows.append((dets[di, 4], tp))
    if n_gt == 0 or not rows:
        return 0.0
    rows.sort(key=lambda r: -r[0])
    tps = np.cumsum([r[1] for r in rows])
    fps = np.cumsum([not r[1] for r in rows])
    recall = tps / n_gt
    precision = tps / np.maximum(tps + fps, 1)
    # all-points interpolation
    mrec = np.concatenate([[0.0], recall, [recall[-1]]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def per_class_average_precision(detections: Sequence[np.ndarray],
                                ground_truths: Sequence[np.ndarray],
                                num_classes: int,
                                iou_threshold: float = 0.5):
    """Per-class AP@iou + mean AP.

    detections: per image (k, 6) [x1,y1,x2,y2,conf,cls];
    ground_truths: per image (m, 5) [x1,y1,x2,y2,cls].
    Returns (aps list of len num_classes — nan where the class has no
    ground truth, mAP over present classes).
    """
    aps = []
    for c in range(num_classes):
        dets_c, gts_c = [], []
        n_gt = 0
        for dets, gts in zip(detections, ground_truths):
            dets = np.asarray(dets, np.float64).reshape(-1, 6) \
                if len(dets) else np.zeros((0, 6))
            gts = np.asarray(gts, np.float64).reshape(-1, 5) \
                if len(gts) else np.zeros((0, 5))
            dc = dets[dets[:, 5] == c][:, :5]
            gc = gts[gts[:, 4] == c][:, :4]
            n_gt += len(gc)
            dets_c.append(dc)
            gts_c.append(gc)
        aps.append(average_precision(dets_c, gts_c, iou_threshold)
                   if n_gt else float("nan"))
    present = [a for a in aps if not np.isnan(a)]
    return aps, float(np.mean(present)) if present else 0.0


def mota(gt_sequences: Sequence[Sequence[np.ndarray]],
         track_sequences: Sequence[Sequence[np.ndarray]],
         iou_threshold: float = 0.5):
    """CLEAR-MOT Multiple Object Tracking Accuracy over sequences.

    gt_sequences: per sequence, per frame (m, 5) [x1,y1,x2,y2,gt_id];
    track_sequences: per sequence, per frame (k, 5) [x1,y1,x2,y2,track_id]
    (the :class:`~.tracking.SmoothedTracker` ``step`` output shape).

    ``MOTA = 1 - (misses + false_positives + id_switches) / n_gt``,
    with greedy IoU matching that prefers keeping the previous frame's
    gt->track assignment (the standard CLEAR-MOT matching step).
    Returns (mota, dict of counts).
    """
    misses = fps = idsw = n_gt = 0
    for gts_seq, trs_seq in zip(gt_sequences, track_sequences):
        last_match = {}                       # gt_id -> track_id
        for gts, trs in zip(gts_seq, trs_seq):
            gts = np.asarray(gts, np.float64).reshape(-1, 5) \
                if len(gts) else np.zeros((0, 5))
            trs = np.asarray(trs, np.float64).reshape(-1, 5) \
                if len(trs) else np.zeros((0, 5))
            n_gt += len(gts)
            if len(gts) == 0:
                fps += len(trs)
                continue
            if len(trs) == 0:
                misses += len(gts)
                continue
            iou = box_iou(gts[:, :4], trs[:, :4])
            taken_t = np.zeros(len(trs), bool)
            matched_g = np.zeros(len(gts), bool)
            matches = {}
            # 1) keep surviving (gt, track) pairs from the last frame
            for gi, g in enumerate(gts):
                prev_tid = last_match.get(int(g[4]))
                if prev_tid is None:
                    continue
                tj = np.where(trs[:, 4] == prev_tid)[0]
                if len(tj) and not taken_t[tj[0]] \
                        and iou[gi, tj[0]] >= iou_threshold:
                    matches[int(g[4])] = int(prev_tid)
                    taken_t[tj[0]] = True
                    matched_g[gi] = True
            # 2) greedy IoU for the rest
            pairs = [(iou[gi, tj], gi, tj)
                     for gi in range(len(gts)) if not matched_g[gi]
                     for tj in range(len(trs)) if not taken_t[tj]]
            for v, gi, tj in sorted(pairs, reverse=True):
                if v < iou_threshold or matched_g[gi] or taken_t[tj]:
                    continue
                gid, tid = int(gts[gi, 4]), int(trs[tj, 4])
                if gid in last_match and last_match[gid] != tid:
                    idsw += 1
                matches[gid] = tid
                matched_g[gi] = True
                taken_t[tj] = True
            misses += int((~matched_g).sum())
            fps += int((~taken_t).sum())
            last_match.update(matches)
    value = 1.0 - (misses + fps + idsw) / max(n_gt, 1)
    return value, {"misses": misses, "false_positives": fps,
                   "id_switches": idsw, "n_gt": n_gt}


def evaluate_detector(detector, images: np.ndarray,
                      boxes: List[np.ndarray],
                      conf_threshold: float = 0.05,
                      iou_threshold: float = 0.5) -> float:
    """AP@iou of a :class:`~.detect.YoloDetector` on a held-out set of
    float [0,1] images."""
    dets = []
    for img in images:
        frame = (img * 255).astype(np.uint8)
        d = detector.get_detections(frame, conf_threshold=conf_threshold)
        dets.append(np.asarray(d, np.float64).reshape(-1, 5))
    return average_precision(dets, boxes, iou_threshold)
