"""Heatmap rendering and viewer frontends.

Ports ``PC/src/visual.py`` with the per-pixel Python colorization loops
(``visual.py:170-184`` — flagged as a reference hot spot, SURVEY.md §3)
replaced by one vectorized NumPy LUT pass:

* jet color LUT                      — ``visual.py:26-49``
* log-normalized thresholded heatmap — ``visual.py:143-188``
* KF-smoothed variant                — ``visual.py:65-140``
* FFT variant                        — ``visual.py:190-221``
* Gaussian power-center detector     — ``visual.py:295-322``
* heatmap + detection box            — ``visual.py:227-293``
* ``Front`` / ``Viewer`` loops       — ``visual.py:327-493`` (cv2 UI when
  available, injectable camera/display for headless runs)

A copy of the JAX package's ``utils/viz.py`` (NumPy only); ``Viewer``
composites through the port's ``fusion.decider``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from . import imaging
from ..ops.kalman import KalmanFilter3D

POWER_EXPONENT = 5      # visual.py:13 (POWER)


def jet_lut() -> np.ndarray:
    """256x3 uint8 jet LUT, reversed like the reference
    (``colors[i] = cmap(255 - i)``, visual.py:43-44)."""
    try:
        import matplotlib.pyplot as plt
        cmap = plt.get_cmap("jet")
        colors = np.array([np.array(cmap(255 - i)[:3]) * 255
                           for i in range(256)], dtype=np.uint8)
        return colors
    except ImportError:                               # pragma: no cover
        x = (255 - np.arange(256)) / 255.0
        r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
        return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


COLORS = jet_lut()


def colorize_power(img01: np.ndarray, amount: float = 0.5,
                   exponent: int = POWER_EXPONENT,
                   colors: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized equivalent of the reference paint loop
    (visual.py:170-184): values in [0,1] (indexed [x, y]) -> BGR uint8
    image (Y, X, 3) with the reference's double flip
    ``small[Y-1-y, X-1-x]``; pixels below ``amount`` stay black."""
    colors = COLORS if colors is None else colors
    X, Y = img01.shape
    p = np.clip((img01 - amount) / amount, 0.0, None)
    color_val = (255.0 * np.power(p, exponent)).astype(np.int64)
    color_val = np.clip(color_val, 0, 255)
    painted = (img01 >= amount)
    src = colors[color_val]                       # (X, Y, 3)
    small_flipped = np.where(painted[..., None], src, 0).astype(np.uint8)
    # small[Y-1-y, X-1-x] = src[x, y] — one contiguous pass (this runs
    # per displayed frame; the previous zeros-then-overwrite paid a dead
    # fill plus a full-image copy)
    return np.ascontiguousarray(
        small_flipped.transpose(1, 0, 2)[::-1, ::-1])


def log_normalize(image: np.ndarray) -> np.ndarray:
    """visual.py:164-166: log10, shift by log10(min), scale to [0, 1]."""
    safe = np.clip(image, 1e-12, None)
    img = np.log10(safe)
    img = img - np.log10(safe.min())
    mx = img.max()
    return img / mx if mx > 0 else img


def calculate_heatmap(image: np.ndarray, threshold: float = 1e-7,
                      amount: float = 0.5, exponent: int = POWER_EXPONENT,
                      window: Tuple[int, int] = (1920, 1080)):
    """visual.py:143-188 -> (resized BGR heatmap, should_overlay)."""
    image = np.asarray(image)
    if image.ndim == 3:
        image = image[..., 0]
    X, Y = image.shape
    should_overlay = bool(image.max() > threshold)
    if should_overlay:
        small = colorize_power(log_normalize(image), amount, exponent)
    else:
        small = np.zeros((Y, X, 3), np.uint8)
    return imaging.resize(small, window), should_overlay


def calculate_heatmap2(image: np.ndarray, kf: Optional[KalmanFilter3D] = None,
                       threshold: float = 1e-7, amount: float = 0.5,
                       exponent: int = POWER_EXPONENT,
                       window: Tuple[int, int] = (1920, 1080)):
    """visual.py:65-140: linear-normalized paint + KF-smoothed peak circle."""
    image = np.asarray(image, np.float64).copy()
    X, Y = image.shape
    x, y = np.unravel_index(int(image.argmax()), image.shape)
    if kf is not None:
        kf.update([float(x), float(y), 0.0])
        xs, ys, _ = kf.get_state()
        x = int(np.clip(xs, 0, X - 1))
        y = int(np.clip(ys, 0, Y - 1))
    mx = image.max()
    should_overlay = bool(mx > threshold)
    image /= max(mx, 1e-30)
    if should_overlay:
        small = colorize_power(image, amount, exponent)
    else:
        small = np.zeros((Y, X, 3), np.uint8)
    heat = imaging.resize(small, window)
    cx = window[0] - 1 - int(x / max(X - 1, 1) * window[0])
    cy = window[1] - 1 - int(y / max(Y - 1, 1) * window[1])
    imaging.circle(heat, (cx, cy), 50, (0, 255, 0), 5)
    return heat, should_overlay


def calculate_heatmap_fft(image: np.ndarray, threshold: float = 5e-8,
                          window: Tuple[int, int] = (1920, 1080)):
    """visual.py:190-221: the web-app FFT heatmap variant (normalized by
    max; painted above 0.5 with exponent 2)."""
    image = np.asarray(image, np.float64)
    mx = image.max()
    should_overlay = bool(mx > threshold * 1e6)
    img = image / max(mx, 1e-30)
    X, Y = img.shape
    if should_overlay:
        small = colorize_power(img, amount=0.5, exponent=2)
    else:
        small = np.zeros((Y, X, 3), np.uint8)
    return imaging.resize(small, window), should_overlay


def find_power_center(image: np.ndarray, region_size: int = 3):
    """visual.py:295-322: Gaussian smooth, mask >= 0.95 max, cubed-power
    center of mass.  Returns (center_x, center_y) in grid coordinates."""
    smoothed = imaging.gaussian_blur(np.asarray(image, np.float32), 5, 1.0)
    mx = smoothed.max()
    mask = smoothed >= mx * 0.95
    if mask.sum() > 0:
        yi, xi = np.indices(smoothed.shape)
        w = (smoothed ** 3) * mask
        tw = w.sum()
        if tw > 0:
            return float((xi * w).sum() / tw), float((yi * w).sum() / tw)
    peak = np.unravel_index(int(smoothed.argmax()), smoothed.shape)
    return float(peak[1]), float(peak[0])


def calculate_heatmap_with_detection(
        image: np.ndarray, threshold: float = 1e-7, amount: float = 0.5,
        exponent: int = POWER_EXPONENT, box_size_ratio: float = 0.1,
        region_size: int = 3, window: Tuple[int, int] = (1920, 1080)):
    """visual.py:227-293 -> (power_detection overlay, heatmap,
    should_overlay)."""
    image = np.asarray(image)
    if image.ndim == 3:
        image = image[..., 0]
    X, Y = image.shape
    safe = np.clip(image, 1e-12, None)
    peak_y, peak_x = find_power_center(safe, region_size)
    should_overlay = bool(image.max() > threshold)
    if should_overlay:
        small = colorize_power(log_normalize(image), amount, exponent)
    else:
        small = np.zeros((Y, X, 3), np.uint8)
    heatmap = imaging.resize(small, window)
    power_detection = np.zeros((window[1], window[0], 3), np.float32)
    if should_overlay:
        sx = window[0] - 1 - int(peak_x / max(X - 1, 1) * window[0])
        sy = window[1] - 1 - int(peak_y / max(Y - 1, 1) * window[1])
        bw = int(window[0] * box_size_ratio)
        bh = int(window[1] * box_size_ratio)
        x1, y1 = max(0, sx - bw // 2), max(0, sy - bh // 2)
        x2, y2 = min(window[0], sx + bw // 2), min(window[1], sy + bh // 2)
        imaging.rectangle(power_detection, (x1, y1), (x2, y2),
                          (255, 0, 255), 3)
        imaging.circle(power_detection, (sx, sy), 5, (0, 0, 255), -1)
    return power_detection, heatmap, should_overlay


# ---------------------------------------------------------------------------
# Viewer frontends
# ---------------------------------------------------------------------------

class Front:
    """Camera + heatmap overlay + click-to-steer (visual.py:327-386).

    ``capture``/``display`` are injectable for headless operation; defaults
    use cv2.  ``q_rec`` provides heatmaps; clicks put normalized
    ``(vertical, 1-horizontal)`` on ``q_out`` (visual.py:375-386).
    """

    def __init__(self, q_rec, q_out, running, src=-1, window=(1920, 1080),
                 capture=None, display=None):
        self.q_rec, self.q_out, self.running = q_rec, q_out, running
        self.window = window
        self.capture = capture if capture is not None else _CvCapture(src)
        self.display = display if display is not None else _CvDisplay(
            "zybo-rt-torch", self._mouse)

    def _mouse(self, x, y):
        horizontal = x / self.window[0]
        vertical = y / self.window[1]
        self.q_out.put((vertical, 1.0 - horizontal))

    def multi_loop(self, max_frames: Optional[int] = None):
        import queue as _q
        prev = np.zeros((self.window[1], self.window[0], 3), np.uint8)
        n = 0
        while self._running() and (max_frames is None or n < max_frames):
            try:
                output = self.q_rec.get(timeout=0.1)
                if hasattr(self.q_rec, "task_done"):
                    self.q_rec.task_done()
            except _q.Empty:
                continue
            ok, frame = self.capture.read()
            if not ok:
                break
            frame = imaging.flip_horizontal(frame)
            frame = imaging.resize(frame, self.window)
            res1, should = calculate_heatmap(output, threshold=0,
                                             window=self.window)
            res = imaging.add_weighted(prev, 0.5, res1, 0.5)
            prev = res
            img = imaging.add_weighted(frame, 0.9, res, 0.9) if should \
                else frame
            self.display.show(img)
            n += 1

    def _running(self):
        v = getattr(self.running, "value", self.running)
        return bool(v)


class Viewer:
    """Heatmap + YOLO + fusion viewer (visual.py:389-493)."""

    def __init__(self, cb: Optional[Callable] = None, window=(1920, 1080),
                 display=None, heatmap_color: bool = False):
        self.cb = cb
        self.window = window
        self.display = display if display is not None else _CvDisplay(
            "zybo-rt-torch", self._mouse)
        self.heatmap_color = heatmap_color

    def _mouse(self, x, y):
        from ..config import DEFAULT
        max_x = DEFAULT.max_angle
        max_y = DEFAULT.max_angle / DEFAULT.aspect_ratio
        horizontal = (x / self.window[0]) * max_x * 2 - max_x
        vertical = (y / self.window[1]) * max_y * 2 - max_y
        if self.cb is not None:
            self.cb(horizontal, vertical)

    def loop(self, q_power, running, q_viewer=None, q_inference=None,
             decider=None, max_frames: Optional[int] = None):
        """One display iteration per (power, camera, yolo) triple
        (visual.py:405-484)."""
        import queue as _queue

        from ..fusion.decider import SensorFusionDecider
        if decider is None:
            decider = SensorFusionDecider((640, 360))
        prev = np.zeros((self.window[1], self.window[0], 3), np.uint8)
        n = 0
        # items already dequeued are CARRIED across timeouts — the three
        # gets are not atomic, and dropping a fetched (yolo, power) pair
        # because the camera queue timed out would silently lose frames
        # every iteration while one producer stalls
        pend_yolo = pend_power = pend_frame = None
        while self._running(running) and (max_frames is None
                                          or n < max_frames):
            try:
                if q_inference is not None and pend_yolo is None:
                    pend_yolo = q_inference.get(timeout=0.5)
                if pend_power is None:
                    pend_power = q_power.get(timeout=0.5)
                if q_viewer is not None and pend_frame is None:
                    pend_frame = q_viewer.get(timeout=0.5)
            except _queue.Empty:
                continue        # keep what we have; retry the missing queue
            yolo_no, yolo_frame, conf = (pend_yolo if pend_yolo is not None
                                         else (None, None, 0.0))
            output, power_no = pend_power
            frame_no, frame = (pend_frame if pend_frame is not None
                               else (None, None))
            pend_yolo = pend_power = pend_frame = None
            for q in (q_inference, q_power, q_viewer):
                if q is not None and hasattr(q, "task_done"):
                    try:
                        q.task_done()
                    except Exception:
                        pass
            if frame is None:
                frame = np.zeros((self.window[1], self.window[0], 3),
                                 np.uint8)
            frame = imaging.flip_horizontal(frame)
            frame = imaging.resize(frame, self.window)
            power_box, res1, should = calculate_heatmap_with_detection(
                output, window=self.window)
            res = imaging.add_weighted(prev, 0.5, res1, 0.5)
            prev = res
            image = imaging.add_weighted(frame, 0.9, res, 0.9) \
                if self.heatmap_color else frame
            yolo_img = np.zeros_like(image) if yolo_frame is None else \
                imaging.resize(imaging.gray_to_bgr(yolo_frame), self.window)
            combined = decider.create_image(image, yolo_img, power_box, res)
            combined = imaging.gray_to_bgr(combined)
            self.display.show(combined)
            n += 1

    @staticmethod
    def _running(running):
        return bool(getattr(running, "value", running))


class _CvCapture:                                     # pragma: no cover
    def __init__(self, src):
        import cv2
        self.cap = cv2.VideoCapture(src)

    def read(self):
        return self.cap.read()


class _CvDisplay:                                     # pragma: no cover
    def __init__(self, name, mouse_cb=None):
        self.name = name
        self.mouse_cb = mouse_cb
        self._set = False

    def show(self, img) -> int:
        """Show ``img``; returns the key pressed meanwhile (-1 for none)."""
        import cv2
        cv2.imshow(self.name, img)
        if self.mouse_cb and not self._set:
            def handler(event, x, y, flags, params):
                if event == cv2.EVENT_LBUTTONDOWN:
                    self.mouse_cb(x, y)
            cv2.setMouseCallback(self.name, handler)
            self._set = True
        return cv2.waitKey(1)


class ArrayDisplay:
    """Headless display capturing shown frames (tests / mp4 export)."""

    def __init__(self, keep: int = 4):
        self.frames = []
        self.keep = keep

    def show(self, img):
        self.frames.append(np.asarray(img).copy())
        if len(self.frames) > self.keep:
            self.frames.pop(0)

    def show_batch(self, imgs):
        """Append a whole (K, H, W, 3) batch the caller relinquishes,
        without a copy a frame (the fused stages hand over a freshly
        unpacked buffer they never touch again)."""
        self.frames.extend(np.asarray(imgs))
        del self.frames[:-self.keep]


class ArrayCapture:
    """Headless camera replaying a list of frames."""

    def __init__(self, frames):
        self.frames = list(frames)
        self.i = 0

    def read(self):
        if not self.frames:
            return False, None
        f = self.frames[self.i % len(self.frames)]
        self.i += 1
        return True, f
