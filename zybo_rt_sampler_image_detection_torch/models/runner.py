"""Standalone object-detection runner — API parity with the reference's
``image-detection/src/run_object_oriented.py`` (ObjectDetection class with
``run_inference`` / ``run_conf_n_inference``) and ``driver.py``.

``train`` waits for the training slice of the port (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class ObjectDetection:
    def __init__(self, model_path: Optional[str] = None, cfg=None,
                 device="cuda"):
        from .detect import YoloDetector

        self.detector = YoloDetector(model_path=model_path, cfg=cfg,
                                     device=device)

    def run_inference(self, frame: np.ndarray, conf_threshold: float = 0.25):
        """Single-frame detections (``run_object_oriented.py:21-30``)."""
        return self.detector.get_detections(frame, conf_threshold)

    def run_conf_n_inference(self, frame_queue, output_queue,
                             conf_threshold: float = 0.25,
                             max_frames: Optional[int] = None):
        """Queue loop: (n, frame) in -> (n, detections) out
        (``run_object_oriented.py:32-48``)."""
        n = 0
        while max_frames is None or n < max_frames:
            try:
                frame_no, frame = frame_queue.get()
            except Exception:
                continue
            if frame is None:
                break
            n += 1
            output_queue.put(
                (frame_no, self.run_inference(frame, conf_threshold)))
        return n
