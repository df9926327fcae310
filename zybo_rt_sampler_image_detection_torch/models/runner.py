"""Standalone object-detection runner — API parity with the reference's
``image-detection/src/run_object_oriented.py`` (ObjectDetection class with
``train`` / ``run_inference`` / ``run_conf_n_inference``) and ``driver.py``.
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

    def train(self, dataset, epochs: int = 1, learning_rate: float = 1e-3):
        """Fine-tune on an iterable of (images, boxes) batches
        (``run_object_oriented.py:13-19`` wrapped Ultralytics train), on
        the detector's device."""
        from .train import Trainer

        trainer = Trainer(self.detector.cfg, learning_rate=learning_rate,
                          device=self.detector.device)
        trainer.state.variables = self.detector.variables
        losses = trainer.fit(dataset, epochs=epochs)
        self.detector.variables = trainer.state.variables
        return losses

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
