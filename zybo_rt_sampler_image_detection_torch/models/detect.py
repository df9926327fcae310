"""Detector wrapper with the reference's ``yolo_model`` API.

``get_detections(frame, conf_threshold)`` returns ``[[x1,y1,x2,y2,conf],
...]`` in source-image pixels, exactly like
``yolo_smooth_tracking.py:13-23``.  A call is one program on the device:
the host resizes the frames, uploads them once as pinned uint8, and the
device scales them, runs the backbone, decodes, scores and suppresses;
the host then downloads one fixed-size table.

Weights: ``save_weights``/``load_weights`` read and write the JAX
package's format (a pickled dict of NumPy arrays, flax's nesting), so a
``--weights`` file written by either package loads in both;
``load_weights`` also reads the flattened ``.npz`` of the committed demo
detector (:func:`pretrained_demo_detector`).
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np
import torch

from . import nms as nms_mod
from .yolo import (YoloConfig, decode_all, fp32_convs, init_params,
                   state_dict_to_variables, variables_to_state_dict)
from ..ops.beamform import resolve_device

DEMO_WEIGHTS = os.path.join(os.path.dirname(__file__), "assets",
                            "demo_detector_s64_w025_c1.npz")
DEMO_CONFIG = YoloConfig(input_size=64, width_mult=0.25, num_classes=1)


class YoloDetector:
    """``device`` defaults to the card (``"cuda"`` raises without a GPU);
    ``seed`` draws the weights (:func:`yolo.init_params`) when no
    ``model_path`` is given.  ``variables`` reads and sets the weights in
    the JAX package's layout."""

    def __init__(self, model_path: Optional[str] = None,
                 cfg: Optional[YoloConfig] = None, max_det: int = 32,
                 iou_threshold: float = 0.45, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg or YoloConfig()
        self.max_det = max_det
        self.iou_threshold = iou_threshold
        self.device = resolve_device(device)
        self.model = init_params(self.cfg,
                                 torch.Generator().manual_seed(seed),
                                 self.device)
        if model_path:
            self.variables = load_weights(model_path)
        self._pinned = {}

    @property
    def variables(self) -> dict:
        return state_dict_to_variables(self.model.state_dict())

    @variables.setter
    def variables(self, variables) -> None:
        self.model.load_state_dict(variables_to_state_dict(variables))

    # -- device program -------------------------------------------------------

    @torch.no_grad()
    def forward(self, imgs_u8: torch.Tensor) -> list:
        """(K, S, S, 3) uint8 on the device -> the raw heads: scale and
        backbone (FP32 convs with TF32 off in float32)."""
        with fp32_convs():
            return self.model(imgs_u8.float() / 255.0)

    @torch.no_grad()
    def postprocess(self, heads):
        """Raw heads -> ((K, max_det, 5) rows, (K, max_det) mask,
        (K, max_det) argmax class ids): decode, score, batched NMS and the
        class gather."""
        boxes, obj, cls = decode_all(self.cfg, heads)
        score = obj * cls.max(dim=-1).values
        out, mask, idx = nms_mod.batched_nms(
            boxes, score, iou_threshold=self.iou_threshold,
            max_det=self.max_det)
        cls_ids = torch.gather(cls.argmax(dim=-1), 1, idx.long())
        return out, mask, cls_ids.to(torch.int32)

    def program(self, imgs_u8: torch.Tensor):
        """The device program of one call, without a host sync:
        :meth:`forward` then :meth:`postprocess`."""
        return self.postprocess(self.forward(imgs_u8))

    def _upload(self, imgs: np.ndarray) -> torch.Tensor:
        """One host->device copy of the uint8 batch, from a pinned buffer
        kept per batch shape on the card (each call downloads its result
        before it returns, so the buffer is free again by the next)."""
        if self.device.type != "cuda":
            return torch.from_numpy(imgs)
        buf = self._pinned.get(imgs.shape)
        if buf is None:
            buf = self._pinned[imgs.shape] = torch.empty(
                imgs.shape, dtype=torch.uint8, pin_memory=True)
        buf.numpy()[...] = imgs
        return buf.to(self.device, non_blocking=True)

    def _infer(self, imgs: np.ndarray):
        """Host (K, S, S, 3) uint8 -> host (rows, mask, class ids), with
        one upload and one download."""
        out, mask, cls_ids = self.program(self._upload(imgs))
        packed = torch.cat([out, mask[..., None].float(),
                            cls_ids[..., None].float()], dim=-1).cpu()
        packed = packed.numpy()
        return (packed[..., :5], packed[..., 5] > 0.5,
                packed[..., 6].astype(np.int32))

    # -- host API (reference parity) ------------------------------------------

    def get_detections_batch(self, frames: List[np.ndarray],
                             conf_threshold: float = 0.0,
                             pad_to: int = 0,
                             include_class: bool = False
                             ) -> List[List[list]]:
        """Batched ``get_detections``: one device program for ``frames``.

        ``pad_to`` > len(frames) pads the batch with zero images so the
        program keeps one batch shape (padded outputs are discarded).
        Returns per-frame detection lists in source-image pixels;
        ``include_class`` appends the argmax class id as a 6th column.
        """
        if not frames:
            return []
        c = self.cfg
        K = max(pad_to, len(frames))
        imgs = np.zeros((K, c.input_size, c.input_size, 3), np.uint8)
        scales = []
        for i, f in enumerate(frames):
            h, w = f.shape[:2]
            imgs[i] = _resize_u8(f, (c.input_size, c.input_size))
            scales.append((w / c.input_size, h / c.input_size))
        out, mask, cls_ids = self._infer(imgs)
        return [self._rows_to_dets(out[i], mask[i], cls_ids[i], sx, sy,
                                   conf_threshold, include_class)
                for i, (sx, sy) in enumerate(scales)]

    @staticmethod
    def _rows_to_dets(out, mask, cls_ids, sx, sy, conf_threshold,
                      include_class):
        dets = []
        for row, ok, ci in zip(out, mask, cls_ids):
            if not ok or row[4] < conf_threshold:
                continue
            x1, y1, x2, y2, conf = row
            d = [float(x1 * sx), float(y1 * sy),
                 float(x2 * sx), float(y2 * sy), float(conf)]
            if include_class:
                d.append(int(ci))
            dets.append(d)
        return dets

    def get_detections(self, frame: np.ndarray,
                       conf_threshold: float = 0.0,
                       include_class: bool = False) -> List[list]:
        """``yolo_model.get_detections`` (yolo_smooth_tracking.py:13-23);
        ``include_class`` appends the argmax class id as a 6th column."""
        return self.get_detections_batch([frame], conf_threshold,
                                         include_class=include_class)[0]


def _resize_u8(frame: np.ndarray, size) -> np.ndarray:
    """Nearest/linear resize to (H, W); cv2 when present, NumPy otherwise."""
    if frame.ndim == 2:
        frame = np.repeat(frame[..., None], 3, axis=-1)
    try:
        import cv2
        return cv2.resize(frame, (size[1], size[0]),
                          interpolation=cv2.INTER_LINEAR)
    except ImportError:
        ys = np.linspace(0, frame.shape[0] - 1, size[0]).round().astype(int)
        xs = np.linspace(0, frame.shape[1] - 1, size[1]).round().astype(int)
        return frame[ys][:, xs]


def save_weights(path: str, variables) -> None:
    """Pickle ``variables`` (the JAX package's layout, as NumPy arrays)."""
    with open(path, "wb") as f:
        pickle.dump(_to_numpy(variables), f)


def load_weights(path: str) -> dict:
    """Variables from a pickle of either package, or from a flattened
    ``.npz`` whose keys join the nesting with ``/``."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            out: dict = {}
            for key in z.files:
                *parents, leaf = key.split("/")
                node = out
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = z[key]
            return out
    with open(path, "rb") as f:
        return pickle.load(f)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def pretrained_demo_detector(device="cuda") -> YoloDetector:
    """The demo detector (64 px, width 0.25, one class) on the committed
    weights, which ``scripts/export_demo_detector.py`` made with the JAX
    package's recipe (``pretrained_demo_detector``, 700 steps on the
    synthetic task).  It loads; it does not train."""
    return YoloDetector(model_path=DEMO_WEIGHTS, cfg=DEMO_CONFIG,
                        device=device)
