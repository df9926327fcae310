"""Non-maximum suppression as tensor ops on the device.

Greedy NMS with a fixed output size and no host sync: ``max_det`` steps of
argmax-select + IoU-suppress over the score vector, vectorised over the
batch axis (the JAX package's ``nms`` under ``vmap``).  No step reads a
device value on the host, so a call queues its work and returns.
"""

from __future__ import annotations

import torch


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, a: (..., N, 4), b: (..., M, 4) xyxy -> (..., N, M).
    Same math as the reference's ``compute_iou`` / ``iou_batch``
    (sort.py:47-63)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float = 0.45, score_threshold: float = 0.0,
                max_det: int = 32):
    """(B, N, 4) boxes + (B, N) scores -> (B, max_det, 5) [x1, y1, x2, y2,
    score], zero-filled past the kept boxes; a (B, max_det) validity mask;
    and the (B, max_det) int32 source indices of the kept boxes (for
    gathering per-anchor side data like the argmax class; zero where
    invalid).

    Each step takes the first index of the highest live score (the tie
    rule of ``jnp.argmax``), keeps it when that score is above 0, and sets
    the scores of the boxes it suppresses (IoU above the threshold, and
    itself) to the -1 sentinel."""
    boxes = boxes.float()
    live = torch.where(scores >= score_threshold, scores.float(),
                       torch.full_like(scores, -1.0, dtype=torch.float32))
    ar = torch.arange(live.shape[1], device=live.device)
    rows, masks, idxs = [], [], []
    for _ in range(max_det):
        j = live.argmax(dim=1, keepdim=True)                     # (B, 1)
        best = live.gather(1, j)                                 # (B, 1)
        valid = best > 0.0
        box = boxes.gather(1, j[..., None].expand(-1, 1, 4))     # (B, 1, 4)
        row = torch.cat([box[:, 0], best], dim=1)
        rows.append(torch.where(valid, row, torch.zeros_like(row)))
        masks.append(valid[:, 0])
        idxs.append(torch.where(valid, j, torch.zeros_like(j))[:, 0])
        ious = iou_matrix(box, boxes)[:, 0]                      # (B, N)
        suppress = (ious > iou_threshold) | (ar[None, :] == j)
        live = torch.where(valid & suppress,
                           torch.full_like(live, -1.0), live)
    return (torch.stack(rows, 1), torch.stack(masks, 1),
            torch.stack(idxs, 1).to(torch.int32))


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.45, score_threshold: float = 0.0,
        max_det: int = 32):
    """(N, 4) boxes + (N,) scores -> (max_det, 5), mask, indices: one
    frame of :func:`batched_nms`."""
    out, mask, idx = batched_nms(boxes[None], scores[None], iou_threshold,
                                 score_threshold, max_det)
    return out[0], mask[0], idx[0]
