"""Peaks of the card and the work of a heatmap, frozen for the benchmark.

The least time the card could take for a batch of lerp heatmaps, whatever
the program computes them with: the larger of the operations over the
FP32 peak and the bytes over the HBM bandwidth.  Operations: 4 for each
active channel, sample, direction and frame (the two-tap interpolation's
multiply-adds; the squares are extra and not counted).  Bytes: the frames
in and the maps out in FP32, and one FP32 delay per channel and direction.
"""

from __future__ import annotations

# Published peaks (NVIDIA H100 data sheet, SXM part, dense, at 700 W).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "bytes_per_s": 3.35e12},
}


def lerp_counts(cfg, frames: int, channels: int):
    """(operations, bytes) of ``frames`` heatmaps of ``channels`` active
    channels."""
    D = cfg.max_res_x * cfg.max_res_y
    N = cfg.n_samples
    ops = 4 * channels * N * D * frames
    nbytes = 4 * (frames * channels * N + frames * D + D * channels)
    return ops, nbytes


def lerp_bound_s(cfg, frames: int, channels: int, device_kind: str):
    """Seconds the card ``device_kind`` needs at least, or None for a card
    whose peaks the table lacks."""
    peak = PEAKS.get(device_kind)
    if peak is None:
        return None
    ops, nbytes = lerp_counts(cfg, frames, channels)
    return max(ops / peak["fp32_flops"], nbytes / peak["bytes_per_s"])
