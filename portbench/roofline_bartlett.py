"""The work of a batch of Bartlett heatmaps, frozen for the benchmark.

The least time the card could take for a batch of ``fft`` heatmaps,
whatever the program computes them with: the larger of the operations
over the FP32 peak and the bytes over the HBM bandwidth
(:data:`portbench.roofline.PEAKS`).  Operations: 8 for each bin, active
channel, direction and frame (the complex multiply-add of the
contraction ``sum_m S[f, m] P[f, m, d]``; the rfft and the squares are
extra and not counted).  Bytes: the frames in as FP32, the complex64
steering tensor once, and the maps out as FP32.
"""

from __future__ import annotations

import numpy as np

from portbench import roofline


def bins(cfg) -> int:
    """The band's rfft bins: those from the bin nearest ``freq_band_low``
    up to, and without, the bin nearest ``freq_band_high`` (Nyquist where
    it is not positive)."""
    f = np.linspace(0, cfg.sample_rate / 2, cfg.n_samples // 2 + 1)
    high = (cfg.freq_band_high if cfg.freq_band_high > 0
            else cfg.sample_rate / 2)
    return int(np.abs(f - high).argmin() - np.abs(f - cfg.freq_band_low)
               .argmin())


def bartlett_counts(cfg, frames: int, channels: int):
    """(operations, bytes) of ``frames`` heatmaps of ``channels`` active
    channels."""
    D = cfg.max_res_x * cfg.max_res_y
    F = bins(cfg)
    ops = 8 * F * channels * D * frames
    nbytes = (4 * frames * channels * cfg.n_samples + 8 * F * channels * D
              + 4 * frames * D)
    return ops, nbytes


def bartlett_bound_s(cfg, frames: int, channels: int, device_kind: str):
    """Seconds the card ``device_kind`` needs at least, or None for a card
    whose peaks the table lacks."""
    peak = roofline.PEAKS.get(device_kind)
    if peak is None:
        return None
    ops, nbytes = bartlett_counts(cfg, frames, channels)
    return max(ops / peak["fp32_flops"], nbytes / peak["bytes_per_s"])
