"""The work of a batch of streaming Capon maps, frozen for the benchmark.

The least time the card could take for a batch of B ``mvdr`` heatmaps,
whatever the program computes them with: the larger of the operations
over the FP32 peak and the bytes over the HBM bandwidth
(:data:`portbench.roofline.PEAKS`), with F the band's bins, M the active
mics and D the directions.  Operations (8 a complex multiply-add):

* every batch, ``8 F M D B`` for the projections ``a^H P S`` of the
  batch's snapshots and ``8 F 4 M^2 B`` for its rank-B update (``P S``,
  the Woodbury advance of P, the covariance's outer products);
* once every ``refresh_frames`` frames, so ``B / refresh_frames`` of it a
  batch: ``8 F M^2 D`` for the full quadratic form ``a^H P a`` and
  ``4 F M^3`` for the exact refresh (a Cholesky and its inverse a bin).

Bytes: the complex64 steering tensor once a batch, P and R (each F M^2
complex64) read and written once a batch, the frames in as FP32 over the
stage's channels and the maps out as FP32.
"""

from __future__ import annotations

import numpy as np

from portbench import geometry, roofline


def bins(cfg, low_hz: float) -> int:
    """The band's rfft bins, from the bin nearest ``low_hz`` up to, and
    without, the bin nearest ``freq_band_high`` (Nyquist where it is not
    positive)."""
    f = np.linspace(0, cfg.sample_rate / 2, cfg.n_samples // 2 + 1)
    high = (cfg.freq_band_high if cfg.freq_band_high > 0
            else cfg.sample_rate / 2)
    return int(np.abs(f - high).argmin() - np.abs(f - low_hz).argmin())


def mvdr_counts(cfg, mvdr: dict, frames: int, channels: int):
    """(operations, bytes) of ``frames`` maps, the stage's batches of
    ``channels`` rows, under the configuration's ``mvdr`` constants."""
    F = bins(cfg, mvdr["band_low_hz"])
    M = len(geometry.active_mics(cfg))
    D = cfg.max_res_x * cfg.max_res_y
    per_refresh = 8 * F * M * M * D + 4 * F * M ** 3
    ops = (8 * F * M * D * frames + 8 * F * 4 * M * M * frames
           + per_refresh * frames / mvdr["refresh_frames"])
    nbytes = (8 * F * M * D + 4 * 8 * F * M * M
              + 4 * frames * channels * cfg.n_samples + 4 * frames * D)
    return ops, nbytes


def mvdr_bound_s(cfg, mvdr: dict, frames: int, channels: int,
                 device_kind: str):
    """Seconds the card ``device_kind`` needs at least, or None for a card
    whose peaks the table lacks."""
    peak = roofline.PEAKS.get(device_kind)
    if peak is None:
        return None
    ops, nbytes = mvdr_counts(cfg, mvdr, frames, channels)
    return max(ops / peak["fp32_flops"], nbytes / peak["bytes_per_s"])
