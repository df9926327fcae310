"""The plain reference of the ``fft`` heatmap: Bartlett power in float64.

The upstream web app's FFT backend (``realtime_scripts/
beam_forming_algorithm.py:30-70``, before its display normalization)
takes the rfft of each active channel, keeps the bins ``[lo, hi)`` of its
band, steers each bin by the phase tensor of
``calc_phase_shift_cartesian.py:44-50``::

    P[f, m, x, y] = exp(-j k_f (x xi_m + y yi_m) / r(x, y)),
    k_f = 2 pi f / c

and sums ``|sum_m S[f, m] P[f, m, x, y]|^2`` over the bins.  The mic
positions are the FFT stack's own model (``calc_r_prime.py:7-24``: the
plane lowered by the camera offset, the boards spread by the array
separation, laid out over ``active_arrays`` boards), and so is its
active-mic selection (``active_microphones.py:4-45``: the same
decimation and deadmap as ``directions.pyx``, over ``active_arrays``
boards).  :func:`maps` runs that in float64 / complex128 torch on any
device, with TF32 off.  It imports nothing of the measured package and
takes nothing it made: only the configuration's numbers and the frames
the benchmark generated.
"""

from __future__ import annotations

import numpy as np
import torch


def active_mics(cfg) -> np.ndarray:
    """Ascending indices of the FFT stack's active microphones: the
    horizontal concatenation of ``active_arrays`` (rows, columns) index
    blocks, decimated by ``skip_n_mics``, minus ``unused_mics``."""
    step = cfg.skip_n_mics
    per = cfg.rows * cfg.columns
    plane = np.hstack([np.arange(a * per, (a + 1) * per).reshape(
        cfg.rows, cfg.columns) for a in range(cfg.active_arrays)])
    unused = {int(m) for m in cfg.unused_mics}
    picked = [int(plane[r, c])
              for r in range(0, cfg.rows, step)
              for c in range(0, cfg.columns * cfg.active_arrays, step)
              if int(plane[r, c]) not in unused]
    return np.sort(np.asarray(picked, np.int64))


def mic_xy(cfg) -> np.ndarray:
    """(2, n_microphones) x and y of every mic slot [m]: boards
    daisy-chain to the left, spread by ``array_separation``, the plane
    centred on the boards' middle and lowered by ``camera_offset``."""
    d = cfg.element_distance
    half = d / 2
    sep = cfg.array_separation
    xy = np.zeros((2, cfg.n_microphones))
    i = 0
    for a in range(cfg.active_arrays):
        for r in range(cfg.rows):
            for c in range(cfg.columns):
                xy[0, i] = (-c * d - half - a * cfg.columns * d - a * sep
                            + cfg.columns * cfg.active_arrays * half
                            + (cfg.active_arrays - 1) * sep / 2)
                xy[1, i] = r * d - cfg.rows * half + half - cfg.camera_offset
                i += 1
    return xy


def band(cfg):
    """(lo, hi): the rfft bins nearest the band's edges (the upper edge
    Nyquist where ``freq_band_high`` is not positive), ``hi`` excluded."""
    f = np.linspace(0, cfg.sample_rate / 2, cfg.n_samples // 2 + 1)
    high = (cfg.freq_band_high if cfg.freq_band_high > 0
            else cfg.sample_rate / 2)
    return (int(np.abs(f - cfg.freq_band_low).argmin()),
            int(np.abs(f - high).argmin()))


def phase(cfg) -> np.ndarray:
    """(F, M, X * Y) complex128 steering tensor of the band's bins."""
    xy = mic_xy(cfg)[:, active_mics(cfg)]
    x_max = cfg.z_scan * np.tan(np.deg2rad(cfg.view_angle / 2))
    y_max = x_max / cfg.aspect_ratio
    x = np.linspace(-x_max, x_max, cfg.max_res_x)[:, None]
    y = np.linspace(-y_max, y_max, cfg.max_res_y)[None, :]
    r = np.sqrt(x ** 2 + y ** 2 + cfg.z_scan ** 2)
    proj = ((x[..., None] * xy[0] + y[..., None] * xy[1])
            / r[..., None])                                    # (X, Y, M)
    lo, hi = band(cfg)
    f = np.linspace(0, cfg.sample_rate / 2, cfg.n_samples // 2 + 1)[lo:hi]
    k = 2 * np.pi * f / cfg.propagation_speed
    ph = np.exp(-1j * k[:, None, None] * proj.reshape(-1, xy.shape[1]).T)
    return ph                                                   # (F, M, D)


def maps(cfg, device, frames: np.ndarray, block: int = 32) -> np.ndarray:
    """(B, n_mics, N) frames (any real dtype, full channel axis) ->
    (B, X, Y) float64 Bartlett heatmaps, ``block`` frames at a time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    active = torch.as_tensor(active_mics(cfg), device=dev)
    P = torch.as_tensor(phase(cfg), device=dev)
    lo, hi = band(cfg)
    out = [_block(frames[i:i + block], active, P, lo, hi, dev)
           for i in range(0, len(frames), block)]
    maps_ = (np.concatenate(out) if out
             else np.zeros((0, cfg.max_res_x * cfg.max_res_y)))
    return maps_.reshape(-1, cfg.max_res_x, cfg.max_res_y)


def _block(frames, active, P, lo, hi, dev) -> np.ndarray:
    s = torch.as_tensor(np.asarray(frames, np.float64),
                        device=dev)[:, active]                  # (B, M, N)
    S = torch.fft.rfft(s, dim=-1)[..., lo:hi]                   # (B, M, F)
    Y = torch.matmul(S.permute(2, 0, 1), P)                     # (F, B, D)
    return (Y.real ** 2 + Y.imag ** 2).sum(dim=0).cpu().numpy()
