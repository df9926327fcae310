"""Steering geometry of the lerp delay-and-sum, frozen for the benchmark.

A copy of the math of the upstream ``PC/src/directions.pyx`` (mic plane,
active-mic selection, cartesian scanning-window delays) and of
``lerp_and_sum.c``'s coefficient split, in float64 NumPy.  The reference
(``references/lerp.py``) and the signal generator
(:mod:`portbench.signals`) take the geometry from here and never from the
measured package, so a change there cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np


def active_mics(cfg) -> np.ndarray:
    """Ascending indices of the active microphones: the mic-index plane is
    the horizontal concatenation of ``array_slots`` (rows, columns) index
    blocks, decimated by ``skip_n_mics``, minus ``unused_mics``."""
    step = cfg.skip_n_mics
    per = cfg.rows * cfg.columns
    plane = np.hstack([np.arange(a * per, (a + 1) * per).reshape(
        cfg.rows, cfg.columns) for a in range(cfg.array_slots)])
    unused = {int(m) for m in cfg.unused_mics}
    picked = [int(plane[r, c])
              for r in range(0, cfg.rows, step)
              for c in range(0, cfg.columns * cfg.array_slots, step)
              if int(plane[r, c]) not in unused]
    return np.sort(np.asarray(picked, np.int64))


def mic_xy(cfg) -> np.ndarray:
    """(2, n_mics_total) x and y of every mic slot [m]: slots daisy-chain
    to the left, the plane is centred on the slots' middle."""
    d = cfg.element_distance
    half = d / 2
    n = cfg.array_slots * cfg.rows * cfg.columns
    xy = np.zeros((2, n))
    i = 0
    for a in range(cfg.array_slots):
        for r in range(cfg.rows):
            for c in range(cfg.columns):
                xy[0, i] = (-c * d - half - a * cfg.columns * d
                            + cfg.columns * cfg.array_slots * half)
                xy[1, i] = r * d - cfg.rows * half + half
                i += 1
    return xy


def scan_points(cfg):
    """(x, y, r) of the scanning window's grid, broadcast (X, 1), (1, Y),
    (X, Y): a window at distance ``z_scan`` spanning ``view_angle``
    horizontally, ``aspect_ratio`` wide."""
    x_max = cfg.z_scan * np.tan(np.deg2rad(cfg.view_angle / 2))
    y_max = x_max / cfg.aspect_ratio
    x = np.linspace(-x_max, x_max, cfg.max_res_x).reshape(-1, 1)
    y = np.linspace(-y_max, y_max, cfg.max_res_y).reshape(1, -1)
    return x, y, np.sqrt(x ** 2 + y ** 2 + cfg.z_scan ** 2)


def sample_delays(cfg) -> np.ndarray:
    """(X, Y, M) fractional delays in samples of the active mics: a plane
    wave from each window point reaches mic i early by
    ``(fs / c) (x xi + y yi) / r``; each direction's delays are shifted so
    that the smallest is 0."""
    xy = mic_xy(cfg)[:, active_mics(cfg)]
    x, y, r = scan_points(cfg)
    dl = (cfg.sample_rate / cfg.propagation_speed) * (
        x[..., None] * xy[0] + y[..., None] * xy[1]) / r[..., None]
    return dl - dl.min(axis=2, keepdims=True)


def lerp_taps(cfg):
    """``lerp_and_sum.c``'s split of each delay, which the C code receives
    as float32: the whole part ``w`` (int64, (D, M)) and ``h = 1 - frac``
    rounded to float32 (returned as float64, (D, M)); direction
    ``d = x * res_y + y``."""
    dl = sample_delays(cfg).astype(np.float32).astype(np.float64)
    whole = np.floor(dl)
    h = (1.0 - (dl - whole)).astype(np.float32).astype(np.float64)
    D = cfg.max_res_x * cfg.max_res_y
    return whole.reshape(D, -1).astype(np.int64), h.reshape(D, -1)
