"""The plain reference of the ``mvdr`` heatmap: streaming Capon maps in
float64.

The measured route (``Pipeline(cfg, "mvdr")``) keeps, per rfft bin f of
its band, the EMA covariance of the snapshots ``x_s`` (the rfft of the
active mics' frame s)::

    R_0 = x_0 x_0^H,   R_t = alpha R_(t-1) + (1 - alpha) x_t x_t^H

(the first frame after the stream's reset replaces the prior), and the
inverse ``P`` of the loaded covariance, updated by Woodbury steps and
refreshed exactly, ``P_r = (R_r + lambda_r I)^-1`` with ``lambda_r =
load tr(R_r) / M + 1e-12``, whenever ``refresh_frames`` frames have gone
by since the last refresh (at frame counts r = refresh_frames,
2 refresh_frames, ...).  Each Woodbury step is
``P^-1 <- alpha P^-1 + (1 - alpha) x x^H``, so between refreshes the
recursion computes exactly::

    P_t^-1 = R_t + alpha^(t - r) lambda_r I,

t frames absorbed, r at the last refresh.  Before the first refresh the
stream starts from ``P^-1 = (1 + load) I`` and weighs every frame
``(1 - alpha)``: ``P_t^-1 = sum_s (1 - alpha) alpha^(t-1-s) x_s x_s^H +
alpha^t (1 + load) I``.  The map of the t-th frame is Capon's spectrum
summed over the band::

    map_t(d) = sum_f 1 / Re(a_fd^H P_t a_fd),   a = conj(phase),

with ``phase[f, m, d] = exp(-j k_f (x x_m + y y_m) / r)`` the main mic
model's near-field steering (:mod:`portbench.geometry`).  :func:`maps`
evaluates that one checked frame at a time, by a Cholesky factor of
``P_t^-1`` and one triangular solve a bin (``a^H A^-1 a = |L^-1
a|^2``), in float64 / complex128 torch with TF32 off: no Woodbury
update, no carried quadratic form, no clamp.  It imports nothing of the
measured package.  The estimator's constants come from the configuration
(its ``"mvdr"`` block) through the sample the driver hands it.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import geometry


def band(cfg, low_hz: float):
    """(lo, hi): the rfft bins nearest ``low_hz`` and the upper edge (the
    configuration's ``freq_band_high``, Nyquist where it is not
    positive), ``hi`` excluded."""
    f = np.linspace(0, cfg.sample_rate / 2, cfg.n_samples // 2 + 1)
    high = (cfg.freq_band_high if cfg.freq_band_high > 0
            else cfg.sample_rate / 2)
    return (int(np.abs(f - low_hz).argmin()),
            int(np.abs(f - high).argmin()))


def steering(cfg, low_hz: float) -> np.ndarray:
    """(F, M, X * Y) complex128 Capon steering vectors ``a = conj(phase)``
    of the band's bins and the active mics, direction ``x * Y + y``."""
    xy = geometry.mic_xy(cfg)[:, geometry.active_mics(cfg)]
    x, y, r = geometry.scan_points(cfg)
    proj = (x[..., None] * xy[0] + y[..., None] * xy[1]) / r[..., None]
    lo, hi = band(cfg, low_hz)
    f = np.linspace(0, cfg.sample_rate / 2, cfg.n_samples // 2 + 1)[lo:hi]
    k = 2 * np.pi * f / cfg.propagation_speed
    return np.exp(1j * k[:, None, None] * proj.reshape(-1, xy.shape[1]).T)


def maps(cfg, device, sample) -> np.ndarray:
    """(n, X, Y) float64 maps of the ``len(sample)`` checked frames of a
    stream sample: ``sample.frames`` (T, n_mics, N), the history then the
    checked frames as delivered; ``sample.first``, the count of frames the
    stream had absorbed since its reset before ``frames[0]`` (0: the
    history starts at the reset); ``sample.mvdr``, the configuration's
    ``alpha``, ``load``, ``band_low_hz`` and ``refresh_frames``.  Raises
    where a checked frame's refresh lies before the history."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = sample.mvdr
    alpha, load = float(c["alpha"]), float(c["load"])
    every = int(c["refresh_frames"])
    dev = torch.device(device)
    n = len(sample)
    T, first = len(sample.frames), int(sample.first)
    if n == 0:
        return np.zeros((0, cfg.max_res_x, cfg.max_res_y))
    t_check = first + T - n                   # count before the first check
    if first > 0 and (t_check // every) * every <= first:
        raise ValueError("the history does not reach the checked frames' "
                         "refresh")
    a = torch.as_tensor(steering(cfg, c["band_low_hz"]), device=dev)
    lo, hi = band(cfg, c["band_low_hz"])
    active = torch.as_tensor(geometry.active_mics(cfg), device=dev)
    M = len(active)
    eye = torch.eye(M, dtype=torch.complex128, device=dev)
    R = torch.zeros((hi - lo, M, M), dtype=torch.complex128, device=dev)
    Q = torch.zeros_like(R)           # the first epoch's precision sum
    lam = None
    out = []
    for i in range(T):
        t = first + i                 # frames absorbed before this one
        if t > 0 and t % every == 0:
            lam = load * R.diagonal(dim1=-2, dim2=-1).real.sum(-1) / M \
                + 1e-12
        s = torch.as_tensor(np.asarray(sample.frames[i], np.float64),
                            device=dev)[active]
        x = torch.fft.rfft(s, dim=-1)[:, lo:hi].T               # (F, M)
        xx = x[:, :, None] * x[:, None, :].conj()
        R = xx if t == 0 else alpha * R + (1 - alpha) * xx
        Q = alpha * Q + (1 - alpha) * xx
        if i < T - n:
            continue
        if t < every:                 # before the first refresh
            A = Q + alpha ** (t + 1) * (1 + load) * eye
        else:
            k = t + 1 - (t // every) * every
            A = R + (alpha ** k * lam)[:, None, None] * eye
        L = torch.linalg.cholesky(A)
        y = torch.linalg.solve_triangular(L, a, upper=False)    # (F, M, D)
        d = y.real.square().sum(1) + y.imag.square().sum(1)     # (F, D)
        out.append((1.0 / d).sum(0).cpu().numpy())
    return np.stack(out).reshape(n, cfg.max_res_x, cfg.max_res_y)
