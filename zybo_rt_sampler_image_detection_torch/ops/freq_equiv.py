"""Exact frequency-domain reformulation of the time-domain beamformers.

Per direction d and mic m the time-domain tables hold a short FIR
``W[d, :, m]`` at integer shifts (:class:`.beamform.SteeringTables`).  With
the per-(d, m) frequency response

    H[d, m, f] = sum_t W[d, t, m] * exp(-j w_f (tau_min + t))

the steered spectrum is ``B[d, f] = sum_m H[d, m, f] S[m, f]`` — a
(D, M) x (M, F) contraction per bin, ~15x fewer MACs than the time-domain
product at the reference shape.  Three terms make the power EXACTLY the C
output (``pad_and_sum.c:114-142``), not an approximation:

* the DFT runs on a zero-padded window L = N + T (+ the negative spill) so
  circular = linear convolution;
* Parseval gives the power over all L outputs; the power of the **tail**
  samples n in [N, L) (a small inverse-DFT matmul) is subtracted;
* the boundary corrections of the time path enter as
  ``||beam - v||^2 = ||beam||^2 - 2<beam, v> + ||v||^2`` over the first Tc
  head samples.

Ported from ``zybo_rt_sampler_image_detection_tpu/ops/freq_equiv.py``.  The
TPU has no complex dtype, so the JAX package keeps real/imag planes and a
DFT-by-matmul; here the response is one complex64 tensor and the spectra
come from ``torch.fft.rfft(s, n=L)``, which is exactly that contraction.
The real planes survive only where the fused kernel's layout wants them
(:mod:`.equiv_kernel`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .beamform import SteeringTables, set_fp32_matmul


@dataclasses.dataclass(frozen=True)
class EquivFreqTables:
    """Frequency response + inverse-DFT bases for the exact power."""

    H: torch.Tensor             # (D, M, F) complex64 frequency response
    ib_re: torch.Tensor         # (F, Ttail[+Tc]) inverse-DFT basis for the
    ib_im: torch.Tensor         #   tail samples n in [N, L) and (with
                                #   boundary corrections) heads n in [0, Tc)
    cf: torch.Tensor            # (F,) Parseval weights (c_f / L)
    Wc: Optional[torch.Tensor]  # (J, D, Tc, M) boundary-correction weights
    adaptive: torch.Tensor      # (M,) int64
    corr_js: tuple
    n_tail: int
    precision: str
    n_samples: int
    L: int
    res_x: int
    res_y: int

    @property
    def n_mics(self) -> int:
        return self.H.shape[1]

    @property
    def n_bins(self) -> int:
        return self.H.shape[2]


def equiv_dims(t: SteeringTables) -> tuple:
    """``(L, F)`` — the padded-window length and rfft bin count
    :func:`make_equiv_tables` uses.  The pipeline's selection bars predict
    table sizes from these, so they come from the same derivation."""
    D, T, M = t.W.shape
    # L covers every positive shift's spill AND wraps negative shifts'
    # spill into the same tail window without collision
    L = t.n_samples + T + max(0, -t.tau_min) + 1
    return L, L // 2 + 1


def _build_H(W: torch.Tensor, tau_min: int, L: int) -> torch.Tensor:
    """(D, T, M) taps -> (D, M, F) complex64 response over the L-window,
    summed in float64 on the tables' device and rounded once."""
    D, T, M = W.shape
    F = L // 2 + 1
    w = 2.0 * np.pi * np.arange(F) / L
    t = tau_min + np.arange(T)
    ang = torch.as_tensor(-np.outer(t, w), device=W.device)        # (T, F)
    Wd = W.to(torch.float64)
    H_re = torch.einsum("dtm,tf->dmf", Wd, torch.cos(ang))
    H_im = torch.einsum("dtm,tf->dmf", Wd, torch.sin(ang))
    return torch.complex(H_re.float(), H_im.float())


def make_equiv_tables(t: SteeringTables) -> EquivFreqTables:
    """Build the exact frequency-domain twin of time-domain tables."""
    N = t.n_samples
    L, F = equiv_dims(t)
    f = np.arange(F)
    w = 2.0 * np.pi * f / L
    cf = np.where((f == 0) | ((L % 2 == 0) & (f == L // 2)), 1.0, 2.0) / L

    def inv_basis(positions):
        # x[n] = sum_f c_f (re cos(wn) - im sin(wn)) for rfft halves
        iang = np.outer(w, positions)                               # (F, P)
        ire = (cf[:, None] * np.cos(iang)).astype(np.float32)
        iim = (-cf[:, None] * np.sin(iang)).astype(np.float32)
        return ire, iim

    # fused inverse-DFT basis: tail columns first, then (if boundary
    # corrections exist) the head columns — one matmul pair at runtime
    tail_pos = np.arange(N, L)
    if t.Wc is not None:
        Tc = t.Wc.shape[2]
        ib_re, ib_im = inv_basis(np.concatenate([tail_pos, np.arange(Tc)]))
        Wc = t.Wc.float()
    else:
        ib_re, ib_im = inv_basis(tail_pos)
        Wc = None
    dev = t.device
    return EquivFreqTables(
        H=_build_H(t.W, t.tau_min, L),
        ib_re=torch.as_tensor(ib_re, device=dev),
        ib_im=torch.as_tensor(ib_im, device=dev),
        cf=torch.as_tensor(cf, dtype=torch.float32, device=dev), Wc=Wc,
        adaptive=t.adaptive, corr_js=t.corr_js, n_tail=len(tail_pos),
        precision=t.precision, n_samples=N, L=L, res_x=t.res_x,
        res_y=t.res_y)


def equiv_power_flat(signals: torch.Tensor,
                     t: EquivFreqTables) -> torch.Tensor:
    """Un-reshaped steered power, (B, D), at FP32 (complex64)."""
    set_fp32_matmul()
    M = t.n_mics
    N = t.n_samples
    s = signals[:, t.adaptive, :].float()                           # (B, M, N)
    S = torch.fft.rfft(s, n=t.L)                                    # (B, M, F)
    # steered spectra B[b, d, f] = sum_m H[d, m, f] S[b, m, f]
    Bc = torch.einsum("dmf,bmf->bdf", t.H, S)
    Br, Bi = Bc.real, Bc.imag
    # Parseval: sum_{n<L} beam^2 = sum_f c_f |B_f|^2
    total = (Br * Br + Bi * Bi) @ t.cf
    # tail samples the C output never had + (if corrections) head samples
    TH = Br @ t.ib_re + Bi @ t.ib_im                                # (B, D, Tt)
    tail = TH[:, :, :t.n_tail]
    total = total - torch.sum(tail * tail, dim=-1)
    if t.Wc is not None:
        # boundary corrections: ||beam - v||^2 over the first Tc columns
        head = TH[:, :, t.n_tail:]
        sj = torch.stack([s[:, :, j] for j in t.corr_js], dim=1)   # (B, J, M)
        v = torch.einsum("jdtm,bjm->bdt", t.Wc, sj)
        total = total + torch.sum(v * v - 2.0 * head * v, dim=-1)
    return total * (1.0 / (N * M * M))


def equiv_steered_power(signals, t: EquivFreqTables) -> torch.Tensor:
    """EXACT time-domain-equivalent steered power, (B, X, Y) or (X, Y):
    matches ``beamform.steered_power`` to f32 reassociation tolerance."""
    signals = torch.as_tensor(signals, device=t.H.device)
    squeeze = signals.ndim == 2
    if squeeze:
        signals = signals[None]
    power = equiv_power_flat(signals, t).reshape(-1, t.res_x, t.res_y)
    return power[0] if squeeze else power
