"""Frequency-domain beamformers: phase-shift (Bartlett) and MVDR (Capon).

The phase-shift path reproduces the reference web app's third backend
(``PC/application/realtime_scripts/beam_forming_algorithm.py:30-70``):
rfft each mic, keep a frequency band, multiply by the precomputed steering
tensor, and sum ``|sum_mics|^2`` over frequencies.

MVDR is the adaptive extension named in the project north star: streaming
per-bin spatial covariance (EMA), trace-scaled diagonal loading, Capon
spectrum ``P(d) = 1 / (a^H R^{-1} a)``, and a distortionless
single-direction beam returned to the time domain by a band-limited
inverse rfft.  The real-time form keeps the INVERSE covariance and
updates it by Sherman-Morrison / Woodbury steps, with an exact Cholesky
refresh at an alpha-aware cadence (:func:`refresh_interval`).

Ported from ``zybo_rt_sampler_image_detection_tpu/ops/freq.py``.  The TPU
has no complex dtype, so the JAX package carries (re, im) planes, runs
the rfft as a DFT-by-matmul and inverts through unrolled real embeddings;
here every quantity is one complex tensor (complex64 for float32 frames,
complex128 for float64 frames), the transforms are ``torch.fft.rfft`` /
``irfft``, and the factorizations are batched ``torch.linalg.cholesky_ex``.
The Bartlett contraction of float32 frames on the card at the
``highest`` and ``high`` rungs is one hand-written kernel
(:mod:`.bartlett_kernel`, after cuFFT's rfft); everything else here is
batched complex matmuls, FFTs and Cholesky factorizations, and the scans
of the JAX package are Python loops over those ops.

Steering: the Bartlett sum is ``sum_m S_m P_m`` with ``P = phase``, so the
Capon steering vector is ``a = conj(phase)``.

Precision: every matmul and the Bartlett kernel run at true FP32 (TF32
off, :func:`.beamform.set_fp32_matmul`) or in complex128, except with
tables made at the ``default`` rung (:attr:`FreqTables.precision`, from
``Config.matmul_precision``): there the Bartlett contraction takes bf16
operands, and the MVDR functions let cuBLAS take TF32 operands in their
complex products (:func:`_products`).  The ``grid_precision`` argument
of the grid evaluations keeps the JAX signature; its three rungs
("highest", "high", "default") all run at FP32, which lies inside each
rung's error class.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..utils.profiling import annotate
from . import bartlett_kernel, geometry
from .beamform import resolve_device, set_fp32_matmul

_GRID_PRECISIONS = ("highest", "high", "default")
CHUNK = 16          # frames per chunk of the subspace recursion


@dataclasses.dataclass(frozen=True)
class FreqTables:
    """Steering tensor for the selected rfft band ``[lo, hi)``."""

    phase: torch.Tensor         # (F, M, D) complex64
    adaptive: torch.Tensor      # (M,) int64 — active mics in the channel axis
    lo: int
    hi: int
    res_x: int
    res_y: int
    n_samples: int
    # (F,) int64 rfft bins of the F steering rows, set only on tables laid
    # out for a mesh (``parallel.mesh.shard_freq_tables``), whose padded
    # rows repeat the last bin; None: the bins ``[lo, hi)``
    bins: Optional[torch.Tensor] = None
    # the Bartlett contraction's rung (``Config.matmul_precision``):
    # "highest" and "high" contract in complex64 at true FP32, "default"
    # with bf16 operands (:func:`fft_steered_power`)
    precision: str = "highest"

    @property
    def device(self) -> torch.device:
        return self.phase.device

    @property
    def n_mics(self) -> int:
        return self.phase.shape[1]

    @functools.cached_property
    def phase_tiles(self) -> torch.Tensor:
        """(NC, F, M, DC) complex64 ``phase`` in the Bartlett kernel's
        tile order, zero past D (:func:`.bartlett_kernel.make_phase_tiles`).
        Made with the card's tables at the ``highest`` and ``high`` rungs
        (:func:`make_freq_tables`), else at the first kernel call."""
        return bartlett_kernel.make_phase_tiles(self.phase)

    @functools.cached_property
    def kernel_indices(self) -> tuple:
        """The Bartlett kernel's ``(adaptive, bins, extent)``: int32
        channel rows and rfft bins of the steering rows, and the frame
        rows and rfft bins they reach, ``(adaptive.max() + 1, bins.max() +
        1)``."""
        bins = (torch.arange(self.lo, self.hi, device=self.device)
                if self.bins is None else self.bins)
        return (self.adaptive.to(torch.int32).contiguous(),
                bins.to(torch.int32).contiguous(),
                (int(self.adaptive.max()) + 1, int(bins.max()) + 1))

    @functools.cached_property
    def phase_bf16(self) -> torch.Tensor:
        """(F, 2M, 2D) bf16 real form of ``phase``, ``[[Pr, Pi], [-Pi,
        Pr]]``: ``[Sr | Si] @ phase_bf16`` is ``[Yr | Yi]``.  Made at the
        first ``default``-rung contraction."""
        pr, pi = self.phase.real, self.phase.imag
        return torch.cat([torch.cat([pr, pi], dim=2),
                          torch.cat([-pi, pr], dim=2)], dim=1).to(
                              torch.bfloat16)

    @classmethod
    def from_numpy(cls, phase_re, phase_im, adaptive, *, lo, hi, res_x,
                   res_y, n_samples, device="cuda") -> "FreqTables":
        """Tables from NumPy planes, e.g. the JAX package's ``phase_re`` /
        ``phase_im`` (``np.asarray`` of each), so both packages compute on
        identical steering.  On the card unless ``device="cpu"``."""
        dev = resolve_device(device)
        phase = torch.complex(
            torch.from_numpy(np.array(phase_re, np.float32)),
            torch.from_numpy(np.array(phase_im, np.float32)))
        return cls(phase=phase.to(dev),
                   adaptive=torch.from_numpy(
                       np.array(adaptive, np.int64)).to(dev),
                   lo=int(lo), hi=int(hi), res_x=int(res_x),
                   res_y=int(res_y), n_samples=int(n_samples))


def make_freq_tables(cfg: Config, freq_low: Optional[float] = None,
                     freq_high: Optional[float] = None,
                     device="cuda") -> FreqTables:
    """Band limits default to the config's ``freq_band_low/high``
    (``realtime_scripts/config.py:47-48`` threshold_freq_lower/upper);
    the mic model follows ``cfg.fft_mic_model``, the contraction's rung
    ``cfg.matmul_precision``.  On the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    if freq_low is None:
        freq_low = cfg.freq_band_low
    if freq_high is None and cfg.freq_band_high > 0:
        freq_high = cfg.freq_band_high
    phase, (lo, hi) = geometry.phase_shift_tensor(cfg, freq_low, freq_high)
    F, M, X, Y = phase.shape
    # the channel gather must use the SAME mic selection the phase tensor
    # was built over (the fft model spans active_arrays boards, the main
    # model spans array_slots — they differ off the shipped profiles)
    if cfg.fft_mic_model == "fft":
        active, _ = geometry.active_microphones_fft(cfg)
    else:
        active, _ = geometry.active_microphones(cfg)
    assert len(active) == M, (len(active), M)
    t = FreqTables(
        phase=torch.from_numpy(phase.reshape(F, M, X * Y)).to(dev),
        adaptive=torch.from_numpy(np.asarray(active, np.int64)).to(dev),
        lo=lo, hi=hi, res_x=X, res_y=Y, n_samples=cfg.n_samples,
        precision=cfg.matmul_precision)
    if takes_bartlett_kernel(torch.float32, dev, t.precision):
        t.phase_tiles, t.kernel_indices     # built with the tables
    return t


def _signals(signals, t: FreqTables) -> torch.Tensor:
    """Frames on the tables' device, float64 kept, anything else float32."""
    s = torch.as_tensor(signals, device=t.device)
    return s if s.dtype == torch.float64 else s.float()


def _phase(t: FreqTables, dtype: torch.dtype) -> torch.Tensor:
    """The steering tensor in the computation's complex dtype."""
    return t.phase if t.phase.dtype == dtype else t.phase.to(dtype)


def _frame_fft(signals: torch.Tensor, t: FreqTables) -> torch.Tensor:
    """(B, channels, N) -> band-limited spectra (B, F, M): the rfft of the
    active mics, bins ``[lo, hi)`` (angle -2 pi n f / N, the JAX package's
    DFT bases)."""
    s = signals[:, t.adaptive, :]
    spec = torch.fft.rfft(s, dim=-1)
    spec = (spec[..., t.lo:t.hi] if t.bins is None
            else spec.index_select(-1, t.bins))
    return spec.transpose(1, 2)


def _check_grid(grid_precision: str) -> None:
    if grid_precision not in _GRID_PRECISIONS:
        raise ValueError(f"unknown grid_precision {grid_precision!r}")


def _band_spectra(signals, t: FreqTables):
    """(band spectra (F, B, M) contiguous, squeeze) of (M, N) frames or
    (B, M, N) batches."""
    signals = _signals(signals, t)
    squeeze = signals.ndim == 2
    if squeeze:
        signals = signals[None]
    return _frame_fft(signals, t).transpose(0, 1).contiguous(), squeeze


def _steered_spectra(signals, t: FreqTables):
    """(steered spectra (F, B, D), squeeze): ``sum_m S[f, m] P[f, m, d]``
    as one batched complex matmul."""
    set_fp32_matmul()
    S, squeeze = _band_spectra(signals, t)                      # (F, B, M)
    return torch.matmul(S, _phase(t, S.dtype)), squeeze


def _per_bin_power_bf16(S: torch.Tensor, t: FreqTables) -> torch.Tensor:
    """``|sum_m S P|^2`` (F, B, D) float32 with bf16 operands: one real
    batched product of ``[Sr | Si]`` by :attr:`FreqTables.phase_bf16`."""
    Sb = torch.cat([S.real, S.imag], dim=-1).to(torch.bfloat16)
    Y = torch.matmul(Sb, t.phase_bf16).float()                  # (F, B, 2D)
    D = Y.shape[-1] // 2
    return Y[..., :D].square() + Y[..., D:].square()


def takes_bartlett_kernel(dtype: torch.dtype, device, precision: str
                          ) -> bool:
    """Whether the Bartlett contraction runs the hand-written kernel:
    float32 frames on the card at the ``highest`` or ``high`` rung.  CPU
    tensors run the eager code, float64 frames contract in complex128,
    and the ``default`` rung keeps its bf16 operands."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and precision in ("highest", "high"))


def fft_steered_power(signals, t: FreqTables,
                      bin_weights: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Bartlett steered power (B, X, Y): ``sum_f |sum_m S[f,m] P[f,m,d]|^2``.

    Matches ``beam_forming_algorithm.main`` before its normalize/threshold
    step (display logic; see :func:`normalize_heatmap`).

    ``bin_weights`` (F,) scales each bin's contribution to the sum (the
    JAX package's sharded path masks the bins that pad F with it).

    Float32 frames on the card at the ``highest`` and ``high`` rungs take
    cuFFT's rfft and the Bartlett kernel (:func:`takes_bartlett_kernel`,
    :func:`.bartlett_kernel.bartlett_power`), which reads the rfft
    through the channel rows and bins; elsewhere float32 frames contract
    in complex64 at true FP32, or with bf16 operands where
    ``t.precision`` is ``"default"``, and float64 frames in complex128.
    Spans: ``power.fft_spectra`` (the rfft; on the eager routes also the
    channel gather and the band) and ``power.fft_contract`` (the
    contraction, ``|.|^2`` and the sum over bins);
    ``fft_steered_power.launches`` counts the calls.
    """
    fft_steered_power.launches += 1
    signals = _signals(signals, t)
    if takes_bartlett_kernel(signals.dtype, signals.device, t.precision):
        return _kernel_steered_power(signals, t, bin_weights)
    set_fp32_matmul()
    with annotate("power.fft_spectra"):
        S, squeeze = _band_spectra(signals, t)                  # (F, B, M)
    with annotate("power.fft_contract"):
        if t.precision == "default" and S.dtype == torch.complex64:
            per_bin = _per_bin_power_bf16(S, t)
        else:
            Y = torch.matmul(S, _phase(t, S.dtype))             # (F, B, D)
            per_bin = Y.real.square() + Y.imag.square()
        if bin_weights is not None:
            per_bin = per_bin * torch.as_tensor(
                bin_weights, device=t.device,
                dtype=per_bin.dtype)[:, None, None]
        power = per_bin.sum(dim=0).reshape(-1, t.res_x, t.res_y)
    return power[0] if squeeze else power


fft_steered_power.launches = 0


def _kernel_steered_power(signals: torch.Tensor, t: FreqTables,
                          bin_weights) -> torch.Tensor:
    """:func:`fft_steered_power` through the Bartlett kernel: the rfft of
    the whole batch, read by the kernel through the channel rows and the
    bins (no gathered or band-sliced copy).  Frames must be
    ``t.n_samples`` long: the bins are those of that length."""
    if signals.shape[-1] != t.n_samples:
        raise ValueError(f"frames of {signals.shape[-1]} samples; the "
                         f"tables are for {t.n_samples}")
    squeeze = signals.ndim == 2
    with annotate("power.fft_spectra"):
        spec = torch.fft.rfft(signals[None] if squeeze else signals, dim=-1)
    with annotate("power.fft_contract"):
        adaptive, bins, extent = t.kernel_indices
        w = (None if bin_weights is None else torch.as_tensor(
            bin_weights, device=t.device, dtype=torch.float32).contiguous())
        power = bartlett_kernel.bartlett_power(
            spec, t.phase_tiles, adaptive, bins, w, D=t.res_x * t.res_y,
            extent=extent).reshape(-1, t.res_x, t.res_y)
    return power[0] if squeeze else power


def normalize_heatmap(power, threshold: float = 0.2) -> torch.Tensor:
    """The reference's display normalization (``beam_forming_algorithm.py:
    57-63``): zero the map unless its max exceeds ``threshold``, else divide
    by the max."""
    power = torch.as_tensor(power)
    mx = power.max()
    return torch.where(mx < threshold, torch.zeros_like(power), power / mx)


def fft_power_spectrum(signals, t: FreqTables) -> torch.Tensor:
    """Per-frequency-bin steered power (B, F, X, Y) — the ``FFT_power``
    intermediate of ``beam_forming_algorithm.main`` (line 53) before the
    sum over frequencies; input to :func:`peak_detection`."""
    Y, squeeze = _steered_spectra(signals, t)                   # (F, B, D)
    power = (Y.real.square() + Y.imag.square()).transpose(0, 1)
    power = power.reshape(power.shape[0], -1, t.res_x, t.res_y)
    return power[0] if squeeze else power


def peak_detection(power_f, t: FreqTables, threshold_upper: float = 0.8,
                   threshold_lower: float = 0.1) -> torch.Tensor:
    """Per-frequency-bin peak map (X, Y) — ``beam_forming_algorithm.py:
    37-48`` (present upstream but disabled in its ``main()``).

    For every bin whose grid maximum exceeds both ``threshold_upper *
    global_max`` and ``threshold_lower``, the bin's peak value is written at
    its argmax cell, keeping the largest across bins.  Reference quirk kept:
    the function slices ``power_in[threshold_freq_lower_idx:]`` even though
    its input already starts at that band index (line 39) — a double cut
    whenever the lower band edge is above bin 0.
    """
    power = torch.as_tensor(power_f)[t.lo:]      # the double-slice quirk
    flat = power.reshape(power.shape[0], -1)     # (F, X*Y)
    pmax = flat.max(dim=1).values
    amax = flat.argmax(dim=1)                    # first occurrence, like C
    qual = (pmax > threshold_upper * pmax.max()) & (pmax > threshold_lower)
    contrib = torch.where(qual, pmax, torch.zeros_like(pmax))
    heat = torch.zeros(flat.shape[1], dtype=flat.dtype, device=flat.device)
    heat = heat.scatter_reduce(0, amax, contrib, reduce="amax")
    return heat.reshape(t.res_x, t.res_y)


# ---------------------------------------------------------------------------
# MVDR (Capon)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _products(t: FreqTables):
    """The rung of the MVDR functions' products, from ``t.precision``:
    true FP32 at ``highest`` and ``high`` (:func:`.beamform.
    set_fp32_matmul`, left set, as everywhere in the port); at
    ``default`` cuBLAS may take TF32 operands (``allow_tf32``) for the
    block, and the process's setting is restored after it.  The flag is
    the process's: a product another thread runs meanwhile takes the
    same rung.  Complex128 products and CPU tensors have no TF32."""
    if t.precision != "default":
        set_fp32_matmul()
        yield
        return
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        yield
    finally:
        matmul.allow_tf32 = before


@dataclasses.dataclass(frozen=True)
class CovarianceState:
    """Streaming per-bin spatial covariance R[f] (EMA over frames)."""

    R: torch.Tensor             # (F, M, M) complex, Hermitian
    count: int                  # update steps absorbed (a host int)


def init_covariance(t: FreqTables,
                    dtype: torch.dtype = torch.complex64) -> CovarianceState:
    F = t.hi - t.lo
    eye = torch.eye(t.n_mics, dtype=dtype, device=t.device)
    return CovarianceState(R=eye.expand(F, -1, -1).clone(), count=0)


def _snapshots(S: torch.Tensor) -> torch.Tensor:
    """Snapshots (B, F, M) as contiguous per-bin matrices (F, M, B): a
    batched product of strided complex operands takes a per-matrix path
    (on the CPU 300x slower at the tests' shapes)."""
    return S.permute(1, 2, 0).contiguous()


def _outer_sum(C: torch.Tensor) -> torch.Tensor:
    """``sum_b C[b, f, m] conj(C[b, f, n])`` (F, M, M) of snapshots (B, F, M)."""
    Cm = _snapshots(C)
    return torch.matmul(Cm, Cm.mH)


def update_covariance(state: CovarianceState, signals, t: FreqTables,
                      alpha: float = 0.9) -> CovarianceState:
    """EMA update ``R <- alpha R + (1-alpha) mean_b(S S^H)`` per bin; the
    first update replaces the initial identity."""
    with _products(t):
        signals = _signals(signals, t)
        if signals.ndim == 2:
            signals = signals[None]
        S = _frame_fft(signals, t)                                  # (B, F, M)
        o = _outer_sum(S) / S.shape[0]
        R = o if state.count == 0 else \
            alpha * state.R.to(o.dtype) + (1 - alpha) * o
        return CovarianceState(R=R, count=state.count + 1)


def _loaded(state: CovarianceState, diagonal_loading: float) -> torch.Tensor:
    """``R + (load * tr(R)/M + 1e-12) I`` per bin."""
    M = state.R.shape[-1]
    tr = state.R.diagonal(dim1=-2, dim2=-1).real.sum(-1) / M
    load = diagonal_loading * tr + 1e-12
    eye = torch.eye(M, dtype=state.R.dtype, device=state.R.device)
    return state.R + load[:, None, None] * eye


def _solve_hermitian(R: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the batched Hermitian-PD systems ``R x = b`` (R (F, M, M), b
    (F, M, K)) by Cholesky of ``(R + R^H) / 2``, as ``jnp.linalg.cholesky``
    symmetrizes its input: a matrix made by products, like the Woodbury
    matrices ``U^H P U``, is Hermitian only up to rounding, and a
    factorization that reads one triangle of it carries that error on (on
    the 320-frame drift stream of the tests, the streaming maps drifted
    0.067 against 0.014 worst-direction at the end of the first carried
    ``d``).  ``cholesky_ex`` does not raise on a matrix that is not
    positive definite (its ``info`` says so and the factor holds NaN, as
    the JAX package's factorization yields NaN); reading ``info`` would
    sync the host, so the hot path does not."""
    L, _ = torch.linalg.cholesky_ex(0.5 * (R + R.mH))
    return torch.cholesky_solve(b, L)


def invert_hermitian(R: torch.Tensor) -> torch.Tensor:
    """Invert batched Hermitian-PD ``R`` (F, M, M): Cholesky, then the
    inverse from the factor: LAPACK's ``potri`` on the CPU, and on the
    card :func:`_inverse_from_factor`.  Takes the place of the JAX
    package's real-embedding inversion and its unrolled complex potri,
    which exist because the TPU has no complex dtype and a serial-loop
    Cholesky.  No Hermitian re-projection of the result, as in the JAX
    package: the factorization's structure errors cancel in ``R @ P``."""
    L, _ = torch.linalg.cholesky_ex(R)
    if L.device.type == "cuda":
        return _inverse_from_factor(L)
    return torch.cholesky_inverse(L)


def _inverse_from_factor(L: torch.Tensor) -> torch.Tensor:
    """``(L L^H)^-1 = G^H G`` with ``G = L^-1``: one batched triangular
    solve against the identity and one batched product (cuBLAS).  On the
    card ``torch.cholesky_inverse`` of a batch takes MAGMA's batched
    potrs, which allocates and frees device memory and waits on the
    device at every call, and whose kernels ran 20-35% slower in some
    processes than in others at 127 bins of 192 mics: 2.9-15 ms a call
    against 0.51 ms here, to the same error against complex128 (1.2e-6
    to 1.6e-6 of the scale, H100)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    G = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.matmul(G.mH, G)


def _quad_form(P: torch.Tensor, t: FreqTables) -> torch.Tensor:
    """``d = Re(a^H P a)`` (F, D) for every direction, ``a = conj(phase)``.

    With ``a = conj(ph)``, ``a^H P a = ph^T P conj(ph)``, which is real for
    Hermitian P, so it equals its conjugate ``ph^H conj(P) ph``: one
    batched (F, M, M) x (F, M, D) complex matmul against the stored
    steering tensor, and no conjugated copy of it."""
    ph = _phase(t, P.dtype)
    return torch.linalg.vecdot(ph, torch.matmul(P.conj(), ph), dim=1).real


def mvdr_power(state: CovarianceState, t: FreqTables,
               diagonal_loading: float = 1e-3,
               grid_precision: str = "highest") -> torch.Tensor:
    """Capon spectrum (X, Y): ``P(d) = sum_f 1 / (a_d^H R_f^{-1} a_d)``.

    The Bartlett path computes ``|sum_m P_m S_m|^2`` so its implied steering
    vector is ``a = conj(P)``.  Diagonal loading scales with tr(R)/M per
    bin — the standard robustifier for a streaming estimate.  Each bin's R
    is inverted once (O(M^3), small) and ``a^H R^{-1} a`` evaluated for
    every direction by one batched matmul, instead of a solve per
    direction.
    """
    _check_grid(grid_precision)
    with _products(t):
        P = invert_hermitian(_loaded(state, diagonal_loading))
        denom = _quad_form(P, t).clamp_min(1e-12)
        return (1.0 / denom).sum(dim=0).reshape(t.res_x, t.res_y)


# ---------------------------------------------------------------------------
# Real-time MVDR: streaming inverse covariance (RLS / Sherman-Morrison)
# ---------------------------------------------------------------------------
#
# The EMA update R <- alpha R + (1-alpha) s s^H is rank-1, so the INVERSE
# admits a closed-form Sherman-Morrison update costing O(F M^2) per frame —
# no per-frame Cholesky (O(F M^3)).  This is the classic RLS recursion with
# forgetting factor alpha; f32 drift is bounded by a periodic exact refresh
# (refresh_precision) from the co-tracked covariance.

@dataclasses.dataclass(frozen=True)
class PrecisionState:
    """Streaming inverse covariance P[f] ~= (R[f] + load*I)^-1, plus the
    covariance itself (used only for the periodic exact refresh)."""

    P: torch.Tensor             # (F, M, M) complex, Hermitian
    cov: CovarianceState
    load: float

    @classmethod
    def from_numpy(cls, P_re, P_im, R_re, R_im, count, load,
                   device="cuda") -> "PrecisionState":
        """A state from NumPy planes, e.g. a JAX ``PrecisionState``
        mid-stream (``np.asarray`` of ``P_re``, ``P_im``, ``cov.R_re``,
        ``cov.R_im``, ``int(cov.count)``, ``load``): complex128 for
        float64 planes, else complex64.  On the card unless
        ``device="cpu"``."""
        dev = resolve_device(device)

        def cplx(re, im):
            re, im = np.asarray(re), np.asarray(im)
            ft = np.float64 if re.dtype == np.float64 else np.float32
            return torch.complex(torch.from_numpy(np.array(re, ft)),
                                 torch.from_numpy(np.array(im, ft))).to(dev)

        return cls(P=cplx(P_re, P_im),
                   cov=CovarianceState(R=cplx(R_re, R_im), count=int(count)),
                   load=float(load))


def init_precision(t: FreqTables, load: float = 1e-3,
                   dtype: torch.dtype = torch.complex64) -> PrecisionState:
    cov = init_covariance(t, dtype)
    # cov starts at I (init_covariance), so P = (1+load)^-1 I
    return PrecisionState(P=cov.R / (1.0 + load), cov=cov, load=load)


def _weights(B: int, alpha: float, dtype: torch.dtype,
             device) -> torch.Tensor:
    """``sqrt((1-a) a^(B-1-i))``, i < B: frame i's column weight in the
    rank-B form of B sequential EMA steps, made on the device (a copy from
    the host would wait for the stream)."""
    i = torch.arange(B, dtype=torch.float64, device=device)
    return torch.sqrt((1.0 - alpha) * alpha ** (B - 1.0 - i)).to(dtype)


def _cov_rank_update(cov: CovarianceState, S: torch.Tensor,
                     alpha: float) -> CovarianceState:
    """Covariance after B sequential per-frame EMA steps, as ONE exact
    rank-B update: ``R_B = a^B R_0 + sum_i (1-a) a^{B-1-i} s_i s_i^H``
    (the sequential recursion's first-ever-frame REPLACEMENT gives the
    first column weight ``a^{B-1}`` and drops the prior).  Shared by
    :func:`update_precision` and :func:`update_precision_block` so the
    precision and its covariance co-estimate always track the SAME
    per-frame-discounted history, whatever the batch size.  S: (B, F, M)."""
    B = S.shape[0]
    w = _weights(B, alpha, S.real.dtype, S.device)
    keep = alpha ** B
    if cov.count == 0:
        w[0] = float(np.sqrt(alpha ** (B - 1)))
        keep = 0.0
    R = keep * cov.R.to(S.dtype) + _outer_sum(S * w[:, None, None])
    return CovarianceState(R=R, count=cov.count + B)


def update_precision(state: PrecisionState, signals, t: FreqTables,
                     alpha: float = 0.9) -> PrecisionState:
    """Per-frame Sherman-Morrison update of P (a loop over the batch):

    ``R_t = a R + (1-a) s s^H``  =>
    ``P_t = (1/a) [P - ((1-a)/a) (P s)(P s)^H / (1 + (1-a)/a s^H P s)]``

    ``s^H P s`` is real because P is Hermitian.  Cost: one matvec and one
    outer product per bin and frame.
    """
    with _products(t):
        signals = _signals(signals, t)
        if signals.ndim == 2:
            signals = signals[None]
        S = _frame_fft(signals, t)                                  # (B, F, M)
        beta = (1.0 - alpha) / alpha
        P = state.P.to(S.dtype)
        for s in S:                                                 # (F, M)
            u = torch.matmul(P, s[:, :, None])[..., 0]              # P s
            g = torch.linalg.vecdot(s, u).real                      # s^H P s
            scale = beta / (1.0 + beta * g)
            # P <- (P - scale u u^H) / alpha
            P = torch.baddbmm(P, (scale[:, None] * u)[:, :, None],
                              u.conj()[:, None, :], beta=1.0 / alpha,
                              alpha=-1.0 / alpha)
        # the co-tracked covariance uses the SAME per-frame discounting as the
        # precision loop (a batch-mean EMA step here would make the periodic
        # refresh snap P onto a different estimate for B > 1)
        return PrecisionState(P=P, cov=_cov_rank_update(state.cov, S, alpha),
                              load=state.load)


def update_precision_block(state: PrecisionState, signals, t: FreqTables,
                           alpha: float = 0.9) -> PrecisionState:
    """Exact rank-B (Woodbury) equivalent of looping
    :func:`update_precision` over a B-frame batch.

    The per-frame Sherman-Morrison recursion reads and writes the whole
    (F, M, M) state every frame.  B sequential rank-1 updates equal ONE
    rank-B update::

        R_B = a^B R_0 + U U^H,   U[f] = [sqrt((1-a) a^{B-1-i}) s_i]
        P_B = (P_0 - V (a^B I + U^H V)^{-1} V^H) / a^B,   V = P_0 U

    so the state streams once per B frames and the extra math is batched
    (F, M, B) / (F, B, B) products and one (F, B, B) Cholesky
    (:func:`_capacitance`).  It matches the loop up to f32 reassociation;
    the covariance co-estimate uses the same U (with the sequential
    recursion's first-ever-frame replacement reproduced exactly).
    """
    with _products(t):
        signals = _signals(signals, t)
        if signals.ndim == 2:
            signals = signals[None]
        S = _frame_fft(signals, t)
        P = state.P.to(S.dtype)
        Ps, c, L = _capacitance(P, S, alpha)
        return PrecisionState(P=_advance(P, Ps, c, L, alpha),
                              cov=_cov_rank_update(state.cov, S, alpha),
                              load=state.load)


def _capacitance(P: torch.Tensor, S: torch.Tensor, alpha: float):
    """The Woodbury form of B sequential EMA steps (S (B, F, M)) from P.

    After frames 0..t, ``R_t = alpha^(t+1) (R_0 + U_t U_t^H)`` with the
    columns ``U = [c_i s_i]``, ``c_i^2 = beta alpha^-i``, beta =
    (1-alpha)/alpha, so ``P_t = alpha^-(t+1) (P_0 - P_0 U_t C_t^-1 U_t^H
    P_0)`` where ``C = I + U^H P_0 U`` (F, B, B) and ``C_t`` is its
    leading (t+1)-square block.  The leading blocks of C's Cholesky
    factor L factor those blocks, so one factorization serves every t.
    C is factored as ``(C + C^H) / 2`` (see :func:`_solve_hermitian`).
    Returns ``Ps = P_0 S`` (F, M, B), c (B,) and L."""
    B = S.shape[0]
    Sm = _snapshots(S)                                          # (F, M, B)
    Ps = torch.matmul(P, Sm)
    i = torch.arange(B, dtype=torch.float64, device=S.device)
    c = torch.sqrt((1.0 - alpha) / alpha * alpha ** -i).to(S.real.dtype)
    C = torch.matmul(Sm.mH, Ps) * (c[:, None] * c[None, :])
    C = 0.5 * (C + C.mH)
    C.diagonal(dim1=-2, dim2=-1).add_(1.0)
    L, _ = torch.linalg.cholesky_ex(C)
    return Ps, c, L


def _advance(P: torch.Tensor, Ps: torch.Tensor, c: torch.Tensor,
             L: torch.Tensor, alpha: float) -> torch.Tensor:
    """P after all B frames of :func:`_capacitance`: ``alpha^-B (P_0 -
    G^H G)`` with ``G = L^-1 diag(c) Ps^H`` (F, B, M)."""
    aB = alpha ** c.shape[0]
    G = torch.linalg.solve_triangular(L, c[:, None] * Ps.mH, upper=False)
    return torch.baddbmm(P, G.mH, G, beta=1.0 / aB, alpha=-1.0 / aB)


def mvdr_d0(state: PrecisionState, t: FreqTables,
            grid_precision: str = "high") -> torch.Tensor:
    """The full Capon quadratic form ``d = a^H P a`` (F, D) — the
    expensive O(F M^2 D) evaluation :func:`mvdr_maps_scan` needs once
    per streaming epoch.  Callers that process consecutive blocks carry
    the returned ``d`` between calls (``d0=``/``return_d=``) and only
    re-evaluate here after :func:`refresh_precision`."""
    _check_grid(grid_precision)
    with _products(t):
        return _quad_form(state.P, t)


def mvdr_maps_scan(state: PrecisionState, signals, t: FreqTables,
                   alpha: float = 0.9, grid_precision: str = "high",
                   bin_weights: Optional[torch.Tensor] = None,
                   d0: Optional[torch.Tensor] = None,
                   return_d: bool = False):
    """EXACT per-frame Capon maps for a B-frame batch at about the cost of
    one.

    The sequential path (``update_precision`` + ``mvdr_power_precision``
    per frame) re-evaluates the full ``a^H P a`` quadratic form — an
    O(F M^2 D) product — after every rank-1 state update.  But the
    Sherman-Morrison steps only move P inside the span of the new
    snapshots, so every frame's denominator follows from one full form
    ``d_0 = a^H P_0 a`` and the B-snapshot SUBSPACE.  With the Woodbury
    form of :func:`_capacitance` (``C = I + diag(c) S^H P_0 S diag(c)`` =
    ``L L^H``) and ``z = diag(c) S^H P_0 a``, the state after frames 0..t
    gives::

        d_t(a) = (d_0(a) - z_{0..t}^H C_t^-1 z_{0..t}) / alpha^(t+1)
               = (d_0(a) - sum_{s<=t} |(L^-1 z)_s|^2) / alpha^(t+1)

    so the projections ``Y_0 = a^H P_0 S`` (F, D, B), one batched
    triangular solve and a running sum over s give every frame's map.
    This is the JAX package's coefficient recursion in closed form: its
    B rank-1 steps on the (F, B, B) snapshot Gram matrix are Gaussian
    elimination of C, unrolled because its backend's batched Cholesky
    had a serial floor; here C is factored once (``cholesky_ex``), and
    the recursion's alpha^-t growth of the coefficients does not arise.
    ``kappa_t alpha^t |m_t|^2`` of the recursion is ``|(L^-1 z)_t|^2``.

    Frames go in chunks of 16, as in the JAX package: every chunk's
    projections are measured from the REAL P, which then advances by the
    exact rank-16 Woodbury update (the same L), while ``d`` carries across
    chunks exactly (the chunk's last ``d_t`` is the next chunk's ``d_0``).

    STREAMING CALLERS: the final ``d`` is itself next block's ``d_0``.
    Pass ``return_d=True`` to get it back and feed it as ``d0=`` on the
    next call — the O(F M^2 D) quadratic form then runs only once per
    refresh epoch (:func:`mvdr_d0` after :func:`refresh_precision`;
    :func:`d0_carry_interval` bounds the carry depth).

    Returns ``(maps (B, X, Y), new_state)`` — frame t's map reflects the
    state AFTER absorbing frames 0..t, exactly like the sequential loop;
    ``new_state`` comes from composing the per-chunk Woodbury block
    updates (the same posterior).  With ``return_d=True`` the return is
    ``(maps, new_state, d)``.  Nothing is read back to the host.
    """
    _check_grid(grid_precision)
    with _products(t):
        signals = _signals(signals, t)
        if signals.ndim == 2:
            signals = signals[None]
        B = signals.shape[0]
        S = _frame_fft(signals, t)                                  # (B, F, M)
        ph = _phase(t, S.dtype)                                     # (F, M, D)
        if bin_weights is not None:
            bin_weights = torch.as_tensor(bin_weights, device=t.device,
                                          dtype=S.real.dtype)
        st = state
        # d_0 = a^H P_0 a (the one full quadratic form), unless carried in
        d = mvdr_d0(st, t, grid_precision) if d0 is None else d0
        maps = []
        for c0 in range(0, B, CHUNK):
            S_c = S[c0:c0 + CHUNK]
            P = st.P.to(S.dtype)
            Ps, c, L = _capacitance(P, S_c, alpha)
            # Y_0 = a^H P_0 S = ph^T Ps (F, D, Bc); z = diag(c) Y_0^H
            Y0 = torch.matmul(ph.transpose(1, 2), Ps)
            V = torch.linalg.solve_triangular(
                L, c[:, None] * Y0.mH, upper=False)             # (F, Bc, D)
            q = torch.cumsum(V.real.square() + V.imag.square(), dim=1)
            i = torch.arange(S_c.shape[0], dtype=S.real.dtype,
                             device=S.device)
            d_all = (d[:, None, :] - q) * (alpha ** -(i + 1.0))[:, None]
            per_bin = 1.0 / d_all.clamp_min(1e-12)              # (F, Bc, D)
            if bin_weights is not None:
                per_bin = per_bin * bin_weights[:, None, None]
            maps.append(per_bin.sum(dim=0))                         # (Bc, D)
            d = d_all[:, -1]
            st = PrecisionState(P=_advance(P, Ps, c, L, alpha),
                                cov=_cov_rank_update(st.cov, S_c, alpha),
                                load=st.load)
        maps = torch.cat(maps, dim=0).reshape(B, t.res_x, t.res_y)
        if return_d:
            return maps, st, d
        return maps, st


def refresh_interval(alpha: float = 0.9) -> int:
    """Max frames between :func:`refresh_precision` calls before f32
    recursion drift becomes visible.

    Every Sherman-Morrison / Woodbury step divides P by ``alpha``, so
    rounding error in directions the data does not strongly re-excite is
    AMPLIFIED by ``alpha^-1`` per frame: after T frames the drift is
    ~``eps * alpha^-T``.  Demanding that stay under ~1e-4 gives
    ``T <= log(1e-4 / eps) / log(1/alpha)`` — about 64 frames at the
    production ``alpha=0.9`` (f32 eps ~1.2e-7), not the few hundred a
    fixed cadence assumes: at alpha=0.9 a fixed 256-frame cadence lets the
    recursion overflow mid-run (NaN maps, or the 1e-12 denominator clamp's
    1e12-scale spikes), where this cadence keeps the maps at the drift
    gate of the tests indefinitely.
    """
    eps = 1.2e-7                      # f32 unit roundoff, one guard bit
    budget = float(np.log(1e-4 / eps))
    rate = max(float(np.log(1.0 / alpha)), 1e-9)
    return int(max(16, min(512, budget / rate)))


def d0_carry_interval(alpha: float = 0.9) -> int:
    """Max frames to carry :func:`mvdr_maps_scan`'s ``d`` between calls
    before re-measuring with :func:`mvdr_d0` — HALF the refresh
    interval.  The carried d's per-step correction errors amplify by
    ``alpha^-1`` per frame exactly like the state drift, but from a
    larger seed (the products' rounding) instead of eps, so it tolerates
    half the exponent budget."""
    return max(16, refresh_interval(alpha) // 2)


def refresh_precision(state: PrecisionState, t: FreqTables) -> PrecisionState:
    """Exact re-factorization of P from the co-tracked covariance — run
    every :func:`refresh_interval` frames to bound f32 recursion drift:
    F batched M x M complex Cholesky factorizations and their inverses
    (:func:`invert_hermitian`)."""
    with _products(t):
        P = invert_hermitian(_loaded(state.cov, state.load))
    return PrecisionState(P=P, cov=state.cov, load=state.load)


def mvdr_power_precision(state: PrecisionState, t: FreqTables,
                         grid_precision: str = "high",
                         bin_weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Capon spectrum (X, Y) directly from the streaming inverse —
    matmuls only, no factorization: the real-time MVDR map.

    ``bin_weights`` (F,) scales each bin's contribution."""
    per_bin = 1.0 / mvdr_d0(state, t, grid_precision).clamp_min(1e-12)
    if bin_weights is not None:
        per_bin = per_bin * torch.as_tensor(
            bin_weights, device=t.device, dtype=per_bin.dtype)[:, None]
    return per_bin.sum(dim=0).reshape(t.res_x, t.res_y)


def _apply_beam_weights(signals, t: FreqTables,
                        w: torch.Tensor) -> torch.Tensor:
    """Apply per-bin beam weights w (F, M) to frames (B, M_ch, N) and
    return the time-domain beam (B, N): ``beam_f = w^H S`` per bin, then
    the irfft of the spectrum that is zero outside ``[lo, hi)`` (the JAX
    package's band-limited inverse-DFT bases: c_f = 1 at DC and Nyquist,
    2 elsewhere, over N)."""
    if t.bins is not None:
        raise ValueError("beam weights need the band [lo, hi), not the "
                         "padded bins of tables laid out for a mesh")
    S = _frame_fft(signals, t)                                  # (B, F, M)
    spec = torch.zeros(S.shape[0], t.n_samples // 2 + 1, dtype=S.dtype,
                       device=S.device)
    spec[:, t.lo:t.hi] = torch.linalg.vecdot(w.to(S.dtype), S)
    return torch.fft.irfft(spec, n=t.n_samples)


def _steer(t: FreqTables, direction, dtype: torch.dtype) -> torch.Tensor:
    """The steering vectors ``a = conj(phase[:, :, d])`` (F, M) of one
    direction: an int, or a 0-d integer tensor indexed on the device (a
    steer needs no host sync)."""
    ph = _phase(t, dtype)
    if isinstance(direction, torch.Tensor):
        col = ph.index_select(2, direction.to(t.device).reshape(1))[..., 0]
    else:
        col = ph[:, :, int(direction)].contiguous()
    return col.conj()


def mvdr_beam(state: CovarianceState, t: FreqTables, signals, direction,
              diagonal_loading: float = 1e-3) -> torch.Tensor:
    """MVDR-weighted single-direction beam in the time domain (B, N):
    ``w_f = R^{-1} a / (a^H R^{-1} a)`` per bin, by a Cholesky solve."""
    with _products(t):
        signals = _signals(signals, t)
        squeeze = signals.ndim == 2
        if squeeze:
            signals = signals[None]
        R = _loaded(state, diagonal_loading)
        a = _steer(t, direction, R.dtype)
        x = _solve_hermitian(R, a[:, :, None])[..., 0]
        denom = torch.linalg.vecdot(a, x).real.clamp_min(1e-12)
        beam = _apply_beam_weights(signals, t, x / denom[:, None])
        return beam[0] if squeeze else beam


def mvdr_beam_precision(state: PrecisionState, t: FreqTables, signals,
                        direction) -> torch.Tensor:
    """Distortionless single-direction beam with weights straight from the
    streaming inverse: ``w = P a / (a^H P a)`` — matmuls only, no
    factorization.  This is the LIVE adaptive-listening path (the
    reference steers its delay-and-sum beam live via ``steer``,
    ``api.c:576-581``; the north star upgrades it to MVDR); the
    covariance-based :func:`mvdr_beam` is the offline/exact variant.

    ``direction``: a flat grid index, an int or a 0-d integer tensor.
    Returns (B, N) (or (N,) for a single frame).
    """
    with _products(t):
        signals = _signals(signals, t)
        squeeze = signals.ndim == 2
        if squeeze:
            signals = signals[None]
        ctype = torch.complex128 if signals.dtype == torch.float64 \
            else torch.complex64
        a = _steer(t, direction, ctype)
        x = torch.matmul(state.P.to(ctype), a[:, :, None])[..., 0]   # P a
        denom = torch.linalg.vecdot(a, x).real.clamp_min(1e-12)
        beam = _apply_beam_weights(signals, t, x / denom[:, None])
        return beam[0] if squeeze else beam


def mvdr_listen_step(state: PrecisionState, signals, t: FreqTables,
                     direction, alpha: float = 0.9):
    """One full-rate adaptive-listening step: absorb a B-frame batch into
    the streaming inverse (exact rank-B Woodbury,
    :func:`update_precision_block`), then beam EVERY frame of the batch
    with the refreshed MVDR weights.

    Returns ``(beams (B, N), new_state)``.  Weights refresh once per
    batch (B frames = B·N/fs seconds of signal — fast enough for the
    spatial statistics an acoustic scene evolves at).  Ref: the
    reference's whole point of MISO is *continuous* playback at line rate
    (``api.c:491-543``).
    """
    signals = _signals(signals, t)
    if signals.ndim == 2:
        signals = signals[None]
    new_state = update_precision_block(state, signals, t, alpha=alpha)
    return mvdr_beam_precision(new_state, t, signals, direction), new_state
