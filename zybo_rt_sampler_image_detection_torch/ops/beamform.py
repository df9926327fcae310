"""Time-domain beamformers in PyTorch: steering tables + exact steered power.

Every delay-and-sum variant of the reference (pad / lerp / convolve /
hybrid / truncated) writes, for direction *d* and mic *m*, a few tap
weights at integer output shifts.  Grouping the shifts into delay lines
``Sdel[t, m, n] = s[m, n - (tau_min + t)]`` turns the whole family into one
dense contraction::

    beams = W(D, T*M) @ Sdel(T*M, B*N)

plus exact boundary corrections on the first few output columns (the C
loops cut a handful of products involving ``s[m, 0..2]``).  This module is
the ground truth of the port: :func:`steered_power` runs that product
with ``torch.matmul`` at true FP32 (TF32 off) or in float64 for the
oracle gates, and the fused kernel in :mod:`.equiv_kernel` is tested
against it.  The MISO path (:func:`miso_beam`, :func:`miso_beams_multi`)
beams toward single directions with the same tables.

Ported from ``zybo_rt_sampler_image_detection_tpu/ops/beamform.py``: the
table builders are the same NumPy code (byte-identical tables), the
runtime half is plain torch.  Reference parity: ``pad_and_sum.c``,
``lerp_and_sum.c``, ``convolve_and_sum.c``, ``hybrid_convolve_and_sum.c``,
driven as in ``PC/src/benchmark.pyx:74-196``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from . import geometry

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def set_fp32_matmul() -> None:
    """Pin float32 matmuls and convolutions to true FP32 (TF32 off).

    The torch twin of passing ``precision=HIGHEST`` to every JAX dot: on
    the card cuBLAS may otherwise round float32 operands to TF32 (~1e-3)
    and cuDNN does so by default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; asking for CUDA without a GPU
    raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available()"
            f" is False; pass device='cpu' to run the plain torch path")
    return dev


# ---------------------------------------------------------------------------
# Steering tables (device-resident, built once per config+algorithm)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SteeringTables:
    """Dense delay-line weights + correction scatter for one algorithm."""

    # (D, T, M) — tap weight for direction d, shift tau_min+t, mic m.
    W: torch.Tensor
    # (J, D, Tc, M) float32 — boundary-correction weights: correction group
    # j multiplies s[m, corr_js[j]] and subtracts at output column t < Tc.
    Wc: Optional[torch.Tensor]
    # (M,) int64 — active mic indices into the full channel axis.
    adaptive: torch.Tensor
    tau_min: int
    corr_js: Tuple[int, ...]
    precision: str
    n_samples: int
    res_x: int
    res_y: int
    algorithm: str

    @property
    def n_mics(self) -> int:
        return self.W.shape[2]

    @property
    def n_taps_line(self) -> int:
        return self.W.shape[1]

    @property
    def n_directions(self) -> int:
        return self.W.shape[0]

    @property
    def device(self) -> torch.device:
        return self.W.device

    @classmethod
    def from_numpy(cls, W, Wc, adaptive, *, tau_min, corr_js, precision,
                   n_samples, res_x, res_y, algorithm,
                   device="cuda") -> "SteeringTables":
        """Tables from NumPy arrays — e.g. the JAX package's own tables
        (``np.asarray`` of each field), so both packages compute on
        identical weights.  On the card unless ``device="cpu"``."""
        dev = resolve_device(device)
        W = np.asarray(W)
        if W.dtype.kind == "V" or W.dtype.name == "bfloat16":
            # ml_dtypes bf16 arrives as a NumPy extension dtype; bf16 ->
            # f32 is exact, and the tensor is re-rounded to bf16 below
            Wt = torch.from_numpy(W.astype(np.float32)).to(torch.bfloat16)
        else:
            Wt = torch.from_numpy(np.array(W))   # own, writable copy
        return cls(
            W=Wt.to(dev),
            Wc=None if Wc is None else torch.from_numpy(
                np.array(Wc, np.float32)).to(dev),
            adaptive=torch.from_numpy(np.array(adaptive, np.int64)).to(dev),
            tau_min=int(tau_min), corr_js=tuple(int(j) for j in corr_js),
            precision=precision, n_samples=int(n_samples),
            res_x=int(res_x), res_y=int(res_y), algorithm=algorithm)


def _scatter_w(delays_shift: np.ndarray, weights: np.ndarray,
               tau_min: int, T: int) -> np.ndarray:
    """Scatter per-(d, m, k) weights at integer shifts into dense (D, T, M)."""
    D, M, K = delays_shift.shape
    W = np.zeros((D, T, M), dtype=np.float32)
    d_idx = np.repeat(np.arange(D), M * K)
    m_idx = np.tile(np.repeat(np.arange(M), K), D)
    t_idx = (delays_shift - tau_min).reshape(-1)
    np.add.at(W, (d_idx, t_idx, m_idx), weights.reshape(-1).astype(np.float32))
    return W


def _tables(cfg: Config, W: np.ndarray, algorithm: str, tau_min: int,
            Wc: Optional[np.ndarray] = None,
            corr_js: Tuple[int, ...] = (), device="cuda") -> SteeringTables:
    active, _ = geometry.active_microphones(cfg)
    dev = resolve_device(device)
    return SteeringTables(
        W=torch.from_numpy(W).to(dev, _DTYPES[cfg.matmul_dtype]),
        Wc=None if Wc is None else torch.from_numpy(
            np.asarray(Wc, np.float32)).to(dev),
        adaptive=torch.as_tensor(np.asarray(active, np.int64), device=dev),
        tau_min=int(tau_min),
        corr_js=tuple(corr_js),
        precision=cfg.matmul_precision,
        n_samples=cfg.n_samples,
        res_x=cfg.max_res_x,
        res_y=cfg.max_res_y,
        algorithm=algorithm,
    )


def make_pad_tables(cfg: Config, whole: Optional[np.ndarray] = None,
                    device="cuda") -> SteeringTables:
    """Pad-and-sum: one unit tap at shift ``whole`` (``pad_and_sum.c:41-47``:
    ``out[pad+i] += s[i]`` — a pure zero-fill shift, no boundary terms)."""
    if whole is None:
        whole, _ = geometry.calculate_coefficients(cfg)
    D = cfg.n_directions
    wh = whole.reshape(D, -1)[..., None].astype(np.int64)          # (D, M, 1)
    T = int(wh.max()) + 1
    W = _scatter_w(wh, np.ones_like(wh, np.float32), 0, T)
    return _tables(cfg, W, "pad", 0, device=device)


def make_truncated_tables(cfg: Config, device="cuda") -> SteeringTables:
    """Trunc-and-sum (``api.c:1015-1056``): identical inner math to pad but
    loaded from the angle-grid delay model (``directions.pyx:126-157``)."""
    delays = geometry.calculate_delays_angles(cfg)
    active, _ = geometry.active_microphones(cfg)
    whole = delays[:, :, active].astype(int)
    t = make_pad_tables(cfg, whole, device=device)
    return dataclasses.replace(t, algorithm="truncated")


def make_lerp_tables(cfg: Config, device="cuda") -> SteeringTables:
    """Lerp-and-sum (``lerp_and_sum.c:50-56``):

    ``out[pad+i+1] += s[i] + h*(s[i+1]-s[i])`` with ``h = 1-frac`` expands to
    weight ``(1-h)`` at shift ``pad+1`` (exact zero-fill shift) plus weight
    ``h`` at shift ``pad`` *excluding its first sample* — so one correction
    per (d, m): subtract ``h * s[m, 0]`` at output position ``pad``.
    """
    whole, h = geometry.lerp_coefficients(cfg)
    D = cfg.n_directions
    wh = whole.reshape(D, -1).astype(np.int64)
    hh = h.reshape(D, -1).astype(np.float32)
    shifts = np.stack([wh, wh + 1], axis=-1)                        # (D, M, 2)
    weights = np.stack([hh, 1.0 - hh], axis=-1)
    T = int(shifts.max()) + 1
    W = _scatter_w(shifts, weights, 0, T)
    Wc, corr_js = _build_corrections(
        [(0, hh, wh)], D, hh.shape[1])
    return _tables(cfg, W, "lerp", 0, Wc, corr_js, device=device)


def make_convolve_tables(cfg: Config, device="cuda") -> SteeringTables:
    """Convolve-and-sum (``convolve_and_sum.c:73-87``):

    ``out[i] += h[k] * padded[i+k]`` with ``padded`` = signal zero-padded by
    ``off = n_taps//2`` — i.e. weight ``h[k]`` at shift ``off - k`` for every
    k; ``i`` spans the whole frame so there are no boundary corrections
    (negative shifts advance the signal with head truncation — exactly what
    the zero-padding does).
    """
    taps = geometry.convolve_coefficients(cfg)                      # (X,Y,M,K)
    D = cfg.n_directions
    K = cfg.n_taps
    off = K // 2
    hh = taps.reshape(D, -1, K).astype(np.float32)
    k = np.arange(K)
    shifts = np.broadcast_to(off - k, hh.shape).astype(np.int64)
    tau_min = off - K + 1
    T = K
    W = _scatter_w(shifts, hh, tau_min, T)
    return _tables(cfg, W, "convolve", tau_min, device=device)


def make_hybrid_tables(cfg: Config, device="cuda") -> SteeringTables:
    """Hybrid convolve-and-sum (``hybrid_convolve_and_sum.c:51-64``):

    ``out[pad+i+1] += h[k] * padded[i+k]`` for ``i in [0, N-pad-1)`` — weight
    ``h[k]`` at shift ``pad + 1 + off - k``.  The ``i >= 0`` bound cuts, for
    taps ``k > off``, the products with ``s[m, j]`` for ``j < k-off``; those
    are subtracted as corrections at position ``j + pad + 1 + off - k``
    (positions < 0 never existed in the C output and are masked out).
    """
    whole, taps = geometry.hybrid_coefficients(cfg)
    D = cfg.n_directions
    K = cfg.n_taps
    off = K // 2
    wh = whole.reshape(D, -1).astype(np.int64)                      # (D, M)
    hh = taps.reshape(D, -1, K).astype(np.float32)                  # (D, M, K)
    k = np.arange(K)
    shifts = wh[..., None] + 1 + off - k                            # (D, M, K)
    tau_min = int(shifts.min())
    T = int(shifts.max()) - tau_min + 1
    W = _scatter_w(shifts, hh, tau_min, T)

    entries = []
    for kk in range(off + 1, K):
        for j in range(kk - off):
            entries.append((j, hh[:, :, kk], j + wh + 1 + off - kk))
    Wc, corr_js = _build_corrections(entries, D, hh.shape[1])
    return _tables(cfg, W, "hybrid", tau_min, Wc, corr_js, device=device)


def _build_corrections(entries, D: int, M: int):
    """entries: list of (signal_index_j, weight (D, M), out_pos (D, M)).

    Packs them into the dense one-hot tensor ``Wc[j_group, d, t, m]`` with
    positions past the max kept column or below 0 dropped (those products
    never existed in the C output)."""
    if not entries:
        return None, ()
    tc = max(int(pos.max()) for _, _, pos in entries) + 1
    groups = {}
    for j, w, pos in entries:
        groups.setdefault(j, []).append((w, pos))
    corr_js = tuple(sorted(groups))
    Wc = np.zeros((len(corr_js), D, tc, M), np.float32)
    d_idx = np.repeat(np.arange(D), M)
    m_idx = np.tile(np.arange(M), D)
    for gi, j in enumerate(corr_js):
        for w, pos in groups[j]:
            p = pos.reshape(-1)
            ok = p >= 0
            np.add.at(Wc[gi], (d_idx[ok], p[ok], m_idx[ok]),
                      w.reshape(-1)[ok].astype(np.float32))
    return Wc, corr_js


# bump when any table builder's output changes for the same config (the
# on-disk cache would otherwise serve tables built by the old code).  The
# port's cache files carry their own "torch-" prefix and directory, so they
# never collide with the JAX package's.
_TABLE_GEOMETRY_VERSION = 2

_BUILDERS = {
    "pad": make_pad_tables,
    "lerp": make_lerp_tables,
    "convolve": make_convolve_tables,
    "hybrid": make_hybrid_tables,
    "truncated": make_truncated_tables,
}


def _cache_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.environ.get("ZRT_TORCH_TABLE_CACHE_DIR",
                          os.path.join(root, "build", "tables"))


def make_tables(cfg: Config, algorithm: str, cache: bool = True,
                device="cuda") -> SteeringTables:
    """Build (or load from the on-disk table cache) the steering tables.

    The reference recomputes every coefficient table at process start
    (``main.pyx:177-181``); table design for the full config costs a few
    seconds of host FIR math, so built tables are cached as
    ``build/tables/torch-<algorithm>-<key>.npz`` beside the package
    (override with ``ZRT_TORCH_TABLE_CACHE_DIR``), keyed by the
    geometry-relevant config fields.

    The tables go to ``device``: the card unless the caller asks for
    ``"cpu"`` (which runs the plain torch versions of the kernels); with
    no GPU present the default raises (:func:`resolve_device`).
    """
    builder = _BUILDERS[algorithm]
    resolve_device(device)          # raise before the host's table math
    if not cache:
        return builder(cfg, device=device)

    key_fields = (algorithm, _TABLE_GEOMETRY_VERSION,
                  cfg.n_microphones, cfg.n_samples, cfg.n_taps,
                  cfg.columns, cfg.rows, cfg.max_res_x, cfg.max_res_y,
                  cfg.z_scan, cfg.max_angle, cfg.view_angle, cfg.sample_rate,
                  cfg.element_distance, cfg.array_slots, cfg.skip_n_mics,
                  cfg.propagation_speed, cfg.aspect_ratio, cfg.unused_mics,
                  cfg.matmul_dtype)
    key = hashlib.sha1(repr(key_fields).encode()).hexdigest()[:16]
    cdir = _cache_dir()
    path = os.path.join(cdir, f"torch-{algorithm}-{key}.npz")
    if os.path.exists(path):
        # entries are always f32 on disk; the table dtype is re-applied on
        # load.  A corrupt/stale entry falls through to a rebuild.
        try:
            z = np.load(path, allow_pickle=False)
            W = np.asarray(z["W"], np.float32)
            Wc = np.asarray(z["Wc"], np.float32) if "Wc" in z else None
            tau_min, corr_js = int(z["tau_min"]), tuple(
                int(j) for j in z["corr_js"])
        except (OSError, ValueError, KeyError, TypeError):
            pass
        else:
            return _tables(cfg, W, algorithm, tau_min, Wc, corr_js,
                           device=device)
    t = builder(cfg, device=device)
    try:
        os.makedirs(cdir, exist_ok=True)
        arrays = dict(W=t.W.float().cpu().numpy(),
                      tau_min=np.int64(t.tau_min),
                      corr_js=np.asarray(t.corr_js, np.int64))
        if t.Wc is not None:
            arrays["Wc"] = t.Wc.cpu().numpy()
        # write-then-rename: a concurrent reader never sees a torn file
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except OSError:
        pass
    return t


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------

def delay_lines(s: torch.Tensor, tau_min: int, T: int,
                stack_axis: int = -3) -> torch.Tensor:
    """(..., M, N) -> shifted copies stacked at ``stack_axis``
    (default: (..., T, M, N)).

    ``out[t]`` holds ``s[..., m, n - (tau_min+t)]`` with zeros outside —
    the C ``pad_delay`` semantics (``pad_and_sum.c:41-47``) for positive
    shifts and head-truncation for negative ones.
    """
    N = s.shape[-1]
    rows = []
    for t in range(T):
        tau = tau_min + t
        if tau >= N or tau <= -N:
            rows.append(torch.zeros_like(s))
        elif tau >= 0:
            rows.append(torch.nn.functional.pad(s[..., : N - tau], (tau, 0)))
        else:
            rows.append(torch.nn.functional.pad(s[..., -tau:], (0, -tau)))
    return torch.stack(rows, dim=stack_axis)


def _acc_dtype(t: SteeringTables) -> torch.dtype:
    return torch.float64 if t.W.dtype == torch.float64 else torch.float32


def _apply_corrections_dbn(beams: torch.Tensor, s: torch.Tensor,
                           t: SteeringTables) -> torch.Tensor:
    """Subtract the exact boundary terms in (D, B, N) layout.

    ``corr[d, b, t'] = sum_j sum_m Wc[j, d, t', m] * s[b, m, corr_js[j]]``
    applied to the first Tc output columns (in place on ``beams``)."""
    if t.Wc is None:
        return beams
    dt = beams.dtype
    sj = torch.stack([s[:, :, j] for j in t.corr_js], dim=1)       # (B, J, M)
    corr = torch.einsum("jdtm,bjm->dbt", t.Wc.to(dt), sj.to(dt))
    tc = corr.shape[-1]
    beams[:, :, :tc] -= corr
    return beams


def steered_beams(signals, t: SteeringTables,
                  mean_power: bool = False) -> torch.Tensor:
    """All-direction beams (B, D, N) — or mean power (B, X, Y).

    ``signals``: (B, n_channels, N) or (n_channels, N), full channel axis
    (the active-mic gather happens here, mirroring the ``adaptive_array``
    argument of ``mimo_*``).  Runs in float64 for float64 tables and at
    true FP32 otherwise (bf16 tables: bf16-rounded operands, FP32 sums).
    """
    set_fp32_matmul()
    signals = torch.as_tensor(signals, device=t.device)
    squeeze = signals.ndim == 2
    if squeeze:
        signals = signals[None]
    B = signals.shape[0]
    N = t.n_samples
    D = t.n_directions
    M = t.n_mics
    acc = _acc_dtype(t)
    # delay lines in (T, M, B, N) layout so the contraction is one plain
    # (D, T*M) @ (T*M, B*N) matmul with no large transposes on either side
    s_act = signals[:, t.adaptive, :]
    s_mbn = s_act.to(t.W.dtype).to(acc).permute(1, 0, 2)
    sdel = delay_lines(s_mbn, t.tau_min, t.n_taps_line, stack_axis=0)
    T = sdel.shape[0]
    beams = torch.matmul(t.W.to(acc).reshape(D, T * M),
                         sdel.reshape(T * M, B * N)).reshape(D, B, N)
    beams = _apply_corrections_dbn(beams, s_act.to(acc), t)
    if mean_power:
        beams = beams / M
        power = torch.mean(beams * beams, dim=-1)                   # (D, B)
        power = power.T.reshape(B, t.res_x, t.res_y)
        return power[0] if squeeze else power
    beams = beams.permute(1, 0, 2)                                  # (B, D, N)
    return beams[0] if squeeze else beams


def steered_power(signals, t: SteeringTables) -> torch.Tensor:
    """The MIMO heatmap: ``image[x, y] = sum((beam/n)**2)/N`` exactly as
    ``pad_and_sum.c:122-131``.  (B, X, Y) or (X, Y)."""
    return steered_beams(signals, t, mean_power=True)


def _pick(x: torch.Tensor, dim: int, directions) -> torch.Tensor:
    """Rows ``directions`` of ``x`` along ``dim`` (a new axis there, K
    long): a Python int or sequence, or an integer tensor on any device.
    An int is a view; ``index_select`` keeps a device index on the device
    (no host sync)."""
    if isinstance(directions, (int, np.integer)):
        return x.narrow(dim, int(directions), 1)
    if isinstance(directions, torch.Tensor):
        idx = directions.to(x.device, torch.int64).reshape(-1)
    else:
        idx = torch.as_tensor(np.asarray(directions, np.int64).reshape(-1),
                              device=x.device)
    return x.index_select(dim, idx)


def _beams_at(signals, t: SteeringTables, directions) -> torch.Tensor:
    """Single-direction beams (B, K, N) for ``directions`` (K of them):
    the tap product ``G = W[d] · s`` (B, K, T, N), its T shifted copies
    summed by one gather over a zero-padded G, then the boundary
    corrections.  Precision as :func:`steered_beams`: float64 for float64
    tables, else true FP32 (bf16 tables: bf16-rounded operands, FP32
    sums); the corrections from the unrounded signal, in FP32 or
    float64."""
    set_fp32_matmul()
    signals = torch.as_tensor(signals, device=t.device)
    N = t.n_samples
    acc = _acc_dtype(t)
    s = signals[:, t.adaptive, :]                                   # (B,M,N)
    Wd = _pick(t.W, 0, directions).to(acc)                          # (K,T,M)
    # one (T, M) x (M, N) product per (direction, frame): the same sums
    # in the same order whatever K and B are
    G = torch.matmul(Wd[:, None], s.to(t.W.dtype).to(acc)[None])    # (K,B,T,N)
    T = G.shape[2]
    # tap t adds G[..., t, n - tau_t] at output n (zero outside the
    # frame): pad G by the largest shift on each side, gather
    tau = t.tau_min + torch.arange(T, device=t.device)
    lo, hi = max(0, t.tau_min + T - 1), max(0, -t.tau_min)
    idx = torch.arange(N, device=t.device)[None, :] - tau[:, None] + lo
    Gz = torch.nn.functional.pad(G, (lo, hi))
    idx = idx.expand(*G.shape[:2], T, N)
    beam = torch.gather(Gz, 3, idx).sum(dim=2)                      # (K,B,N)
    if t.Wc is not None:
        Wcd = _pick(t.Wc, 1, directions).to(acc)                    # (J,K,Tc,M)
        J, K, Tc, M = Wcd.shape
        Wcd = Wcd.permute(1, 2, 0, 3).reshape(K, 1, Tc, J * M)
        sj = torch.stack([s[:, :, j] for j in t.corr_js], dim=1)    # (B,J,M)
        corr = torch.matmul(Wcd, sj.to(acc).reshape(1, -1, J * M, 1))
        beam[..., :Tc] -= corr[..., 0]                              # (K,B,Tc)
    return beam.permute(1, 0, 2)


def miso_beam(signals, t: SteeringTables, direction) -> torch.Tensor:
    """Single-direction beam (the MISO path, ``pad_and_sum.c:54-70`` /
    ``lerp_and_sum.c:67-92``): raw mic sum, NOT divided by n (the caller
    applies gain/normalization, as ``api.c:517-522`` does).

    ``signals``: (B, n_channels, N) or (n_channels, N), full channel
    axis.  ``direction``: flat grid index d = x * res_y + y, an int or a
    0-d integer tensor (indexed on the device: steering changes cost no
    host sync).  Returns (B, N) or (N,)."""
    signals = torch.as_tensor(signals, device=t.device)
    squeeze = signals.ndim == 2
    beam = _beams_at(signals[None] if squeeze else signals, t, direction)
    beam = beam[:, 0]
    return beam[0] if squeeze else beam


def make_miso_tables(cfg: Config, azimuth_deg: float, elevation_deg: float,
                     device="cuda") -> SteeringTables:
    """Single-direction pad tables from the angle delay model — parity with
    ``load_coefficients_pad2``/``miso_pad2`` (``pad_and_sum.c:77-92,153``),
    which steers with a dedicated per-mic whole-sample table computed by
    ``calculate_delay_miso`` (``directions.pyx:159-187``).  Use with
    ``miso_beam(signals, tables, 0)``."""
    delays = geometry.calculate_delay_miso(cfg, azimuth_deg, elevation_deg)
    active, _ = geometry.active_microphones(cfg)
    whole = delays[active].reshape(1, 1, -1)
    one = cfg.replace(max_res_x=1, max_res_y=1)
    return make_pad_tables(one, whole, device=device)


def miso_beams_multi(signals, t: SteeringTables, directions) -> torch.Tensor:
    """Beams for several steering directions at once: (B, K, N) for
    batched signals, (K, N) for one frame — one product for all K
    directions, not K calls."""
    signals = torch.as_tensor(signals, device=t.device)
    squeeze = signals.ndim == 2
    beams = _beams_at(signals[None] if squeeze else signals, t, directions)
    return beams[0] if squeeze else beams


def steer_index(cfg: Config, azimuth_deg: float, elevation_deg: float) -> int:
    """Map (azimuth, elevation) degrees in [-90, 90] to a flat grid index.

    Follows ``main.pyx:498-515`` (``steer_cartesian_degree``) for the
    degree->cell quantization; the cell->flat-offset mapping here is the
    geometrically consistent ``x * res_y + y`` (the reference computes a
    byte offset that disagrees with its own table layout — a known quirk we
    do not reproduce; see SURVEY.md §3.3).
    """
    az = int((azimuth_deg + 90.0) / 180.0 * cfg.max_res_x)
    el = int((elevation_deg + 90.0) / 180.0 * cfg.max_res_y)
    az = min(max(az, 0), cfg.max_res_x - 1)
    el = min(max(el, 0), cfg.max_res_y - 1)
    return az * cfg.max_res_y + el
