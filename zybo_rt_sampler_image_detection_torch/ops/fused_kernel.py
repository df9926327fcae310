"""Fused time-domain steered power: host class + CUDA kernel.

For frame b and direction d the delay-and-sum family is one contraction
over delay lines (:mod:`.beamform`)::

    beam[b, d, n] = sum_{m, j} W[d, tau_min + base[d, m] + j, m]
                               * s[b, m, n - tau_min - base[d, m] - j]
    power[b, d]   = sum_n (beam[b, d, n] - corr[b, n, d])**2 / (M**2 N)

with zero-filled shifts per frame and the boundary corrections ``corr``
on the first ``cc`` samples.  The kernel (``csrc/time_power.cu``) is an
implicit GEMM: a block stages a slab of each frame's signal in shared
memory and reads every shifted operand from it, so the delay lines and
the (B, D, N) beams never reach device memory.  The source note in the
``.cu`` says what bounds it on the H100 and how the design answers.

K runs over a per-(direction tile, mic) window of ``Tw`` taps starting
at ``base`` (:func:`_window_plan`).  Where a tile's taps spread over all
T, the plan degenerates to ``Tw = T`` and ``base = 0``: the dense
contraction of the TPU's full and chunked-T kernels.

Layout the kernel takes (the forward below builds it):

* ``s``      (BP, M, N)      active-mic signals, plane dtype;
* ``w``      (M*Tw, DP)      weights, row ``m*Tw + j``, directions padded
                             to DP;
* ``bases``  (DP/tile_d, M)  int32 first tap of each window;
* ``corr``   (BP, cc, DP)    float32 boundary corrections, or None;
* output     (BP, DP)        float32 power.

Precision: ``f32``/``high`` tables run FP32 operands, ``bf16`` tables bf16
operands, always with FP32 sums.  The TPU's bf16 hi/lo 3-pass split
(``_split_bf16``) was its way to FP32 on a bf16-only matrix unit and is
not ported; the correction prologue is an FP32 ``torch.matmul`` (TF32
off), as the JAX package left it to XLA.

Ported from ``zybo_rt_sampler_image_detection_tpu/ops/pallas_kernels.py``
(``FusedBeamformer``, ``_fused_forward``, ``_fused_forward_tchunk``,
``_fused_forward_window``, ``_window_plan``, ``_prep_corr``): the full,
chunked-T and windowed variants are one K-looped kernel here, and the v5e
VMEM planner is replaced by a plan for one H100 block's shared memory.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F_

from .beamform import delay_lines, set_fp32_matmul

# kernel constants of csrc/time_power.cu
TILE_DS = (8, 16, 32)           # directions per block (8 per warp)
TAP_CHUNK = 64                  # taps of one weight tile (TKC cap)
K_GROUP = 256                   # weight rows (k steps) per staged mic group
SMEM_MAX = 232448               # dynamic shared memory one H100 block can opt into


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _window_plan(Wnp: np.ndarray, tile_d: int):
    """Per-(direction tile, mic) tap windows of the kernel.

    Within one direction tile each mic's nonzero taps span a narrow
    window (delays vary smoothly over adjacent directions), so the tile's
    contraction runs over a compact window of uniform width Tw = the
    largest spread instead of all T taps.  The JAX package rounds bases
    and Tw to Mosaic's sublane multiple of 8 (``pallas_kernels.py:335-339``);
    the CUDA kernel takes any offset, so the port does not.

    Returns ``(bases (n_tiles, M) int32, Tw)``; every window covers all
    nonzero taps of its (tile, mic) and lies in ``[0, T)``.  Where the
    spread is T, Tw = T and every base is 0: the dense contraction.
    """
    D, T, M = Wnp.shape
    DP = _round_up(D, tile_d)
    nz = Wnp != 0
    taps = np.arange(T)[None, :, None]
    tmin = np.where(nz, taps, T).min(axis=1)           # (D, M)
    tmax = np.where(nz, taps, -1).max(axis=1)
    pad = DP - D
    tmin = np.concatenate([tmin, np.full((pad, M), T)], 0)
    tmax = np.concatenate([tmax, np.full((pad, M), -1)], 0)
    tmin_t = tmin.reshape(DP // tile_d, tile_d, M).min(axis=1)
    tmax_t = tmax.reshape(DP // tile_d, tile_d, M).max(axis=1)
    Tw = max(int(np.maximum(tmax_t - tmin_t + 1, 0).max()), 1)
    bases = np.clip(tmin_t, 0, T - Tw).astype(np.int32)
    return bases, Tw


def _prep_corr_weights(Wc: Optional[torch.Tensor], cc: int, DP: int):
    """(J, D, Tc, M) correction weights -> (J*M, cc*DP) float32, the
    right-hand side whose column order is the kernel's (cc, DP) layout
    (``pallas_kernels._prep_corr_weights``, swapped orientation)."""
    if Wc is None:
        return None
    J, D, Tc, M = Wc.shape
    if Tc > cc:
        raise ValueError(f"corrections span {Tc} samples, more than cc={cc}")
    wcp = F_.pad(Wc.float(), (0, 0, 0, cc - Tc, 0, DP - D))
    return wcp.permute(0, 3, 2, 1).reshape(J * M, cc * DP).contiguous()


def _prep_corr(sf: torch.Tensor, corr_w, corr_js, cc: int, DP: int):
    """Boundary corrections in the kernel layout (BP, cc, DP): one
    (BP, J*M) @ (J*M, cc*DP) FP32 product (``pallas_kernels._prep_corr``)."""
    if corr_w is None:
        return None
    set_fp32_matmul()
    BP = sf.shape[0]
    sj = torch.stack([sf[:, :, j].float() for j in corr_js], dim=1)
    return (sj.reshape(BP, -1) @ corr_w).reshape(BP, cc, DP)


def _prep_weights(W: torch.Tensor, bases: torch.Tensor, Tw: int,
                  tile_d: int, DP: int, dtype) -> torch.Tensor:
    """(D, T, M) -> (M*Tw, DP): row m*Tw + j holds, for each direction d,
    ``W[d, bases[d // tile_d, m] + j, m]`` (0 past the last tap)."""
    D, T, M = W.shape
    nt = DP // tile_d
    Wr = F_.pad(W.float(), (0, 0, 0, Tw, 0, DP - D)).reshape(
        nt, tile_d, T + Tw, M)
    idx = (bases.long()[:, None, None, :]
           + torch.arange(Tw, device=W.device)[None, None, :, None])
    comp = torch.gather(Wr, 2, idx.expand(nt, tile_d, Tw, M))  # (nt, td, Tw, M)
    return comp.permute(3, 2, 0, 1).reshape(M * Tw, DP).to(dtype).contiguous()


def plan(TK: int, N: int, M: int, tile_d: int):
    """The Hopper plan of one block: ``(NI, MG, TKC, smem_bytes)``.

    NI: samples per lane and pass (a warp covers 32*NI samples; longer
    frames take several passes); TKC: taps per weight tile; MG: mics per
    staged group, about K_GROUP k steps between two barriers.  Mirrors
    ``smem_floats`` in the .cu.  Raises ValueError when not even one mic
    fits a block's shared memory."""
    NI = 2 if N <= 64 else 4 if N <= 128 else 8
    TKC = min(TK, TAP_CHUNK)
    MG = max(1, min(M, K_GROUP // TKC))

    def smem(mg):
        LP = 32 * NI + TK - 1
        return 4 * (_round_up(mg * LP, 4) + mg * TKC * tile_d)

    while MG > 1 and smem(MG) > SMEM_MAX:
        MG //= 2
    if smem(MG) > SMEM_MAX:
        raise ValueError(f"time_power: no shared-memory plan for TK={TK} "
                         f"N={N} tile_d={tile_d}")
    return NI, MG, TKC, smem(MG)


def fused_power_plain(s, w, bases, corr, *, tau_min: int, tile_d: int,
                      inv: float) -> torch.Tensor:
    """Plain-torch version of the kernel, same inputs and layout, FP32.

    bf16 operands are widened to FP32 first, which is the kernel's
    arithmetic (bf16 operands, FP32 sums)."""
    set_fp32_matmul()
    BP, M, N = s.shape
    K, DP = w.shape
    TK = K // M
    sf, wf = s.float(), w.float()
    T_all = int(bases.max()) + TK
    full = delay_lines(sf, tau_min, T_all, stack_axis=-2)  # (BP, M, T_all, N)
    jj = torch.arange(TK, device=s.device)
    tiles = []
    for i in range(DP // tile_d):
        idx = (bases[i].long()[:, None] + jj[None, :])      # (M, TK)
        win = torch.gather(full, 2, idx[None, :, :, None].expand(
            BP, M, TK, N))
        tiles.append(win.reshape(BP, K, N).transpose(1, 2)
                     @ wf[:, i * tile_d:(i + 1) * tile_d])
    beams = torch.cat(tiles, dim=2)                          # (BP, N, DP)
    if corr is not None:
        cc = corr.shape[1]
        beams = torch.cat([beams[:, :cc] - corr, beams[:, cc:]], dim=1)
    return torch.sum(beams * beams, dim=1) * inv


def _lib():
    from . import _build

    lib = _build.load("time_power")
    if not getattr(lib, "_zrt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.zrt_time_power.restype = i
        lib.zrt_time_power.argtypes = [
            p, p, p, p, p,                         # s w bases corr out
            i, i, i, i, i, i, i, i,                # BP M N TK DP tile_d tau_min cc
            i, i, i, ctypes.c_float, i, p]         # MG TKC NI inv bf16 stream
        lib.zrt_cuda_error_string.restype = ctypes.c_char_p
        lib.zrt_cuda_error_string.argtypes = [i]
        lib._zrt_typed = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_power: {msg}")


def fused_power(s, w, bases, corr, *, tau_min: int, tile_d: int,
                inv: float) -> torch.Tensor:
    """Fused time-domain power, (BP, DP) float32.

    On CPU tensors this is :func:`fused_power_plain`.  On CUDA tensors it
    launches the ``sm_90a`` kernel or raises; there is no fallback.
    ``fused_power.launches`` counts the kernel launches."""
    if s.device.type == "cpu":
        return fused_power_plain(s, w, bases, corr, tau_min=tau_min,
                                 tile_d=tile_d, inv=inv)
    _check(s.device.type == "cuda", f"unsupported device {s.device}")
    dev = s.device
    _check(s.ndim == 3, "s must be (BP, M, N)")
    BP, M, N = s.shape
    _check(s.dtype in (torch.float32, torch.bfloat16),
           f"s dtype {s.dtype} (float32 or bfloat16)")
    _check(w.dtype == s.dtype, "s and w must share one dtype")
    _check(w.ndim == 2 and w.shape[0] % M == 0, "w must be (M*TK, DP)")
    K, DP = w.shape
    TK = K // M
    _check(tile_d in TILE_DS and DP % tile_d == 0,
           f"tile_d must be one of {TILE_DS} and divide DP")
    _check(bases.dtype == torch.int32 and bases.shape == (DP // tile_d, M),
           "bases must be int32 (DP/tile_d, M)")
    tensors = [s, w, bases]
    cc = 0
    if corr is not None:
        _check(corr.dtype == torch.float32 and corr.ndim == 3
               and corr.shape[0] == BP and corr.shape[2] == DP
               and corr.shape[1] <= N, "corr must be float32 (BP, cc<=N, DP)")
        cc = corr.shape[1]
        tensors.append(corr)
    _check(all(t.device == dev for t in tensors),
           "all tensors must be on one device")
    _check(all(t.is_contiguous() for t in tensors),
           "all tensors must be contiguous")
    NI, MG, TKC, _ = plan(TK, N, M, tile_d)
    lib = _lib()
    out = torch.empty((BP, DP), dtype=torch.float32, device=dev)
    cptr = corr.data_ptr() if corr is not None else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zrt_time_power(
            s.data_ptr(), w.data_ptr(), bases.data_ptr(), cptr,
            out.data_ptr(), BP, M, N, TK, DP, tile_d, int(tau_min), cc, MG,
            TKC, NI, float(inv), int(s.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"time_power kernel launch failed: "
                           f"{lib.zrt_cuda_error_string(err).decode()}")
    fused_power.launches += 1
    return out


fused_power.launches = 0


class FusedBeamformer:
    """Precomputed windowed weights + the fused time-domain power kernel.

    Usage::

        fused = FusedBeamformer(tables)         # SteeringTables
        power = fused(frames)                   # (B, X, Y) or (X, Y)

    ``frames`` are ``(M, N)`` or ``(B, C, N)`` tensors or numpy arrays.
    ``tile_d`` directions (8/16/32) make one block, with one frame; the
    tap windows are planned at ``tile_d`` (:func:`_window_plan`).
    ``mode`` follows the tables: ``bf16`` for bf16 weights, else ``high``
    or ``f32`` (the same FP32 arithmetic).
    """

    def __init__(self, t, tile_d: int = 32):
        if tile_d not in TILE_DS:
            raise ValueError(f"tile_d must be one of {TILE_DS}")
        self.t = t
        D, T, M = t.W.shape
        N = t.n_samples
        self.device = t.W.device
        self.plane_dtype = (torch.bfloat16 if t.W.dtype == torch.bfloat16
                            else torch.float32)
        self.mode = ("bf16" if self.plane_dtype == torch.bfloat16
                     else "high" if t.precision == "high" else "f32")
        self.D, self.T, self.M, self.N = D, T, M, N
        self.tile_d = tile_d
        self.DP = _round_up(D, tile_d)
        tc = 0 if t.Wc is None else t.Wc.shape[2]
        self.cc = min(max(8, _round_up(tc, 8)), N)
        self.tau_min, self.corr_js = t.tau_min, t.corr_js
        self.res_x, self.res_y = t.res_x, t.res_y
        bases, self.TK = _window_plan(t.W.float().cpu().numpy(), tile_d)
        self.bases = torch.from_numpy(bases).to(self.device)
        self.Wp = _prep_weights(t.W, self.bases, self.TK, tile_d, self.DP,
                                self.plane_dtype)
        # the Hopper plan; raises here, not at the first call, if no block fits
        self.plan = plan(self.TK, N, M, tile_d)
        self.corr_w = _prep_corr_weights(t.Wc, self.cc, self.DP)
        ident = torch.arange(M, device=self.device)
        # identity active-mic set -> slice the leading M rows, no gather
        self.adaptive = (None if torch.equal(t.adaptive, ident)
                         else t.adaptive)
        self.inv = float(np.float32(1.0 / (N * M * M)))

    def kernel_inputs(self, signals: torch.Tensor):
        """The forward's prologue: (B, C, N) frames -> ``(s, corr)``, the
        per-call kernel inputs (active-mic gather, plane dtype, and the
        correction product)."""
        sf = (signals[:, self.adaptive, :] if self.adaptive is not None
              else signals[:, :self.M, :]).float()
        s = sf.to(self.plane_dtype).contiguous()
        corr = _prep_corr(sf, self.corr_w, self.corr_js, self.cc, self.DP)
        return s, corr

    def __call__(self, signals) -> torch.Tensor:
        signals = torch.as_tensor(signals, device=self.device)
        squeeze = signals.ndim == 2
        if squeeze:
            signals = signals[None]
        B = signals.shape[0]
        s, corr = self.kernel_inputs(signals)
        power = fused_power(s, self.Wp, self.bases, corr,
                            tau_min=self.tau_min, tile_d=self.tile_d,
                            inv=self.inv)
        power = power[:, :self.D].reshape(B, self.res_x, self.res_y)
        return power[0] if squeeze else power
