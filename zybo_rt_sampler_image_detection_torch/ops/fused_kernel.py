"""Fused time-domain steered power: host class + CUDA kernel.

For frame b and direction d the delay-and-sum family is one contraction
over delay lines (:mod:`.beamform`)::

    beam[b, d, n] = sum_{m, j} W[d, tau_min + base[d, m] + j, m]
                               * s[b, m, n - tau_min - base[d, m] - j]
    power[b, d]   = sum_n (beam[b, d, n] - v[b, d, n])**2 / (M**2 N)

with zero-filled shifts per frame and the boundary corrections ``v`` on
the first ``Tc`` samples.  The kernel (``csrc/time_power.cu``) is an
implicit GEMM: a block stages one frame's signal rows in shared memory, a
group of mics at a time, and every warp reads its shifted operands from
them, so the delay lines and the (B, D, N) beams never reach device
memory.  The source note in the ``.cu`` says what bounds it on the H100
and how the design answers.

K runs over a per-(window tile, mic) window of ``Tw`` taps starting at
``base`` (:func:`_window_plan`, window tile ``tile_d`` = 8 directions by
default, one warp's).  Where a tile's taps spread over all T, the plan
degenerates to ``Tw = T`` and ``base = 0``: the dense contraction of the
TPU's full and chunked-T kernels.

Layout the kernel takes (:class:`FusedBeamformer` builds it):

* ``s``      (BP, M, NL)     active-mic signals in the plane dtype, sample
                             n of a row at ``lpad + n``, zero margins wide
                             enough for every shifted read
                             (:func:`row_layout`), NL rounded to 16 bytes;
* ``w``      (M*Tw, DP)      weights, row ``m*Tw + j``, directions padded
                             to DP;
* ``bases``  (DP/tile_d, M)  int32 first tap of each window;
* ``sj``     (BP, J*M)       float32 correction sample columns, and
  ``wc``     :class:`~.equiv_kernel.HeadCorrections`, the nonzero weights
                             of ``Wc`` as a CSR over rows ``d*Tc + c``
                             (both None without corrections);
* output     (BP, DP)        float32 power.

Precision: ``f32``/``high`` tables run FP32 operands, ``bf16`` tables bf16
operands, always with FP32 sums.  The TPU's bf16 hi/lo 3-pass split
(``_split_bf16``) was its way to FP32 on a bf16-only matrix unit and is
not ported; the corrections are FP32 sums over the sparse list inside the
kernel, where the JAX package left a dense product to XLA.

Ported from ``zybo_rt_sampler_image_detection_tpu/ops/pallas_kernels.py``
(``FusedBeamformer``, ``_fused_forward``, ``_fused_forward_tchunk``,
``_fused_forward_window``, ``_window_plan``, ``_prep_corr``): the full,
chunked-T and windowed variants are one K-looped kernel here, and the v5e
VMEM planner is replaced by a plan of H100 blocks (:func:`plan`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F_

from ..utils.profiling import annotate
from .beamform import set_fp32_matmul
from .equiv_kernel import (HeadCorrections, corrections_plain,
                           make_head_corrections)

# kernel constants of csrc/time_power.cu
DW = 8                          # directions of a warp tile
TILE_DS = (8, 16, 32)           # window tiles: directions sharing one window
MAX_WARPS = 8                   # warps a block: G tiles x NS sample splits
WARPS_PER_SM = 16               # __launch_bounds__(256, 2): registers for 16
SMEM_MAX = 232448               # dynamic shared memory one H100 block can opt into
SM_SHARED = 233472              # shared memory of one SM ...
BLOCK_RESERVED = 1024           # ... of which the runtime keeps 1 KB a block
SMS = 132                       # SMs of an H100 SXM (the CPU plan's card)
MGS = (16, 8, 4, 2, 1)          # mics a stage, largest first
ROW_ALIGN = 8                   # elements a padded row rounds to (>= 16 B)


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


def sample_splits(N: int) -> dict:
    """``{NS: NI}``: the sample splits a block may take for N samples and
    the samples a lane of each (a warp covers 32*NI a pass).  A split is
    offered only where each warp keeps at least 2 samples a lane."""
    out = {}
    for NS in (1, 2, 4):
        per = -(-N // (32 * NS))
        if NS > 1 and per < 2:
            break
        out[NS] = min(8, max(2, 1 << (per - 1).bit_length()))
    return out


def sample_cover(N: int, NS: int, NI: int) -> int:
    """Samples the passes of a (NS, NI) block cover (>= N)."""
    return _round_up(N, 32 * NS * NI)


def row_layout(tau_min: int, taps: int, N: int) -> tuple:
    """``(lpad, NL)`` of the padded signal rows: sample n at ``lpad + n``;
    every read ``lpad + n - tau_min - t`` for taps t < ``taps`` and n below
    any split's cover lies in ``[0, NL)``; NL rounded to ROW_ALIGN."""
    lpad = max(0, tau_min + taps - 1)
    cover = max(sample_cover(N, ns, ni) for ns, ni in
                sample_splits(N).items())
    return lpad, _round_up(max(lpad + N, lpad - tau_min + cover), ROW_ALIGN)


def smem_bytes(itemsize: int, NL: int, TK: int, M: int, JM: int, Tc: int,
               G: int, NS: int, MG: int) -> int:
    """Shared memory of one block (mirrors ``layout`` in the .cu): two
    stages of rows and weights in the plane type, then the bases, the sj
    row, the corrections and the split sums."""
    def r16(x):
        return _round_up(x, 16)

    return (r16(2 * MG * NL * itemsize) + r16(2 * G * MG * TK * DW * itemsize)
            + r16(G * M * 4) + r16(JM * 4) + r16(G * Tc * DW * 4)
            + r16(G * NS * DW * 4))


class Plan(NamedTuple):
    """One launch: G warp tiles x NS sample splits a block, NI samples a
    lane, MG mics a stage, ``smem`` bytes a block, ``bps`` blocks an SM
    (by shared memory and registers), ``blocks`` in the grid."""

    G: int
    NS: int
    NI: int
    MG: int
    smem: int
    bps: int
    blocks: int


def block_plan(N: int, M: int, TK: int, DP: int, B: int, NL: int,
               itemsize: int, JM: int, Tc: int, G: int,
               NS: int) -> Optional[Plan]:
    """The launch of ``B`` frames on blocks of G warp tiles x NS sample
    splits, with the most mics a stage (MG) that keep WARPS_PER_SM warps
    an SM in shared memory; None when no MG fits.  Raises ValueError for a
    (G, NS) the kernel does not take."""
    splits = sample_splits(N)
    if NS not in splits or not 1 <= G <= MAX_WARPS // NS:
        raise ValueError(f"time_power: split (G={G}, NS={NS}) not in "
                         f"G*NS <= {MAX_WARPS}, NS in {sorted(splits)}")
    want = max(1, WARPS_PER_SM // (G * NS))
    best = None
    for MG in sorted({min(mg, M) for mg in MGS}, reverse=True):
        sm = smem_bytes(itemsize, NL, TK, M, JM, Tc, G, NS, MG)
        if sm > SMEM_MAX:
            continue
        bps = min(want, SM_SHARED // (sm + BLOCK_RESERVED))
        if best is None or bps > best.bps:
            blocks = B * -(-(DP // DW) // G)
            best = Plan(G, NS, splits[NS], MG, sm, bps, blocks)
        if bps == want:
            break
    return best


@functools.lru_cache(maxsize=256)
def plan(N: int, M: int, TK: int, DP: int, B: int, NL: int, itemsize: int,
         JM: int = 0, Tc: int = 0, sms: int = SMS) -> Plan:
    """The Hopper plan of a launch of ``B`` frames (memoized: a call's
    host cost is one lookup).

    NS: the fewest sample splits that give every SM WARPS_PER_SM warps
    (B * DP/8 * NS of them), else the most; one frame needs them to fill
    the card, 16 frames do not.  G: the warp tiles a block whose launch
    puts the fewest warps on the busiest SM, then the fewest waves, the
    most SMs busy, the most resident warps an SM and the most tiles (a
    frame is staged once a block).  MG: :func:`block_plan`'s.  Raises
    ValueError when no block fits."""
    splits = sample_splits(N)
    NS = next((ns for ns in splits
               if B * (DP // DW) * ns >= sms * WARPS_PER_SM), max(splits))
    cands = [p for p in (block_plan(N, M, TK, DP, B, NL, itemsize, JM, Tc,
                                    G, NS)
                         for G in range(1, MAX_WARPS // NS + 1))
             if p is not None]
    if not cands:
        raise ValueError(f"time_power: no shared-memory plan for TK={TK} "
                         f"N={N} M={M}")

    def cost(p):
        return (-(-p.blocks // sms) * p.G * p.NS,
                -(-p.blocks // (sms * p.bps)), -min(p.blocks, sms),
                -p.bps * p.G * p.NS, -p.G)

    return min(cands, key=cost)


@functools.lru_cache(maxsize=16)
def device_sms(index: int) -> int:
    """SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    from . import _build

    lib = _build.load("time_power")
    if not getattr(lib, "_zrt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.zrt_time_power.restype = i
        lib.zrt_time_power.argtypes = [
            p, p, p, p, p, p, p, p,                # s w bases sj ptr idx val out
            i, i, i, i, i, i, i, i, i,             # BP M N NL lpad TK DP tile_d tau_min
            i, i, i, i, i, i,                      # Tc JM G NS MG NI
            ctypes.c_float, i, p]                  # inv bf16 stream
        lib.zrt_time_power_smem.restype = ctypes.c_long
        lib.zrt_time_power_smem.argtypes = [i] * 9
        lib.zrt_cuda_error_string.restype = ctypes.c_char_p
        lib.zrt_cuda_error_string.argtypes = [i]
        lib._zrt_typed = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_power: {msg}")


def fused_power_plain(s, w, bases, sj, wc, *, tau_min: int, tile_d: int,
                      inv: float, lpad: int, n_samples: int) -> torch.Tensor:
    """Plain-torch version of the kernel, same inputs and layout, FP32.

    Tap t of a mic reads its padded row from ``lpad - tau_min - t`` on,
    as the kernel does; the corrections are
    :func:`~.equiv_kernel.corrections_plain` of the list.  bf16 operands
    are widened to FP32 first, which is the kernel's arithmetic (bf16
    operands, FP32 sums)."""
    set_fp32_matmul()
    BP, M, NL = s.shape
    K, DP = w.shape
    TK, N = K // M, n_samples
    wf = w.float()
    T_all = int(bases.max()) + TK
    starts = lpad - tau_min - torch.arange(T_all, device=s.device)
    _check(int(starts.min()) >= 0 and int(starts.max()) + N <= NL,
           "the padded rows do not hold every shifted read")
    full = s.float().unfold(2, N, 1)[:, :, starts]          # (BP, M, T_all, N)
    jj = torch.arange(TK, device=s.device)
    tiles = []
    for i in range(DP // tile_d):
        idx = (bases[i].long()[:, None] + jj[None, :])      # (M, TK)
        win = torch.gather(full, 2, idx[None, :, :, None].expand(
            BP, M, TK, N))
        tiles.append(win.reshape(BP, K, N).transpose(1, 2)
                     @ wf[:, i * tile_d:(i + 1) * tile_d])
    beams = torch.cat(tiles, dim=2)                          # (BP, N, DP)
    if wc is not None:
        Tc = (wc.ptr.numel() - 1) // DP
        v = corrections_plain(sj, wc, Tc, DP).permute(1, 0, 2)
        beams = torch.cat([beams[:, :Tc] - v, beams[:, Tc:]], dim=1)
    return torch.sum(beams * beams, dim=1) * inv


def fused_power(s, w, bases, sj, wc, *, tau_min: int, tile_d: int,
                inv: float, lpad: int, n_samples: int) -> torch.Tensor:
    """Fused time-domain power, (BP, DP) float32.

    On CPU tensors this is :func:`fused_power_plain`.  On CUDA tensors it
    launches the ``sm_90a`` kernel on :func:`plan`'s blocks (``plan(N, M,
    TK, DP, BP, NL, itemsize, JM, Tc, device_sms(index))``) or raises;
    there is no fallback.  ``fused_power.launches`` counts the kernel
    launches."""
    if s.device.type == "cpu":
        return fused_power_plain(s, w, bases, sj, wc, tau_min=tau_min,
                                 tile_d=tile_d, inv=inv, lpad=lpad,
                                 n_samples=n_samples)
    _check(s.device.type == "cuda", f"unsupported device {s.device}")
    dev = s.device
    _check(s.ndim == 3, "s must be (BP, M, NL)")
    BP, M, NL = s.shape
    N = int(n_samples)
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
    Tc = JM = 0
    if wc is not None or sj is not None:
        _check(isinstance(wc, HeadCorrections)
               and wc.ptr.dtype == torch.int32 and wc.idx.dtype == torch.int32
               and wc.val.dtype == torch.float32 and wc.idx.ndim == 1
               and wc.val.shape == wc.idx.shape and wc.ptr.ndim == 1
               and (wc.ptr.numel() - 1) % DP == 0,
               "wc must be HeadCorrections of int32 ptr (DP*Tc + 1,) and "
               "idx, float32 val of one length")
        _check(sj is not None and sj.dtype == torch.float32 and sj.ndim == 2
               and sj.shape[0] == BP, "sj must be float32 (BP, J*M) with wc")
        Tc, JM = (wc.ptr.numel() - 1) // DP, sj.shape[1]
        _check(Tc <= N, f"corrections span {Tc} samples, more than {N}")
        tensors += [sj, *wc]
    _check(all(t.device == dev for t in tensors),
           "all tensors must be on one device")
    _check(all(t.is_contiguous() for t in tensors),
           "all tensors must be contiguous")
    _check(s.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
           "s and w must be 16-byte aligned")
    isz = s.element_size()
    p = plan(N, M, TK, DP, BP, NL, isz, JM, Tc,
             device_sms(dev.index if dev.index is not None
                        else torch.cuda.current_device()))
    _check(0 <= lpad and lpad - tau_min - TK + 1 >= 0
           and NL >= lpad - tau_min + sample_cover(N, p.NS, p.NI)
           and NL * isz % 16 == 0,
           f"s rows (NL={NL}, lpad={lpad}) must hold every shifted read "
           f"(row_layout)")
    lib = _lib()
    out = torch.empty((BP, DP), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zrt_time_power(
            s.data_ptr(), w.data_ptr(), bases.data_ptr(),
            sj.data_ptr() if Tc else None,
            wc.ptr.data_ptr() if Tc else None,
            wc.idx.data_ptr() if Tc else None,
            wc.val.data_ptr() if Tc else None, out.data_ptr(),
            BP, M, N, NL, int(lpad), TK, DP, tile_d, int(tau_min), Tc, JM,
            p.G, p.NS, p.MG, p.NI, float(inv), int(s.dtype == torch.bfloat16),
            stream)
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
    The tap windows are planned at ``tile_d`` directions (8/16/32; 8 is
    one warp's tile, :func:`_window_plan`).  ``mode`` follows the tables:
    ``bf16`` for bf16 weights, else ``high`` or ``f32`` (the same FP32
    arithmetic).  The class holds the windowed weights, their bases and
    the sparse correction list (:attr:`table_bytes`).
    """

    def __init__(self, t, tile_d: int = 8):
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
        self.Tc = 0 if t.Wc is None else t.Wc.shape[2]
        self.JM = len(t.corr_js) * M if self.Tc else 0
        self.tau_min = t.tau_min
        self.res_x, self.res_y = t.res_x, t.res_y
        bases, self.TK = _window_plan(t.W.float().cpu().numpy(), tile_d)
        self.bases = torch.from_numpy(bases).to(self.device)
        self.Wp = _prep_weights(t.W, self.bases, self.TK, tile_d, self.DP,
                                self.plane_dtype)
        self.lpad, self.NL = row_layout(t.tau_min, T, N)
        self.wc = (make_head_corrections(t.Wc, self.DP) if self.Tc
                   else None)
        self._js = torch.tensor(t.corr_js, dtype=torch.long,
                                device=self.device)
        # the Hopper plan of one frame on a 132-SM card; raises here, not
        # at the first call, if no block fits
        plan(N, M, self.TK, self.DP, 1, self.NL,
             self.Wp.element_size(), self.JM, self.Tc)
        ident = torch.arange(M, device=self.device)
        # identity active-mic set -> slice the leading M rows, no gather
        self.adaptive = (None if torch.equal(t.adaptive, ident)
                         else t.adaptive)
        self.inv = float(np.float32(1.0 / (N * M * M)))
        self.kernel_kw = dict(tau_min=self.tau_min, tile_d=tile_d,
                              inv=self.inv, lpad=self.lpad, n_samples=N)

    @property
    def table_bytes(self) -> int:
        """Bytes of the tables the class holds on its device."""
        ts = [self.Wp, self.bases] + (list(self.wc) if self.wc else [])
        return sum(t.numel() * t.element_size() for t in ts)

    def launch_plan(self, B: int) -> Plan:
        """The :class:`Plan` :func:`fused_power` launches for ``B`` frames
        on the class's CUDA device."""
        index = (self.device.index if self.device.index is not None
                 else torch.cuda.current_device())
        return plan(self.N, self.M, self.TK, self.DP, B, self.NL,
                    self.Wp.element_size(), self.JM, self.Tc,
                    device_sms(index))

    def kernel_inputs(self, signals: torch.Tensor):
        """The forward's prologue: (B, C, N) frames -> ``(s, sj)``, the
        per-call kernel inputs: the active mics' padded rows in the plane
        dtype (:func:`row_layout`) and the correction sample columns
        ``sj[b, j*M + m] = s[b, m, corr_js[j]]`` in FP32 (None without
        corrections)."""
        sf = (signals[:, self.adaptive, :] if self.adaptive is not None
              else signals[:, :self.M, :]).float()
        s = F_.pad(sf.to(self.plane_dtype),
                   (self.lpad, self.NL - self.lpad - self.N)).contiguous()
        sj = (sf[:, :, self._js].transpose(1, 2).reshape(len(sf), self.JM)
              .contiguous() if self.Tc else None)
        return s, sj

    def __call__(self, signals) -> torch.Tensor:
        signals = torch.as_tensor(signals, device=self.device)
        squeeze = signals.ndim == 2
        if squeeze:
            signals = signals[None]
        B = signals.shape[0]
        with annotate("power.inputs"):
            s, sj = self.kernel_inputs(signals)
        with annotate("power.kernel"):
            power = fused_power(s, self.Wp, self.bases, sj, self.wc,
                                **self.kernel_kw)
        power = power[:, :self.D].reshape(B, self.res_x, self.res_y)
        return power[0] if squeeze else power
