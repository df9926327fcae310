"""Fused exact frequency-domain steered power: host class + CUDA kernels.

The plain formulation (:mod:`.freq_equiv`) materialises the steered
spectra ``Br/Bi`` — (B, D, F) tensors — and streams them again for the
Parseval sum and the tail/head inverse DFT.  K1 (``csrc/equiv_power.cu``)
has two routes.  In FP32, from ``SPLIT_MIN_FRAMES`` padded frames up, it
does the same in two hand-written kernels: the per-bin product streams the
plane into ``P``, then the fold and finish read ``P`` once
(:func:`split_plan`).  bf16 planes, and smaller FP32 batches, take the
fused kernel, which keeps ``Br/Bi`` on chip: a block owns a (frames x
directions) output tile, loops over every frequency bin, and folds both
reductions in while the per-bin products are live.  The source notes in
the ``.cu`` files say what bounds the kernels on the H100 and how the
design answers.

Layout the kernels take (:class:`FusedEquivBeamformer` builds it):

* ``S``   (F, BP, KS)         spectra, bin-major: ``[sr | si]``, each half
                               zero-padded to ``MP = KP / 2`` (K = 2M
                               padded to KP, a multiple of 128), each row
                               padded by 16 bytes to ``KS`` (shared-memory
                               banks);
* ``H1``  (DP/TD, F, KP, TD)   the one response plane ``sqrt(cf) * [H_re |
                               -H_im]``, direction-tile-major, so that one
                               block's tile of one bin is one contiguous
                               run (TD = 8 directions in FP32, 16 in bf16);
* ``ib1/ib2`` (F, TtA)         tail/head inverse-DFT bases / ``sqrt(cf)``,
                               rows padded with zeros to ``TtA``, Tt
                               rounded up to 4 (16-byte bulk copies);
* ``sj``  (BP, J*M)            head-correction sample columns, and
  ``wc``  :class:`HeadCorrections`, the nonzero weights of ``Wc`` as a
                               CSR over rows ``d * Tc + c`` (both None
                               without corrections);
* output  (BP, DP)             float32 power.

Per bin, ``Br = [sr | si] . H1`` and ``Bi = [si | -sr] . H1``: one GEMM of
the 2B spectra rows with one plane.  The second row set is the first with
its halves swapped and one negated, so it is never stored.

``sweep="fd"`` (the JAX package's direction-innermost order, TPU K5) cuts
the bins into ``n_fc`` chunks of ``fc`` (F zero-padded to ``FP = fc *
n_fc``) and runs ``csrc/equiv_power_fd.cu`` on the same inputs and the same
product core (``csrc/equiv_core.cuh``): a block stages one S chunk once and
sweeps a group of direction tiles, writing per-chunk partials that a second
kernel sums in chunk order.  An fd plan of one chunk runs K1, as the JAX
forward does.

Modes keep the JAX package's names and default rule: ``f32`` and ``high``
both run FP32 operands with FP32 sums on the CUDA cores (the TPU's 3-pass
bf16 hi/lo split was a workaround for a bf16-only matrix unit and is not
ported); ``bf16`` takes bf16 S/H planes and runs the product on the tensor
cores with FP32 sums.  The tail/head term is FP32 in every mode.

Ported from ``zybo_rt_sampler_image_detection_tpu/ops/equiv_kernel.py``
(``FusedEquivBeamformer``, ``_equiv_forward_flat``); the v5e VMEM tile
planner is replaced by a plan for the H100's 227 KB of shared memory per
block and the occupancy the runtime reports.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.profiling import annotate
from .beamform import set_fp32_matmul
from .freq_equiv import EquivFreqTables, make_equiv_tables

# tile constants of csrc/equiv_core.cuh: the stacked-mic axis pads to a
# multiple of K_ALIGN, the direction axis to D_ALIGN (a multiple of both
# direction tiles)
K_ALIGN = 128
D_ALIGN = 16
FRAME_TILES = (16, 8, 4, 2, 1)
SMEM_MAX = 232448          # dynamic shared memory one H100 block can opt into
FD_MAX_CHUNKS = 32
MAX_STAGES = 8             # ring stages of H tiles a block may keep
FCB = 4                    # bins folded per tail/head pass
# frames' worth of work a block's H tile costs, in the frame-tile choice:
# a block's time goes as (frame tile + FRAME_COST_H)
FRAME_COST_H = 8
# the FP32 route in two passes (csrc/equiv_power.cu): k pairs a ring stage
# holds, consumer warps a product block may take, tail/head samples a fold
# warp owns, warps a fold block may take, bins a fold stage holds and the
# stages in flight
SPLIT_KC = 16
SPLIT_WARPS = (2, 3, 4)
SPLIT_STAGES = 2
# the fewest padded frames that take the two passes: below 8 the fused
# kernel is faster at the 192-channel shape (measured, PERF.md)
SPLIT_MIN_FRAMES = 8
FOLD_TQ = 8
FOLD_MAX_WARPS = 16
FOLD_FC = 8
FOLD_STAGES = 4

_MODES = ("high", "bf16", "f32")


class HeadCorrections(NamedTuple):
    """The nonzero head-correction weights, a CSR over rows ``d * Tc + c``
    (direction d < DP, correction column c < Tc): row r's entries are
    ``ptr[r]:ptr[r + 1]``, each a column ``idx`` of the sj rows (``j * M +
    m``) and its weight ``val``."""

    ptr: torch.Tensor          # (DP * Tc + 1,) int32
    idx: torch.Tensor          # (nnz,) int32
    val: torch.Tensor          # (nnz,) float32


def make_head_corrections(Wc: torch.Tensor, DP: int) -> HeadCorrections:
    """The list of the nonzero entries of ``Wc`` (J, D, Tc, M), rows
    ``d * Tc + c`` for d < DP (the padded directions have none), each row's
    entries in column order."""
    J, D, Tc, M = Wc.shape
    w = Wc.permute(1, 2, 0, 3).reshape(D * Tc, J * M)
    rows, cols = torch.nonzero(w, as_tuple=True)           # row-major order
    counts = torch.bincount(rows, minlength=DP * Tc)
    ptr = torch.zeros(DP * Tc + 1, dtype=torch.int64, device=Wc.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return HeadCorrections(ptr.to(torch.int32).contiguous(),
                           cols.to(torch.int32).contiguous(),
                           w[rows, cols].float().contiguous())


def tile_d(dtype: torch.dtype) -> int:
    """Directions per tile of the plane type (``Plane<T>::TD``)."""
    return 16 if dtype == torch.bfloat16 else 8


def row_pad(dtype: torch.dtype) -> int:
    """Elements that pad each spectra row by 16 bytes (``KPAD``)."""
    return 16 // (2 if dtype == torch.bfloat16 else 4)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _warps(bt: int, fd: bool) -> int:
    """Warps a block (``k1_threads`` / ``fd_threads`` in equiv_core.cuh):
    16 where one block fills an SM (K1 at frame tile 16, the fd chunk
    kernel from tile 8 up), else 8."""
    return 16 if bt >= (8 if fd else 16) else 8


def _k_split(itemsize: int, bt: int, warps: int) -> int:
    """Warps that split K (``k_split`` in equiv_core.cuh): bf16 splits the
    2*bt rows in tiles of 8 among warps first."""
    return warps // ((2 * bt + 7) // 8) if itemsize == 2 else warps


def smem_bytes(bt: int, Tt: int, KP: int, JM: int, itemsize: int,
               stages: int = 2, fc: int = 0) -> int:
    """Shared memory of one block of frame tile ``bt`` (mirrors
    ``layout`` in csrc/equiv_core.cuh): mbarriers; K1 (``fc == 0``): the
    ring of ``stages`` (S rows, H tile) stages, at least the sj rows; K5:
    the S chunk of ``fc`` bins and a ring of ``stages`` H tiles; then the
    tail/head accumulators, the warps' partials, the reduced Br/Bi rows
    and the bases of two fold chunks."""
    td = 16 if itemsize == 2 else 8
    s_bin = bt * (KP + 16 // itemsize) * itemsize
    h_tile = KP * td * itemsize
    if fc == 0:
        area0 = max(stages * (s_bin + h_tile), bt * JM * 4)
    else:
        area0 = fc * s_bin + stages * h_tile
    th = 128 + _round_up(area0, 128)
    red = th + _round_up(Tt * bt * td * 4, 128)
    ksplit = _k_split(itemsize, bt, _warps(bt, fc > 0))
    brbi = red + _round_up(2 * ksplit * 2 * bt * td * 4, 128)
    ibs = brbi + _round_up(2 * FCB * 2 * bt * td * 4, 128)
    return ibs + 2 * 2 * FCB * _round_up(Tt, 4) * 4


def smem_bytes_fd(bt: int, fc: int, Tt: int, KP: int, itemsize: int,
                  stages: int = 2) -> int:
    """Shared memory one fd chunk-kernel block needs: its S chunk of
    ``fc`` bins in the plane type, a ring of ``stages`` H tiles, then the
    working set."""
    return smem_bytes(bt, Tt, KP, 0, itemsize, stages, fc)


def fd_chunks(F: int, Tt: int, KP: int, itemsize: int, bt: int = 8) -> int:
    """The Hopper fd plan: the fewest frequency chunks whose staged S
    chunk, a two-stage H ring and the working set fit one block of frame
    tile ``bt``.  Raises ``ValueError`` past ``FD_MAX_CHUNKS``, which
    bounds the partial buffers (``n_fc * (Tt + 1) * DP`` floats a
    frame)."""
    for n_fc in range(1, FD_MAX_CHUNKS + 1):
        if smem_bytes_fd(bt, -(-F // n_fc), Tt, KP, itemsize) <= SMEM_MAX:
            return n_fc
    raise ValueError(f"equiv kernel: no fd shared-memory plan for F={F} "
                     f"Tt={Tt} KP={KP} in {FD_MAX_CHUNKS} chunks")


@functools.lru_cache(maxsize=64)
def dir_groups(n_bt: int, n_fc: int, n_tiles: int, slots: int) -> int:
    """Direction groups of an fd launch whose blocks fill ``slots`` places
    at once (SMs x the blocks an SM holds).  A block's time goes as its
    tiles, and the launch's as the waves of blocks times that: the fewest
    groups that minimise waves x tiles a group.  One frame and few chunks
    alone would leave most SMs idle; a last wave of a few blocks would
    double the time."""
    slots = max(1, slots)

    def cost(n_dg):
        return -(-n_bt * n_fc * n_dg // slots) * -(-n_tiles // n_dg)

    return min(range(1, n_tiles + 1), key=lambda n: (cost(n), n))


def make_plane(H: torch.Tensor, scale: torch.Tensor, KP: int, DP: int,
               FP: int, td: int) -> torch.Tensor:
    """The one response plane from the (D, M, F) complex response:
    ``scale * [H_re | -H_im]`` (halves padded to ``KP / 2``), bins padded
    to FP and directions to DP, laid out direction-tile-major (DP/td, FP,
    KP, td), in the real dtype of ``H``."""
    D, M, Fb = H.shape
    MP = KP // 2
    h = torch.zeros((FP, KP, DP), dtype=H.real.dtype, device=H.device)
    h[:Fb, :M, :D] = (H.real * scale).permute(2, 1, 0)
    h[:Fb, MP:MP + M, :D] = (-H.imag * scale).permute(2, 1, 0)
    return h.reshape(FP, KP, DP // td, td).permute(2, 0, 1, 3).contiguous()


def make_spectra(spec: torch.Tensor, FP: int, BP: int, KP: int,
                 KS: int) -> torch.Tensor:
    """The spectra rows (FP, BP, KS) from (F, B, M) complex bins:
    ``[sr | si]``, each half padded to ``KP / 2``, zero rows and bins past
    B and F, in the real dtype of ``spec``."""
    Fb, B, M = spec.shape
    MP = KP // 2
    S = torch.zeros((FP, BP, KS), dtype=spec.real.dtype, device=spec.device)
    S[:Fb, :B, :M] = spec.real
    S[:Fb, :B, MP:MP + M] = spec.imag
    return S


class SplitPlan(NamedTuple):
    """A launch of K1's FP32 route in two passes (:func:`split_plan`)."""

    fb: int                    # frames a product block (divides BP)
    nc: int                    # consumer warps a product block
    stages: int                # ring stages a product block
    smem: int                  # shared memory of a product block, bytes
    product_grid: tuple        # (frame groups, direction groups, bins)
    oq: int                    # frames a fold block (divides BP)
    nw: int                    # warps a fold block
    fold_smem: int             # shared memory of a fold block, bytes
    fold_grid: tuple           # (direction groups of 32, frame groups)
    p_shape: tuple             # P, in the order the fold reads it


def split_smem_bytes(fb: int, nc: int, stages: int) -> int:
    """Shared memory of one product block (mirrors ``split_smem`` in
    csrc/equiv_power.cu): 128 bytes of mbarriers, then ``stages`` ring
    stages, each the ``fb`` frames' spectra for ``SPLIT_KC`` k pairs
    (``[sr | si]``) and ``8 * nc`` direction-tile slices of ``SPLIT_KC``
    rows of each half, padded by 8 floats."""
    stage = fb * 2 * SPLIT_KC + nc * 8 * (16 * SPLIT_KC + 8)
    return 128 + stages * stage * 4


def fold_smem_bytes(oq: int, Tt: int, Tc: int, JM: int) -> int:
    """Shared memory of one fold block (mirrors ``fold_layout`` in
    csrc/equiv_power.cu): the mbarriers, ``FOLD_STAGES`` stages of
    ``FOLD_FC`` bins (the block's Br/Bi rows and the bases), the head
    corrections, each warp's row pointers of the list, and the warps' sums
    (before them, the frames' sj rows)."""
    nw = -(-Tt // FOLD_TQ)
    stage = _round_up(FOLD_FC * (2 * oq * 32 + 2 * _round_up(Tt, 4)) * 4, 128)
    v = 128 + FOLD_STAGES * stage
    rp = v + _round_up(Tc * oq * 32 * 4, 128)
    red = rp + _round_up(nw * (Tc + 1) * 4, 128)
    return red + max(nw * oq * 32, oq * JM) * 4


@functools.lru_cache(maxsize=64)
def split_plan(F: int, BP: int, KP: int, DP: int, Tt: int, Tc: int,
               JM: int) -> SplitPlan:
    """The plan of K1's FP32 route for its shapes alone.  Product: the
    largest frame group (of 16, 8, 4, 2, 1) dividing BP; the consumer warps
    (64 directions each) that leave the fewest idle on the last direction
    group; a ring of ``SPLIT_STAGES`` (measured: a deeper ring costs
    blocks an SM, and is slower).  Fold: 4, 2 or 1 frames a block, one warp
    for each ``FOLD_TQ`` tail/head samples.  Raises ``ValueError`` when Tt
    needs more than ``FOLD_MAX_WARPS`` warps (:func:`takes_split`)."""
    fb = next(b for b in FRAME_TILES if BP % b == 0)
    units = -(-DP // 64)
    nc = min(SPLIT_WARPS, key=lambda n: (-(-units // n) * n, -n))
    stages = SPLIT_STAGES
    oq = next(q for q in (4, 2, 1) if BP % q == 0)
    nw = -(-Tt // FOLD_TQ)
    if nw > FOLD_MAX_WARPS:
        raise ValueError(f"equiv_power: no fold plan for Tt={Tt} (at most "
                         f"{FOLD_TQ * FOLD_MAX_WARPS})")
    n_db = -(-DP // 32)
    return SplitPlan(fb, nc, stages, split_smem_bytes(fb, nc, stages),
                     (BP // fb, -(-(DP // 8) // (8 * nc)), F), oq, nw,
                     fold_smem_bytes(oq, Tt, Tc, JM), (n_db, BP // oq),
                     (n_db, BP // oq, F, 2, oq, 32))


# ---- plain versions ---------------------------------------------------------

def dense_plane(H1: torch.Tensor) -> torch.Tensor:
    """The direction-tile-major plane (DP/TD, F, KP, TD) as (F, KP, DP)."""
    n_dt, Fb, KP, td = H1.shape
    return H1.permute(1, 2, 0, 3).reshape(Fb, KP, n_dt * td)


def spectra_rows(S: torch.Tensor, KP: int) -> torch.Tensor:
    """The 2*BP rows of the one-plane product, (F, 2BP, KP): ``[sr | si]``
    (Br) then ``[si | -sr]`` (Bi)."""
    Sf = S[..., :KP]
    MP = KP // 2
    swapped = torch.cat([Sf[..., MP:], -Sf[..., :MP]], dim=-1)
    return torch.cat([Sf, swapped], dim=1)


def corrections_plain(sj: torch.Tensor, wc: HeadCorrections, Tc: int,
                      DP: int) -> torch.Tensor:
    """Head corrections ``v`` (Tc, BP, DP) from the sparse list, in the
    dtype of ``sj``: each row's entries summed into their (d, c) cell."""
    rows = torch.repeat_interleave(
        torch.arange(DP * Tc, device=sj.device),
        (wc.ptr[1:] - wc.ptr[:-1]).long())
    contrib = sj[:, wc.idx.long()] * wc.val.to(sj.dtype)      # (BP, nnz)
    v = torch.zeros((sj.shape[0], DP * Tc), dtype=sj.dtype, device=sj.device)
    v.index_add_(1, rows, contrib)
    return v.reshape(-1, DP, Tc).permute(2, 0, 1)


def _partials_plain(S, H1, ib1, ib2):
    """Parseval sum (BP, DP) and tail/head samples (Tt, BP, DP) over the
    bins of ``S``, FP32 (bf16 planes widened first: the kernels'
    arithmetic is bf16 operands, FP32 sums): one ``torch.bmm`` of the 2BP
    spectra rows with the one plane."""
    BP = S.shape[1]
    H = dense_plane(H1).float()
    P = torch.bmm(spectra_rows(S, H.shape[1]).float(), H)         # (F, 2BP, DP)
    Br, Bi = P[:, :BP], P[:, BP:]
    power = torch.sum(Br * Br + Bi * Bi, dim=0)
    TH = (torch.einsum("ft,fbd->tbd", ib1, Br)
          + torch.einsum("ft,fbd->tbd", ib2, Bi))                  # (Tt, BP, DP)
    return power, TH


def _finish_plain(power, TH, sj, wc, *, n_tail: int, Tc: int,
                  inv: float) -> torch.Tensor:
    """Subtract the tails, add the head corrections, scale."""
    power = power - torch.sum(TH[:n_tail] ** 2, dim=0)
    if Tc:
        v = corrections_plain(sj, wc, Tc, power.shape[1])          # (Tc, BP, DP)
        power = power + torch.sum(v * v - 2.0 * TH[n_tail:n_tail + Tc] * v,
                                  dim=0)
    return power * inv


def equiv_power_plain(S, H1, ib1, ib2, sj, wc, *, n_tail: int, Tc: int,
                      inv: float) -> torch.Tensor:
    """Plain-torch version of K1, same inputs and layout, FP32."""
    set_fp32_matmul()
    power, TH = _partials_plain(S, H1, ib1, ib2)
    return _finish_plain(power, TH, sj, wc, n_tail=n_tail, Tc=Tc, inv=inv)


def equiv_power_fd_plain(S, H1, ib1, ib2, sj, wc, *, n_tail: int, Tc: int,
                         inv: float, n_fc: int) -> torch.Tensor:
    """Plain-torch version of the fd kernel: the partials of each of the
    ``n_fc`` frequency chunks (``torch.bmm`` at FP32, TF32 off), summed in
    chunk order, then K1's finish.  The same function as
    :func:`equiv_power_plain` with the bin sum cut where the kernel cuts
    it."""
    set_fp32_matmul()
    fc = S.shape[0] // n_fc
    power = TH = None
    for c in range(n_fc):
        sl = slice(c * fc, (c + 1) * fc)
        p, th = _partials_plain(S[sl], H1[:, sl], ib1[sl], ib2[sl])
        power, TH = (p, th) if c == 0 else (power + p, TH + th)
    return _finish_plain(power, TH, sj, wc, n_tail=n_tail, Tc=Tc, inv=inv)


# ---- the kernels' wrappers ----------------------------------------------------

def _lib(name: str):
    from . import _build

    lib = _build.load(name)
    if not getattr(lib, "_zrt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "equiv_power":
            lib.zrt_equiv_power.restype = i
            lib.zrt_equiv_power.argtypes = [
                p, p, p, p, p, p, p, p, p,          # S H1 ib1 ib2 sj ptr idx val out
                i, i, i, i, i, i, i, i, i,          # F BP KP DP TtP n_tail Tc JM NS
                ctypes.c_float, i, i, p]            # inv bf16 bt stream
            lib.zrt_equiv_power_blocks_per_sm.restype = i
            lib.zrt_equiv_power_blocks_per_sm.argtypes = [i] * 6
            lib.zrt_equiv_power_tensor_cores.restype = i
            lib.zrt_equiv_power_tensor_cores.argtypes = [i]
            lib.zrt_equiv_power_split.restype = i
            lib.zrt_equiv_power_split.argtypes = [
                p, p, p, p, p, p, p, p, p, p,       # S H1 ib1 ib2 sj ptr idx val P out
                i, i, i, i, i, i, i, i,             # F BP KP DP TtP n_tail Tc JM
                ctypes.c_float, i, i, i, i, p]      # inv fb nc ns oq stream
        else:
            lib.zrt_equiv_power_fd.restype = i
            lib.zrt_equiv_power_fd.argtypes = [
                p, p, p, p, p, p, p, p,             # S H1 ib1 ib2 sj ptr idx val
                p, p, p,                            # pow_part th_part out
                i, i, i, i, i, i, i, i,             # FP BP KP DP TtP n_tail Tc JM
                i, i, i, ctypes.c_float, i, i, p]   # n_fc n_dg NS inv bf16 bt stream
            lib.zrt_equiv_power_fd_blocks_per_sm.restype = i
            lib.zrt_equiv_power_fd_blocks_per_sm.argtypes = [i] * 6
        lib.zrt_cuda_error_string.restype = ctypes.c_char_p
        lib.zrt_cuda_error_string.argtypes = [i]
        lib._zrt_typed = True
    return lib


SPLIT_ROUTE = ("CUDA cores (FP32 FMA), two passes: the per-bin product, "
               "then the fold and finish")


def takes_split(dtype: torch.dtype, Tt: int, BP: int) -> bool:
    """Whether K1 takes the two passes: FP32 planes, from
    ``SPLIT_MIN_FRAMES`` padded frames up, whose tail/head samples one fold
    block's warps cover.  bf16 planes, and the other FP32 calls, take the
    fused kernel."""
    return (dtype == torch.float32 and BP >= SPLIT_MIN_FRAMES
            and Tt <= FOLD_TQ * FOLD_MAX_WARPS)


def route(dtype: torch.dtype, Tt: Optional[int] = None,
          BP: Optional[int] = None) -> str:
    """Where the product of this plane type runs, as the compiled library
    reports it (builds it on first use): bf16 on the tensor cores, FP32 on
    the CUDA cores; given K1's tail/head count ``Tt`` and padded frames
    ``BP``, FP32 in K1's two passes where :func:`takes_split`."""
    tc = _lib("equiv_power").zrt_equiv_power_tensor_cores(
        int(dtype == torch.bfloat16))
    if tc:
        return "tensor cores (mma.sync m16n8k16 bf16, FP32 sums)"
    if Tt is not None and BP is not None and takes_split(dtype, Tt, BP):
        return SPLIT_ROUTE
    return "CUDA cores (FP32 FMA)"


def _check(cond: bool, msg: str, name: str = "equiv_power") -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_inputs(name, S, H1, ib1, ib2, sj, wc, n_tail, Tc, block_b):
    """The checks both wrappers make on CUDA inputs; returns
    ``(F, BP, KP, DP, JM)``."""
    def check(cond, msg):
        _check(cond, msg, name)

    check(S.device.type == "cuda", f"unsupported device {S.device}")
    check(S.dtype in (torch.float32, torch.bfloat16),
          f"S dtype {S.dtype} (float32 or bfloat16)")
    check(H1.dtype == S.dtype, "S and H1 must share one dtype")
    td = tile_d(S.dtype)
    check(S.ndim == 3 and H1.ndim == 4 and H1.shape[3] == td
          and H1.shape[1] == S.shape[0]
          and S.shape[2] == H1.shape[2] + row_pad(S.dtype),
          f"S must be (F, BP, KP + {row_pad(S.dtype)}) and H1 (DP/{td}, F, "
          f"KP, {td})")
    Fb, BP = S.shape[:2]
    KP, DP = H1.shape[2], H1.shape[0] * td
    check(ib1.dtype == torch.float32 and ib1.shape[0] == Fb
          and ib2.shape == ib1.shape
          and ib1.shape[1] == _round_up(n_tail + Tc, 4),
          "ib1/ib2 must be float32 (F, n_tail + Tc rounded up to 4)")
    check(KP % K_ALIGN == 0, f"KP % {K_ALIGN} must be 0")
    check(block_b in FRAME_TILES and BP % block_b == 0,
          f"block_b must be one of {FRAME_TILES} and divide BP")
    tensors = [S, H1, ib1, ib2]
    if Tc:
        check(sj is not None and wc is not None,
              "sj and wc are required when Tc > 0")
        check(sj.dtype == torch.float32 and sj.ndim == 2
              and sj.shape[0] == BP, "sj must be float32 (BP, J*M)")
        check(isinstance(wc, HeadCorrections)
              and wc.ptr.dtype == torch.int32 and wc.idx.dtype == torch.int32
              and wc.val.dtype == torch.float32,
              "wc must be HeadCorrections of int32 ptr/idx and float32 val")
        check(wc.ptr.shape == (DP * Tc + 1,) and wc.idx.ndim == 1
              and wc.val.shape == wc.idx.shape,
              f"wc must hold ptr (DP*Tc + 1 = {DP * Tc + 1},) and idx/val "
              f"of one length")
        JM = sj.shape[1]
        tensors += [sj, *wc]
    else:
        JM = 0
    check(all(t.device == S.device for t in tensors),
          "all tensors must be on one device")
    check(all(t.is_contiguous() for t in tensors),
          "all tensors must be contiguous")
    check(S.data_ptr() % 16 == 0 and H1.data_ptr() % 16 == 0,
          "S and H1 must be 16-byte aligned")
    return Fb, BP, KP, DP, JM


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.zrt_cuda_error_string(err).decode()}")


_OCCUPANCY: dict = {}


def _blocks_per_sm(lib, fn: str, dev, *args) -> int:
    """Blocks of one kernel instantiation an SM of ``dev`` holds at once,
    as the runtime reports them (registers, shared memory and threads
    together); ``args`` are the C function's."""
    key = (fn, dev.index, args)
    if key not in _OCCUPANCY:
        with torch.cuda.device(dev):
            n = getattr(lib, fn)(*args)
        if n < 0:
            _raise_on(lib, -n, fn)
        _OCCUPANCY[key] = n
    return _OCCUPANCY[key]


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _k1_plan(dev, bf16: int, bt: int, Tt: int, KP: int, JM: int,
             n_blocks: int) -> tuple:
    """``(waves, stages)`` of a K1 launch: the ring depth that keeps the
    fewest waves of blocks and, among those, the most bytes in flight per
    SM (stages x the blocks an SM really gets)."""
    lib, sms, itemsize = _lib("equiv_power"), _sms(dev), 2 if bf16 else 4
    best = None
    for ns in range(2, MAX_STAGES + 1):
        if smem_bytes(bt, Tt, KP, JM, itemsize, ns) > SMEM_MAX:
            break
        bps = _blocks_per_sm(lib, "zrt_equiv_power_blocks_per_sm", dev,
                             bf16, bt, Tt, KP, JM, ns)
        if bps == 0:
            continue
        waves = -(-n_blocks // (bps * sms))
        key = (waves, -min(bps, -(-n_blocks // sms)) * ns)
        if best is None or key < best[0]:
            best = (key, ns)
    if best is None:
        raise RuntimeError(f"equiv_power: no SM holds a block of frame tile "
                           f"{bt}")
    return best[0][0], best[1]


def _fd_plan(dev, bf16: int, bt: int, KP: int, fc: int, Tt: int, n_bt: int,
             n_fc: int, n_tiles: int) -> tuple:
    """``(cost, stages, n_dg)`` of an fd launch: for each ring depth, the
    direction groups that fill the card (:func:`dir_groups`); cost = waves
    x tiles a block; the ring depth of the least cost and, among those,
    the most bytes in flight per SM."""
    lib, sms, itemsize = _lib("equiv_power_fd"), _sms(dev), 2 if bf16 else 4
    best = None
    for ns in range(2, MAX_STAGES + 1):
        if smem_bytes_fd(bt, fc, Tt, KP, itemsize, ns) > SMEM_MAX:
            break
        bps = _blocks_per_sm(lib, "zrt_equiv_power_fd_blocks_per_sm", dev,
                             bf16, bt, KP, fc, Tt, ns)
        if bps == 0:
            continue
        slots = bps * sms
        n_dg = dir_groups(n_bt, n_fc, n_tiles, slots)
        nb = n_bt * n_fc * n_dg
        cost = -(-nb // slots) * -(-n_tiles // n_dg)
        key = (cost, -min(bps, -(-nb // sms)) * ns)
        if best is None or key < best[0]:
            best = (key, ns, n_dg)
    if best is None:
        raise RuntimeError(f"equiv_power_fd: no SM holds a block of frame "
                           f"tile {bt} with {fc} bins a chunk")
    return best[0][0], best[1], best[2]


def _fused(lib, S, H1, ib1, ib2, sj, wc, out, *, n_tail, Tc, inv, block_b,
           stages, dims) -> int:
    """One launch of the fused kernel (the bf16 route) into ``out``."""
    Fb, BP, KP, DP, JM = dims
    bf16 = int(S.dtype == torch.bfloat16)
    Tt = n_tail + Tc
    if stages is None:
        stages = _k1_plan(S.device, bf16, block_b, Tt, KP, JM,
                          BP // block_b * (DP // tile_d(S.dtype)))[1]
    _check(2 <= stages <= MAX_STAGES
           and smem_bytes(block_b, Tt, KP, JM, S.element_size(), stages)
           <= SMEM_MAX,
           f"block_b={block_b} with {stages} stages needs more than "
           f"{SMEM_MAX} B shared memory")
    stream = torch.cuda.current_stream(S.device).cuda_stream
    return lib.zrt_equiv_power(
        S.data_ptr(), H1.data_ptr(), ib1.data_ptr(), ib2.data_ptr(),
        sj.data_ptr() if Tc else None, wc.ptr.data_ptr() if Tc else None,
        wc.idx.data_ptr() if Tc else None, wc.val.data_ptr() if Tc else None,
        out.data_ptr(), Fb, BP, KP, DP, ib1.shape[1], n_tail, Tc, JM, stages,
        float(inv), bf16, block_b, stream)


def _split(lib, S, H1, ib1, ib2, sj, wc, out, *, n_tail, Tc, inv, stages,
           dims) -> int:
    """The FP32 route's two launches into ``out``, through ``P``
    (:attr:`SplitPlan.p_shape`: direction blocks of 32, frame groups of the
    fold, bins, Br/Bi, frames, directions), allocated here and read by the
    second launch on the same stream."""
    Fb, BP, KP, DP, JM = dims
    plan = split_plan(Fb, BP, KP, DP, n_tail + Tc, Tc, JM)
    ns = plan.stages if stages is None else stages
    _check(2 <= ns <= MAX_STAGES
           and split_smem_bytes(plan.fb, plan.nc, ns) <= SMEM_MAX,
           f"{ns} ring stages of the product pass need more than "
           f"{SMEM_MAX} B shared memory")
    P = torch.empty(plan.p_shape, dtype=torch.float32, device=S.device)
    stream = torch.cuda.current_stream(S.device).cuda_stream
    return lib.zrt_equiv_power_split(
        S.data_ptr(), H1.data_ptr(), ib1.data_ptr(), ib2.data_ptr(),
        sj.data_ptr() if Tc else None, wc.ptr.data_ptr() if Tc else None,
        wc.idx.data_ptr() if Tc else None, wc.val.data_ptr() if Tc else None,
        P.data_ptr(), out.data_ptr(), Fb, BP, KP, DP, ib1.shape[1], n_tail,
        Tc, JM, float(inv), plan.fb, plan.nc, ns, plan.oq, stream)


def equiv_power(S, H1, ib1, ib2, sj, wc, *, n_tail: int, Tc: int,
                inv: float, block_b: int = 1,
                stages: Optional[int] = None) -> torch.Tensor:
    """Fused equiv power (K1), (BP, DP) float32.

    On CPU tensors this is :func:`equiv_power_plain`.  On CUDA tensors it
    launches the ``sm_90a`` kernels or raises; there is no fallback.  FP32
    planes take two kernels (:func:`takes_split`): the per-bin product into
    ``P`` (Br and Bi of every bin, frame and direction), then the fold and
    finish (:func:`split_plan`).  bf16 planes, and FP32 below
    ``SPLIT_MIN_FRAMES`` padded frames, take the fused kernel (frame tile
    ``block_b``).  ``stages`` fixes the ring depth of the product pass or
    the fused kernel, by default planned.
    ``equiv_power.launches`` counts the calls; ``equiv_power.last_route``
    says where the last one computed (:func:`route`)."""
    if S.device.type == "cpu":
        return equiv_power_plain(S, H1, ib1, ib2, sj, wc, n_tail=n_tail,
                                 Tc=Tc, inv=inv)
    dims = _check_inputs("equiv_power", S, H1, ib1, ib2, sj, wc, n_tail, Tc,
                         block_b)
    lib = _lib("equiv_power")
    out = torch.empty((dims[1], dims[3]), dtype=torch.float32,
                      device=S.device)
    kw = dict(n_tail=n_tail, Tc=Tc, inv=inv, stages=stages, dims=dims)
    with torch.cuda.device(S.device):
        if takes_split(S.dtype, n_tail + Tc, dims[1]):
            err = _split(lib, S, H1, ib1, ib2, sj, wc, out, **kw)
        else:
            err = _fused(lib, S, H1, ib1, ib2, sj, wc, out, block_b=block_b,
                         **kw)
    _raise_on(lib, err, "equiv_power")
    equiv_power.launches += 1
    equiv_power.last_route = route(S.dtype, n_tail + Tc, dims[1])
    return out


equiv_power.launches = 0
equiv_power.last_route = None


def equiv_power_fd(S, H1, ib1, ib2, sj, wc, *, n_tail: int, Tc: int,
                   inv: float, n_fc: int, block_b: int = 1) -> torch.Tensor:
    """Fused equiv power in the direction-innermost order (TPU K5),
    (BP, DP) float32: the bins of ``S`` (FP of them) cut into ``n_fc``
    chunks.

    On CPU tensors this is :func:`equiv_power_fd_plain`.  On CUDA tensors
    it launches ``csrc/equiv_power_fd.cu`` (the chunk kernel, then the
    finish kernel, on the current stream) or raises; there is no
    fallback, to K1 or to the plain version.  ``equiv_power_fd.launches``
    counts the launches."""
    name = "equiv_power_fd"
    if S.device.type == "cpu":
        return equiv_power_fd_plain(S, H1, ib1, ib2, sj, wc, n_tail=n_tail,
                                    Tc=Tc, inv=inv, n_fc=n_fc)
    FP, BP, KP, DP, JM = _check_inputs(name, S, H1, ib1, ib2, sj, wc,
                                       n_tail, Tc, block_b)
    _check(1 <= n_fc <= FD_MAX_CHUNKS and FP % n_fc == 0,
           f"n_fc must be in 1..{FD_MAX_CHUNKS} and divide F={FP}", name)
    Tt, fc = n_tail + Tc, FP // n_fc
    bf16 = int(S.dtype == torch.bfloat16)
    td = tile_d(S.dtype)
    _check(smem_bytes_fd(block_b, fc, Tt, KP, S.element_size())
           <= SMEM_MAX, f"block_b={block_b} with {fc} bins a chunk needs "
           f"more than {SMEM_MAX} B shared memory", name)
    dev = S.device
    lib = _lib(name)
    _, ns, n_dg = _fd_plan(dev, bf16, block_b, KP, fc, Tt, BP // block_b,
                           n_fc, DP // td)
    # the chunks' partials, the port's form of the TPU's aliased pow0/th0
    # windows; the finish kernel reads them on the same stream
    pow_part = torch.empty((n_fc, DP // td, BP, td), dtype=torch.float32,
                           device=dev)
    th_part = torch.empty((n_fc, Tt, DP // td, BP, td), dtype=torch.float32,
                          device=dev)
    out = torch.empty((BP, DP), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zrt_equiv_power_fd(
            S.data_ptr(), H1.data_ptr(), ib1.data_ptr(), ib2.data_ptr(),
            sj.data_ptr() if Tc else None,
            wc.ptr.data_ptr() if Tc else None,
            wc.idx.data_ptr() if Tc else None,
            wc.val.data_ptr() if Tc else None, pow_part.data_ptr(),
            th_part.data_ptr(), out.data_ptr(),
            FP, BP, KP, DP, ib1.shape[1], n_tail, Tc, JM, n_fc, n_dg, ns,
            float(inv), bf16, block_b, stream)
    _raise_on(lib, err, name)
    equiv_power_fd.launches += 1
    return out


equiv_power_fd.launches = 0


class FusedEquivBeamformer:
    """Fused-kernel twin of ``freq_equiv.equiv_steered_power``.

    Usage::

        fused = FusedEquivBeamformer(tables)      # SteeringTables
        power = fused(frames)                     # (B, X, Y) or (X, Y)

    ``mode`` (default from the tables' precision: ``high`` -> ``high``,
    ``highest`` -> ``f32``, else ``bf16``):

    * ``"f32"`` / ``"high"`` — FP32 planes and sums (~1e-6 class);
    * ``"bf16"`` — bf16 spectra and plane on the tensor cores, FP32 sums
      (~4e-3 class).

    ``sweep``: ``"df"`` (K1: a block loops over every bin of its direction
    tile) or ``"fd"`` (direction innermost: :func:`equiv_power_fd` over
    ``n_fc`` frequency chunks).  ``plan_override=(frame tile, n_fc)``, the
    JAX keyword, caps the frame tile and fixes the chunks; without it fd
    takes the fewest chunks that fit one block (:func:`fd_chunks`) and df
    one chunk.  F pads to ``FP = fc * n_fc`` with zero planes and bases,
    which add exactly nothing.  A plan of one chunk runs K1.

    The class holds one response plane ``H1`` and the sparse head
    corrections ``wc`` (:class:`HeadCorrections`), built once here.

    ``channels``: the rows of the channel-sliced frames (B, channels, N)
    the forward takes, as a full-rate stage reads them from the ring.
    Every mic of a slot at or past ``channels`` is exactly zero there, so
    the plane, the corrections and the gather span the mics below it
    alone (K = 2M shrinks with M); the normalisation keeps the full mic
    count, and the maps are the same numbers.  ``self.channels`` is then
    ``channels``; it is 0 where no mic lies past the slice (``channels``
    0 or the whole frame), and the forward takes whole frames.

    Raises ``ValueError`` for an unknown mode or sweep, when no frame
    tile's shared memory fits one H100 block, and when no active mic lies
    below ``channels``.
    """

    def __init__(self, t, mode: Optional[str] = None,
                 plan_override: Optional[tuple] = None, sweep: str = "df",
                 channels: int = 0):
        if sweep not in ("df", "fd"):
            raise ValueError(f"sweep must be 'df' or 'fd', got {sweep!r}")
        self.sweep = sweep
        et = t if isinstance(t, EquivFreqTables) else make_equiv_tables(t)
        H, Wc, adaptive = et.H, et.Wc, et.adaptive
        n_active = H.shape[1]
        kept = adaptive < channels
        self.channels = 0
        if channels and not bool(kept.all()):
            if not bool(kept.any()):
                raise ValueError(f"equiv kernel: no active mic below "
                                 f"channel {channels}")
            H, adaptive = H[:, kept], adaptive[kept]
            Wc = None if Wc is None else Wc[..., kept]
            self.channels = channels
        if mode is None:
            mode = {"high": "high", "highest": "f32"}.get(et.precision,
                                                          "bf16")
        if mode not in _MODES:
            # an unknown string (e.g. the SteeringTables vocabulary's
            # "highest") must not fall through to the bf16 path under a
            # name promising the most accurate rung
            raise ValueError(
                f"equiv kernel mode must be high/bf16/f32, got {mode!r}")
        self.mode = mode
        self.device = et.H.device
        self.plane_dtype = (torch.bfloat16 if mode == "bf16"
                            else torch.float32)
        D, M, Fb = H.shape
        Tt = et.ib_re.shape[1]
        Tc = 0 if Wc is None else Wc.shape[2]
        self.D, self.M, self.F, self.N, self.L = D, M, Fb, et.n_samples, et.L
        self.n_tail, self.Tc, self.Tt = et.n_tail, Tc, Tt
        self.corr_js = et.corr_js
        self.res_x, self.res_y = et.res_x, et.res_y
        self.TD = tile_d(self.plane_dtype)
        self.DP = _round_up(D, D_ALIGN)
        self.KP = _round_up(2 * M, K_ALIGN)
        self.MP = self.KP // 2
        self.KS = self.KP + row_pad(self.plane_dtype)
        J = len(et.corr_js) if Tc else 0
        self.JM = J * M

        # Hopper plan: the largest frame tile and the frequency chunks,
        # then the frame tiles whose shared memory fits one block
        itemsize = 2 if mode == "bf16" else 4
        if plan_override is not None:
            bt_max, n_fc = (int(x) for x in plan_override)
            if bt_max not in FRAME_TILES or not 1 <= n_fc <= FD_MAX_CHUNKS:
                raise ValueError(
                    f"plan_override must be (one of {FRAME_TILES}, n_fc in "
                    f"1..{FD_MAX_CHUNKS}), got {plan_override!r}")
        else:
            bt_max = FRAME_TILES[0]
            n_fc = (fd_chunks(Fb, Tt, self.KP, itemsize) if sweep == "fd"
                    else 1)
        self.n_fc = n_fc
        self.fc = -(-Fb // n_fc)
        self.FP = self.fc * n_fc
        # the fd kernel runs for an fd plan of more than one chunk
        self.runs_fd = sweep == "fd" and n_fc > 1
        self.frame_tiles = tuple(
            bt for bt in FRAME_TILES if bt <= bt_max and (
                smem_bytes_fd(bt, self.fc, Tt, self.KP, itemsize)
                if self.runs_fd
                else smem_bytes(bt, Tt, self.KP, self.JM, itemsize))
            <= SMEM_MAX)
        if not self.frame_tiles:
            raise ValueError(
                f"equiv kernel: no shared-memory plan for Tt={Tt} "
                f"KP={self.KP} J*M={self.JM} (sweep {sweep}, {n_fc} "
                f"chunks)")

        # --- device tables: bin-major, sqrt(cf)-scaled, padded ----------
        cf = et.cf.double()
        scf = torch.sqrt(cf).float()                                # (F,)
        inv_scf = (1.0 / torch.sqrt(cf)).float()
        self.H1 = make_plane(H, scf, self.KP, self.DP, self.FP,
                             self.TD).to(self.plane_dtype)

        def basis(ib):
            # (F, Tt) / sqrt(cf) -> (FP, Tt rounded up to 4): rows of a
            # 16-byte multiple, for the kernels' bulk copies
            out = torch.zeros((self.FP, _round_up(Tt, 4)),
                              dtype=torch.float32, device=self.device)
            out[:Fb, :Tt] = ib * inv_scf[:, None]
            return out

        self.ib1 = basis(et.ib_re)
        self.ib2 = basis(et.ib_im)
        self.wc = (make_head_corrections(Wc, self.DP) if Tc else None)
        ident = torch.arange(M, device=self.device)
        self.adaptive = (None if torch.equal(adaptive, ident) else adaptive)
        self.inv = float(np.float32(1.0 / (self.N * n_active * n_active)))

    @property
    def table_bytes(self) -> int:
        """Bytes of the tables the class holds on its device."""
        ts = [self.H1, self.ib1, self.ib2] + (list(self.wc) if self.wc
                                              else [])
        return sum(t.numel() * t.element_size() for t in ts)

    def frame_tile(self, B: int) -> int:
        """The frame tile of a call of ``B`` frames.  df: the smallest
        planned tile covering ``B``; past the largest tile, the largest one
        where K1 takes its two passes (:func:`takes_split`; their product
        runs frame groups of the largest tile dividing the padded batch),
        else, on the card, the tile of 8 or more whose waves of blocks x
        (tile + ``FRAME_COST_H``) are least, from the runtime's occupancy.
        fd: on the card the tile (up to the covering one) of the least
        planned cost (waves x tiles a block x (tile + ``FRAME_COST_H``)).
        On the CPU, where the plain version runs, the covering tile or the
        largest one."""
        tiles = self.frame_tiles
        cover = min((bt for bt in tiles if bt >= B), default=None)
        if not self.runs_fd and cover is not None:
            return cover
        cands = [bt for bt in tiles if bt <= (cover or tiles[0])]
        if not self.runs_fd:
            cands = [bt for bt in tiles if bt >= 8] or [tiles[0]]
            if takes_split(self.plane_dtype, self.Tt,
                           _round_up(B, tiles[0])):
                cands = [tiles[0]]
        if self.device.type != "cuda" or len(cands) == 1:
            return cands[0]
        bf16 = int(self.plane_dtype == torch.bfloat16)

        def cost(bt):
            n_bt = -(-B // bt)
            if self.runs_fd:
                c = _fd_plan(self.device, bf16, bt, self.KP, self.fc,
                             self.Tt, n_bt, self.n_fc, self.DP // self.TD)[0]
            else:
                c = _k1_plan(self.device, bf16, bt, self.Tt, self.KP,
                             self.JM, n_bt * (self.DP // self.TD))[0]
            return c * (bt + FRAME_COST_H)

        return min(cands, key=lambda bt: (cost(bt), -bt))

    def kernel_inputs(self, signals: torch.Tensor,
                      block_b: Optional[int] = None):
        """The forward's prologue: (B, C, N) frames -> ``(S, sj, bt)``,
        the per-call kernel inputs (the DFT, stacking, padding and the
        head-correction sample gather) and the frame tile (``block_b``,
        else :meth:`frame_tile`)."""
        B, M = signals.shape[0], self.M
        bt = block_b or self.frame_tile(B)
        BP = _round_up(B, bt)
        sf = (signals[:, self.adaptive, :] if self.adaptive is not None
              else signals[:, :M, :]).float()                       # (B, M, N)
        spec = torch.fft.rfft(sf, n=self.L).permute(2, 0, 1)        # (F, B, M)
        S = make_spectra(spec, self.FP, BP, self.KP,
                         self.KS).to(self.plane_dtype)              # (FP, BP, KS)
        if self.Tc:
            sj = torch.zeros((BP, self.JM), dtype=torch.float32,
                             device=signals.device)
            sj[:B] = torch.stack([sf[:, :, j] for j in self.corr_js],
                                 dim=1).reshape(B, self.JM)
        else:
            sj = None
        return S, sj, bt

    def __call__(self, signals) -> torch.Tensor:
        signals = torch.as_tensor(signals, device=self.device)
        squeeze = signals.ndim == 2
        if squeeze:
            signals = signals[None]
        B = signals.shape[0]
        with annotate("power.inputs"):
            S, sj, bt = self.kernel_inputs(signals)
        args = (S, self.H1, self.ib1, self.ib2, sj, self.wc)
        kw = dict(n_tail=self.n_tail, Tc=self.Tc, inv=self.inv, block_b=bt)
        with annotate("power.kernel"):
            power = (equiv_power_fd(*args, n_fc=self.n_fc, **kw)
                     if self.runs_fd else equiv_power(*args, **kw))  # (BP, DP)
        power = power[:B, :self.D].reshape(B, self.res_x, self.res_y)
        return power[0] if squeeze else power
