"""Fused exact frequency-domain steered power: host class + CUDA kernel.

The plain formulation (:mod:`.freq_equiv`) materialises the steered
spectra ``Br/Bi`` — (B, D, F) tensors — and streams them again for the
Parseval sum and the tail/head inverse DFT.  The fused kernel
(``csrc/equiv_power.cu``) keeps them on chip: a block owns a (frames x
directions) output tile, loops over every frequency bin, and folds both
reductions in while the per-bin products are live.  The source note in the
``.cu`` says what bounds it on the H100 and how the design answers.

Layout the kernel takes (the forward below builds it):

* ``S``      (F, BP, KP)  spectra, bin-major, ``[sr | si]`` stacked along
                          the mic axis (K = 2M, zero-padded to KP);
* ``H1/H2``  (F, KP, DP)  ``sqrt(cf) * [H_re | -H_im]`` / ``[H_im | H_re]``;
* ``ib1/ib2`` (F, Tt)     tail/head inverse-DFT bases divided by ``sqrt(cf)``;
* ``sj``     (BP, J*M)    head-correction sample columns, and
  ``Wc3``    (J*M, Tc, DP) their weights (both None without corrections);
* output     (BP, DP)     float32 power.

``sweep="fd"`` (the JAX package's direction-innermost order, TPU K5) cuts
the bins into ``n_fc`` chunks of ``fc`` (F zero-padded to ``FP = fc *
n_fc``) and runs ``csrc/equiv_power_fd.cu``: a block stages one S chunk
once and sweeps a group of direction tiles, writing per-chunk partials
that a second kernel sums in chunk order.  An fd plan of one chunk runs
K1, as the JAX forward does.

Modes keep the JAX package's names and default rule: ``f32`` and ``high``
both run FP32 operands with FP32 sums on the CUDA cores (the TPU's 3-pass
bf16 hi/lo split was a workaround for a bf16-only matrix unit and is not
ported); ``bf16`` takes bf16 S/H planes with FP32 sums.  The tail/head
term is FP32 in every mode.

Ported from ``zybo_rt_sampler_image_detection_tpu/ops/equiv_kernel.py``
(``FusedEquivBeamformer``, ``_equiv_forward_flat``); the v5e VMEM tile
planner is replaced by a plan for the H100's 227 KB of shared memory per
block.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F_

from .beamform import set_fp32_matmul
from .freq_equiv import EquivFreqTables, make_equiv_tables

# tile constants of csrc/equiv_power.cu: the host pads the direction axis
# to a multiple of TILE_D and the stacked-mic axis to a multiple of K_ALIGN
TILE_D = 8
K_ALIGN = 128
FRAME_TILES = (8, 4, 2, 1)
SMEM_MAX = 232448          # dynamic shared memory one H100 block can opt into
FD_MAX_CHUNKS = 32

_MODES = ("high", "bf16", "f32")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _work_floats(bt: int, Tt: int) -> int:
    """Floats of one block's per-tile working set (both kernels): the
    tail/head accumulators, the K-group partials, their warp-reduced
    groups (blocks of fewer than 32 outputs) and Br/Bi."""
    nt = 512 if bt == 1 else 256                  # block_threads in the .cu
    no = bt * TILE_D
    g2 = nt // 32 if no < 32 else 0
    return Tt * no + 2 * (nt // TILE_D) * no + 2 * g2 * no + 2 * no


def smem_bytes(bt: int, Tt: int, KP: int, JM: int) -> int:
    """Shared memory one K1 block of frame tile ``bt`` needs (mirrors
    ``smem_floats`` in equiv_power.cu): the staged spectra (later the sj
    rows) and the working set."""
    return 4 * (bt * max(KP, JM) + _work_floats(bt, Tt))


def smem_bytes_fd(bt: int, fc: int, Tt: int, KP: int, itemsize: int) -> int:
    """Shared memory one fd block needs (mirrors ``launch`` in
    equiv_power_fd.cu): its S chunk of ``fc`` bins in the plane type,
    then the working set."""
    return fc * bt * KP * itemsize + 4 * _work_floats(bt, Tt)


def fd_chunks(F: int, Tt: int, KP: int, itemsize: int,
              bt: int = FRAME_TILES[0]) -> int:
    """The Hopper fd plan: the fewest frequency chunks whose staged S
    chunk and working set fit one block of frame tile ``bt``.  Raises
    ``ValueError`` past ``FD_MAX_CHUNKS``, which bounds the partial
    buffers (``n_fc * (Tt + 1) * DP`` floats a frame)."""
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


def _partials_plain(S, H1, H2, ib1, ib2):
    """Parseval sum (BP, DP) and tail/head samples (TtP, BP, DP) over the
    bins of ``S``, FP32 (bf16 planes widened first: the kernels'
    arithmetic is bf16 operands, FP32 sums)."""
    Sf = S.float()
    Br = torch.bmm(Sf, H1.float())                                  # (F, BP, DP)
    Bi = torch.bmm(Sf, H2.float())
    power = torch.sum(Br * Br + Bi * Bi, dim=0)
    TH = (torch.einsum("ft,fbd->tbd", ib1, Br)
          + torch.einsum("ft,fbd->tbd", ib2, Bi))                  # (Tt, BP, DP)
    return power, TH


def _finish_plain(power, TH, sj, Wc3, *, n_tail: int, Tc: int,
                  inv: float) -> torch.Tensor:
    """Subtract the tails, add the head corrections, scale."""
    power = power - torch.sum(TH[:n_tail] ** 2, dim=0)
    if Tc:
        v = torch.einsum("bj,jcd->cbd", sj, Wc3)                    # (Tc, BP, DP)
        power = power + torch.sum(v * v - 2.0 * TH[n_tail:n_tail + Tc] * v,
                                  dim=0)
    return power * inv


def equiv_power_plain(S, H1, H2, ib1, ib2, sj, Wc3, *, n_tail: int,
                      Tc: int, inv: float) -> torch.Tensor:
    """Plain-torch version of K1, same inputs and layout, FP32."""
    set_fp32_matmul()
    power, TH = _partials_plain(S, H1, H2, ib1, ib2)
    return _finish_plain(power, TH, sj, Wc3, n_tail=n_tail, Tc=Tc, inv=inv)


def equiv_power_fd_plain(S, H1, H2, ib1, ib2, sj, Wc3, *, n_tail: int,
                         Tc: int, inv: float, n_fc: int) -> torch.Tensor:
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
        p, th = _partials_plain(S[sl], H1[sl], H2[sl], ib1[sl], ib2[sl])
        power, TH = (p, th) if c == 0 else (power + p, TH + th)
    return _finish_plain(power, TH, sj, Wc3, n_tail=n_tail, Tc=Tc, inv=inv)


def _lib(name: str):
    from . import _build

    lib = _build.load(name)
    if not getattr(lib, "_zrt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "equiv_power":
            lib.zrt_equiv_power.restype = i
            lib.zrt_equiv_power.argtypes = [
                p, p, p, p, p, p, p, p,             # S H1 H2 ib1 ib2 sj wc3 out
                i, i, i, i, i, i, i, i,             # F BP KP DP TtP n_tail Tc JMP
                ctypes.c_float, i, i, p]            # inv bf16 bt stream
        else:
            lib.zrt_equiv_power_fd.restype = i
            lib.zrt_equiv_power_fd.argtypes = [
                p, p, p, p, p, p, p,                # S H1 H2 ib1 ib2 sj wc3
                p, p, p,                            # pow_part th_part out
                i, i, i, i, i, i, i, i,             # FP BP KP DP TtP n_tail Tc JMP
                i, i, ctypes.c_float, i, i, p]      # n_fc n_dg inv bf16 bt stream
            lib.zrt_equiv_power_fd_blocks_per_sm.restype = i
            lib.zrt_equiv_power_fd_blocks_per_sm.argtypes = [i] * 5
        lib.zrt_cuda_error_string.restype = ctypes.c_char_p
        lib.zrt_cuda_error_string.argtypes = [i]
        lib._zrt_typed = True
    return lib


def _check(cond: bool, msg: str, name: str = "equiv_power") -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_inputs(name, S, H1, H2, ib1, ib2, sj, Wc3, n_tail, Tc,
                  block_b):
    """The checks both wrappers make on CUDA inputs; returns
    ``(F, BP, KP, DP, JM)``."""
    def check(cond, msg):
        _check(cond, msg, name)

    check(S.device.type == "cuda", f"unsupported device {S.device}")
    Fb, BP, KP = S.shape
    check(S.dtype in (torch.float32, torch.bfloat16),
          f"S dtype {S.dtype} (float32 or bfloat16)")
    check(H1.dtype == S.dtype and H2.dtype == S.dtype,
          "S, H1 and H2 must share one dtype")
    check(H1.ndim == 3 and H1.shape[:2] == (Fb, KP)
          and H2.shape == H1.shape, "H1/H2 must be (F, KP, DP)")
    DP = H1.shape[2]
    check(ib1.dtype == torch.float32 and ib1.shape[0] == Fb
          and ib2.shape == ib1.shape and ib1.shape[1] >= n_tail + Tc,
          "ib1/ib2 must be float32 (F, >= n_tail + Tc)")
    check(KP % K_ALIGN == 0 and DP % TILE_D == 0,
          f"KP % {K_ALIGN} and DP % {TILE_D} must be 0")
    check(block_b in FRAME_TILES and BP % block_b == 0,
          f"block_b must be one of {FRAME_TILES} and divide BP")
    tensors = [S, H1, H2, ib1, ib2]
    if Tc:
        check(sj is not None and Wc3 is not None,
              "sj and Wc3 are required when Tc > 0")
        check(sj.dtype == torch.float32 and Wc3.dtype == torch.float32,
              "sj/Wc3 must be float32")
        JM = sj.shape[1]
        check(sj.shape == (BP, JM) and Wc3.shape == (JM, Tc, DP),
              "sj must be (BP, J*M) and Wc3 (J*M, Tc, DP)")
        tensors += [sj, Wc3]
    else:
        JM = 0
    check(all(t.device == S.device for t in tensors),
          "all tensors must be on one device")
    check(all(t.is_contiguous() for t in tensors),
          "all tensors must be contiguous")
    return Fb, BP, KP, DP, JM


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.zrt_cuda_error_string(err).decode()}")


_FD_SLOTS: dict = {}


def _fd_slots(lib, dev, KP: int, fc: int, Tt: int, bf16: int,
              bt: int) -> int:
    """Blocks of the fd chunk kernel the whole card holds at once: SMs x
    the blocks one SM holds, as the runtime reports them (registers,
    shared memory and threads together)."""
    key = (dev.index, KP, fc, Tt, bf16, bt)
    if key not in _FD_SLOTS:
        with torch.cuda.device(dev):
            per_sm = lib.zrt_equiv_power_fd_blocks_per_sm(KP, fc, Tt, bf16,
                                                          bt)
        if per_sm < 0:
            _raise_on(lib, -per_sm, "equiv_power_fd")
        if per_sm == 0:
            raise RuntimeError(f"equiv_power_fd: no SM holds a block of "
                               f"frame tile {bt} with {fc} bins a chunk")
        _FD_SLOTS[key] = per_sm * torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _FD_SLOTS[key]


def equiv_power(S, H1, H2, ib1, ib2, sj, Wc3, *, n_tail: int, Tc: int,
                inv: float, block_b: int = 1) -> torch.Tensor:
    """Fused equiv power (K1), (BP, DP) float32.

    On CPU tensors this is :func:`equiv_power_plain`.  On CUDA tensors it
    launches the ``sm_90a`` kernel (frame tile ``block_b`` in 1/2/4/8) or
    raises; there is no fallback.  ``equiv_power.launches`` counts the
    kernel launches."""
    if S.device.type == "cpu":
        return equiv_power_plain(S, H1, H2, ib1, ib2, sj, Wc3,
                                 n_tail=n_tail, Tc=Tc, inv=inv)
    Fb, BP, KP, DP, JM = _check_inputs("equiv_power", S, H1, H2, ib1, ib2,
                                       sj, Wc3, n_tail, Tc, block_b)
    _check(smem_bytes(block_b, n_tail + Tc, KP, JM) <= SMEM_MAX,
           f"block_b={block_b} needs more than {SMEM_MAX} B shared memory")
    dev = S.device
    lib = _lib("equiv_power")
    out = torch.empty((BP, DP), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zrt_equiv_power(
            S.data_ptr(), H1.data_ptr(), H2.data_ptr(), ib1.data_ptr(),
            ib2.data_ptr(), sj.data_ptr() if Tc else None,
            Wc3.data_ptr() if Tc else None, out.data_ptr(),
            Fb, BP, KP, DP, ib1.shape[1], n_tail, Tc, JM, float(inv),
            int(S.dtype == torch.bfloat16), block_b, stream)
    _raise_on(lib, err, "equiv_power")
    equiv_power.launches += 1
    return out


equiv_power.launches = 0


def equiv_power_fd(S, H1, H2, ib1, ib2, sj, Wc3, *, n_tail: int, Tc: int,
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
        return equiv_power_fd_plain(S, H1, H2, ib1, ib2, sj, Wc3,
                                    n_tail=n_tail, Tc=Tc, inv=inv,
                                    n_fc=n_fc)
    FP, BP, KP, DP, JM = _check_inputs(name, S, H1, H2, ib1, ib2, sj, Wc3,
                                       n_tail, Tc, block_b)
    _check(1 <= n_fc <= FD_MAX_CHUNKS and FP % n_fc == 0,
           f"n_fc must be in 1..{FD_MAX_CHUNKS} and divide F={FP}", name)
    _check(S.data_ptr() % 16 == 0, "S must be 16-byte aligned", name)
    Tt = n_tail + Tc
    smem = smem_bytes_fd(block_b, FP // n_fc, Tt, KP, S.element_size())
    _check(smem <= SMEM_MAX, f"block_b={block_b} with {FP // n_fc} bins a "
           f"chunk needs more than {SMEM_MAX} B shared memory", name)
    dev = S.device
    lib = _lib(name)
    bf16 = int(S.dtype == torch.bfloat16)
    n_dg = dir_groups(BP // block_b, n_fc, DP // TILE_D,
                      _fd_slots(lib, dev, KP, FP // n_fc, Tt, bf16, block_b))
    # the chunks' partials, the port's form of the TPU's aliased pow0/th0
    # windows; the finish kernel reads them on the same stream
    pow_part = torch.empty((n_fc, BP, DP), dtype=torch.float32, device=dev)
    th_part = torch.empty((n_fc, Tt, BP, DP), dtype=torch.float32,
                          device=dev)
    out = torch.empty((BP, DP), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zrt_equiv_power_fd(
            S.data_ptr(), H1.data_ptr(), H2.data_ptr(), ib1.data_ptr(),
            ib2.data_ptr(), sj.data_ptr() if Tc else None,
            Wc3.data_ptr() if Tc else None, pow_part.data_ptr(),
            th_part.data_ptr(), out.data_ptr(),
            FP, BP, KP, DP, ib1.shape[1], n_tail, Tc, JM, n_fc, n_dg,
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
    * ``"bf16"`` — bf16 spectra and planes, FP32 sums (~4e-3 class).

    ``sweep``: ``"df"`` (K1: a block loops over every bin of its direction
    tile) or ``"fd"`` (direction innermost: :func:`equiv_power_fd` over
    ``n_fc`` frequency chunks).  ``plan_override=(frame tile, n_fc)``, the
    JAX keyword, caps the frame tile and fixes the chunks; without it fd
    takes the fewest chunks that fit one block (:func:`fd_chunks`) and df
    one chunk.  F pads to ``FP = fc * n_fc`` with zero planes and bases,
    which add exactly nothing.  A plan of one chunk runs K1.

    Raises ``ValueError`` for an unknown mode or sweep and when no frame
    tile's shared memory fits one H100 block.
    """

    def __init__(self, t, mode: Optional[str] = None,
                 plan_override: Optional[tuple] = None, sweep: str = "df"):
        if sweep not in ("df", "fd"):
            raise ValueError(f"sweep must be 'df' or 'fd', got {sweep!r}")
        self.sweep = sweep
        et = t if isinstance(t, EquivFreqTables) else make_equiv_tables(t)
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
        D, M, Fb = et.H.shape
        Tt = et.ib_re.shape[1]
        Tc = 0 if et.Wc is None else et.Wc.shape[2]
        self.D, self.M, self.F, self.N, self.L = D, M, Fb, et.n_samples, et.L
        self.n_tail, self.Tc, self.Tt = et.n_tail, Tc, Tt
        self.corr_js = et.corr_js
        self.res_x, self.res_y = et.res_x, et.res_y
        self.DP = _round_up(D, TILE_D)
        self.KP = _round_up(2 * M, K_ALIGN)
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
                if self.runs_fd else smem_bytes(bt, Tt, self.KP, self.JM))
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
        Hr, Hi = et.H.real, et.H.imag                               # (D, M, F)

        def plane(a, b):
            # (D, 2M, F) -> sqrt(cf)-scaled (FP, KP, DP)
            h = (torch.cat([a, b], dim=1) * scf).permute(2, 1, 0)
            h = F_.pad(h, (0, self.DP - D, 0, self.KP - 2 * M,
                           0, self.FP - Fb))
            return h.to(self.plane_dtype).contiguous()

        def basis(ib):
            # (F, Tt) / sqrt(cf) -> (FP, Tt)
            return F_.pad(ib * inv_scf[:, None],
                          (0, 0, 0, self.FP - Fb)).contiguous()

        self.H1 = plane(Hr, -Hi)
        self.H2 = plane(Hi, Hr)
        self.ib1 = basis(et.ib_re)
        self.ib2 = basis(et.ib_im)
        if Tc:
            # (J, D, Tc, M) -> (J*M, Tc, DP)
            w3 = et.Wc.permute(0, 3, 2, 1).reshape(J * M, Tc, D)
            self.Wc3 = F_.pad(w3, (0, self.DP - D)).contiguous()
        else:
            self.Wc3 = None
        ident = torch.arange(M, device=self.device)
        self.adaptive = (None if torch.equal(et.adaptive, ident)
                         else et.adaptive)
        self.inv = float(np.float32(1.0 / (self.N * M * M)))

    def frame_tile(self, B: int) -> int:
        """The smallest planned frame tile covering ``B`` frames, else the
        largest one."""
        return min((bt for bt in self.frame_tiles if bt >= B),
                   default=self.frame_tiles[0])

    def kernel_inputs(self, signals: torch.Tensor):
        """The forward's prologue: (B, C, N) frames -> ``(S, sj, bt)``,
        the per-call kernel inputs (the DFT, stacking, padding and the
        head-correction sample gather) and the frame tile."""
        B = signals.shape[0]
        M = self.M
        bt = self.frame_tile(B)
        BP = _round_up(B, bt)
        sf = (signals[:, self.adaptive, :] if self.adaptive is not None
              else signals[:, :M, :]).float()                       # (B, M, N)
        spec = torch.fft.rfft(sf, n=self.L)                         # (B, M, F)
        S = torch.cat([spec.real, spec.imag], dim=1).permute(2, 0, 1)
        S = F_.pad(S, (0, self.KP - 2 * M, 0, BP - B, 0, self.FP - self.F))
        S = S.to(self.plane_dtype).contiguous()                     # (FP, BP, KP)
        if self.Tc:
            sj = torch.stack([sf[:, :, j] for j in self.corr_js], dim=1)
            sj = F_.pad(sj.reshape(B, self.JM), (0, 0, 0, BP - B))
            sj = sj.contiguous()
        else:
            sj = None
        return S, sj, bt

    def __call__(self, signals) -> torch.Tensor:
        signals = torch.as_tensor(signals, device=self.device)
        squeeze = signals.ndim == 2
        if squeeze:
            signals = signals[None]
        B = signals.shape[0]
        S, sj, bt = self.kernel_inputs(signals)
        args = (S, self.H1, self.H2, self.ib1, self.ib2, sj, self.Wc3)
        kw = dict(n_tail=self.n_tail, Tc=self.Tc, inv=self.inv, block_b=bt)
        power = (equiv_power_fd(*args, n_fc=self.n_fc, **kw) if self.runs_fd
                 else equiv_power(*args, **kw))                     # (BP, DP)
        power = power[:B, :self.D].reshape(B, self.res_x, self.res_y)
        return power[0] if squeeze else power
