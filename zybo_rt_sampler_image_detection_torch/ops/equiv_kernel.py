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

_MODES = ("high", "bf16", "f32")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(bt: int, Tt: int, KP: int, JM: int) -> int:
    """Shared memory one block of frame tile ``bt`` needs (mirrors
    ``smem_floats`` in the .cu): the staged spectra (later the sj rows),
    the tail/head accumulators, the K-group partials, their warp-reduced
    groups (blocks of fewer than 32 outputs) and Br/Bi."""
    nt = 512 if bt == 1 else 256                  # block_threads in the .cu
    no = bt * TILE_D
    g2 = nt // 32 if no < 32 else 0
    return 4 * (bt * max(KP, JM) + Tt * no + 2 * (nt // TILE_D) * no
                + 2 * g2 * no + 2 * no)


def equiv_power_plain(S, H1, H2, ib1, ib2, sj, Wc3, *, n_tail: int,
                      Tc: int, inv: float) -> torch.Tensor:
    """Plain-torch version of the kernel, same inputs and layout, FP32.

    bf16 planes are widened to FP32 first, which is the kernel's
    arithmetic (bf16 operands, FP32 sums)."""
    set_fp32_matmul()
    Sf = S.float()
    Br = torch.bmm(Sf, H1.float())                                  # (F, BP, DP)
    Bi = torch.bmm(Sf, H2.float())
    power = torch.sum(Br * Br + Bi * Bi, dim=0)
    TH = (torch.einsum("ft,fbd->tbd", ib1, Br)
          + torch.einsum("ft,fbd->tbd", ib2, Bi))                  # (Tt, BP, DP)
    power = power - torch.sum(TH[:n_tail] ** 2, dim=0)
    if Tc:
        v = torch.einsum("bj,jcd->cbd", sj, Wc3)                    # (Tc, BP, DP)
        power = power + torch.sum(v * v - 2.0 * TH[n_tail:n_tail + Tc] * v,
                                  dim=0)
    return power * inv


def _lib():
    from . import _build

    lib = _build.load("equiv_power")
    if not getattr(lib, "_zrt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.zrt_equiv_power.restype = i
        lib.zrt_equiv_power.argtypes = [
            p, p, p, p, p, p, p, p,                 # S H1 H2 ib1 ib2 sj wc3 out
            i, i, i, i, i, i, i, i,                 # F BP KP DP TtP n_tail Tc JMP
            ctypes.c_float, i, i, p]                # inv bf16 bt stream
        lib.zrt_cuda_error_string.restype = ctypes.c_char_p
        lib.zrt_cuda_error_string.argtypes = [i]
        lib._zrt_typed = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"equiv_power: {msg}")


def equiv_power(S, H1, H2, ib1, ib2, sj, Wc3, *, n_tail: int, Tc: int,
                inv: float, block_b: int = 1) -> torch.Tensor:
    """Fused equiv power, (BP, DP) float32.

    On CPU tensors this is :func:`equiv_power_plain`.  On CUDA tensors it
    launches the ``sm_90a`` kernel (frame tile ``block_b`` in 1/2/4/8) or
    raises; there is no fallback.  ``equiv_power.launches`` counts the
    kernel launches."""
    if S.device.type == "cpu":
        return equiv_power_plain(S, H1, H2, ib1, ib2, sj, Wc3,
                                 n_tail=n_tail, Tc=Tc, inv=inv)
    _check(S.device.type == "cuda", f"unsupported device {S.device}")
    dev = S.device
    Fb, BP, KP = S.shape
    _check(S.dtype in (torch.float32, torch.bfloat16),
           f"S dtype {S.dtype} (float32 or bfloat16)")
    _check(H1.dtype == S.dtype and H2.dtype == S.dtype,
           "S, H1 and H2 must share one dtype")
    _check(H1.ndim == 3 and H1.shape[:2] == (Fb, KP)
           and H2.shape == H1.shape, "H1/H2 must be (F, KP, DP)")
    DP = H1.shape[2]
    Tt = n_tail + Tc
    _check(ib1.dtype == torch.float32 and ib1.shape[0] == Fb
           and ib2.shape == ib1.shape and ib1.shape[1] >= Tt,
           "ib1/ib2 must be float32 (F, >= n_tail + Tc)")
    _check(KP % K_ALIGN == 0 and DP % TILE_D == 0,
           f"KP % {K_ALIGN} and DP % {TILE_D} must be 0")
    _check(block_b in FRAME_TILES and BP % block_b == 0,
           f"block_b must be one of {FRAME_TILES} and divide BP")
    tensors = [S, H1, H2, ib1, ib2]
    if Tc:
        _check(sj is not None and Wc3 is not None,
               "sj and Wc3 are required when Tc > 0")
        _check(sj.dtype == torch.float32 and Wc3.dtype == torch.float32,
               "sj/Wc3 must be float32")
        JM = sj.shape[1]
        _check(sj.shape == (BP, JM) and Wc3.shape == (JM, Tc, DP),
               "sj must be (BP, J*M) and Wc3 (J*M, Tc, DP)")
        tensors += [sj, Wc3]
    else:
        JM = 0
    _check(all(t.device == dev for t in tensors),
           "all tensors must be on one device")
    _check(all(t.is_contiguous() for t in tensors),
           "all tensors must be contiguous")
    _check(smem_bytes(block_b, Tt, KP, JM) <= SMEM_MAX,
           f"block_b={block_b} needs more than {SMEM_MAX} B shared memory")
    lib = _lib()
    out = torch.empty((BP, DP), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zrt_equiv_power(
            S.data_ptr(), H1.data_ptr(), H2.data_ptr(), ib1.data_ptr(),
            ib2.data_ptr(), sj.data_ptr() if Tc else None,
            Wc3.data_ptr() if Tc else None, out.data_ptr(),
            Fb, BP, KP, DP, ib1.shape[1], n_tail, Tc, JM, float(inv),
            int(S.dtype == torch.bfloat16), block_b, stream)
    if err != 0:
        raise RuntimeError(f"equiv_power kernel launch failed: "
                           f"{lib.zrt_cuda_error_string(err).decode()}")
    equiv_power.launches += 1
    return out


equiv_power.launches = 0


class FusedEquivBeamformer:
    """Fused-kernel twin of ``freq_equiv.equiv_steered_power``.

    Usage::

        fused = FusedEquivBeamformer(tables)      # SteeringTables
        power = fused(frames)                     # (B, X, Y) or (X, Y)

    ``mode`` (default from the tables' precision: ``high`` -> ``high``,
    ``highest`` -> ``f32``, else ``bf16``):

    * ``"f32"`` / ``"high"`` — FP32 planes and sums (~1e-6 class);
    * ``"bf16"`` — bf16 spectra and planes, FP32 sums (~4e-3 class).

    Raises ``ValueError`` for an unknown mode and when no frame tile's
    shared memory fits one H100 block.
    """

    def __init__(self, t, mode: Optional[str] = None):
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

        # Hopper plan: frame tiles whose shared memory fits one block
        self.frame_tiles = tuple(
            bt for bt in FRAME_TILES
            if smem_bytes(bt, Tt, self.KP, self.JM) <= SMEM_MAX)
        if not self.frame_tiles:
            raise ValueError(
                f"equiv kernel: no shared-memory plan for Tt={Tt} "
                f"KP={self.KP} J*M={self.JM}")

        # --- device tables: bin-major, sqrt(cf)-scaled, padded ----------
        cf = et.cf.double()
        scf = torch.sqrt(cf).float()                                # (F,)
        inv_scf = (1.0 / torch.sqrt(cf)).float()
        Hr, Hi = et.H.real, et.H.imag                               # (D, M, F)

        def plane(a, b):
            # (D, 2M, F) -> sqrt(cf)-scaled (F, KP, DP)
            h = (torch.cat([a, b], dim=1) * scf).permute(2, 1, 0)
            h = F_.pad(h, (0, self.DP - D, 0, self.KP - 2 * M))
            return h.to(self.plane_dtype).contiguous()

        self.H1 = plane(Hr, -Hi)
        self.H2 = plane(Hi, Hr)
        self.ib1 = (et.ib_re * inv_scf[:, None]).contiguous()
        self.ib2 = (et.ib_im * inv_scf[:, None]).contiguous()
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
        S = F_.pad(S, (0, self.KP - 2 * M, 0, BP - B))
        S = S.to(self.plane_dtype).contiguous()                     # (F, BP, KP)
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
        power = equiv_power(S, self.H1, self.H2, self.ib1, self.ib2, sj,
                            self.Wc3, n_tail=self.n_tail, Tc=self.Tc,
                            inv=self.inv, block_b=bt)               # (BP, DP)
        power = power[:B, :self.D].reshape(B, self.res_x, self.res_y)
        return power[0] if squeeze else power
