"""The MVDR route's quadratic form in hand-written CUDA.

``d[f, x] = Re(a^H P_f a)`` with ``a = conj(phase[f, :, x])``, (F, D)
float32 from P (F, M, M) and the steering tensor (F, M, D), both
complex64: ``csrc/quad_form.cu`` (``sm_90a``, built and bound through
:mod:`._build`).  It replaces no TPU kernel (the JAX package leaves the
form to XLA); it exists because the library chain it replaced (cuBLAS's
complex GEMM ``conj(P) phase``, an elementwise product and a reduction
over the mics, conj copies) wrote and re-read an (F, M, D) product and
multiplied all of P.  The kernel multiplies P's Hermitian half only, by
32-mic tiles: with ``Ph = (P + P^H) / 2``, exactly,

    d = sum_I Re(a_I^H Ph_II a_I) + 2 Re sum_{I<J} a_I^H Ph_IJ a_J,

each tile of ``Ph`` the mean of P's two triangles as they are, so ``d``
is the form of the P it is given (Hermitian or only up to rounding, as
the Woodbury-advanced P is); only the order of the FP32 sums changes.
Its bound on an H100 at the MVDR cell's shape (127 bins, 192 mics,
1,824 directions): the half's FP32 FMAs, 39.8 GFLOP, 0.59 ms at 67
TFLOP/s; it takes about 1.2 ms there, against 2.04 ms for the library
chain.  The design (a pass that makes the tiles of the sum, then a
persistent kernel whose ninth warp streams them and the tensor's rows
into shared memory for eight warps of FP32 FMAs) is described in the
source.

Here: the plain torch version (:func:`hermitian_quad_form_plain`, the same
half-sum of P and the (F, M, D) tensor; CPU tensors take it) and the
wrapper (:func:`hermitian_quad_form`), which reads the tensor in the
Bartlett kernel's tile layout.
"""

from __future__ import annotations

import ctypes

import torch

from . import bartlett_kernel

TM = 32                 # mics of a tile
DT = 64                 # directions of a work item
MAX_MICS = 256          # mics the kernel takes (MAX_TILES * TM)


def hermitian_quad_form_plain(P: torch.Tensor,
                              phase: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch: ``Re(a^H P a)`` (F, D) in P's real
    dtype over the tile pairs I <= J of the Hermitian half, a row of
    tiles at a time (the diagonal tile the mean of P's two triangles, the
    tiles right of it their sum ``P_IJ + P_JI^H``)."""
    F, M, D = phase.shape
    a = phase.conj()
    d = torch.zeros((F, D), dtype=phase.real.dtype, device=phase.device)
    for i0 in range(0, M, TM):
        i1 = min(i0 + TM, M)
        row = P[:, i0:i1, i0:] + P[:, i0:, i0:i1].mH        # (F, ti, M - i0)
        row[:, :, :i1 - i0] *= 0.5
        T = torch.matmul(row, a[:, i0:])                    # (F, ti, D)
        d += (phase[:, i0:i1] * T).real.sum(dim=1)
    return d


def pairs(M: int) -> int:
    """The tile pairs I <= J of M mics in 32-mic tiles."""
    nt = -(-M // TM)
    return nt * (nt + 1) // 2


# ---- the kernel's wrapper ---------------------------------------------------

def _lib():
    from . import _build

    lib = _build.load("quad_form")
    if not getattr(lib, "_zrt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.zrt_quad_form.restype = i
        lib.zrt_quad_form.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.zrt_cuda_error_string.restype = ctypes.c_char_p
        lib.zrt_cuda_error_string.argtypes = [i]
        lib._zrt_typed = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"hermitian_quad_form: {msg}")


def hermitian_quad_form(P: torch.Tensor, tiles: torch.Tensor, *,
                        D: int) -> torch.Tensor:
    """``Re(a^H P a)`` (F, D) float32 for every bin and direction, ``a =
    conj(phase)``, from P (F, M, M) and the steering tensor in the
    Bartlett kernel's tile layout (NC, F, M, DC) (:attr:`.freq.FreqTables.
    phase_tiles`, :func:`.bartlett_kernel.make_phase_tiles`), both
    complex64 on the card.

    On CPU tensors this is :func:`hermitian_quad_form_plain` of the
    tensor the tiles hold.  On CUDA tensors it launches
    ``csrc/quad_form.cu`` or raises; there is no fallback.  The kernel's
    tiles of the sum, ``P_IJ + P_JI^H`` for the tile pairs I <= J
    (:func:`pairs`), are made into a scratch tensor of their own (21.8 MB
    at the MVDR cell's shape).  ``hermitian_quad_form.launches`` counts
    the launches."""
    _check(P.ndim == 3 and tiles.ndim == 4,
           f"P must be (F, M, M), not {tuple(P.shape)}, and tiles "
           f"(NC, F, M, DC), not {tuple(tiles.shape)}")
    nc, F, M, dc = tiles.shape
    _check(P.shape == (F, M, M), f"P {tuple(P.shape)} does not match "
           f"tiles {tuple(tiles.shape)}: P must be {(F, M, M)}")
    _check((nc, dc) == bartlett_kernel.tile_layout(D),
           f"tiles {tuple(tiles.shape)} are not the layout of {D} "
           f"directions {bartlett_kernel.tile_layout(D)}")
    if P.device.type == "cpu" and tiles.device.type == "cpu":
        phase = tiles.permute(1, 2, 0, 3).reshape(F, M, nc * dc)[..., :D]
        return hermitian_quad_form_plain(P, phase)
    _check(P.device.type == "cuda" and tiles.device == P.device,
           f"P on {P.device} and tiles on {tiles.device}: both on one "
           f"CUDA device")
    _check(P.dtype == torch.complex64 and tiles.dtype == torch.complex64,
           f"P and tiles must be complex64, not {P.dtype} and "
           f"{tiles.dtype}")
    _check(1 <= M <= MAX_MICS, f"{M} mics (1 to {MAX_MICS})")
    _check(P.is_contiguous() and tiles.is_contiguous(),
           "P and tiles must be contiguous")
    _check(tiles.data_ptr() % 16 == 0, "tiles must be 16-byte aligned")
    out = torch.empty((F, D), dtype=torch.float32, device=P.device)
    if F == 0:
        return out
    scratch = torch.empty((F, pairs(M), TM, TM), dtype=torch.complex64,
                          device=P.device)
    lib = _lib()
    with torch.cuda.device(P.device):
        err = lib.zrt_quad_form(
            P.data_ptr(), tiles.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), F, M, D, dc, nc,
            torch.cuda.current_stream(P.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hermitian_quad_form: the launch failed: "
                           f"{lib.zrt_cuda_error_string(err).decode()}")
    hermitian_quad_form.launches += 1
    return out


hermitian_quad_form.launches = 0
