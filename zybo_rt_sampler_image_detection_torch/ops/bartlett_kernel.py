"""The FFT route's Bartlett contraction as one hand-written kernel.

``P[b, d] = sum_f w_f |sum_m X[b, adaptive[m], bins[f]] phase[f, m, d]|^2``
in FP32, from the rfft of the batch as the stage hands it (B, C, N/2 + 1)
complex64: ``csrc/bartlett_power.cu`` (``sm_90a``, built and bound through
:mod:`._build`).  It replaces no TPU kernel (the JAX package leaves this
contraction to XLA); it exists because the library chain it replaced
(gather, band copy, cuBLAS complex GEMM, ``|.|^2``, bin sum) streamed the
steering tensor at a quarter of HBM's rate and wrote and re-read its
intermediates.  Its bound on an H100 at the web app's shape (94 bins, 256
mics, 169 directions, 16 frames): the tensor's bytes, 9.7 us at 3.35
TB/s, and its FMAs, 7.8 us at 67 TFLOP/s; the design (read the tensor
once through a ring of bulk copies, FMAs in registers beside the stream,
the frames' spectra gathered a few stages ahead) is described in the
source.

Here: the tensor's tile layout (:func:`make_phase_tiles`, built once per
table), the frame tile (:func:`frame_tile`; the kernel works out its own
ring depth from the card's shared memory), the plain torch version
(:func:`bartlett_power_plain`, the same function from the same inputs;
CPU tensors take it) and the wrapper (:func:`bartlett_power`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

DC_MAX = 192            # directions of one chunk (three warps of 64)
DC_ALIGN = 16           # chunk widths are multiples of 16 directions
MAX_MICS = 256          # steering rows of a bin the kernel takes
FRAME_TILES = (1, 2, 4, 8, 16)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_layout(D: int) -> tuple:
    """``(NC, DC)``: the direction chunks of the tile layout, the fewest
    of at most ``DC_MAX`` directions, each ``DC`` wide (a multiple of 16;
    the last chunk's tail is zeros)."""
    nc = _cdiv(D, DC_MAX)
    return nc, _cdiv(_cdiv(D, nc), DC_ALIGN) * DC_ALIGN


def make_phase_tiles(phase: torch.Tensor) -> torch.Tensor:
    """The steering tensor (F, M, D) in the kernel's order (NC, F, M, DC),
    zero past D: one block's steering rows of one bin are one contiguous
    run, rows 16-byte aligned for bulk copies."""
    F, M, D = phase.shape
    nc, dc = tile_layout(D)
    tiles = torch.zeros(F, M, nc * dc, dtype=phase.dtype,
                        device=phase.device)
    tiles[..., :D] = phase
    return tiles.view(F, M, nc, dc).permute(2, 0, 1, 3).contiguous()


def frame_tile(B: int) -> int:
    """Frames a block takes: the smallest tile that holds B, else 16."""
    return next((t for t in FRAME_TILES if t >= B), FRAME_TILES[-1])


def bartlett_power_plain(spec: torch.Tensor, tiles: torch.Tensor,
                         adaptive: torch.Tensor, bins: torch.Tensor,
                         weights: Optional[torch.Tensor] = None, *,
                         D: int) -> torch.Tensor:
    """The kernel's function in torch, from the kernel's inputs: (B, D)
    float32 maps of the rfft ``spec`` (B, C, NF), the tiles (NC, F, M,
    DC), the channel rows ``adaptive`` (M,), the rfft bins (F,) and the
    per-bin ``weights`` (F,) or None."""
    S = spec[:, adaptive.long()][:, :, bins.long()]             # (B, M, F)
    Y = torch.einsum("bmf,cfmd->bfcd", S, tiles)
    per_bin = Y.real.square() + Y.imag.square()
    if weights is not None:
        per_bin = per_bin * weights[None, :, None, None]
    return per_bin.sum(dim=1).reshape(spec.shape[0], -1)[:, :D]


# ---- the kernel's wrapper ---------------------------------------------------

def _lib():
    from . import _build

    lib = _build.load("bartlett_power")
    if not getattr(lib, "_zrt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.zrt_bartlett_power.restype = i
        lib.zrt_bartlett_power.argtypes = [
            p, p, p, p, p, p, p,                # X Pt adaptive bins w part out
            i, i, i, i, i, i, i, i,             # B C NF F M D DC NC
            i, p]                               # bt stream
        lib.zrt_cuda_error_string.restype = ctypes.c_char_p
        lib.zrt_cuda_error_string.argtypes = [i]
        lib._zrt_typed = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"bartlett_power: {msg}")


def bartlett_power(spec: torch.Tensor, tiles: torch.Tensor,
                   adaptive: torch.Tensor, bins: torch.Tensor,
                   weights: Optional[torch.Tensor] = None, *, D: int,
                   extent: tuple) -> torch.Tensor:
    """Bartlett maps (B, D) float32 of the rfft ``spec`` (B, C, NF)
    complex64 (see :func:`bartlett_power_plain` for the other inputs;
    ``adaptive`` and ``bins`` int32 on the card).  ``extent`` is
    ``(adaptive.max() + 1, bins.max() + 1)``, the rows and bins the
    kernel reads, checked against C and NF on the host.

    On CPU tensors this is :func:`bartlett_power_plain`.  On CUDA tensors
    it launches ``csrc/bartlett_power.cu`` and its second pass, or raises;
    there is no fallback.  ``bartlett_power.launches`` counts the calls."""
    _check(spec.ndim == 3 and tiles.ndim == 4,
           f"spec must be (B, C, NF), not {tuple(spec.shape)}, and tiles "
           f"(NC, F, M, DC), not {tuple(tiles.shape)}")
    B, C, NF = spec.shape
    _check(extent[0] <= C and extent[1] <= NF,
           f"the tables read rows < {extent[0]} and bins < {extent[1]} of "
           f"a spectrum of {C} rows and {NF} bins")
    if spec.device.type == "cpu":
        return bartlett_power_plain(spec, tiles, adaptive, bins, weights,
                                    D=D)
    _check(spec.device.type == "cuda", f"unsupported device {spec.device}")
    _check(spec.dtype == torch.complex64 and tiles.dtype == torch.complex64,
           f"spec and tiles must be complex64, not {spec.dtype} and "
           f"{tiles.dtype}")
    nc, F, M, dc = tiles.shape
    _check((nc, dc) == tile_layout(D), f"tiles {tuple(tiles.shape)} are "
           f"not the layout of {D} directions {tile_layout(D)}")
    _check(adaptive.dtype == torch.int32 and adaptive.shape == (M,)
           and bins.dtype == torch.int32 and bins.shape == (F,),
           f"adaptive must be int32 ({M},) and bins int32 ({F},)")
    _check(M <= MAX_MICS, f"{M} mics (at most {MAX_MICS})")
    tensors = [spec, tiles, adaptive, bins]
    if weights is not None:
        _check(weights.dtype == torch.float32 and weights.shape == (F,),
               f"weights must be float32 ({F},)")
        tensors.append(weights)
    _check(all(t.device == spec.device for t in tensors),
           "all tensors must be on one device")
    _check(all(t.is_contiguous() for t in tensors),
           "all tensors must be contiguous")
    _check(tiles.data_ptr() % 16 == 0, "tiles must be 16-byte aligned")
    dev = spec.device
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    part = torch.empty((F, B, D), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.zrt_bartlett_power(
            spec.data_ptr(), tiles.data_ptr(), adaptive.data_ptr(),
            bins.data_ptr(), weights.data_ptr() if weights is not None
            else None, part.data_ptr(), out.data_ptr(), B, C, NF, F, M, D,
            dc, nc, frame_tile(B), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bartlett_power: the launch failed: "
                           f"{lib.zrt_cuda_error_string(err).decode()}")
    bartlett_power.launches += 1
    return out


bartlett_power.launches = 0
