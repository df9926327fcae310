"""Where the time of the streaming MVDR goes on the card.

Builds ``make_mvdr_stream`` at ``Config()`` (100 Hz-Nyquist: F=127 bins,
M=256 mics, D=1824 directions), streams four batches of 16 drifting-tone
frames through it, then for each step of the stream (one batch's
``mvdr_maps_scan`` with d carried, ``mvdr_d0``, ``refresh_precision``,
the Woodbury block update, the ``beams`` and ``maps_beams`` calls, one
live frame) prints: the host-synchronizing operations it issues
(``torch.cuda.set_sync_debug_mode``), its kernels' summed device time a
call (``torch.profiler``), its CUDA-event time over back-to-back calls,
its host wall time a call when each call is waited for, and the device's
busy share of that wall time.  Then the refresh's inverse by four
routes (``cholesky_inverse``, the port's; triangular solve + product;
``cholesky_solve`` of the identity; LU ``inv_ex``): time and error
against the complex128 inverse.  Imports nothing of JAX.

    python3 scripts/profile_mvdr.py [--iters 5]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_equiv_fd import event_ms, kernel_times  # noqa: E402


def wall_ms(fn, iters: int) -> float:
    """Mean host wall time of ``fn`` and its wait for the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def syncs(fn) -> list:
    """The first line of each host-synchronization warning ``fn`` raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [str(w.message).splitlines()[0][:100] for w in caught]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_mvdr: needs a CUDA GPU", file=sys.stderr)
        return 2
    import numpy as np

    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import freq

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    cfg = Config()
    rng = np.random.default_rng(7)
    t = np.arange(cfg.n_samples) / cfg.sample_rate
    frames = torch.from_numpy(np.stack([
        np.tile(np.sin(2 * np.pi * (2300.0 + 37.0 * i) * t),
                (cfg.n_microphones, 1))
        + 0.3 * rng.standard_normal((cfg.n_microphones, cfg.n_samples))
        for i in range(64)]).astype(np.float32)).cuda()
    fm = pipeline.make_mvdr_stream(cfg, "maps")
    fb = pipeline.make_mvdr_stream(cfg, "beams")
    fmb = pipeline.make_mvdr_stream(cfg, "maps_beams")
    for fn in (fm, fb, fmb):
        fn.reset()
    d = 1007
    for b in range(4):
        x = frames[b * 16:(b + 1) * 16]
        fm(x)
        fb(x, d)
        fmb(x, d)
    torch.cuda.synchronize()
    ft, st = fm.tables, fm.state["p"]
    x = frames[:16]
    dq = freq.mvdr_d0(st, ft)
    steps = {
        "mvdr_maps_scan (16 frames, d carried)":
            lambda: freq.mvdr_maps_scan(st, x, ft, d0=dq, return_d=True),
        "mvdr_d0": lambda: freq.mvdr_d0(st, ft),
        "refresh_precision": lambda: freq.refresh_precision(st, ft),
        "update_precision_block (16 frames)":
            lambda: freq.update_precision_block(st, x, ft),
        "stream 'beams' call": lambda: fb(x, d),
        "stream 'maps_beams' call": lambda: fmb(x, d),
        "stream 'maps' live frame": lambda: fm(x[0]),
    }
    for name, fn in steps.items():
        found = syncs(fn)
        dev = sum(r[2] for r in kernel_times(fn, args.iters))
        ev = event_ms(fn, args.iters)
        wall = wall_ms(fn, args.iters)
        print(f"[mvdr] {name}: host syncs {len(found)} "
              f"{sorted(set(found))}; kernels {dev:.4f} ms device a call; "
              f"{ev:.4f} ms CUDA events back to back; {wall:.4f} ms wall a "
              f"call; device busy {dev / wall:.1%} of the wall [{card}]")

    R = freq._loaded(st.cov, st.load)
    R64 = R.to(torch.complex128)
    P64 = torch.linalg.inv(R64)
    eye = torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)

    def potri():
        return torch.cholesky_inverse(torch.linalg.cholesky_ex(R)[0])

    def trsm():
        L = torch.linalg.cholesky_ex(R)[0]
        Li = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
        return torch.matmul(Li.mH, Li)

    def potrs():
        L = torch.linalg.cholesky_ex(R)[0]
        return torch.cholesky_solve(eye.expand_as(L).contiguous(), L)

    def lu():
        return torch.linalg.inv_ex(R)[0]

    chol = event_ms(lambda: torch.linalg.cholesky_ex(R), args.iters)
    for name, fn in (("cholesky_inverse", potri),
                     ("solve_triangular + matmul", trsm),
                     ("cholesky_solve(I)", potrs), ("inv_ex (LU)", lu)):
        P = fn()
        torch.cuda.synchronize()
        err = ((P.to(torch.complex128) - P64).abs().max()
               / P64.abs().max()).item()
        print(f"[inverse] {name}: {event_ms(fn, args.iters):.4f} ms CUDA "
              f"events, {wall_ms(fn, args.iters):.4f} ms wall, host syncs "
              f"{len(syncs(fn))}; max err vs the complex128 inverse "
              f"{err:.3e} of its scale (cholesky_ex alone {chol:.4f} ms) "
              f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
