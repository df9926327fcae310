"""Where the time of the fd sweep goes on the card, kernel by kernel.

Runs ``FusedEquivBeamformer(tables, sweep="fd")`` (the prologue, the fd
chunk kernel and its finish kernel) and K1 (``sweep="df"``) on the same
frames under ``torch.profiler`` at ``Config()`` lerp and hybrid, f32 and
bf16, B=1 and B=16, and prints each CUDA kernel's mean device time with the
fd plan (chunks, direction groups, blocks an SM).  Imports nothing of JAX.

    python3 scripts/profile_equiv_fd.py [--iters 10]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def kernel_times(fn, iters: int) -> list:
    """(name, launches, mean device ms) of each CUDA kernel ``fn`` runs."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        # operator rows (aten::...) carry their kernels' time again
        if dev_us > 0 and ev.count and not ev.key.startswith(
                ("aten::", "Activity Buffer")):
            rows.append((ev.key, ev.count, dev_us / 1e3 / iters))
    return sorted(rows, key=lambda r: -r[2])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_equiv_fd: needs a CUDA GPU", file=sys.stderr)
        return 2
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import (
        beamform, equiv_kernel as ek)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config()
    gen = torch.Generator("cuda").manual_seed(2468)
    frames = torch.randn(16, cfg.n_microphones, cfg.n_samples,
                         device="cuda", generator=gen) * 0.05
    lib = ek._lib("equiv_power_fd")
    for algo in ("lerp", "hybrid"):
        tables = beamform.make_tables(cfg, algo, device="cuda")
        for mode in ("f32", "bf16"):
            fd = ek.FusedEquivBeamformer(tables, mode=mode, sweep="fd")
            df = ek.FusedEquivBeamformer(tables, mode=mode)
            # the same chunks with the frame tile capped at 4: half the
            # shared memory a block, so two blocks an SM at B=16
            fd4 = ek.FusedEquivBeamformer(tables, mode=mode, sweep="fd",
                                          plan_override=(4, fd.n_fc))
            for B in (1, 16):
                x = frames[:B]
                bf16 = int(mode == "bf16")
                runs = [("fd", fd), ("df", df)] + (
                    [("fd tile 4", fd4)] if B > 4 else [])
                for label, f in runs:
                    if f.runs_fd:
                        bt = f.frame_tile(B)
                        slots = ek._fd_slots(lib, x.device, f.KP, f.fc, f.Tt,
                                             bf16, bt)
                        n_dg = ek.dir_groups(-(-B // bt), f.n_fc, f.DP // 8,
                                             slots)
                        print(f"[{algo} {mode} B={B}] {label} plan: "
                              f"n_fc={f.n_fc} fc={f.fc} frame tile {bt}, "
                              f"{slots} block slots, {n_dg} direction "
                              f"groups, {-(-B // bt) * f.n_fc * n_dg} blocks "
                              f"[{card}]")
                for label, f in runs:
                    total = 0.0
                    for name, count, ms in kernel_times(lambda: f(x),
                                                        args.iters):
                        total += ms
                        print(f"  {label}: {ms:9.4f} ms x{count // args.iters}"
                              f"  {name[:110]}")
                    print(f"  {label}: {total:9.4f} ms device time a call")
            del fd, df, fd4
        del tables
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
