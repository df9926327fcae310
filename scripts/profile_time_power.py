"""Where the time of the time-domain ``FusedBeamformer`` goes on the card.

Runs ``FusedBeamformer(tables)`` (the prologue that builds the kernel's
per-call inputs, then ``csrc/time_power.cu``) under ``torch.profiler`` at
``Config()`` lerp and hybrid, f32 and bf16, B=1 and B=16, and prints each
CUDA kernel's mean device time a call, the prologue's sum (every kernel
but the time-domain one) and the whole call.  Imports nothing of JAX.

    python3 scripts/profile_time_power.py [--iters 20] [--sweep]

``--sweep`` instead times the kernel alone (CUDA events) at every block
split (G warp tiles x NS sample splits) at B=1 and 16: the data behind
the plan's choices.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from profile_equiv_fd import kernel_times  # noqa: E402


def sweep(fk, fb, frames, card: str, iters: int) -> None:
    """The kernel at every split, B=1 and 16."""
    from profile_equiv_fd import event_ms

    auto_plan = fk.plan
    for B in (1, 16):
        s, sj = fb.kernel_inputs(frames[:B])
        args = (s, fb.Wp, fb.bases, sj, fb.wc)
        auto = fb.launch_plan(B)
        times = []
        for NS in fk.sample_splits(fb.N):
            for G in range(1, fk.MAX_WARPS // NS + 1):
                p = fk.block_plan(fb.N, fb.M, fb.TK, fb.DP, B, fb.NL,
                                  fb.Wp.element_size(), fb.JM, fb.Tc, G, NS)
                if p is None:
                    continue
                # fused_power launches whatever the module's plan returns
                fk.plan = lambda *a, p=p: p
                try:
                    ms = event_ms(lambda: fk.fused_power(
                        *args, **fb.kernel_kw), iters)
                finally:
                    fk.plan = auto_plan
                mark = "*" if (G, NS) == (auto.G, auto.NS) else ""
                times.append(f"{G}x{NS}{mark}/MG{p.MG}:{ms:.4f}")
        print(f"[sweep {fb.t.algorithm} {fb.mode} B={B} Tw={fb.TK}] ms by "
              f"GxNS (* the plan's) {' '.join(times)} [{card}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sweep", action="store_true",
                    help="time the kernel at every block split")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_time_power: needs a CUDA GPU", file=sys.stderr)
        return 2
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import (
        beamform, fused_kernel as fk)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config()
    gen = torch.Generator("cuda").manual_seed(1357)
    frames = torch.randn(16, cfg.n_microphones, cfg.n_samples,
                         device="cuda", generator=gen) * 0.05
    for algo in ("lerp", "hybrid"):
        for mode in ("f32", "bf16"):
            mcfg = (cfg if mode == "f32" else cfg.replace(
                matmul_dtype="bfloat16", matmul_precision="default"))
            fb = fk.FusedBeamformer(beamform.make_tables(mcfg, algo,
                                                         device="cuda"))
            if args.sweep:
                sweep(fk, fb, frames, card, args.iters)
                continue
            for B in (1, 16):
                x = frames[:B]
                rows = kernel_times(lambda: fb(x), args.iters)
                kern = sum(ms for name, _, ms in rows
                           if "time_power" in name)
                total = sum(ms for _, _, ms in rows)
                print(f"[{algo} {mode} B={B}] TK={fb.TK} tile_d={fb.tile_d}: "
                      f"time_power {kern:.4f} ms, prologue "
                      f"{total - kern:.4f} ms, call {total:.4f} ms [{card}]")
                for name, count, ms in rows:
                    print(f"  {ms:9.4f} ms x{count // args.iters}  "
                          f"{name[:110]}")
            del fb
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
