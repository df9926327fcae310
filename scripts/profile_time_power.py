"""Where the time of the time-domain ``FusedBeamformer`` goes on the card.

Runs ``FusedBeamformer(tables)`` (the prologue that builds the kernel's
per-call inputs, then ``csrc/time_power.cu``) under ``torch.profiler`` at
``Config()`` lerp and hybrid, f32 and bf16, B=1 and B=16, and prints each
CUDA kernel's mean device time a call, the prologue's sum (every kernel
but the time-domain one) and the whole call.  Imports nothing of JAX.

    python3 scripts/profile_time_power.py [--iters 20] [--sweep
        [--all-mg] [--log sweep.jsonl]]

``--sweep`` instead times the kernel alone (CUDA events, the faster of
two runs of ``--iters`` launches) at every block split (G warp tiles x
NS sample splits, MG mics a stage) at B=1 and 16, at those shapes and at
``cfgjson_fine``'s (``Config()`` at 228x128, lerp, high and its bf16
control: 29,184 directions, 3-tap windows), and prints beside each split
the plan's model time (``fused_kernel.model_times``) and the plan's
mark: the data behind the plan's choices and its constants.
``--all-mg`` also times every MG that fits each split (the stage rounds'
cost); ``--log`` writes a JSON line a split.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from profile_equiv_fd import kernel_times  # noqa: E402


def splits(fk, fb, B: int, all_mg: bool) -> list:
    """The block splits the planner ranks for B frames (MG from
    ``block_plan``), or with ``all_mg`` every MG that fits each split."""
    isz = fb.Wp.element_size()
    out = []
    for NS in fk.sample_splits(fb.N):
        for G in range(1, fk.MAX_WARPS // NS + 1):
            p = fk.block_plan(fb.N, fb.M, fb.TK, fb.DP, B, fb.NL, isz,
                              fb.JM, fb.Tc, G, NS)
            if p is None:
                continue
            if not all_mg:
                out.append(p)
                continue
            for MG in sorted({min(mg, fb.M) for mg in fk.MGS}, reverse=True):
                sm = fk.smem_bytes(isz, fb.NL, fb.TK, fb.M, fb.JM, fb.Tc, G,
                                   NS, MG)
                if sm <= fk.SMEM_MAX:
                    bps = min(max(1, fk.WARPS_PER_SM // (G * NS)),
                              fk.SM_SHARED // (sm + fk.BLOCK_RESERVED))
                    out.append(p._replace(MG=MG, smem=sm, bps=bps))
    return out


def sweep(fk, fb, label: str, frames, card: str, iters: int,
          all_mg: bool, log) -> None:
    """The kernel at every split, B=1 and 16, each beside the plan's model
    time (``model_times(...).total``) and the plan's mark."""
    from profile_equiv_fd import event_ms

    auto_plan = fk.plan
    isz = fb.Wp.element_size()
    for B in (1, 16):
        s, sj = fb.kernel_inputs(frames[:B])
        args = (s, fb.Wp, fb.bases, sj, fb.wc)
        auto = fb.launch_plan(B)
        times = []
        for p in splits(fk, fb, B, all_mg):
            # fused_power launches whatever the module's plan returns
            fk.plan = lambda *a, p=p: p
            try:
                ms = min(event_ms(lambda: fk.fused_power(
                    *args, **fb.kernel_kw), iters) for _ in range(2))
            finally:
                fk.plan = auto_plan
            t = fk.model_times(p, fb.N, fb.M, fb.TK, fb.DP, B, fb.NL, isz)
            mark = "*" if p == auto else ""
            times.append(f"{p.G}x{p.NS}{mark}/MG{p.MG}:{ms:.4f}"
                         f"({t.total * 1e3:.4f})")
            if log is not None:
                log.write(json.dumps(dict(
                    shape=label, B=B, G=p.G, NS=p.NS, MG=p.MG, bps=p.bps,
                    blocks=p.blocks, ms=ms, model_ms=t.total * 1e3,
                    fma_ms=t.fma * 1e3, stage_ms=t.stage * 1e3,
                    rounds_ms=t.rounds * 1e3, plan=p == auto,
                    staged=fk.staged_bytes(p, fb.N, fb.M, fb.TK, fb.DP, B,
                                           fb.NL, isz), card=card)) + "\n")
        print(f"[sweep {label} B={B} Tw={fb.TK} DP={fb.DP}] ms (model ms) "
              f"by GxNS/MG (* the plan's) {' '.join(times)} [{card}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sweep", action="store_true",
                    help="time the kernel at every block split")
    ap.add_argument("--all-mg", action="store_true",
                    help="with --sweep, every MG that fits each split too")
    ap.add_argument("--log", help="with --sweep, a JSON line a split here")
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
    bf16 = dict(matmul_dtype="bfloat16", matmul_precision="default")
    shapes = [(f"{algo} {mode}", algo, cfg.replace(**bf16) if mode == "bf16"
               else cfg) for algo in ("lerp", "hybrid")
              for mode in ("f32", "bf16")]
    if args.sweep:
        # cfgjson_fine's kernel shape (Config() at 228x128, lerp, high) and
        # its bf16 control's
        fine = cfg.replace(max_res_x=228, max_res_y=128)
        shapes += [("fine lerp high", "lerp",
                    fine.replace(matmul_precision="high")),
                   ("fine lerp bf16", "lerp", fine.replace(**bf16))]
    log = open(args.log, "w") if args.sweep and args.log else None
    for label, algo, mcfg in shapes:
        fb = fk.FusedBeamformer(beamform.make_tables(
            mcfg, algo, cache=False, device="cuda"))
        if args.sweep:
            sweep(fk, fb, label, frames, card, args.iters, args.all_mg, log)
        else:
            for B in (1, 16):
                x = frames[:B]
                rows = kernel_times(lambda: fb(x), args.iters)
                kern = sum(ms for name, _, ms in rows
                           if "time_power" in name)
                total = sum(ms for _, _, ms in rows)
                print(f"[{label} B={B}] TK={fb.TK} tile_d={fb.tile_d}: "
                      f"time_power {kern:.4f} ms, prologue "
                      f"{total - kern:.4f} ms, call {total:.4f} ms [{card}]")
                for name, count, ms in rows:
                    print(f"  {ms:9.4f} ms x{count // args.iters}  "
                          f"{name[:110]}")
        del fb
        torch.cuda.empty_cache()
    if log is not None:
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
