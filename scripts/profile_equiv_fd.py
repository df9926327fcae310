"""Where the time of the fd sweep goes on the card, kernel by kernel.

Runs ``FusedEquivBeamformer(tables, sweep="fd")`` (the prologue, the fd
chunk kernel and its finish kernel) and K1 (``sweep="df"``) on the same
frames under ``torch.profiler`` at ``Config()`` lerp and hybrid, f32 and
bf16, B=1 and B=16, and prints each CUDA kernel's mean device time with
each plan (frame tile, ring stages, chunks, direction groups, blocks).
Imports nothing of JAX.

    python3 scripts/profile_equiv_fd.py [--iters 10] [--sweep]

``--sweep`` instead times K1 alone (CUDA events) at every frame tile the
plan can take and every ring depth that fits (the fused kernel's, or the
product pass's where K1 takes its two passes), at B=1, 16 and 37: the data
behind the plan's choices.
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


def event_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sweep(ek, tables, frames, card: str, iters: int) -> None:
    """K1 at every planned frame tile and ring depth, f32 and bf16."""
    for mode in ("f32", "bf16"):
        fk = ek.FusedEquivBeamformer(tables, mode=mode)
        isz = 2 if mode == "bf16" else 4
        for B in (1, 16, 37):
            chosen = fk.frame_tile(B)
            for bt in fk.frame_tiles:
                if bt > 2 * B and bt != chosen:
                    continue
                S, sj, _ = fk.kernel_inputs(frames[:B], bt)
                kw = dict(n_tail=fk.n_tail, Tc=fk.Tc, inv=fk.inv, block_b=bt)
                args = (S, fk.H1, fk.ib1, fk.ib2, sj, fk.wc)
                BP = S.shape[1]
                if ek.takes_split(fk.plane_dtype, fk.Tt, BP):
                    # the two passes: the product pass's ring depth
                    plan = ek.split_plan(S.shape[0], BP, fk.KP, fk.DP,
                                         fk.Tt, fk.Tc, fk.JM)
                    auto = plan.stages

                    def smem(ns):
                        return (ek.split_smem_bytes(plan.fb, plan.nc, ns)
                                if ns <= fk.KP // 2 // ek.SPLIT_KC
                                else ek.SMEM_MAX + 1)
                else:
                    auto = ek._k1_plan(S.device, int(mode == "bf16"), bt,
                                       fk.Tt, fk.KP, fk.JM,
                                       BP // bt * (fk.DP // fk.TD))[1]

                    def smem(ns):
                        return ek.smem_bytes(bt, fk.Tt, fk.KP, fk.JM, isz, ns)
                times = []
                for ns in range(2, ek.MAX_STAGES + 1):
                    if smem(ns) > ek.SMEM_MAX:
                        break
                    ms = event_ms(lambda: ek.equiv_power(*args, stages=ns,
                                                         **kw), iters)
                    times.append(f"{ns}{'*' if ns == auto else ''}:{ms:.4f}")
                print(f"[sweep {tables.algorithm} {mode} B={B}] frame tile "
                      f"{bt}{' (chosen)' if bt == chosen else ''}, "
                      f"{ek.route(fk.plane_dtype, fk.Tt, BP)}: ms by "
                      f"ring stages (* the plan's) {' '.join(times)} "
                      f"[{card}]")
        del fk


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sweep", action="store_true",
                    help="time K1 at every frame tile and ring depth")
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
    frames = torch.randn(37, cfg.n_microphones, cfg.n_samples,
                         device="cuda", generator=gen) * 0.05
    for algo in ("lerp", "hybrid"):
        tables = beamform.make_tables(cfg, algo, device="cuda")
        if args.sweep:
            sweep(ek, tables, frames, card, args.iters)
            del tables
            torch.cuda.empty_cache()
            continue
        for mode in ("f32", "bf16"):
            fd = ek.FusedEquivBeamformer(tables, mode=mode, sweep="fd")
            df = ek.FusedEquivBeamformer(tables, mode=mode)
            # the same chunks with the frame tile capped at 4: a smaller
            # block, more of them an SM at B=16
            fd4 = ek.FusedEquivBeamformer(tables, mode=mode, sweep="fd",
                                          plan_override=(4, fd.n_fc))
            for B in (1, 16):
                x = frames[:B]
                bf16 = int(mode == "bf16")
                runs = [("fd", fd), ("df", df)] + (
                    [("fd tile 4", fd4)] if B > 4 else [])
                for label, f in runs:
                    bt = f.frame_tile(B)
                    n_bt, n_tiles = -(-B // bt), f.DP // f.TD
                    if f.runs_fd:
                        cost, ns, n_dg = ek._fd_plan(
                            x.device, bf16, bt, f.KP, f.fc, f.Tt, n_bt,
                            f.n_fc, n_tiles)
                        plan = (f"n_fc={f.n_fc} fc={f.fc}, {n_dg} direction "
                                f"groups, {n_bt * f.n_fc * n_dg} blocks")
                    elif ek.takes_split(f.plane_dtype, f.Tt, n_bt * bt):
                        sp = ek.split_plan(f.FP, n_bt * bt, f.KP, f.DP, f.Tt,
                                           f.Tc, f.JM)
                        ns = sp.stages
                        plan = (f"two passes, product grid "
                                f"{sp.product_grid}, fold grid "
                                f"{sp.fold_grid}")
                    else:
                        waves, ns = ek._k1_plan(x.device, bf16, bt, f.Tt,
                                                f.KP, f.JM, n_bt * n_tiles)
                        plan = (f"{n_bt * n_tiles} blocks in {waves} "
                                f"wave(s)")
                    print(f"[{algo} {mode} B={B}] {label} plan: frame tile "
                          f"{bt}, {ns} ring stages, {plan} [{card}]")
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
