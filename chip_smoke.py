"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive.

    python3 chip_smoke.py

Needs one CUDA GPU (exits non-zero without one) and ``nvcc`` to build the
kernels from the sources in this checkout.  Imports nothing of JAX.

Phases (any failure raises, so the exit code is non-zero):

1. Card and build: ``nvidia-smi`` name and power limit; the three kernel
   sources built by three ``nvcc`` processes started together, with the
   ptxas register/spill reports of all three.
2. The fused equiv-power kernel (K1) against its plain torch version on
   the card, at ``Config()`` (256 mics, 57x32 grid) for lerp and hybrid,
   in modes f32/high/bf16, at B=1 (the live stage), B=16 (the full-rate
   batch) and B=37, with CUDA-event times of both, of the two-plane
   ``torch.bmm`` pair (continuity with the first kernel) and of the
   one-plane ``torch.bmm`` of the 2B spectra rows; the restated bound and
   the kernel's share of it, each mode's route (FP32 FMA or tensor cores)
   and the table bytes the class holds.
3. The direction-innermost equiv kernel (K5, ``sweep="fd"``) against its
   plain version and against K1 at ``Config()`` lerp and hybrid,
   f32/high/bf16, B=1 and B=16, on the auto fd plan (more than one
   frequency chunk), with the same times, bound and route.
4. The fused time-domain kernel (K2/K3/K4: one kernel over planned tap
   windows, corrections from the sparse list) against its plain version
   at ``Config()`` lerp and hybrid, f32/high/bf16, B=1 and B=16, and
   against the exact FP32 product, with CUDA-event times of the prologue
   and the kernel, the plan (Tw, G, NS, MG), the table bytes the class
   holds, the dense ``torch.matmul(W, Sdel)`` alone as a yardstick at
   each B, and the wall time of one ``FusedBeamformer`` call.
5. The live slice end to end: the native emulator on loopback ->
   ``Pipeline(..., power_backend="equiv_kernel", device="cuda")``, then
   ``Pipeline(..., power_fn=FusedEquivBeamformer(tables, sweep="fd"))`` ->
   at least 20 heatmaps each, with the kernel's launch counter read around
   the run; one received frame checked against the plain FP32 time-domain
   ``steered_power``; the auto policy at ``high`` must pick K1.
6. Full rate end to end: the native emulator at line rate -> the batched
   stage (K=16, 192 channels) through ``FusedBeamformer(tables)``, the
   auto policy's ``power_backend="equiv_kernel"`` and
   ``FusedEquivBeamformer(tables, sweep="fd")``; each run must skip no
   frame, lose no packet, launch its kernel once per batch, and match the
   plain FP32 ``steered_power`` on one batch it received.  Then the
   policy: bf16 tables outside the equiv bar select the fused time-domain
   kernel, which launches.
7. Listening at ``Config()`` lerp: (a) the combined full-rate stage
   (``make_mimo_miso_batched``: heatmaps and the steered beam from one
   transfer; K=16, 192 channels, 4 s at line rate) through the policy at
   ``high`` (K1) and through ``power_fn=FusedBeamformer(tables)``; each
   run must skip no frame, lose no packet, zero-fill no audio frame,
   write ``processed * 256`` samples, launch its kernel once per batch,
   match ``steered_power`` on a recorded batch's maps and, after the gain
   chain, row d of ``steered_beams`` on its beams (rtol 1e-4 / atol
   1e-7); it prints processed/s, the audio e2e p50/p95 and the device
   program per batch against the power program alone.  (b) The live
   listening stage beside the live K1 heatmap stage, steered by
   ``steer_cartesian_degree``: whole frames reach the sink, and a
   received frame's audio passes the same gate.  (c) 20 of those maps
   through ``viz.Front.multi_loop`` on an array display.

The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = "zybo_rt_sampler_image_detection_torch/ops/csrc"
TPU_OPS = "zybo_rt_sampler_image_detection_tpu/ops"
KERNEL_SOURCE = f"{CSRC}/equiv_power.cu"
KERNEL_REPLACES = f"{TPU_OPS}/equiv_kernel.py:74"
FD_SOURCE = f"{CSRC}/equiv_power_fd.cu"
FD_REPLACES = f"{TPU_OPS}/equiv_kernel.py:198"
TIME_SOURCE = f"{CSRC}/time_power.cu"
# one kernel for K2 (:128), K3 (:212) and K4 (:363)
TIME_REPLACES = [f"{TPU_OPS}/pallas_kernels.py:{n}" for n in (128, 212, 363)]
# max cellwise relative error of the kernel against its plain version
TOL = {"f32": 2e-6, "high": 5e-5, "bf16": 3e-2}
# the time-domain kernel against its plain version, every mode: the same
# operands, FP32 sums in another order (the JAX gate)
TIME_RTOL = 1e-4
BF16_CLASS = 3e-2          # bf16 tables vs the exact FP32 product
E2E_RTOL = 1e-4            # kernel path vs plain FP32 steered_power
N_HEATMAPS = 20
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 FLOP/s outside the
# tensor cores, dense bf16 FLOP/s on the tensor cores
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
FULLRATE_BATCH = 16
FULLRATE_CHANNELS = 192    # the 3 connected arrays of Config()
FULLRATE_SECONDS = 4.0
# phase 7: the steered direction, and the gate of the gain-scaled beams
# against the plain beam (the JAX package's tests/test_fullrate.py:204,258)
LISTEN_AZ, LISTEN_EL = 10.0, -5.0
LISTEN_RTOL, LISTEN_ATOL = 1e-4, 1e-7


def zero_counts() -> None:
    """Every kernel wrapper's launch count to 0, just before a path runs."""
    from zybo_rt_sampler_image_detection_torch.ops import (
        equiv_kernel as ek, fused_kernel as fk)

    for wrapper in (ek.equiv_power, ek.equiv_power_fd, fk.fused_power):
        wrapper.launches = 0


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()


def peak(m: torch.Tensor) -> tuple:
    return tuple(int(i) for i in np.unravel_index(int(m.argmax()), m.shape))


def bound(nbytes: float, flops: float, tc_flops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over their rate (FP32 on the CUDA
    cores; ``tc_flops`` bf16 on the tensor cores)."""
    t_b = nbytes / HBM_BPS * 1e3
    t_f = (flops / FP32_FLOPS + tc_flops / BF16_TC_FLOPS) * 1e3
    return dict(bound_ms=max(t_b, t_f),
                bound_by="bytes" if t_b >= t_f else "operations")


def equiv_bound(fk, B: int) -> dict:
    """The equiv kernels' bound, restated from the work the maps need:
    bytes of H1 once in the plane type, the B frames' spectra rows, the
    bases, the sj rows, the list's entries and the output (the F bins, not
    the zero bins that pad them to chunks); operations of the one-plane
    product (2 * 2B * 2M * D * F; on the tensor cores in bf16), Parseval,
    the tail/head fold (2 * 2B * Tt * D * F) and the corrections
    (2 * B * nnz), the rest FP32."""
    isz = 2 if fk.plane_dtype == torch.bfloat16 else 4
    F, D, M, Tt = fk.F, fk.D, fk.M, fk.Tt
    nnz = 0 if fk.wc is None else fk.wc.val.numel()
    list_bytes = 0 if fk.wc is None else nbytes(fk.wc.ptr) + 8 * nnz
    nb = (isz * F * (fk.KP * fk.DP + B * fk.KS) + 4 * 2 * F * Tt
          + 4 * B * fk.JM + list_bytes + 4 * B * D)
    prod = 2 * 2 * B * 2 * M * D * F
    rest = 4 * B * D * F + 2 * 2 * B * Tt * D * F + 2 * B * nnz
    if fk.plane_dtype == torch.bfloat16:
        return bound(nb, rest, prod)
    return bound(nb, prod + rest)


def describe(ek, fk) -> str:
    """The route of the class's mode and the table bytes it holds."""
    h1 = fk.H1.numel() * fk.H1.element_size()
    nnz = 0 if fk.wc is None else fk.wc.val.numel()
    return (f"route {ek.route(fk.plane_dtype)}; tables held "
            f"{fk.table_bytes / 1e9:.4f} GB (H1 {h1 / 1e9:.4f} GB, list "
            f"{nnz} entries)")


def bmm_yardsticks(fk, S, iters: int) -> tuple:
    """(two-plane ``torch.bmm`` pair ms, one-plane ``torch.bmm`` ms) on
    the same spectra: the pair in FP32 on the planes [Hr | -Hi] and
    [Hi | Hr] as the first kernel took them; the one-plane product of the
    2BP rows with H1 in the plane type.  The port never calls either."""
    from zybo_rt_sampler_image_detection_torch.ops import equiv_kernel as ek

    H = ek.dense_plane(fk.H1[:, :fk.F])
    MP = fk.MP
    Hf = H.float()
    H2 = torch.cat([-Hf[:, MP:], Hf[:, :MP]], dim=1)
    Sf = S[:fk.F, :, :fk.KP].float()
    pair_ms = time_ms(lambda: (torch.bmm(Sf, Hf), torch.bmm(Sf, H2)), iters)
    del Hf, H2, Sf
    rows = ek.spectra_rows(S[:fk.F], fk.KP).contiguous()
    H = H.contiguous()
    one_ms = time_ms(lambda: torch.bmm(rows, H), iters)
    del rows, H
    return pair_ms, one_ms


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
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


def call_ms(fn, iters: int) -> float:
    """Mean wall time of ``fn`` and its wait for the device, a call at a
    time (host clock): what a caller that reads each result waits."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def in_turns(plain, kern, iters: int) -> tuple:
    """(kernel ms, plain ms), timed in turns: plain, kernel, kernel,
    plain."""
    p1 = time_ms(plain, iters)
    k1 = time_ms(kern, iters)
    k2 = time_ms(kern, iters)
    p2 = time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_card_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    from zybo_rt_sampler_image_detection_torch.ops import _build

    names = ("equiv_power", "time_power", "equiv_power_fd")
    t0 = time.perf_counter()
    # one nvcc per source, started together
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    for name in names:
        _build.load(name)
    print(f"[build] {', '.join(n + '.cu' for n in names)} built and "
          f"loaded in {time.perf_counter() - t0:.2f} s (nvcc "
          + ", ".join(f"{n} {_build.build_seconds.get(n, 0.0):.2f} s"
                      for n in names) + ")")
    for name in names:
        report = os.path.join(_build._build_dir(), f"{name}.ptxas.txt")
        if os.path.exists(report):      # absent when the build was cached
            with open(report) as f:
                lines = [ln.strip() for ln in f
                         if "registers" in ln or "spill" in ln]
            print(f"[build] {name} ptxas: " + " | ".join(lines))
    return card


def phase_kernel_vs_plain(card: str) -> dict:
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import (
        beamform, equiv_kernel as ek)

    cfg = Config()
    gen = torch.Generator("cuda").manual_seed(1234)
    frames = torch.randn(37, cfg.n_microphones, cfg.n_samples,
                         device="cuda", generator=gen) * 0.05
    main = None
    for algo in ("lerp", "hybrid"):
        tables = beamform.make_tables(cfg, algo, device="cuda")
        td = beamform.steered_power(frames, tables)      # exact FP32 product
        for mode in ("f32", "high", "bf16"):
            fk = ek.FusedEquivBeamformer(tables, mode=mode)
            print(f"[K1] {algo:6s} {mode:4s}: {describe(ek, fk)}")
            for B in (1, FULLRATE_BATCH, 37):
                x = frames[:B]
                S, sj, bt = fk.kernel_inputs(x)
                kw = dict(n_tail=fk.n_tail, Tc=fk.Tc, inv=fk.inv)
                args = (S, fk.H1, fk.ib1, fk.ib2, sj, fk.wc)
                got = ek.equiv_power(*args, block_b=bt, **kw)
                ref = ek.equiv_power_plain(*args, **kw)
                torch.cuda.synchronize()
                shape = (B, fk.res_x, fk.res_y)
                got = got[:B, :fk.D].reshape(shape)
                ref = ref[:B, :fk.D].reshape(shape)
                assert torch.isfinite(got).all(), (algo, mode, B)
                err = rel_err(got, ref)
                abs_err = (got.double() - ref.double()).abs().max().item()
                err_td = rel_err(got, td[:B])
                same_peak = all(peak(got[b]) == peak(ref[b])
                                for b in range(B))
                iters = 20 if B == 1 else 5
                pair_ms, one_ms = bmm_yardsticks(fk, S, iters)
                k_ms, p_ms = in_turns(
                    lambda: ek.equiv_power_plain(*args, **kw),
                    lambda: ek.equiv_power(*args, block_b=bt, **kw), iters)
                bd = equiv_bound(fk, B)
                ok = err <= TOL[mode] and (mode != "bf16" or same_peak)
                print(f"[K1] {algo:6s} {mode:4s} B={B:2d} bt={bt} "
                      f"F={fk.F} Tt={fk.Tt}: max rel err vs plain {err:.3e} "
                      f"(tol {TOL[mode]:.0e}) max abs {abs_err:.3e} "
                      f"same peak {same_peak} | vs time-domain "
                      f"{err_td:.3e} | kernel {k_ms:.4f} ms plain "
                      f"{p_ms:.4f} ms bmm pair (FP32) {pair_ms:.4f} ms "
                      f"one-plane bmm {one_ms:.4f} ms | bound "
                      f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
                      f"{bd['bound_ms'] / k_ms:.1%} of it) [{card}]")
                assert ok, f"kernel disagrees with plain: {algo} {mode} B={B}"
                if (algo, mode, B) == ("lerp", "f32", 1):
                    # the main path's shape: Config() lerp, highest -> f32
                    main = dict(max_abs_err=abs_err, ms=k_ms, plain_ms=p_ms,
                                library_ms=one_ms, **bd)
            del fk
        del tables, td
        torch.cuda.empty_cache()
    return main


def phase_fd_vs_plain(card: str) -> dict:
    """K5 (``sweep="fd"``) against its plain version and against K1 at
    Config(), on the auto fd plan; returns the main path's entry (lerp,
    f32, B=16: the full-rate stage's shape)."""
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import (
        beamform, equiv_kernel as ek)

    cfg = Config()
    gen = torch.Generator("cuda").manual_seed(2468)
    frames = torch.randn(FULLRATE_BATCH, cfg.n_microphones, cfg.n_samples,
                         device="cuda", generator=gen) * 0.05
    main = None
    for algo in ("lerp", "hybrid"):
        tables = beamform.make_tables(cfg, algo, device="cuda")
        for mode in ("f32", "high", "bf16"):
            fk = ek.FusedEquivBeamformer(tables, mode=mode, sweep="fd")
            # the path must run K5, not K1's single-chunk case
            assert fk.runs_fd and fk.n_fc > 1, (algo, mode, fk.n_fc)
            print(f"[K5] {algo:6s} {mode:4s}: {describe(ek, fk)}")
            for B in (1, FULLRATE_BATCH):
                S, sj, bt = fk.kernel_inputs(frames[:B])
                kw = dict(n_tail=fk.n_tail, Tc=fk.Tc, inv=fk.inv)
                args = (S, fk.H1, fk.ib1, fk.ib2, sj, fk.wc)

                def kern():
                    return ek.equiv_power_fd(*args, n_fc=fk.n_fc,
                                             block_b=bt, **kw)

                def plain():
                    return ek.equiv_power_fd_plain(*args, n_fc=fk.n_fc,
                                                   **kw)

                def k1_kern():
                    return ek.equiv_power(*args, block_b=bt, **kw)

                got, ref, k1 = kern(), plain(), k1_kern()
                torch.cuda.synchronize()
                shape = (B, fk.res_x, fk.res_y)
                got, ref, k1 = (o[:B, :fk.D].reshape(shape)
                                for o in (got, ref, k1))
                assert torch.isfinite(got).all(), (algo, mode, B)
                err, err_k1 = rel_err(got, ref), rel_err(got, k1)
                abs_err = (got.double() - ref.double()).abs().max().item()
                same_peak = all(peak(got[b]) == peak(ref[b])
                                and peak(got[b]) == peak(k1[b])
                                for b in range(B))
                iters = 10 if B == 1 else 5
                pair_ms, one_ms = bmm_yardsticks(fk, S, iters)
                k_ms, p_ms = in_turns(plain, kern, iters)
                k1_ms = time_ms(k1_kern, iters)
                # the same work as K1, so K1's bound: the F bins, not the
                # zero bins that pad them to n_fc chunks
                bd = equiv_bound(fk, B)
                print(f"[K5] {algo:6s} {mode:4s} B={B:2d} bt={bt} "
                      f"n_fc={fk.n_fc} fc={fk.fc} F={fk.F}: max rel err vs "
                      f"plain {err:.3e} vs K1 {err_k1:.3e} (tol "
                      f"{TOL[mode]:.0e}) max abs {abs_err:.3e} same peak "
                      f"{same_peak} | kernel {k_ms:.4f} ms plain "
                      f"{p_ms:.4f} ms K1 {k1_ms:.4f} ms bmm pair (FP32) "
                      f"{pair_ms:.4f} ms one-plane bmm {one_ms:.4f} ms | "
                      f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
                      f"{bd['bound_ms'] / k_ms:.1%} of it) | route "
                      f"{ek.route(fk.plane_dtype)} [{card}]")
                ok = (err <= TOL[mode] and err_k1 <= TOL[mode]
                      and (mode != "bf16" or same_peak))
                assert ok, f"fd kernel disagrees: {algo} {mode} B={B}"
                if (algo, mode, B) == ("lerp", "f32", FULLRATE_BATCH):
                    main = dict(max_abs_err=abs_err, ms=k_ms, plain_ms=p_ms,
                                library_ms=one_ms, **bd)
            del fk
        del tables
        torch.cuda.empty_cache()
    return main


def phase_time_kernel_vs_plain(card: str) -> dict:
    """K2/K3/K4 (one kernel over the planned tap windows) against its
    plain version, and against the exact FP32 product, at Config(); each
    row with the prologue's and the kernel's device ms, the plan (Tw, G
    warp tiles x NS sample splits, MG mics a stage) and the dense
    ``torch.matmul(W, Sdel)`` at the same B.  Returns the main path's
    entry (lerp, f32, B=16: the full-rate stage's shape)."""
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import (
        beamform, fused_kernel as fk)

    cfg = Config()
    N = cfg.n_samples
    gen = torch.Generator("cuda").manual_seed(4321)
    frames = torch.randn(FULLRATE_BATCH, cfg.n_microphones, N,
                         device="cuda", generator=gen) * 0.05
    main = None
    for algo in ("lerp", "hybrid"):
        t32 = beamform.make_tables(cfg, algo, device="cuda")
        td = beamform.steered_power(frames, t32)         # exact FP32 product
        for mode in ("f32", "high", "bf16"):
            mcfg = {"f32": cfg, "high": cfg.replace(matmul_precision="high"),
                    "bf16": cfg.replace(matmul_dtype="bfloat16",
                                        matmul_precision="default")}[mode]
            tables = (t32 if mode == "f32"
                      else beamform.make_tables(mcfg, algo, device="cuda"))
            fb = fk.FusedBeamformer(tables)
            assert fb.mode == mode, (fb.mode, mode)
            nnz = int((tables.W != 0).sum())
            wc = list(fb.wc) if fb.wc is not None else []
            nnz_c = fb.wc.val.numel() if wc else 0
            isz = fb.Wp.element_size()
            print(f"[K2-4] {algo:6s} {mode:4s}: Tw={fb.TK} (tile_d "
                  f"{fb.tile_d}) rows NL={fb.NL} lpad={fb.lpad}; tables "
                  f"held {fb.table_bytes / 1e6:.3f} MB (weights "
                  f"{nbytes(fb.Wp) / 1e6:.3f} MB, list {nnz_c} entries "
                  f"{nbytes(*wc) / 1e6:.3f} MB)")
            for B in (1, FULLRATE_BATCH):
                x = frames[:B]
                s, sj = fb.kernel_inputs(x)
                args = (s, fb.Wp, fb.bases, sj, fb.wc)

                def kern():
                    return fk.fused_power(*args, **fb.kernel_kw)

                def plain():
                    return fk.fused_power_plain(*args, **fb.kernel_kw)

                got, ref = kern(), plain()
                torch.cuda.synchronize()
                p = fb.launch_plan(B)
                shape = (B, fb.res_x, fb.res_y)
                got = got[:B, :fb.D].reshape(shape)
                ref = ref[:B, :fb.D].reshape(shape)
                assert torch.isfinite(got).all(), (algo, mode, B)
                err = rel_err(got, ref)
                abs_err = (got.double() - ref.double()).abs().max().item()
                err_td = rel_err(got, td[:B])
                peak_td = all(peak(got[b]) == peak(td[b]) for b in range(B))
                iters = 10 if B == 1 else 5
                k_ms, p_ms = in_turns(plain, kern, iters)
                pro_ms = time_ms(lambda: fb.kernel_inputs(x), iters)
                wall_ms = call_ms(lambda: fb(x), iters)
                # the dense product alone in the tables' dtype, at this B;
                # the port never calls it
                sdel = beamform.delay_lines(
                    x.permute(1, 0, 2)[tables.adaptive], tables.tau_min,
                    fb.T, stack_axis=0).to(tables.W.dtype)
                w2 = tables.W.reshape(fb.D, -1)
                sd2 = sdel.reshape(w2.shape[1], -1)
                lib_ms = time_ms(lambda: torch.matmul(w2, sd2), iters)
                del sdel, sd2
                # the work the maps need, whatever the plan: one product
                # per nonzero weight and sample, the squares and sums, one
                # per list entry and frame; bytes: the frames' samples, the
                # nonzero weights, sj, the list and the output, each once
                flops = 2 * B * N * nnz + 2 * B * fb.D * N + 2 * B * nnz_c
                bd = bound(B * fb.M * N * isz + nnz * isz + nbytes(sj, *wc)
                           + 4 * B * fb.D, flops)
                print(f"[K2-4] {algo:6s} {mode:4s} B={B:2d} Tw={fb.TK} "
                      f"G={p.G} NS={p.NS} NI={p.NI} MG={p.MG} "
                      f"({p.blocks} blocks, {p.bps} an SM, {p.smem} B "
                      f"shared): max rel err vs plain {err:.3e} (tol "
                      f"{TIME_RTOL:.0e}) max abs {abs_err:.3e} | vs exact "
                      f"FP32 {err_td:.3e} same peak {peak_td} | prologue "
                      f"{pro_ms:.4f} ms kernel {k_ms:.4f} ms plain "
                      f"{p_ms:.4f} ms dense matmul(W, Sdel) {lib_ms:.4f} ms "
                      f"| FusedBeamformer call {wall_ms:.4f} ms wall | bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
                      f"{bd['bound_ms'] / k_ms:.1%} of it) [{card}]")
                if (algo, mode, B) == ("lerp", "f32", FULLRATE_BATCH):
                    main = dict(max_abs_err=abs_err, ms=k_ms, plain_ms=p_ms,
                                library_ms=lib_ms, **bd)
                assert err <= TIME_RTOL, (
                    f"time kernel disagrees with plain: {algo} {mode} B={B}")
                if mode == "bf16":
                    assert err_td <= BF16_CLASS and peak_td, (
                        f"bf16 outside its class: {algo} B={B}")
                else:
                    assert err_td <= E2E_RTOL, (
                        f"time kernel vs exact: {algo} {mode} B={B}")
            del fb, tables
        del t32, td
        torch.cuda.empty_cache()
    return main


def _source_frame(cfg, tx: int, ty: int, seed: int = 3) -> np.ndarray:
    """Broadband source steered at grid cell (tx, ty): per-mic lags from
    the array geometry (the pipeline tests' ``_source_frames``)."""
    from zybo_rt_sampler_image_detection_torch.ops import geometry

    delays = geometry.calculate_delays(cfg)
    active, _ = geometry.active_microphones(cfg)
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(cfg.n_samples * 3).astype(np.float32) * 0.05
    lag = (delays[tx, ty].max() - delays[tx, ty]).round().astype(int)
    fr = np.zeros((cfg.n_microphones, cfg.n_samples), np.float32)
    for i, m in enumerate(active):
        s = cfg.n_samples - lag[i]
        fr[m] = base[s:s + cfg.n_samples]
    return fr


def _live_run(label: str, p, counter, sig: np.ndarray, tx: int,
              ty: int) -> int:
    """One live-stage run: the emulator on loopback -> ``p`` -> at least
    N_HEATMAPS maps, with every launch count set to 0 just before the run
    and the path's kernel's read just after; the peak at the source and one
    received frame
    against the plain FP32 ``steered_power``."""
    from zybo_rt_sampler_image_detection_torch.ingest.streamer import (
        NativeStreamer)
    from zybo_rt_sampler_image_detection_torch.ops import beamform

    cfg = p.cfg
    emu = NativeStreamer(cfg, n_arrays=cfg.active_arrays)
    maps = []
    try:
        emu.start(sig, rate=cfg.sample_rate)
        zero_counts()
        t0 = time.perf_counter()
        p.connect(timeout=30.0)
        p.start_heatmap()
        while len(maps) < N_HEATMAPS:
            power, seq = p.q_power.get(timeout=30.0)
            maps.append(power)
        elapsed = time.perf_counter() - t0
        frame, seq = p.receiver.read_frame(fresh=True, last_seq=0,
                                           timeout=10.0)
    finally:
        p.stop()
        launches = getattr(*counter)
        sent = emu.stop()
    rep = p.report()
    print(f"[e2e] {label}: {len(maps)} heatmaps in {elapsed:.2f} s (connect "
          f"and warm-up included); kernel launches {launches}; emulator "
          f"sent {sent} packets; report {json.dumps(rep)}")
    assert launches >= N_HEATMAPS, f"{label}: only {launches} launches"
    stack = np.stack(maps)
    assert stack.shape == (N_HEATMAPS, cfg.max_res_x, cfg.max_res_y)
    assert np.isfinite(stack).all(), "non-finite heatmap"
    pk = np.unravel_index(stack[-1].argmax(), stack[-1].shape)
    print(f"[e2e] {label}: last heatmap peak {tuple(int(i) for i in pk)} "
          f"(source at ({tx}, {ty}))")
    assert abs(pk[0] - tx) <= 1 and abs(pk[1] - ty) <= 1, "peak misplaced"

    x = torch.from_numpy(frame).cuda()
    got = p._power_fn(x)
    ref = beamform.steered_power(x, p.tables)
    torch.cuda.synchronize()
    err = rel_err(got, ref)
    print(f"[e2e] {label}: received frame seq={seq}: kernel path vs plain "
          f"FP32 steered_power max rel err {err:.3e} (tol {E2E_RTOL:.0e})")
    assert err <= E2E_RTOL, f"{label}: kernel path disagrees"
    return launches


def phase_end_to_end() -> dict:
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import (
        beamform, equiv_kernel as ek)

    cfg = Config()
    tx, ty = 40, 20
    sig = np.tile(_source_frame(cfg, tx, ty), (1, 8))
    t0 = time.perf_counter()
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="native",
                          power_backend="equiv_kernel", device="cuda")
    print(f"[e2e] pipeline built in {time.perf_counter() - t0:.2f} s "
          f"(kernel mode {p._power_fn.mode})")
    out = {"equiv": _live_run("power_backend=equiv_kernel", p,
                              (ek.equiv_power, "launches"), sig, tx, ty)}
    del p
    torch.cuda.empty_cache()

    # the same stage through K5: an explicit power_fn, as a user passes it
    fd = ek.FusedEquivBeamformer(beamform.make_tables(cfg, "lerp",
                                                      device="cuda"),
                                 sweep="fd")
    assert fd.runs_fd and fd.n_fc > 1, fd.n_fc
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="native",
                          device="cuda", power_fn=fd)
    out["fd"] = _live_run(f'sweep="fd" (n_fc={fd.n_fc}, fc={fd.fc})', p,
                          (ek.equiv_power_fd, "launches"), sig, tx, ty)
    del p, fd
    torch.cuda.empty_cache()

    t_high = beamform.make_tables(cfg.replace(matmul_precision="high"),
                                  "lerp", device="cuda")
    kind, _ = pipeline._select_power_backend(t_high)
    print(f"[policy] auto backend at matmul_precision='high': {kind}")
    assert kind == "equiv_kernel", kind
    return out


class _Recorder:
    """Wraps a stage's power_fn and keeps one batch it computed (input and
    output), for the check against the plain product."""

    def __init__(self, fn, keep_after: int = 8):
        self.fn, self.calls, self.keep_after = fn, 0, keep_after
        self.x = self.y = None

    def __call__(self, frames):
        out = self.fn(frames)
        self.calls += 1
        if self.x is None and self.calls > self.keep_after:
            self.x, self.y = frames.clone(), out.clone()
        return out


def _line_rate(p, stage, counter) -> tuple:
    """Drive a built, warmed-up full-rate stage of ``p``: the native
    emulator at line rate for FULLRATE_SECONDS, every launch count set to
    0 just before the run and the path's kernel's (``counter``) read just
    after it.  Returns (launches, seconds, packets sent, the emulator's
    count every 0.25 s)."""
    from zybo_rt_sampler_image_detection_torch.ingest.streamer import (
        NativeStreamer)

    cfg = p.cfg
    t = np.arange(cfg.n_samples * 64) / cfg.sample_rate
    sig = (np.tile(np.sin(2 * np.pi * 8000.0 * t).astype(np.float32),
                   (FULLRATE_CHANNELS, 1))
           + np.random.default_rng(5).standard_normal(
               (FULLRATE_CHANNELS, t.size)).astype(np.float32)) * 0.05
    emu = NativeStreamer(cfg, n_arrays=cfg.active_arrays)
    emu.start(sig, rate=cfg.sample_rate)
    try:
        p.connect(timeout=30.0)
        zero_counts()
        p.run_stage(stage)
        t0, sent0 = time.perf_counter(), emu.sent
        # the emulator's packets in each quarter second: an even slowdown
        # and one long stall look alike in the total
        marks = [sent0]
        while time.perf_counter() - t0 < FULLRATE_SECONDS:
            time.sleep(0.25)
            marks.append(emu.sent)
        sent = marks[-1] - sent0
    finally:
        p.stop()
        launches = getattr(*counter)
        elapsed = time.perf_counter() - t0
        emu.stop()
    return launches, elapsed, sent, marks


def _fullrate_run(label: str, make_pipeline, counter) -> dict:
    """One full-rate run: the stage built and warmed up, then driven at
    line rate (:func:`_line_rate`)."""
    from zybo_rt_sampler_image_detection_torch.ops import beamform

    p, rec = make_pipeline()
    cfg = p.cfg
    stage = p.make_heatmap_batched(batch=FULLRATE_BATCH,
                                   channels=FULLRATE_CHANNELS,
                                   sink=lambda powers, first_seq: None)
    stage.warmup()
    rec.x = rec.y = None
    rec.calls = 0
    launches, elapsed, sent, marks = _line_rate(p, stage, counter)
    rep = p.report()
    gaps = p.receiver.native_stats.gaps
    line_rate = cfg.sample_rate / cfg.n_samples
    lat = rep[stage.metric.name]
    print(f"[fullrate] {label}: processed {stage.processed} frames in "
          f"{elapsed:.2f} s ({stage.processed / elapsed:.1f}/s vs line rate "
          f"{line_rate:.1f}/s); skipped {stage.skipped}; ingest gaps {gaps}; "
          f"kernel launches {launches}; batch latency p50 "
          f"{lat['latency_p50_ms']} ms p95 {lat['latency_p95_ms']} ms; "
          f"emulator {sent / FULLRATE_SECONDS:.0f} pkt/s (line "
          f"{cfg.sample_rate:.0f}); packets per 0.25 s "
          f"{np.diff(marks).tolist()}")
    assert stage.processed > 0, "no batch processed"
    assert stage.skipped == 0, f"{label}: {stage.skipped} frames skipped"
    assert gaps == 0, f"{label}: {gaps} ingest gaps"
    assert launches * FULLRATE_BATCH >= stage.processed, (
        f"{label}: {launches} launches for {stage.processed} frames")
    assert rec.x is not None, "no batch recorded"
    ref = beamform.steered_power(rec.x, p.tables)
    torch.cuda.synchronize()
    err = rel_err(rec.y, ref)
    print(f"[fullrate] {label}: a received batch vs plain FP32 "
          f"steered_power: max rel err {err:.3e} (tol {E2E_RTOL:.0e})")
    assert torch.isfinite(rec.y).all() and err <= E2E_RTOL, label
    # the stage's device program alone (pad prologue + power) on a
    # 192-channel batch: the heatmaps/s the device could give
    x = rec.x[:, :FULLRATE_CHANNELS].contiguous()
    prog_ms = time_ms(lambda: stage.power_fn(x), 10)
    cap = FULLRATE_BATCH / prog_ms * 1e3
    print(f"[fullrate] {label}: device program {prog_ms:.3f} ms per batch "
          f"of {FULLRATE_BATCH} -> {cap:.0f} heatmaps/s "
          f"({cap / line_rate:.1f}x line rate)")
    out = dict(launches=launches, processed=stage.processed)
    del p, stage, rec
    torch.cuda.empty_cache()
    return out


def _ingest_alone(cfg, seconds: float = 2.0) -> None:
    """The host's share of the full-rate path, without the device: the
    emulator at line rate -> native ingest -> K-frame batches read and
    dropped.  Says whether the host alone reaches the line rate."""
    from zybo_rt_sampler_image_detection_torch.ingest.receiver import (
        Receiver)
    from zybo_rt_sampler_image_detection_torch.ingest.streamer import (
        NativeStreamer)

    rx = Receiver(cfg, replay_mode=True, backend="native")
    sig = np.random.default_rng(5).standard_normal(
        (FULLRATE_CHANNELS, cfg.n_samples * 64)).astype(np.float32) * 0.05
    emu = NativeStreamer(cfg, n_arrays=cfg.active_arrays)
    emu.start(sig, rate=cfg.sample_rate)
    read = skipped = 0
    try:
        rx.connect(timeout=30.0)
        next_seq = rx.stream_anchor_seq
        t0, sent0 = time.perf_counter(), emu.sent
        while time.perf_counter() - t0 < seconds:
            batch, first, sk = rx.read_batch(FULLRATE_BATCH, next_seq,
                                             timeout=1.0,
                                             channels=FULLRATE_CHANNELS)
            next_seq = first + FULLRATE_BATCH
            read += FULLRATE_BATCH
            skipped += sk
        elapsed, sent = time.perf_counter() - t0, emu.sent - sent0
    finally:
        rx.disconnect()
        emu.stop()
    line_rate = cfg.sample_rate / cfg.n_samples
    print(f"[fullrate] ingest alone (no device): read {read} frames in "
          f"{elapsed:.2f} s ({read / elapsed:.1f}/s vs line rate "
          f"{line_rate:.1f}/s); skipped {skipped}; ingest gaps "
          f"{rx.native_stats.gaps}; emulator {sent / elapsed:.0f} pkt/s "
          f"(line {cfg.sample_rate:.0f})")


def phase_fullrate() -> dict:
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import (
        beamform, equiv_kernel as ek, fused_kernel as fk)

    cfg = Config()
    _ingest_alone(cfg)
    out = {}

    def make_fused():
        tables = beamform.make_tables(cfg, "lerp", device="cuda")
        rec = _Recorder(fk.FusedBeamformer(tables))
        p = pipeline.Pipeline(cfg, "lerp", replay_mode=True,
                              backend="native", device="cuda", power_fn=rec)
        return p, rec

    out["fused"] = _fullrate_run("FusedBeamformer", make_fused,
                                 (fk.fused_power, "launches"))

    def make_equiv():
        p = pipeline.Pipeline(cfg, "lerp", replay_mode=True,
                              backend="native", device="cuda",
                              power_backend="equiv_kernel")
        p._power_fn = rec = _Recorder(p._power_fn)
        return p, rec

    out["equiv"] = _fullrate_run("power_backend=equiv_kernel", make_equiv,
                                 (ek.equiv_power, "launches"))

    def make_fd():
        tables = beamform.make_tables(cfg, "lerp", device="cuda")
        fd = ek.FusedEquivBeamformer(tables, sweep="fd")
        assert fd.runs_fd and fd.n_fc > 1, fd.n_fc
        rec = _Recorder(fd)
        p = pipeline.Pipeline(cfg, "lerp", replay_mode=True,
                              backend="native", device="cuda", power_fn=rec)
        return p, rec

    out["fd"] = _fullrate_run('FusedEquivBeamformer(sweep="fd")', make_fd,
                              (ek.equiv_power_fd, "launches"))
    return out


def phase_policy():
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import (
        beamform, fused_kernel as fk)

    cfg = Config().replace(matmul_dtype="bfloat16",
                           matmul_precision="default")
    tables = beamform.make_tables(cfg, "lerp", device="cuda")
    bar = pipeline._equiv_bar
    pipeline._equiv_bar = lambda t: False     # a shape outside the bar
    try:
        kind, obj = pipeline._select_power_backend(tables)
    finally:
        pipeline._equiv_bar = bar
    print(f"[policy] bf16 tables outside the equiv bar: {kind} "
          f"({type(obj).__name__}, mode {getattr(obj, 'mode', None)})")
    assert kind == "fused" and isinstance(obj, fk.FusedBeamformer), kind
    x = torch.randn(2, cfg.n_microphones, cfg.n_samples, device="cuda") * 0.05
    before = fk.fused_power.launches
    got = obj(x)
    torch.cuda.synchronize()
    assert fk.fused_power.launches == before + 1, "the kernel did not launch"
    ref = beamform.steered_power(x, tables)
    same = all(peak(got[b]) == peak(ref[b]) for b in range(2))
    err = rel_err(got, ref)
    print(f"[policy] fused bf16 vs the plain product on bf16 tables: max "
          f"rel err {err:.3e}, same peak {same}")
    assert same and err <= BF16_CLASS


class _PairRecorder:
    """Wraps the combined stage's ``process_fn`` and keeps one batch it
    computed (input, direction, maps and beams), for the checks against
    the plain products."""

    def __init__(self, fn, keep_after: int = 8):
        self.fn, self.keep_after = fn, keep_after
        self.reset()

    def reset(self):
        self.calls, self.x = 0, None

    def __call__(self, frames, d):
        powers, beams = self.fn(frames, d)
        self.calls += 1
        if self.x is None and self.calls > self.keep_after:
            self.x, self.d = frames.clone(), d
            self.y, self.b = powers.clone(), beams.clone()
        return powers, beams


def _beam_errors(got: np.ndarray, ref: np.ndarray) -> tuple:
    """(max abs err, max abs err over rtol*|ref| + atol) of the gain-scaled
    beams; the gate holds when the second is <= 1."""
    excess = np.abs(got - ref) / (LISTEN_RTOL * np.abs(ref) + LISTEN_ATOL)
    return float(np.abs(got - ref).max()), float(excess.max())


def _plain_beams(p, x: torch.Tensor, d: int) -> np.ndarray:
    """The plain beams of ``x`` toward ``d``: row d of the all-direction
    ``steered_beams`` (one dense product, not ``miso_beam``), through the
    pipeline's gain chain."""
    from zybo_rt_sampler_image_detection_torch.ops import beamform

    ref = beamform.steered_beams(x, p.tables)[..., d, :]
    return p._gain(ref.cpu().numpy())


def _listen_run(label: str, p, counter, card: str) -> dict:
    """One combined full-rate run (heatmaps and the beam from one
    transfer): built, steered, warmed up, driven at line rate; then the
    contract, a recorded batch against the plain products, the audio e2e
    latency, and the device program against the power program alone."""
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.ops import beamform
    from zybo_rt_sampler_image_detection_torch.utils import audio

    cfg = p.cfg
    N, n_full = cfg.n_samples, cfg.n_microphones
    sink = audio.NullSink()
    stage = p.make_mimo_miso_batched(batch=FULLRATE_BATCH,
                                     channels=FULLRATE_CHANNELS, sink=sink,
                                     power_sink=lambda powers, first: None)
    d = p.steer_cartesian_degree(LISTEN_AZ, LISTEN_EL)
    stage.process_fn = rec = _PairRecorder(stage.process_fn)
    stage.warmup()
    rec.reset()
    launches, elapsed, sent, marks = _line_rate(p, stage, counter)
    rep = p.report()[stage.metric.name]
    gaps = p.receiver.native_stats.gaps
    line_rate = cfg.sample_rate / N
    lat = stage.audio_latency()
    print(f"[listen] {label}: processed {stage.processed} frames in "
          f"{elapsed:.2f} s ({stage.processed / elapsed:.1f}/s vs line rate "
          f"{line_rate:.1f}/s); skipped {stage.skipped}; ingest gaps {gaps}; "
          f"underrun frames {stage.underrun_frames}; samples "
          f"{stage.samples}; kernel launches {launches}; batch latency p50 "
          f"{rep['latency_p50_ms']} ms p95 {rep['latency_p95_ms']} ms; "
          f"audio e2e p50 {lat.get('audio_e2e_p50_ms')} ms p95 "
          f"{lat.get('audio_e2e_p95_ms')} ms (newest frame p50 "
          f"{lat.get('audio_e2e_newest_p50_ms')} ms); emulator "
          f"{sent / FULLRATE_SECONDS:.0f} pkt/s; packets per 0.25 s "
          f"{np.diff(marks).tolist()} [{card}]")
    assert stage.processed > 0, "no batch processed"
    assert stage.skipped == 0, f"{label}: {stage.skipped} frames skipped"
    assert gaps == 0, f"{label}: {gaps} ingest gaps"
    assert stage.underrun_frames == 0, f"{label}: underruns"
    assert stage.samples == stage.processed * N == sink.frames, (
        f"{label}: {stage.samples} samples for {stage.processed} frames")
    assert launches * FULLRATE_BATCH >= stage.processed, (
        f"{label}: {launches} launches for {stage.processed} frames")
    assert lat, f"{label}: no audio latency recorded"

    assert rec.x is not None and rec.d == d, "no batch recorded"
    x = pipeline._pad_full(rec.x, n_full)
    err = rel_err(rec.y, beamform.steered_power(x, p.tables))
    got_b = p._gain(rec.b.cpu().numpy())
    abs_b, excess = _beam_errors(got_b, _plain_beams(p, x, d))
    print(f"[listen] {label}: a received batch (direction {d}): maps vs "
          f"plain FP32 steered_power max rel err {err:.3e} (tol "
          f"{E2E_RTOL:.0e}); beams after miso_gain vs row {d} of "
          f"steered_beams max abs err {abs_b:.3e} ({excess:.3f} of the "
          f"rtol {LISTEN_RTOL:.0e} / atol {LISTEN_ATOL:.0e} gate)")
    assert torch.isfinite(rec.y).all() and err <= E2E_RTOL, label
    assert np.isfinite(got_b).all() and excess <= 1.0, label

    # the device program per batch, CUDA events, in turns: the combined
    # program against the power program alone (the beam's added cost)
    xs = rec.x.contiguous()
    power_fn = p._power_fn or pipeline._batched_power_program(p.tables,
                                                              n_full)
    comb_ms, power_ms = in_turns(
        lambda: power_fn(pipeline._pad_full(xs, n_full)),
        lambda: stage.process_fn.fn(xs, d), 10)
    beam_ms = time_ms(
        lambda: beamform.miso_beam(pipeline._pad_full(xs, n_full), p.tables,
                                   d), 10)
    print(f"[listen] {label}: device program per batch of "
          f"{FULLRATE_BATCH}: maps + beam {comb_ms:.3f} ms, power program "
          f"alone {power_ms:.3f} ms (+{comb_ms - power_ms:.3f} ms), beam "
          f"alone {beam_ms:.3f} ms [{card}]")
    out = dict(launches=launches, processed=stage.processed,
               ms=comb_ms, power_ms=power_ms, **lat)
    del stage, rec
    return out


def phase_listen_fullrate(card: str) -> dict:
    """Phase 7 (a): the combined full-rate stage through the policy (K1 at
    ``high``) and through ``power_fn=FusedBeamformer(tables)``."""
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import (
        beamform, equiv_kernel as ek, fused_kernel as fk)

    cfg = Config()
    p = pipeline.Pipeline(cfg.replace(matmul_precision="high"), "lerp",
                          replay_mode=True, backend="native", device="cuda")
    out = {"equiv": _listen_run("policy (K1 at high)", p,
                                (ek.equiv_power, "launches"), card)}
    del p
    torch.cuda.empty_cache()
    fused = fk.FusedBeamformer(beamform.make_tables(cfg, "lerp",
                                                    device="cuda"))
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="native",
                          device="cuda", power_fn=fused)
    out["fused"] = _listen_run("power_fn=FusedBeamformer", p,
                               (fk.fused_power, "launches"), card)
    del p, fused
    torch.cuda.empty_cache()
    return out


class _ChunkSink:
    """An audio sink that keeps the size of every write and the first
    few chunks."""

    def __init__(self):
        self.sizes, self.chunks = [], []

    def write(self, samples):
        self.sizes.append(samples.shape[0])
        if len(self.chunks) < 4:
            self.chunks.append(np.array(samples))

    def close(self):
        pass


def phase_listen_live(card: str) -> int:
    """Phase 7 (b, c): the live K1 heatmap stage and the live listening
    stage side by side, steered by ``steer_cartesian_degree``; whole
    frames reach the sink, and one received frame's audio matches the
    plain beam; then 20 maps of the stage through ``viz.Front.multi_loop``
    headless.  Returns K1's launches in the run."""
    import queue

    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ingest.streamer import (
        NativeStreamer)
    from zybo_rt_sampler_image_detection_torch.ops import equiv_kernel as ek
    from zybo_rt_sampler_image_detection_torch.utils import viz

    cfg = Config()
    N = cfg.n_samples
    tx, ty = 40, 20
    sig = np.tile(_source_frame(cfg, tx, ty), (1, 8))
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="native",
                          power_backend="equiv_kernel", device="cuda")
    sink = _ChunkSink()
    emu = NativeStreamer(cfg, n_arrays=cfg.active_arrays)
    maps = []
    try:
        emu.start(sig, rate=cfg.sample_rate)
        zero_counts()
        t0 = time.perf_counter()
        p.connect(timeout=30.0)
        p.start_heatmap()
        miso = p.start_miso(sink=sink)
        d = p.steer_cartesian_degree(LISTEN_AZ, LISTEN_EL)
        while len(maps) < N_HEATMAPS or len(sink.sizes) < N_HEATMAPS:
            maps.append(p.q_power.get(timeout=30.0)[0])
            assert time.perf_counter() - t0 < 60.0, "live stages stalled"
        elapsed = time.perf_counter() - t0
        frame, seq = p.receiver.read_frame(fresh=True, last_seq=0,
                                           timeout=10.0)
    finally:
        p.stop()
        launches = ek.equiv_power.launches
        emu.stop()
    rep = p.report()
    print(f"[live-listen] {len(maps)} heatmaps and {len(sink.sizes)} audio "
          f"frames in {elapsed:.2f} s (connect and warm-up included); K1 "
          f"launches {launches}; heatmap {json.dumps(rep['heatmap'])}; "
          f"miso {json.dumps(rep['miso'])} [{card}]")
    assert launches >= N_HEATMAPS, f"only {launches} K1 launches"
    assert set(sink.sizes) == {N}, f"partial audio frames: {set(sink.sizes)}"
    assert all(np.isfinite(c).all() for c in sink.chunks)
    x = torch.from_numpy(frame).cuda()
    got = miso.beam(frame)
    abs_b, excess = _beam_errors(got, _plain_beams(p, x, d))
    print(f"[live-listen] received frame seq={seq}, direction {d}: audio vs "
          f"row {d} of steered_beams max abs err {abs_b:.3e} ({excess:.3f} "
          f"of the gate)")
    assert got.shape == (N,) and np.isfinite(got).all() and excess <= 1.0

    # (c) the heatmap display, headless: 20 of the stage's maps
    stack = np.stack(maps[:N_HEATMAPS])
    assert np.isfinite(stack).all(), "non-finite heatmap"
    q = queue.Queue()
    for m in stack:
        q.put(m)
    ramp = np.linspace(0, 255, 640, dtype=np.float32)
    cam = np.broadcast_to(ramp[None, :, None], (480, 640, 3)).astype(
        np.uint8)
    disp = viz.ArrayDisplay(keep=N_HEATMAPS)
    t1 = time.perf_counter()
    viz.Front(q, queue.Queue(), True, window=(720, 480),
              capture=viz.ArrayCapture([cam]), display=disp).multi_loop(
        max_frames=N_HEATMAPS)
    show_ms = (time.perf_counter() - t1) * 1e3 / N_HEATMAPS
    print(f"[display] {len(disp.frames)} frames through Front.multi_loop "
          f"(720x480, cv2 {viz.imaging._HAS_CV2}): {show_ms:.2f} ms a frame "
          f"on the host")
    assert len(disp.frames) == N_HEATMAPS
    assert all(f.shape == (480, 720, 3) and f.dtype == np.uint8
               for f in disp.frames)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # without the package beside this script, fail before printing anything
    import zybo_rt_sampler_image_detection_torch  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = phase_card_and_build()
    main_k = phase_kernel_vs_plain(card)
    t1 = time.perf_counter()
    main_fd = phase_fd_vs_plain(card)
    t2 = time.perf_counter()
    main_t = phase_time_kernel_vs_plain(card)
    t3 = time.perf_counter()
    live = phase_end_to_end()
    t4 = time.perf_counter()
    full = phase_fullrate()
    phase_policy()
    t5 = time.perf_counter()
    listen = phase_listen_fullrate(card)
    listen_live = phase_listen_live(card)
    t6 = time.perf_counter()
    print(f"[time] build+K1 {t1 - t0:.1f} s, K5 {t2 - t1:.1f} s, K2-4 "
          f"{t3 - t2:.1f} s, live {t4 - t3:.1f} s, full rate+policy "
          f"{t5 - t4:.1f} s, listen {t6 - t5:.1f} s")
    # launches: the main path's run (phase 5 live / phase 6 full rate);
    # listen_launches: the combined full-rate stage's run (phase 7)
    kernels = [dict(name="equiv_power", route="cuda", source=KERNEL_SOURCE,
                    replaces=KERNEL_REPLACES, launches=live["equiv"],
                    listen_launches=listen["equiv"]["launches"],
                    listen_live_launches=listen_live, **main_k)]
    kernels.append(dict(
        name="time_power", route="cuda", source=TIME_SOURCE,
        replaces=TIME_REPLACES[0], also_replaces=TIME_REPLACES[1:],
        launches=full["fused"]["launches"],
        listen_launches=listen["fused"]["launches"], **main_t))
    kernels.append(dict(
        name="equiv_power_fd", route="cuda", source=FD_SOURCE,
        replaces=FD_REPLACES, launches=full["fd"]["launches"], **main_fd))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
