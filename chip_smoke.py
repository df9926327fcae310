"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive.

    python3 chip_smoke.py

Needs one CUDA GPU (exits non-zero without one) and ``nvcc`` to build the
kernels from the sources in this checkout.  Imports nothing of JAX.

Phases (any failure raises, so the exit code is non-zero):

1. Card and build: ``nvidia-smi`` name and power limit, the kernel build.
2. The fused equiv-power kernel against its plain torch version on the
   card, at ``Config()`` (256 mics, 57x32 grid) for lerp and hybrid, in
   modes f32/high/bf16, at B=1 and B=37, with CUDA-event times of both.
3. The slice end to end: the native emulator on loopback ->
   ``Pipeline(..., power_backend="equiv_kernel", device="cuda")`` -> at
   least 20 heatmaps, with the kernel's launch counter read around the
   run; one received frame checked against the plain FP32 time-domain
   ``steered_power``; the auto policy at ``high`` must pick the kernel.

The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "zybo_rt_sampler_image_detection_torch/ops/csrc/equiv_power.cu"
KERNEL_REPLACES = "zybo_rt_sampler_image_detection_tpu/ops/equiv_kernel.py:74"
# max cellwise relative error of the kernel against its plain version
TOL = {"f32": 2e-6, "high": 5e-5, "bf16": 3e-2}
E2E_RTOL = 1e-4            # kernel path vs plain FP32 steered_power
N_HEATMAPS = 20


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()


def peak(m: torch.Tensor) -> tuple:
    return tuple(int(i) for i in np.unravel_index(int(m.argmax()), m.shape))


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


def phase_card_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    from zybo_rt_sampler_image_detection_torch.ops import _build

    t0 = time.perf_counter()
    _build.load("equiv_power")
    print(f"[build] equiv_power.cu built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds.get('equiv_power', 0.0):.2f} s)")
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
            for B in (1, 37):
                x = frames[:B]
                S, sj, bt = fk.kernel_inputs(x)
                kw = dict(n_tail=fk.n_tail, Tc=fk.Tc, inv=fk.inv)
                args = (S, fk.H1, fk.H2, fk.ib1, fk.ib2, sj, fk.Wc3)
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
                # in turns: plain, kernel, kernel, plain
                p1 = time_ms(lambda: ek.equiv_power_plain(*args, **kw), iters)
                k1 = time_ms(lambda: ek.equiv_power(*args, block_b=bt, **kw),
                             iters)
                k2 = time_ms(lambda: ek.equiv_power(*args, block_b=bt, **kw),
                             iters)
                p2 = time_ms(lambda: ek.equiv_power_plain(*args, **kw), iters)
                k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
                ok = err <= TOL[mode] and (mode != "bf16" or same_peak)
                print(f"[K1] {algo:6s} {mode:4s} B={B:2d} bt={bt} "
                      f"F={fk.F} Tt={fk.Tt}: max rel err vs plain {err:.3e} "
                      f"(tol {TOL[mode]:.0e}) max abs {abs_err:.3e} "
                      f"same peak {same_peak} | vs time-domain "
                      f"{err_td:.3e} | kernel {k_ms:.4f} ms plain "
                      f"{p_ms:.4f} ms [{card}]")
                assert ok, f"kernel disagrees with plain: {algo} {mode} B={B}"
                if (algo, mode, B) == ("lerp", "f32", 1):
                    # the main path's shape: Config() lerp, highest -> f32
                    main = dict(max_abs_err=abs_err, ms=k_ms, plain_ms=p_ms)
            del fk
        del tables, td
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


def phase_end_to_end() -> int:
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ingest.streamer import (
        NativeStreamer)
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
    emu = NativeStreamer(cfg, n_arrays=cfg.active_arrays)
    maps = []
    try:
        emu.start(sig, rate=cfg.sample_rate)
        ek.equiv_power.launches = 0
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
        sent = emu.stop()
    launches = ek.equiv_power.launches
    rep = p.report()
    print(f"[e2e] {len(maps)} heatmaps in {elapsed:.2f} s (connect and "
          f"warm-up included); kernel launches {launches}; emulator sent "
          f"{sent} packets; report {json.dumps(rep)}")
    assert launches >= N_HEATMAPS, f"only {launches} kernel launches"
    stack = np.stack(maps)
    assert stack.shape == (N_HEATMAPS, cfg.max_res_x, cfg.max_res_y)
    assert np.isfinite(stack).all(), "non-finite heatmap"
    pk = np.unravel_index(stack[-1].argmax(), stack[-1].shape)
    print(f"[e2e] last heatmap peak {tuple(int(i) for i in pk)} "
          f"(source at ({tx}, {ty}))")
    assert abs(pk[0] - tx) <= 1 and abs(pk[1] - ty) <= 1, "peak misplaced"

    x = torch.from_numpy(frame).cuda()
    got = p._power_fn(x)
    ref = beamform.steered_power(x, p.tables)
    torch.cuda.synchronize()
    err = rel_err(got, ref)
    print(f"[e2e] received frame seq={seq}: kernel path vs plain FP32 "
          f"steered_power max rel err {err:.3e} (tol {E2E_RTOL:.0e})")
    assert err <= E2E_RTOL, "kernel path disagrees with steered_power"
    del p
    torch.cuda.empty_cache()

    t_high = beamform.make_tables(cfg.replace(matmul_precision="high"),
                                  "lerp", device="cuda")
    kind, _ = pipeline._select_power_backend(t_high)
    print(f"[policy] auto backend at matmul_precision='high': {kind}")
    assert kind == "equiv_kernel", kind
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
    card = phase_card_and_build()
    main_k = phase_kernel_vs_plain(card)
    launches = phase_end_to_end()
    print(json.dumps({"kernels": [dict(
        name="equiv_power", route="cuda", source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES, launches=launches, **main_k)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
