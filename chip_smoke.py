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
   and the table bytes the class holds.  Then K1 f32 at B=16 on the plane
   over the 192 connected channels of a channel-sliced stage beside the
   full 256-mic plane, timed in turns, with the plane's channel count
   and the gap between the two.
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
8. FFT and MVDR (``ops.freq``; the Bartlett contraction is
   ``csrc/bartlett_power.cu``, the MVDR quadratic form
   ``csrc/quad_form.cu``, the rest plain torch): (a) the Bartlett
   map of the golden reference frame at ``Config()`` (100-20000 Hz) and
   ``Config.fft_reference()`` against the complex128 run of the same
   function (rtol 2e-4 / atol 1e-6) and its distance to the golden rows;
   at B=1 and B=16 random frames through the route at the same gate, the
   kernel against its plain version (map gap 1e-5), and the time per call
   of the route and of the kernel beside their bounds, the plain version
   and one ``torch.matmul`` of the complex steering product; the fft
   full-rate stage launches ``bartlett_power`` once a batch; (b) 20 batches of 16
   drifting-tone frames through ``make_mvdr_stream("maps")`` in complex64
   against the same stream in complex128 (every map finite, worst
   direction within 0.05 on every frame); (b2) the quadratic form
   kernel at the MVDR cell's shape and at ``Config()``'s 256 mics on a
   streamed P, against the complex128 form, bitwise repeats, and its time
   beside its bound, its plain version and the cuBLAS chain it replaced;
   (c) the full-rate heatmap stage
   of ``Pipeline(cfg, "mvdr")``, which takes the route's stream as it is
   (K=16, 192 channels, 4 s at line rate; 0 skipped, 0
   gaps; a kernel launch for each quadratic form), and the device ms of
   one batch's scan, of ``mvdr_d0`` and of
   ``refresh_precision``, each with its bound; (d) the combined stage
   with ``beam="mvdr"`` (maps and beams from one state update; 0 skipped,
   0 gaps, 0 underruns, ``processed * 256`` samples, beams finite and
   ``|beam| < 10``); (e) 20 maps of the live stage through the stream's
   single-frame recursion, with the per-frame latency.
9. Vision and the host sensor-fusion chain (``models``, ``fusion``; no
   kernel of their own: cuDNN FP32 convs with TF32 off, decode and NMS in
   torch): (a) the full-width detector (``YoloConfig()``: 416 px, width
   1.0, seeded, random BatchNorm statistics) on the card against the same
   module on the CPU at K = 1, 4, 16 (heads at rtol 1e-5 / atol 1e-5;
   detection tables at rtol 1e-5 / atol 1e-4 with equal masks and
   indices, from the same heads and end to end), with CUDA-event times of
   the forward and of decode + NMS, the wall time of one
   ``get_detections_batch``, NMS's share and the forward's bound; (b) the
   committed demo detector's AP@0.5 on 48 held-out frames (at least 0.75)
   and its detections against its CPU run; (c) the host chain beside the
   live K1 stage: ``SceneCamera`` -> ``start_tracker_batched`` (the demo
   detector, K=4) -> ``Viewer.loop`` through ``SensorFusionDecider`` for
   30 composited frames, each overlay's ``rect_conf`` offered to
   ``focus_beam``; every dequeued camera frame processed, K1 launched, the
   scene object found in 4 of 6 probed frames, ``focus_beam`` steered.
10. The device compositor and the fused stage (``fusion/composite.py``,
   ``apps/fused.py``; plain torch, no kernel of their own; K1 inside):
   (a) ``DeviceCompositor`` at ``Config()``'s grid, 240x320 cameras, a
   640x360 window, 8 track boxes, K=16, on the card against its CPU run
   (the host chain's gates, power centers within 1 px), with its device
   ms a batch beside its bytes bound; (b) ``FusedSensorStage`` (K=16,
   192 channels, the committed demo detector, ``Config()`` lerp at
   ``high``: K1) on a pre-rendered ``SceneCamera`` from the native
   emulator, with ``display_transport`` rgb and then yuv420, each for
   192 composited frames: frames/s, ``phase_p50_ms``, K1 launches, a
   recorded batch's composites equal to ``DeviceCompositor`` on the
   stage's own powers and its detections against ``det.program`` on the
   same resized input (atol 1e-5, equal masks and classes), and the
   device ms a batch of the program and of its power / detector /
   composite parts; (c) one batch with the full-width detector
   (``YoloConfig()``, seeded, random BatchNorm statistics); (d) 4 s of
   ``listen="time"`` and then ``"mvdr"`` (mic batch 64, a ring of four
   mic batches as the demo sizes it) at line rate: 0 underrun frames,
   audio frames equal to the mic frames beamed, the audio e2e p50/p95,
   a recorded batch's beams against ``miso_beam`` /
   ``mvdr_listen_step`` run apart (rtol 1e-4 / atol 1e-7); (e) ``demo
   sensorfusion --replay --frames 30 --out ''`` (the fused default) and
   ``--composite device``, each exiting 0.

11. Training (``models/train.py``; no kernel of its own: cuDNN FP32 convs
   with TF32 off in the forward and the backward, torch's AdamW): (a) five
   train steps at the demo shape (64 px, width 0.25, B=8) from one seeded
   init on the card against the CPU, each in eight batch orders (losses
   at rtol 1e-4, every leaf within a relative norm of 3e-4, for at least
   one pair of orders); (b) train steps/s and img/s
   at the demo shape and at ``YoloConfig(416, width 1.0, 3 classes)``
   with B=16 (CUDA events after warm-up), a ``utils.profiling.trace`` of
   five steps split into forward / backward / optimizer with the top
   device kernels and the device's idle share, the step's bound, and the
   host cost of one ``annotate`` range; (c)
   ``train.pretrained_demo_detector(steps=700)`` on the card with a
   temporary cache, held-out AP@0.5 at least 0.75; (d)
   ``train_reference_recipe`` at 416 px, width 1.0, 3 classes, B=16, cut
   to 300 steps with a pool of 16 batches and 64 held-out images: steps/s,
   img/s, the losses, mAP, the saved weights loaded into a
   ``YoloDetector`` and run, the loss falling; (e) ``demo record
   --replay --seconds 1`` from the native emulator, the ``.npy`` shape
   checked.
12. The web monitor (``apps/web.py``) at ``Config()`` with
   ``matmul_precision="high"`` on the card, on loopback, fed by the native
   emulator at line rate: a 60 s soak of ``/enableBackend1`` with one
   ``/monitor`` client (VmRSS every 5 s; at most 64 MB of growth after the
   first 15 s), then ``?fullrate=1``, ``?fused=1``, ``/sound``,
   ``/sound?beam=mvdr``, ``/enableBackend3`` and ``/enableBackend4`` for
   4 s each: MJPEG frames/s on the true multipart boundary, ``/metrics``
   (stage rates and latencies, overlay errors, the JPEG encoder), K1
   launches (the policy's routes must launch it); a route fails when it
   serves no frame or its overlay errors grow after its first second.
13. The device mesh (``parallel/mesh.py``) over ``cuda:0`` as (1, 1) and
   (2, 2) (and every card when there are more): each sharded power at
   ``Config()`` against its single-device result at the gates of the JAX
   package's tests/test_parallel.py, K1 and K2 launches a block, sharded
   against single-device times in turns; the sharded full-rate stage
   (K=16, full width, the policy at ``high``: K1 a block) for 4 s at line
   rate, 0 skipped, 0 gaps, a batch against ``steered_power``;
   ``Trainer(mesh=(2, 1))`` against ``Trainer()`` on one global batch
   (loss rtol 1e-4, leaves 3e-4); ``dryrun_multichip(4)``.

The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import queue
import subprocess
import sys
import threading
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
BARTLETT_SOURCE = f"{CSRC}/bartlett_power.cu"   # replaces no TPU kernel
QUAD_FORM_SOURCE = f"{CSRC}/quad_form.cu"       # replaces no TPU kernel
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
# phase 8: Bartlett against its complex128 run (the JAX package's
# tests/test_freq.py:25), the complex64 MVDR stream against its complex128
# run (worst direction, tests/test_freq.py:570), the batches of (b), the
# audio lag limit of phase 7 (three batch periods at line rate) and the
# frame period (the live stage's limit)
BARTLETT_RTOL, BARTLETT_ATOL = 2e-4, 1e-6
# the Bartlett kernel against its plain version: the widest gap of a map
# over its largest value (tests/test_torch_cuda.py's BARTLETT_GAP); and
# the batches of the fft full-rate stage whose launches are counted
BARTLETT_GAP = 1e-5
BARTLETT_BATCHES = 8
MVDR_DRIFT = 0.05
MVDR_BATCHES = 20
AUDIO_LIMIT_MS = 3 * FULLRATE_BATCH * 256 / 48828 * 1e3
FRAME_MS = 256 / 48828 * 1e3
# phase 9: the detector's heads and tables on the card against the CPU
# (tables: the JAX package's tests/test_vision.py:207), the AP gate of
# tests/test_vision.py:189, the batch sizes, the composited frames
VISION_HEAD_RTOL = VISION_HEAD_ATOL = 1e-5
VISION_DET_RTOL, VISION_DET_ATOL = 1e-5, 1e-4
VISION_AP_GATE = 0.75
VISION_KS = (1, 4, 16)
VISION_FRAMES = 30


def zero_counts() -> None:
    """Every kernel wrapper's launch count to 0, just before a path runs."""
    from zybo_rt_sampler_image_detection_torch.ops import (
        bartlett_kernel as bk, equiv_kernel as ek, fused_kernel as fk)

    for wrapper in (ek.equiv_power, ek.equiv_power_fd, fk.fused_power,
                    bk.bartlett_power):
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
    """The route of the class's mode at the full-rate batch and the table
    bytes it holds."""
    h1 = fk.H1.numel() * fk.H1.element_size()
    nnz = 0 if fk.wc is None else fk.wc.val.numel()
    return (f"route {ek.route(fk.plane_dtype, fk.Tt, FULLRATE_BATCH)}; "
            f"tables held "
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


def device_ms(fn, iters: int) -> dict:
    """Mean device time a call of each kernel ``fn`` launches
    (``torch.profiler``'s CUDA activity over ``iters`` calls, after one
    warm-up): {kernel name: ms}.  Unlike :func:`time_ms`, host gaps
    between launches do not count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / iters / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


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

    names = ("equiv_power", "time_power", "equiv_power_fd", "bartlett_power",
             "quad_form")
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
    """K1 against its plain version at Config() (the cfgjson cell's shape)
    in every mode, then at the onboard64 cell's shape (one 64-channel
    board, 65x65 grid) on the FP32 route; returns the main path's entry
    (Config() lerp f32 B=1)."""
    from zybo_rt_sampler_image_detection_torch.config import Config

    main = _k1_vs_plain(card, "Config()", Config(), ("lerp", "hybrid"),
                        ("f32", "high", "bf16"))
    _k1_vs_plain(card, "onboard64", Config.northstar(), ("lerp",),
                 ("f32", "high"))
    phase_k1_trim(card)
    return main


def phase_k1_trim(card: str) -> None:
    """K1 f32 at B=16 at Config() lerp on the plane over the connected
    channels (``FusedEquivBeamformer(channels=192)``, the sliced batch)
    beside the full plane (the batch padded to 256 rows): each kernel's
    CUDA-event time in turns (full, trimmed, trimmed, full), the planes'
    channel counts, KP and the bound of each, and the maps' gap."""
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import (
        beamform, equiv_kernel as ek)

    cfg, B, C = Config(), FULLRATE_BATCH, FULLRATE_CHANNELS
    et = ek.make_equiv_tables(beamform.make_tables(cfg, "lerp",
                                                   device="cuda"))
    gen = torch.Generator("cuda").manual_seed(1234)
    x = torch.randn(B, C, cfg.n_samples, device="cuda", generator=gen) * 0.05
    runs = {}
    for label, channels, frames in (
            ("full", 0, pipeline._pad_full(x, cfg.n_microphones)),
            ("trimmed", C, x)):
        fk = ek.FusedEquivBeamformer(et, mode="f32", channels=channels)
        S, sj, bt = fk.kernel_inputs(frames)
        args = (S, fk.H1, fk.ib1, fk.ib2, sj, fk.wc)
        kw = dict(n_tail=fk.n_tail, Tc=fk.Tc, inv=fk.inv, block_b=bt)
        runs[label] = (fk, lambda a=args, k=kw: ek.equiv_power(*a, **k),
                       fk(frames))
    (full, kfull, mfull), (trim, ktrim, mtrim) = runs["full"], runs["trimmed"]
    f1, t1 = time_ms(kfull, 10), time_ms(ktrim, 10)
    t2, f2 = time_ms(ktrim, 10), time_ms(kfull, 10)
    gap = ((mtrim - mfull).abs().max() / mfull.abs().max()).item()
    for label, fk, ms in (("full", full, (f1 + f2) / 2),
                          ("trimmed", trim, (t1 + t2) / 2)):
        bd = equiv_bound(fk, B)
        print(f"[K1-trim] Config() lerp f32 B={B} {label}: plane over "
              f"{fk.M} mics (channels {fk.channels or cfg.n_microphones}), "
              f"KP {fk.KP}, H1 {nbytes(fk.H1) / 1e9:.4f} GB | kernel "
              f"{ms:.4f} ms | bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']}, {bd['bound_ms'] / ms:.1%} of it) | route "
              f"{ek.route(fk.plane_dtype, fk.Tt, B)} [{card}]")
    print(f"[K1-trim] trimmed / full {(t1 + t2) / (f1 + f2):.3f}; maps' gap "
          f"max|trimmed - full| / max|full| {gap:.3e} (limit 1e-6) [{card}]")
    assert trim.channels == C and trim.M == C and gap <= 1e-6, gap
    del runs, full, trim, et
    torch.cuda.empty_cache()


def _k1_vs_plain(card: str, label: str, cfg, algos, modes) -> dict:
    from zybo_rt_sampler_image_detection_torch.ops import (
        beamform, equiv_kernel as ek)

    gen = torch.Generator("cuda").manual_seed(1234)
    frames = torch.randn(37, cfg.n_microphones, cfg.n_samples,
                         device="cuda", generator=gen) * 0.05
    main = None
    for algo in algos:
        tables = beamform.make_tables(cfg, algo, device="cuda")
        td = beamform.steered_power(frames, tables)      # exact FP32 product
        for mode in modes:
            fk = ek.FusedEquivBeamformer(tables, mode=mode)
            print(f"[K1] {label} {algo:6s} {mode:4s}: {describe(ek, fk)}")
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
                print(f"[K1] {label} {algo:6s} {mode:4s} B={B:2d} bt={bt} "
                      f"F={fk.F} Tt={fk.Tt}: max rel err vs plain {err:.3e} "
                      f"(tol {TOL[mode]:.0e}) max abs {abs_err:.3e} "
                      f"same peak {same_peak} | vs time-domain "
                      f"{err_td:.3e} | kernel {k_ms:.4f} ms plain "
                      f"{p_ms:.4f} ms bmm pair (FP32) {pair_ms:.4f} ms "
                      f"one-plane bmm {one_ms:.4f} ms | bound "
                      f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
                      f"{bd['bound_ms'] / k_ms:.1%} of it) | route "
                      f"{ek.equiv_power.last_route} [{card}]")
                assert ok, f"kernel disagrees with plain: {algo} {mode} B={B}"
                if (algo, mode, B) == ("lerp", "f32", 1):
                    # the main path's shape: lerp, highest -> f32
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
    got = p.stages[-1].power_fn(x)
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
    print(f"[e2e] pipeline built in {time.perf_counter() - t0:.2f} s")
    out = {"equiv": _live_run("power_backend=equiv_kernel", p,
                              (ek.equiv_power, "launches"), sig, tx, ty)}
    print(f"[e2e] kernel mode {p.stages[-1].power_fn.mode}")
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
    0 just before the run and the path's kernel's (``counter``; None on a
    path without one) read just after it.  Returns (launches, seconds,
    packets sent, the emulator's count every 0.25 s)."""
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
        launches = getattr(*counter) if counter else None
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
        # the program power_backend="equiv_kernel" builds, recorded
        tables = beamform.make_tables(cfg, "lerp", device="cuda")
        rec = _Recorder(ek.FusedEquivBeamformer(tables))
        p = pipeline.Pipeline(cfg, "lerp", replay_mode=True,
                              backend="native", device="cuda", power_fn=rec)
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
    # the report names the block split of the object's last launch
    rep, p = obj.report(), obj.launch_plan(2)
    split = {k: rep[k] for k in ("G", "NS", "MG", "stagings")}
    print(f"[policy] fused bf16 vs the plain product on bf16 tables: max "
          f"rel err {err:.3e}, same peak {same}; report's split {split}")
    assert same and err <= BF16_CLASS
    assert split == {"G": p.G, "NS": p.NS, "MG": p.MG,
                     "stagings": fk.stagings(p, obj.N, obj.DP)}, split


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
    power_fn = pipeline.power_program(p.tables, n_full,
                                      power_fn=p._power_fn)
    comb_ms, power_ms = in_turns(
        lambda: power_fn(xs),
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


# -- phase 8: FFT and MVDR ---------------------------------------------------


def _cplx_bytes(*shape) -> int:
    return 8 * int(np.prod(shape))


def phase_bartlett(card: str) -> dict:
    """(a) Bartlett on the golden reference frame at Config() (100-20000
    Hz) and Config.fft_reference(), through the Bartlett kernel, against
    the complex128 run of the same function, with its distance to the
    golden rows (recorded on the CPU); at B=1 and B=16, random frames
    through the route against their complex128 run (the same gate), the
    kernel alone (``bartlett_power`` on the rfft) against its plain
    version (map gap at most ``BARTLETT_GAP``), and the time per call of
    the route (rfft and kernel) against its bound (bytes of the steering
    tensor, the frames and the maps once; operations of the complex
    product (8 F B M D), the squares and sums, and the rfft (2.5 N log2 N
    a row)), of the kernel in turns with its plain version against the
    kernel's bound (the tensor, the spectra it reads and the maps; 8 F B M
    D), and of one ``torch.matmul`` of the (F, B, M) x (F, M, D) complex
    steering product (the library yardstick; the port never calls it).
    Then the fft full-rate stage of Config.fft_reference() (the web app's
    program, B=16) with the launch counts zeroed: one ``bartlett_power``
    launch a batch.  Returns the kernel's figures at the web app's shape,
    B=16, and those launches."""
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import bartlett_kernel as bk
    from zybo_rt_sampler_image_detection_torch.ops import freq

    def excess(got, ref):
        return ((got.double() - ref).abs()
                / (BARTLETT_RTOL * ref.abs() + BARTLETT_ATOL)).max().item()

    def map_gap(got, ref):
        got, ref = got.double().flatten(1), ref.double().flatten(1)
        return ((got - ref).abs().amax(1) / ref.amax(1)).max().item()

    golden = np.load(os.path.join(HERE, "tests", "golden",
                                  "reference_heatmaps.npz"))
    frame = torch.from_numpy(golden["frame"]).cuda()
    out = {}
    for label, cfg, band, row in (
            ("Config() 100-20000 Hz", Config(), (100.0, 20000.0), "fft"),
            ("Config.fft_reference()", Config.fft_reference(), (),
             "fft_reference_profile")):
        t = freq.make_freq_tables(cfg, *band, device="cuda")
        got = freq.fft_steered_power(frame, t)
        ref = freq.fft_steered_power(frame.double(), t)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), label
        gold = golden[row]
        g_err = float((np.abs(got.cpu().numpy() - gold)
                       / np.abs(gold)).max())
        F, M, D = t.phase.shape
        print(f"[fft] {label}: F={F} M={M} D={D}; vs its complex128 run "
              f"{excess(got, ref):.3f} of the rtol {BARTLETT_RTOL:.0e} / "
              f"atol {BARTLETT_ATOL:.0e} gate; vs the golden row '{row}' "
              f"max rel {g_err:.3e} (the JAX gate 1e-5, rows recorded on "
              f"the CPU) [{card}]")
        assert excess(got, ref) <= 1.0, f"Bartlett outside its gate: {label}"
        gen = torch.Generator("cuda").manual_seed(8642)
        adaptive, bins, extent = t.kernel_indices
        for B in (1, FULLRATE_BATCH):
            x = torch.randn(B, cfg.n_microphones, cfg.n_samples,
                            device="cuda", generator=gen) * 0.05
            r_exc = excess(freq.fft_steered_power(x, t),
                           freq.fft_steered_power(x.double(), t))
            S = freq._frame_fft(x, t).transpose(0, 1).contiguous()
            spec = torch.fft.rfft(x, dim=-1)
            iters = 20 if B == 1 else 10
            before = bk.bartlett_power.launches
            call = time_ms(lambda: freq.fft_steered_power(x, t), iters)
            assert bk.bartlett_power.launches == before + iters + 1, label

            def kern():
                return bk.bartlett_power(spec, t.phase_tiles, adaptive, bins,
                                         D=D, extent=extent)

            def plain():
                return bk.bartlett_power_plain(spec, t.phase_tiles,
                                               adaptive, bins, D=D)

            k_ms, p_ms = in_turns(plain, kern, iters)
            k_gap = map_gap(kern(), plain())
            dev = device_ms(lambda: freq.fft_steered_power(x, t), iters)
            k_dev = sum(v for k, v in dev.items() if "bartlett" in k)
            lib = time_ms(lambda: torch.matmul(S, t.phase), iters)
            N = cfg.n_samples
            bd = bound(_cplx_bytes(F, M, D) + 4 * B * cfg.n_microphones * N
                       + 4 * B * D,
                       8 * F * B * M * D + 3 * F * B * D
                       + 2.5 * B * M * N * np.log2(N))
            kb = bound(_cplx_bytes(F, M, D) + _cplx_bytes(B, M, F)
                       + 4 * B * D, 8 * F * B * M * D)
            print(f"[fft] {label} B={B:2d}: route vs its complex128 run "
                  f"{r_exc:.3f} of the gate; fft_steered_power "
                  f"{call:.4f} ms, device "
                  + ", ".join(f"{k[:40]} {v:.4f}" for k, v in dev.items())
                  + f" ms | bound {bd['bound_ms']:.4f} ms "
                  f"({bd['bound_by']}); bartlett_power {k_ms:.4f} ms "
                  f"(device {k_dev:.4f}, both passes), "
                  f"plain {p_ms:.4f} ms (map gap {k_gap:.2e}, limit "
                  f"{BARTLETT_GAP:.0e}), torch.matmul (F, B, M) x (F, M, D) "
                  f"complex64 {lib:.4f} ms | kernel bound "
                  f"{kb['bound_ms']:.4f} ms ({kb['bound_by']}, "
                  f"{kb['bound_ms'] / k_dev:.1%} of it); frame tile "
                  f"{bk.frame_tile(B)} [{card}]")
            assert r_exc <= 1.0, f"Bartlett route outside its gate: {label}"
            assert k_gap <= BARTLETT_GAP, f"bartlett_power vs plain: {label}"
            if row == "fft_reference_profile" and B == FULLRATE_BATCH:
                out = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                           library_ms=lib, route_ms=call, map_gap=k_gap,
                           **kb)
        del t
        torch.cuda.empty_cache()

    # the web app's program: the fft full-rate stage at B=16
    cfg = Config.fft_reference()
    p = pipeline.Pipeline(cfg, "fft", replay_mode=True, backend="python",
                          device="cuda")
    stage = p.make_heatmap_batched(
        batch=FULLRATE_BATCH,
        channels=cfg.active_arrays * cfg.rows * cfg.columns)
    stage.warmup()
    rng = np.random.default_rng(5)
    zero_counts()
    fft_before = freq.fft_steered_power.launches
    for _ in range(BARTLETT_BATCHES):
        x = (rng.standard_normal((FULLRATE_BATCH, stage.channels,
                                  cfg.n_samples)) * 0.05).astype(np.float32)
        host, done = stage._dispatch(x)
        done.synchronize()
        assert host.shape[0] == FULLRATE_BATCH and np.isfinite(
            host.numpy()).all()
    launches = bk.bartlett_power.launches
    fft = freq.fft_steered_power.launches - fft_before
    print(f"[fft] Pipeline(Config.fft_reference(), 'fft') full-rate stage, "
          f"{BARTLETT_BATCHES} batches of {FULLRATE_BATCH}: bartlett_power "
          f"launches {launches}, fft_steered_power calls {fft}")
    assert launches == fft == BARTLETT_BATCHES, (launches, fft)
    out["launches"] = launches
    del p, stage
    torch.cuda.empty_cache()
    return out


def _drift_frames(cfg, n: int, seed: int = 7) -> np.ndarray:
    """A drifting tone on every mic plus noise (tests/test_freq.py:492):
    frame i at 2300 + 37 i Hz, 0.3 and 0.03 of unit noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.n_samples) / cfg.sample_rate
    shape = (cfg.n_microphones, cfg.n_samples)
    return np.stack([
        np.tile(np.sin(2 * np.pi * (2300.0 + 37.0 * i) * t), (shape[0], 1))
        + 0.3 * rng.standard_normal(shape) + 0.03 * rng.standard_normal(shape)
        for i in range(n)]).astype(np.float32)


def phase_mvdr_oracle(card: str) -> dict:
    """(b) MVDR_BATCHES batches of 16 through ``make_mvdr_stream("maps")``
    in complex64 and through the same stream fed float64 frames, which it
    runs in complex128 (the same cadence, refreshes and carried d)."""
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import freq

    cfg = Config()
    frames = _drift_frames(cfg, MVDR_BATCHES * FULLRATE_BATCH)
    f32 = pipeline.make_mvdr_stream(cfg, "maps")
    f64 = pipeline.make_mvdr_stream(cfg, "maps")
    f32.reset()
    f64.reset()
    errs, agree, finite = [], [], []
    walls = []
    for b in range(MVDR_BATCHES):
        x = torch.from_numpy(
            frames[b * FULLRATE_BATCH:(b + 1) * FULLRATE_BATCH]).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m32 = f32(x)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        m64 = f64(x.double())
        finite.append(torch.isfinite(m32).all())
        errs.append(((m32.double() - m64).abs()
                     / m64.abs().clamp_min(1e-30)).flatten(1).amax(1))
        agree.append(m32.flatten(1).argmax(1) == m64.flatten(1).argmax(1))
    errs = torch.cat(errs).cpu().numpy()
    agree = torch.cat(agree).cpu().numpy()
    assert all(bool(f) for f in finite), "non-finite MVDR map"
    n = errs.size
    worst = int(errs.argmax())
    per_epoch = [float(errs[i:i + 64].max()) for i in range(0, n, 64)]
    print(f"[mvdr] complex64 stream vs the same stream in complex128, "
          f"Config() 100 Hz-Nyquist, alpha {f32.alpha}, {n} frames in "
          f"batches of {FULLRATE_BATCH} ({f32.state['r']} frames at the "
          f"last refresh, every {freq.refresh_interval(f32.alpha)}): "
          f"worst-direction "
          f"rel err max {errs.max():.3e} at frame {worst} (gate "
          f"{MVDR_DRIFT}), per 64 frames "
          f"{[float(f'{e:.3e}') for e in per_epoch]}; argmax agrees on "
          f"{int(agree.sum())}/{n} frames; host wall per complex64 batch "
          f"p50 {np.percentile(walls, 50):.2f} ms [{card}]")
    assert errs.max() < MVDR_DRIFT, "complex64 stream drifted"
    del f32, f64
    torch.cuda.empty_cache()
    return dict(max_err=float(errs.max()), argmax_agree=int(agree.sum()),
                frames=n)


def _quad_form_work(F: int, M: int, D: int) -> tuple:
    """``(operations, bytes)`` the MVDR quadratic form needs over P's
    Hermitian half (``quad_form_kernel``): 8 real operations a complex
    multiply-add of the 32-mic tile pairs I <= J (``(M^2 + sum_I m_I^2) /
    2`` a bin and direction, m_I the mics of tile I), and P, the steering
    tensor and d once."""
    tiles = [min(32, M - i) for i in range(0, M, 32)]
    macs = (M * M + sum(m * m for m in tiles)) // 2
    return 8 * F * D * macs, _cplx_bytes(F, M, M) + _cplx_bytes(F, M, D) \
        + 4 * F * D


def _mvdr_bounds(ft, B: int, channels: int) -> dict:
    """Bounds of the MVDR steps at the stream's shape, from the work the
    result needs.  ``mvdr_d0``: the quadratic form over P's Hermitian
    half (the tile pairs I <= J of 32 mics, :func:`_quad_form_work`:
    about 4 F M (M + 32) D), reading P and the steering tensor once and
    writing d.  One chunk of the scan: the projections P S,
    a^H P S and S^H P S, the coefficient product, the anchor's solve,
    the Woodbury advance and the covariance update (about 8 F (4 M^2 B + M
    D B + 2 D B^2 + 3 M B^2) in all), reading the frames, the steering
    tensor, P and R once and writing P, R, d and the maps.
    ``refresh_precision``: a complex Cholesky and its inverse a bin (about
    4 M^3 real operations), reading R and writing P."""
    F, M, D = ft.phase.shape
    N = ft.n_samples
    flops, nbytes = _quad_form_work(F, M, D)
    d0 = bound(nbytes, flops)
    scan = bound(4 * B * channels * N + _cplx_bytes(F, M, D)
                 + 4 * _cplx_bytes(F, M, M) + 2 * 4 * F * D + 4 * B * D,
                 8 * F * (4 * M * M * B + M * D * B + 2 * D * B * B
                          + 3 * M * B * B))
    refresh = bound(2 * _cplx_bytes(F, M, M), 4 * F * M ** 3)
    return dict(d0=d0, scan=scan, refresh=refresh)


def phase_mvdr_quad_form(card: str) -> dict:
    """(b2) The MVDR quadratic form kernel (``quad_form_kernel.
    hermitian_quad_form``) at the MVDR cell's shape (127 bins, 192 mics,
    1,824 directions) and at ``Config()``'s 256 mics, on the P of a stream
    that took four batches of drifting-tone frames: against the
    complex128 form of the same P (inside the FP32 bound of
    ``tests/test_torch_quad_form.py``, which the cuBLAS chain meets too),
    bitwise repeats, and its time in turns with its plain version (CUDA
    events) and on the profiler's device clock, beside its bound (the
    Hermitian half's operations at the FP32 peak, or P, the tensor and d
    once, if larger) and the cuBLAS chain it replaced (``conj(P) phase``,
    the elementwise product and the reduction: ``library_ms``).  Returns
    the cell shape's figures."""
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import quad_form_kernel \
        as qk

    def chain(P, ph):
        return torch.linalg.vecdot(ph, torch.matmul(P.conj(), ph),
                                   dim=1).real

    def excess(got, P, ph):
        P64, ph64 = P.to(torch.complex128), ph.to(torch.complex128)
        mag = (ph64.abs() * torch.matmul(P64.abs(), ph64.abs())).sum(1)
        M = P.shape[-1]
        return ((got.double() - chain(P64, ph64)).abs()
                / (4 * (M + 64) * 2.0 ** -24 * mag)).max().item()

    out = {}
    for label, cfg in (("cell", Config(unused_mics=tuple(range(192, 256)))),
                       ("Config()", Config())):
        fn = pipeline.make_mvdr_stream(cfg, "maps")
        fn.reset()
        frames = torch.from_numpy(_drift_frames(cfg, 4 * FULLRATE_BATCH)
                                  ).cuda()
        for i in range(0, len(frames), FULLRATE_BATCH):
            fn(frames[i:i + FULLRATE_BATCH])
        P, ph, tiles = fn.state["p"].P, fn.tables.phase, fn.tables.phase_tiles
        F, M, D = ph.shape
        before = qk.hermitian_quad_form.launches

        def kern():
            return qk.hermitian_quad_form(P, tiles, D=D)

        def plain():
            return qk.hermitian_quad_form_plain(P, ph)

        got = kern()
        repeat = all(torch.equal(kern(), got) for _ in range(3))
        k_exc, c_exc = excess(got, P, ph), excess(chain(P, ph), P, ph)
        p_gap = ((plain() - got).abs().max() / got.abs().max()).item()
        k_ms, p_ms = in_turns(plain, kern, 10)
        lib = time_ms(lambda: chain(P, ph), 10)
        dev = device_ms(kern, 10)
        k_dev = sum(v for k, v in dev.items() if "quad_form" in k)
        lib_dev = sum(device_ms(lambda: chain(P, ph), 10).values())
        flops, nbytes = _quad_form_work(F, M, D)
        bd = bound(nbytes, flops)
        launches = qk.hermitian_quad_form.launches - before
        print(f"[mvdr-quad-form] {label} F={F} M={M} D={D}: vs the "
              f"complex128 form {k_exc:.3f} of its FP32 bound (cuBLAS "
              f"chain {c_exc:.3f}), vs plain max rel {p_gap:.2e}, repeats "
              f"bitwise {repeat}; kernel {k_ms:.4f} ms (device {k_dev:.4f},"
              f" {bd['bound_ms'] / k_dev:.1%} of its bound), plain "
              f"{p_ms:.4f} ms, cuBLAS chain {lib:.4f} ms (device "
              f"{lib_dev:.4f}) | bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']}: {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB); launches {launches} [{card}]")
        assert k_exc <= 1.0 and repeat, label
        if label == "cell":
            out = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                       library_ms=lib, library_device_ms=lib_dev,
                       excess=k_exc, **bd)
        del fn, P, ph, tiles
        torch.cuda.empty_cache()
    return out


def phase_mvdr_fullrate(card: str) -> dict:
    """(c) The full-rate heatmap stage with the MVDR stream's Capon maps,
    then the device ms of the stream's steps on a batch it took."""
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import freq

    cfg = Config()
    p = pipeline.Pipeline(cfg, "mvdr", replay_mode=True, backend="native",
                          device="cuda")
    seen = {"maps": 0, "finite": True}

    def sink(powers, first_seq):
        seen["maps"] += len(powers)
        seen["finite"] &= bool(np.isfinite(powers).all())

    stage = p.make_heatmap_batched(batch=FULLRATE_BATCH,
                                   channels=FULLRATE_CHANNELS, sink=sink)
    fn = stage.power_fn
    assert fn.tables is p.power_tables, "the stage wrapped the stream"
    stage.warmup()
    assert fn.state["n"] == 0, "warm-up left the stream's state polluted"
    _, elapsed, sent, marks = _line_rate(p, stage, None)
    rep = p.report()[stage.metric.name]
    gaps = p.receiver.native_stats.gaps
    line_rate = cfg.sample_rate / cfg.n_samples
    print(f"[mvdr-fullrate] processed {stage.processed} frames in "
          f"{elapsed:.2f} s ({stage.processed / elapsed:.1f}/s vs line rate "
          f"{line_rate:.1f}/s); skipped {stage.skipped}; ingest gaps {gaps}; "
          f"maps {seen['maps']} (all finite {seen['finite']}); refreshes "
          f"to frame {fn.state['r']}; batch latency p50 "
          f"{rep['latency_p50_ms']} ms p95 {rep['latency_p95_ms']} ms; "
          f"emulator {sent / FULLRATE_SECONDS:.0f} pkt/s; packets per "
          f"0.25 s {np.diff(marks).tolist()} [{card}]")
    assert stage.processed > 0 and seen["finite"], "no finite maps"
    assert stage.skipped == 0, f"{stage.skipped} frames skipped"
    assert gaps == 0, f"{gaps} ingest gaps"

    ft, st = fn.tables, fn.state["p"]
    gen = torch.Generator("cuda").manual_seed(97)
    x = torch.randn(FULLRATE_BATCH, FULLRATE_CHANNELS, cfg.n_samples,
                    device="cuda", generator=gen) * 0.05
    xf = pipeline._pad_full(x, cfg.n_microphones)
    dq = freq.mvdr_d0(st, ft)
    bounds = _mvdr_bounds(ft, FULLRATE_BATCH, FULLRATE_CHANNELS)

    def scan():
        return freq.mvdr_maps_scan(st, xf, ft, d0=dq, return_d=True)

    times = dict(scan=time_ms(scan, 5),
                 d0=time_ms(lambda: freq.mvdr_d0(st, ft), 5),
                 refresh=time_ms(lambda: freq.refresh_precision(st, ft), 5))
    walls = dict(scan=call_ms(scan, 5),
                 d0=call_ms(lambda: freq.mvdr_d0(st, ft), 5),
                 refresh=call_ms(lambda: freq.refresh_precision(st, ft), 5))
    for k, label in (("scan", f"mvdr_maps_scan (one batch of "
                              f"{FULLRATE_BATCH}, d carried)"),
                     ("d0", "mvdr_d0"), ("refresh", "refresh_precision")):
        bd = bounds[k]
        print(f"[mvdr-fullrate] {label}: {times[k]:.4f} ms on CUDA events "
              f"({walls[k]:.4f} ms wall a call) | bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}) [{card}]")
    counts = p.report()["mvdr"]
    print(f"[mvdr-fullrate] quadratic forms {counts['quad_forms']}, "
          f"kernel launches {counts['quad_form_launches']} [{card}]")
    assert counts["quad_form_launches"] == counts["quad_forms"] > 0, counts
    out = dict(processed=stage.processed, skipped=stage.skipped,
               quad_forms=counts["quad_forms"],
               quad_form_launches=counts["quad_form_launches"],
               rate=stage.processed / elapsed,
               latency_p50_ms=rep["latency_p50_ms"],
               latency_p95_ms=rep["latency_p95_ms"],
               **{f"{k}_ms": v for k, v in times.items()},
               **{f"{k}_bound_ms": bounds[k]["bound_ms"] for k in bounds})
    del p, stage, fn, st
    torch.cuda.empty_cache()
    return out


class _BoundSink:
    """An audio sink that counts samples and keeps the largest |sample|
    and whether every sample was finite."""

    def __init__(self):
        self.frames, self.peak, self.finite = 0, 0.0, True

    def write(self, samples):
        self.frames += samples.shape[0]
        if samples.size:
            self.finite &= bool(np.isfinite(samples).all())
            self.peak = max(self.peak, float(np.abs(samples).max()))

    def close(self):
        pass


def phase_mvdr_listen(card: str) -> dict:
    """(d) The combined full-rate stage with ``beam="mvdr"``: Capon maps
    and the adaptive beam from one streaming-inverse update a batch."""
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config

    cfg = Config()
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="native",
                          device="cuda")
    sink = _BoundSink()
    seen = {"maps": 0, "finite": True}

    def power_sink(powers, first_seq):
        seen["maps"] += len(powers)
        seen["finite"] &= bool(np.isfinite(powers).all())

    stage = p.make_mimo_miso_batched(batch=FULLRATE_BATCH, beam="mvdr",
                                     channels=FULLRATE_CHANNELS, sink=sink,
                                     power_sink=power_sink)
    d = p.steer_cartesian_degree(LISTEN_AZ, LISTEN_EL)
    stage.warmup()
    _, elapsed, sent, marks = _line_rate(p, stage, None)
    rep = p.report()[stage.metric.name]
    gaps = p.receiver.native_stats.gaps
    lat = stage.audio_latency()
    line_rate = cfg.sample_rate / cfg.n_samples
    print(f"[mvdr-listen] beam='mvdr', direction {d}: processed "
          f"{stage.processed} frames in {elapsed:.2f} s "
          f"({stage.processed / elapsed:.1f}/s vs line rate "
          f"{line_rate:.1f}/s); skipped {stage.skipped}; ingest gaps {gaps}; "
          f"underrun frames {stage.underrun_frames}; samples "
          f"{stage.samples}; maps {seen['maps']} (finite {seen['finite']}); "
          f"beams finite {sink.finite}, max |beam| {sink.peak:.4f}; batch "
          f"latency p50 {rep['latency_p50_ms']} ms p95 "
          f"{rep['latency_p95_ms']} ms; audio e2e p50 "
          f"{lat.get('audio_e2e_p50_ms')} ms p95 "
          f"{lat.get('audio_e2e_p95_ms')} ms (limit {AUDIO_LIMIT_MS:.1f} "
          f"ms, phase 7's); emulator {sent / FULLRATE_SECONDS:.0f} pkt/s; "
          f"packets per 0.25 s {np.diff(marks).tolist()} [{card}]")
    assert stage.processed > 0, "no batch processed"
    assert stage.skipped == 0 and gaps == 0, "drops"
    assert stage.underrun_frames == 0, "underruns"
    assert stage.samples == stage.processed * cfg.n_samples == sink.frames
    assert sink.finite and sink.peak < 10.0, "beams not finite and bounded"
    assert seen["finite"], "non-finite MVDR map"
    out = dict(processed=stage.processed, rate=stage.processed / elapsed,
               max_beam=sink.peak, **lat)
    del p, stage
    torch.cuda.empty_cache()
    return out


def phase_mvdr_live(card: str) -> dict:
    """(e) 20 maps of the live stage through the MVDR stream's
    single-frame recursion (``update_precision`` + the Capon map)."""
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ingest.streamer import (
        NativeStreamer)

    cfg = Config()
    tx, ty = 40, 20
    sig = np.tile(_source_frame(cfg, tx, ty), (1, 8))
    fn = pipeline.make_mvdr_stream(cfg, "maps")
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="native",
                          device="cuda", power_fn=fn)
    emu = NativeStreamer(cfg, n_arrays=cfg.active_arrays)
    maps = []
    try:
        emu.start(sig, rate=cfg.sample_rate)
        p.connect(timeout=30.0)
        p.start_heatmap()
        while len(maps) < N_HEATMAPS:
            maps.append(p.q_power.get(timeout=30.0)[0])
    finally:
        p.stop()
        emu.stop()
    rep = p.report()["heatmap"]
    stack = np.stack(maps)
    pk = np.unravel_index(stack[-1].argmax(), stack[-1].shape)
    print(f"[mvdr-live] {len(maps)} maps through the single-frame "
          f"recursion ({fn.state['n']} frames absorbed): per-frame latency "
          f"p50 {rep['latency_p50_ms']} ms p95 {rep['latency_p95_ms']} ms "
          f"(frame period {FRAME_MS:.2f} ms), rate {rep['rate_hz']} Hz; "
          f"last map's peak {tuple(int(i) for i in pk)} (source at ({tx}, "
          f"{ty})) [{card}]")
    assert np.isfinite(stack).all(), "non-finite live MVDR map"
    out = dict(latency_p50_ms=rep["latency_p50_ms"],
               latency_p95_ms=rep["latency_p95_ms"])
    del p, fn
    torch.cuda.empty_cache()
    return out


# -- phase 9: the vision path and the host sensor-fusion chain ---------------


def _gate(got: torch.Tensor, ref: torch.Tensor, rtol: float,
          atol: float) -> tuple:
    """(max abs error, the worst element's share of its allowance
    ``atol + rtol * |ref|``): the gate holds while the share is <= 1."""
    got, ref = got.double().cpu(), ref.double().cpu()
    err = (got - ref).abs()
    return err.max().item(), (err / (atol + rtol * ref.abs())).max().item()


def _tables_match(label: str, got, ref) -> str:
    """The detection tables (rows, mask, class ids) of the card against
    the CPU's: equal masks and indices, rows at the detection gate."""
    rows, mask, ids = (t.cpu() for t in got)
    r_rows, r_mask, r_ids = (t.cpu() for t in ref)
    assert torch.equal(mask, r_mask), f"{label}: masks differ"
    assert torch.equal(ids, r_ids), f"{label}: class ids differ"
    err, share = _gate(rows, r_rows, VISION_DET_RTOL, VISION_DET_ATOL)
    assert share <= 1.0, f"{label}: rows off by {err:.3e} ({share:.2f})"
    return f"{int(mask.sum())} kept, rows max abs {err:.3e} ({share:.3f} " \
           f"of the gate)"


def _random_bn(model, seed: int) -> None:
    """Random BatchNorm scales, biases and statistics (seeded on the
    host), so that the check runs every term of the normalisation."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(0.5 + torch.rand(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))


def _yolo_bound(det, K: int) -> dict:
    """The forward's bound, restated from the code: its operations
    counted by ``FlopCounterMode`` on a one-frame CPU run (the convs,
    2 x MACs) at FP32 on the CUDA cores (TF32 off), and its bytes (the
    uint8 frames and the weights read once, the heads written once)."""
    from torch.utils.flop_counter import FlopCounterMode

    from zybo_rt_sampler_image_detection_torch.models import yolo

    c = det.cfg
    m = yolo.TinyYolo(c).eval()
    x = torch.zeros(1, c.input_size, c.input_size, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        heads = m(x)
    flops = fc.get_total_flops() * K
    nb = (K * c.input_size ** 2 * 3 + nbytes(*m.state_dict().values())
          + K * nbytes(*heads))
    return dict(gflop_per_frame=flops / K / 1e9, **bound(nb, flops))


def _torch_ops(fn) -> tuple:
    """(torch operations, those that are not views) that ``fn`` dispatches:
    each of the latter is a kernel launch on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = k = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            # a view returns an alias of an input it does not write
            self.k += not any(
                a.alias_info is not None and not a.alias_info.is_write
                for a in func._schema.returns)
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.n, c.k


def phase_vision_detector(card: str) -> dict:
    """(a) The full-width detector (``YoloConfig()``: 416 px, width 1.0,
    one class) from a seeded generator, with random BatchNorm statistics,
    on the card against the same module on the CPU at K = 1, 4, 16:
    heads at rtol 1e-5 / atol 1e-5; detection tables at rtol 1e-5 / atol
    1e-4 with equal masks and indices, from the same heads and end to
    end.  CUDA-event times of the forward and of decode + NMS, the wall
    time of one ``get_detections_batch``, NMS's share, the bound."""
    from zybo_rt_sampler_image_detection_torch.models import detect, yolo

    cfg = yolo.YoloConfig()
    cpu = detect.YoloDetector(cfg=cfg, seed=0, device="cpu")
    _random_bn(cpu.model, seed=1)
    gpu = detect.YoloDetector(cfg=cfg, seed=0, device="cuda")
    gpu.model.load_state_dict(cpu.model.state_dict())
    rng = np.random.default_rng(9)
    frames = [(rng.random((240, 320, 3)) * 255).astype(np.uint8)
              for _ in range(max(VISION_KS))]
    out = {}
    for K in VISION_KS:
        imgs = np.stack([detect._resize_u8(f, (cfg.input_size,) * 2)
                         for f in frames[:K]])
        x_cpu = torch.from_numpy(imgs)
        x_gpu = x_cpu.cuda()
        h_cpu = cpu.forward(x_cpu)
        h_gpu = gpu.forward(x_gpu)
        torch.cuda.synchronize()
        heads = [_gate(a, b, VISION_HEAD_RTOL, VISION_HEAD_ATOL)
                 for a, b in zip(h_gpu, h_cpu)]
        for err, share in heads:
            assert share <= 1.0, f"K={K}: heads off by {err:.3e}"
        ref = cpu.postprocess(h_cpu)
        same = _tables_match(f"K={K} same heads",
                             gpu.postprocess([h.cuda() for h in h_cpu]),
                             ref)
        e2e = _tables_match(f"K={K} end to end", gpu.program(x_gpu), ref)
        iters = 20 if K < 16 else 10
        fwd_ms = time_ms(lambda: gpu.forward(x_gpu), iters)
        post_ms = time_ms(lambda: gpu.postprocess(h_gpu), iters)
        prog_ms = time_ms(lambda: gpu.program(x_gpu), iters)
        call_wall = call_ms(lambda: gpu.get_detections_batch(
            frames[:K], pad_to=K), iters)
        b = _yolo_bound(gpu, K)
        n_ops, n_launch = _torch_ops(lambda: cpu.postprocess(h_cpu))
        out[K] = dict(forward_ms=fwd_ms, nms_ms=post_ms, program_ms=prog_ms,
                      call_ms=call_wall, nms_ops=n_launch, **b)
        print(f"[vision] K={K}: heads vs CPU max abs "
              f"{max(e for e, _ in heads):.3e} "
              f"({max(s for _, s in heads):.3f} of the gate); tables from "
              f"the same heads: {same}; end to end: {e2e} [{card}]")
        print(f"[vision] K={K}: forward {fwd_ms:.4f} ms (bound "
              f"{b['bound_ms']:.4f} ms, {b['bound_by']}; "
              f"{b['gflop_per_frame']:.3f} GFLOP a frame; "
              f"{b['bound_ms'] / fwd_ms:.1%} of it), decode + NMS "
              f"{post_ms:.4f} ms ({post_ms / prog_ms:.1%} of the program "
              f"{prog_ms:.4f} ms; {n_launch} of its {n_ops} torch ops are "
              f"not views), one get_detections_batch {call_wall:.4f} ms "
              f"wall (resize, upload, program, download; NMS "
              f"{post_ms / call_wall:.1%} of it) [{card}]")
    del gpu, cpu
    torch.cuda.empty_cache()
    return out


def phase_vision_demo_detector(card: str) -> dict:
    """(b) The committed demo detector on the card: AP@0.5 on the 48
    held-out frames of ``synthetic_detection_batch(default_rng(999), 48,
    size=64)`` at least 0.75, and its detections equal to its CPU run's
    on the same frames within the detection gate."""
    from zybo_rt_sampler_image_detection_torch.models import data, detect
    from zybo_rt_sampler_image_detection_torch.models import eval as ev

    gpu = detect.pretrained_demo_detector(device="cuda")
    cpu = detect.pretrained_demo_detector(device="cpu")
    imgs, boxes = data.synthetic_detection_batch(
        np.random.default_rng(999), 48, size=64)
    ap = ev.evaluate_detector(gpu, imgs, boxes)
    ap_cpu = ev.evaluate_detector(cpu, imgs, boxes)
    frames = [(im * 255).astype(np.uint8) for im in imgs]
    worst = 0.0
    for k in range(0, len(frames), 16):
        got = gpu.get_detections_batch(frames[k:k + 16], include_class=True)
        ref = cpu.get_detections_batch(frames[k:k + 16], include_class=True)
        for g, r in zip(got, ref):
            assert len(g) == len(r), "demo detector: detection counts differ"
            if r:
                _, share = _gate(torch.tensor(g), torch.tensor(r),
                                 VISION_DET_RTOL, VISION_DET_ATOL)
                worst = max(worst, share)
    print(f"[vision-demo] committed detector (64 px, width 0.25): AP@0.5 "
          f"{ap:.4f} on the card, {ap_cpu:.4f} on the CPU (gate "
          f"{VISION_AP_GATE}); detections of 48 frames vs the CPU: "
          f"{worst:.3f} of the gate [{card}]")
    assert ap >= VISION_AP_GATE, f"AP@0.5 {ap:.3f}"
    assert worst <= 1.0
    return dict(ap=ap, ap_cpu=ap_cpu)


class _CountingQueue(queue.Queue):
    """A queue that counts the items the tracker stage takes from it (not
    the ones the camera drops as the oldest)."""

    taken = 0

    def _get(self):
        if threading.current_thread().name.startswith("tracker"):
            self.taken += 1
        return super()._get()


def phase_vision_chain(card: str) -> dict:
    """(c) The host chain end to end beside the live K1 heatmap stage: the
    native emulator on loopback -> ``Pipeline(Config() at high)`` (the
    policy picks K1) -> ``start_heatmap``; ``SceneCamera((240, 320))`` ->
    ``start_camera`` -> ``start_tracker_batched(demo detector, batch=4)``;
    ``Viewer.loop`` through ``SensorFusionDecider`` into an array display
    for VISION_FRAMES composited frames, each tracker overlay's
    ``rect_conf`` offered to ``decider.focus_beam`` (steering the
    pipeline).  Every frame the tracker dequeued must be processed, K1
    must launch, the detector must find the scene object in 4 of 6 probed
    frames, and ``focus_beam`` must steer."""
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.fusion.decider import (
        SensorFusionDecider)
    from zybo_rt_sampler_image_detection_torch.ingest.streamer import (
        NativeStreamer)
    from zybo_rt_sampler_image_detection_torch.models import data, detect
    from zybo_rt_sampler_image_detection_torch.models.tracking import (
        compute_iou)
    from zybo_rt_sampler_image_detection_torch.ops import equiv_kernel as ek
    from zybo_rt_sampler_image_detection_torch.utils import viz

    det = detect.pretrained_demo_detector(device="cuda")
    probe = data.SceneCamera((240, 320))
    hits = 0
    for _ in range(6):
        _, frame = probe.read()
        hits += any(compute_iou(d[:4], probe.last_box) > 0.3
                    for d in det.get_detections(frame, conf_threshold=0.3))
    print(f"[vision-chain] probe: the scene object found in {hits}/6 "
          f"frames (IoU > 0.3 at conf 0.3)")
    assert hits >= 4, f"scene object found in {hits}/6 frames"

    cfg = Config().replace(matmul_precision="high")
    tx, ty = 40, 20
    sig = np.tile(_source_frame(cfg, tx, ty), (1, 8))
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="native",
                          device="cuda")
    kind, _ = pipeline._select_power_backend(p.tables)
    assert kind == "equiv_kernel", kind
    decider = SensorFusionDecider((320, 240))      # camera pixels
    steers = []

    def steer(h, v):
        steers.append(p.steer_cartesian_degree(h, v))

    class FocusTap(queue.Queue):
        """q_inference: every overlay's rect_conf goes to focus_beam as
        the viewer takes it."""

        def _get(self):
            item = super()._get()
            (x1, y1), (x2, y2), conf = item[2]
            decider.focus_beam(steer, [x1, y1, x2, y2, conf])
            return item

    p.q_yolo = _CountingQueue(maxsize=2)
    p.q_inference = FocusTap(maxsize=2)
    disp = viz.ArrayDisplay(keep=VISION_FRAMES)
    viewer = viz.Viewer(window=(640, 360), display=disp)
    emu = NativeStreamer(cfg, n_arrays=cfg.active_arrays)
    track_s = []

    class Running:
        deadline = time.time() + 90.0

        @property
        def value(self):
            return time.time() < self.deadline

    try:
        emu.start(sig, rate=cfg.sample_rate)
        zero_counts()
        p.connect(timeout=30.0)
        p.start_heatmap()
        p.start_camera(data.SceneCamera((240, 320)), fps_limit=30.0)
        tr = p.start_tracker_batched(det, batch=4)
        step = tr.tracker.step_with_detections

        def timed_step(*a, **kw):
            t = time.perf_counter()
            res = step(*a, **kw)
            track_s.append(time.perf_counter() - t)
            return res

        tr.tracker.step_with_detections = timed_step
        t0 = time.perf_counter()
        viewer.loop(p.q_power, Running(), q_viewer=p.q_viewer,
                    q_inference=p.q_inference, decider=decider,
                    max_frames=VISION_FRAMES)
        elapsed = time.perf_counter() - t0
    finally:
        p.stop()
        launches = ek.equiv_power.launches
        sent = emu.stop()
    rep = p.report()
    n = len(disp.frames)
    trk = rep.get("tracker_batched", {})
    print(f"[vision-chain] {n} composited frames in {elapsed:.2f} s "
          f"({n / elapsed:.2f} frames/s); K1 launches {launches}; tracker "
          f"dequeued {p.q_yolo.taken}, processed {tr.processed}; detector "
          f"ms a batch of 4 p50 {trk.get('latency_p50_ms')} p95 "
          f"{trk.get('latency_p95_ms')}; tracker host ms a frame "
          f"{1e3 * np.mean(track_s):.3f}; focus_beam steered {len(steers)} "
          f"times (last direction {steers[-1] if steers else None}); "
          f"heatmap {json.dumps(rep.get('heatmap'))}; camera "
          f"{json.dumps(rep.get('camera'))}; emulator sent {sent} packets "
          f"[{card}]")
    assert n == VISION_FRAMES, f"only {n} composited frames"
    assert all(f.shape == (240, 320, 3) and f.dtype == np.uint8
               for f in disp.frames)
    assert tr.processed == p.q_yolo.taken > 0, "tracker skipped frames"
    assert launches > 0, "K1 did not launch"
    assert steers, "focus_beam never steered"
    return dict(launches=launches, frames_per_s=n / elapsed,
                detector_p50_ms=trk.get("latency_p50_ms"),
                tracker_host_ms=1e3 * float(np.mean(track_s)),
                steers=len(steers))

# phase 10: the fused stage's batch, camera, window and composited frames
# of (b), the mic batch of (d), the detection gate against det.program on
# the same resized input (the JAX package's tests/test_fused.py:93), the
# host chain's gates of the compositor (tests/test_composite.py:31-36)
FUSED_BATCH = 16
FUSED_CAM = (240, 320)
FUSED_WINDOW = (640, 360)
FUSED_FRAMES = 192
FUSED_MIC_BATCH = 64
FUSED_DET_ATOL = 1e-5
COMPOSITE_MAX, COMPOSITE_MEAN, COMPOSITE_FRAC2 = 5, 0.6, 0.02


def _bump_powers(cfg, k: int, seed: int) -> np.ndarray:
    """(k, X, Y) smooth Gaussian-bump maps with clear peaks (the JAX
    package's tests/test_composite.py:_powers at ``Config()``'s grid)."""
    rng = np.random.default_rng(seed)
    X, Y = cfg.max_res_x, cfg.max_res_y
    xs, ys = np.arange(X)[:, None], np.arange(Y)[None, :]
    out = []
    for _ in range(k):
        cx, cy = rng.uniform(2, X - 3), rng.uniform(2, Y - 3)
        bump = rng.uniform(0.5, 2.0) * np.exp(
            -((xs - cx) ** 2 + (ys - cy) ** 2) / rng.uniform(4.0, 16.0))
        out.append((bump + rng.uniform(0, 1e-2, (X, Y))) * 1e-4)
    return np.asarray(out, np.float32)


def _raster_mask(sx: int, sy: int, window, ratio: float = 0.1):
    """Pixels the power box and circle can touch at (sx, sy), dilated by
    1, in display coordinates (tests/test_composite.py:_box_raster_mask):
    a one-pixel center shift flips those pixels 0 <-> 255."""
    Ww, Hw = window
    bw, bh = int(Ww * ratio), int(Hw * ratio)
    x1, y1 = max(0, sx - bw // 2), max(0, sy - bh // 2)
    x2, y2 = min(Ww, sx + bw // 2), min(Hw, sy + bh // 2)
    m = np.zeros((Hw, Ww), bool)
    for (ax1, ay1, ax2, ay2) in [(x1, y1, x2, y1), (x1, y2, x2, y2),
                                 (x1, y1, x1, y2), (x2, y1, x2, y2)]:
        m[max(0, ay1 - 4):ay2 + 5, max(0, ax1 - 4):ax2 + 5] = True
    m[max(0, sy - 7):sy + 8, max(0, sx - 7):sx + 8] = True
    return m[:, ::-1]


def phase_composite(card: str) -> dict:
    """10 (a): the compositor on the card against the same compositor on
    the CPU (the fallback convention, which the card's host runs), at
    ``Config()``'s grid, 240x320 cameras, a 640x360 window, 8 track boxes
    and K=16; the device ms a batch (CUDA events) beside its bytes
    bound."""
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.fusion.composite import (
        DeviceCompositor)

    cfg, K = Config(), FUSED_BATCH
    grid = (cfg.max_res_x, cfg.max_res_y)
    rng = np.random.default_rng(10)
    powers = _bump_powers(cfg, K, 10)
    cams = rng.integers(30, 230, (K,) + FUSED_CAM + (3,)).astype(np.uint8)
    boxes = np.full((K, 8, 5), -100.0, np.float32)
    boxes[:, 0] = [40, 30, 200, 150, 1]
    boxes[:, 1] = [100, 120, 300, 230, 2]
    kw = dict(window=FUSED_WINDOW, yolo_shape=FUSED_CAM, max_tracks=8,
              cv2_convention=False)
    dev = DeviceCompositor(grid, FUSED_CAM, device="cuda", **kw)
    cpu = DeviceCompositor(grid, FUSED_CAM, device="cpu", **kw)
    got, prev, meta = dev(powers, cams, boxes, dev.init_prev())
    ref, prev_ref, meta_ref = cpu(powers, cams, boxes, cpu.init_prev())
    got, ref = got.cpu().numpy(), ref.numpy()
    m, mr = DeviceCompositor.meta_dict(meta), DeviceCompositor.meta_dict(
        meta_ref)
    same_center = (m["sx"] == mr["sx"]) & (m["sy"] == mr["sy"])
    near = (np.abs(m["sx"] - mr["sx"]) <= 1) & (np.abs(m["sy"] - mr["sy"])
                                                <= 1)
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    for i in range(K):
        if not same_center[i]:
            ex = _raster_mask(int(mr["sx"][i]), int(mr["sy"][i]),
                              FUSED_WINDOW) | _raster_mask(
                int(m["sx"][i]), int(m["sy"][i]), FUSED_WINDOW)
            diff[i][ex] = 0
    equal = float((diff == 0).mean())
    print(f"[composite] K={K} {FUSED_CAM} -> {FUSED_WINDOW}, grid {grid}, "
          f"8 boxes: card vs CPU max |diff| {diff.max()} mean "
          f"{diff.mean():.5f} (gates {COMPOSITE_MAX} / {COMPOSITE_MEAN}), "
          f"{equal:.5f} of bytes equal; sx/sy equal on "
          f"{int(same_center.sum())}/{K} frames, within 1 px on "
          f"{int(near.sum())}/{K}; light max |diff| "
          f"{np.abs(m['light'] - mr['light']).max():.3e}, conf "
          f"{np.abs(m['conf'] - mr['conf']).max():.3e}; EMA carry equal "
          f"{bool(np.array_equal(prev.cpu().numpy(), prev_ref.numpy()))}")
    assert near.all(), "power centers differ by more than 1 px"
    assert diff.max() <= COMPOSITE_MAX and diff.mean() <= COMPOSITE_MEAN
    assert (diff > 2).mean() <= COMPOSITE_FRAC2
    p_d = torch.from_numpy(powers).cuda()
    c_d = torch.from_numpy(cams).cuda()
    b_d = torch.from_numpy(boxes).cuda()
    prev0 = dev.init_prev()
    ms = time_ms(lambda: dev._run(p_d, c_d, b_d, prev0, K), 10)
    wall = call_ms(lambda: dev._run(p_d, c_d, b_d, prev0, K), 5)
    Ww, Hw = FUSED_WINDOW
    nb = nbytes(p_d, c_d, b_d, prev0) + K * Hw * Ww * 3 + Hw * Ww * 3 \
        + K * 5 * 4
    bd = bound(nb, 0.0)
    print(f"[composite] device program {ms:.4f} ms a batch of {K} on CUDA "
          f"events ({wall:.4f} ms wall a call) | bound {bd['bound_ms']:.4f} "
          f"ms ({bd['bound_by']}: {nb / 1e6:.2f} MB) [{card}]")
    return dict(ms=ms, wall_ms=wall, **bd)


def _fused_pipeline(ring_frames: int = 64):
    """``Config()`` lerp at ``high`` on the card (the policy picks K1),
    native ingest on loopback with a ring of ``ring_frames``."""
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config

    cfg = Config().replace(matmul_precision="high")
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="native",
                          device="cuda", ring_frames=ring_frames)
    kind, _ = pipeline._select_power_backend(p.tables)
    assert kind == "equiv_kernel", kind
    return cfg, p


def _fused_stage(p, det, transport: str, listen=None, sink=None,
                 q_cam=None):
    """A FusedSensorStage at the demo's shapes: K=16, 192 channels, a
    640x360 window, 8 track boxes, 240x320 cameras."""
    from zybo_rt_sampler_image_detection_torch.apps.fused import (
        FusedSensorStage)
    from zybo_rt_sampler_image_detection_torch.fusion.composite import (
        DeviceCompositor)
    from zybo_rt_sampler_image_detection_torch.utils import viz

    cfg = p.cfg
    comp = DeviceCompositor((cfg.max_res_x, cfg.max_res_y), FUSED_CAM,
                            window=FUSED_WINDOW, yolo_shape=FUSED_CAM,
                            max_tracks=8, device="cuda")
    return FusedSensorStage(
        p.receiver, p.tables, comp, det,
        q_cam if q_cam is not None else p.q_yolo,
        viz.ArrayDisplay(keep=2), p.metrics, batch=FUSED_BATCH,
        channels=FULLRATE_CHANNELS, display_transport=transport,
        steer_cb=lambda h, v: p.steer_cartesian_degree(h, v),
        listen=listen, audio_sink=sink,
        mic_batch=FUSED_MIC_BATCH if listen else 0)


def _record_launch(stage, which: int) -> dict:
    """Wrap ``stage._launch``: keep the inputs (and the MVDR state before
    it) of launch number ``which`` after the wrap."""
    rec = {"n": 0}
    launch = stage._launch

    def wrapped(mic, cams, n):
        rec["n"] += 1
        if rec["n"] == which:
            with stage._dir_lock:
                d = stage._direction
            rec.update(mic=np.array(mic), cams=np.array(cams), k=n,
                       boxes=stage._boxes.copy(), d=d,
                       state=(stage._mvdr.state["p"] if stage._mvdr
                              else None))
        return launch(mic, cams, n)

    stage._launch = wrapped
    return rec


def _drive_fused(cfg, p, stage, seconds: float, frames: int = 0,
                 cam_fps: float = 1000.0):
    """The native emulator at line rate and a pre-rendered SceneCamera
    (240x320) -> ``stage`` until ``frames`` frames are composited (or
    ``seconds`` pass, with ``frames`` 0), every launch count set to 0
    just before; returns (K1 launches, seconds, packets sent)."""
    from zybo_rt_sampler_image_detection_torch.ingest.streamer import (
        NativeStreamer)
    from zybo_rt_sampler_image_detection_torch.models import data
    from zybo_rt_sampler_image_detection_torch.ops import equiv_kernel as ek

    sig = np.tile(_source_frame(cfg, 40, 20), (1, 8))
    emu = NativeStreamer(cfg, n_arrays=cfg.active_arrays)
    try:
        emu.start(sig, rate=cfg.sample_rate)
        p.connect(timeout=30.0)
        p.start_camera(data.SceneCamera(FUSED_CAM, prerender=128),
                       fps_limit=cam_fps)
        zero_counts()
        t0 = time.perf_counter()
        p.run_stage(stage)
        while stage.error is None and time.perf_counter() - t0 < 60.0:
            if (stage.frames >= frames if frames
                    else time.perf_counter() - t0 >= seconds):
                break
            time.sleep(0.02)
        elapsed = time.perf_counter() - t0
    finally:
        p.stop()
        launches = ek.equiv_power.launches
        sent = emu.stop()
    assert stage.error is None, f"the fused stage failed: {stage.error!r}"
    return launches, elapsed, sent


def _fused_parity(label: str, stage, rec, card: str) -> dict:
    """Launch the recorded batch again (count K, a fresh EMA carry): its
    composites against ``DeviceCompositor`` fed the stage's own powers
    (equal bytes), its detections against ``det.program`` on the same
    resized input; then the device ms a batch of the whole program, the
    power program, the detector and the compositor (CUDA events)."""
    from zybo_rt_sampler_image_detection_torch.apps import fused

    K = FUSED_BATCH
    Hc, Wc = FUSED_CAM
    Ww, Hw = FUSED_WINDOW
    stage._prev, stage._boxes = None, rec["boxes"]
    seen = {}
    run = stage._run

    def keep(packed, d, count):
        seen["packed"] = packed
        return run(packed, d, count)

    stage._run = keep
    host, done = stage._launch(rec["mic"], rec["cams"], K)
    stage._run = run
    done.synchronize()
    comps, dets, mask, cls_ids, metas, _ = stage._unpack(host.numpy())
    x = torch.from_numpy(rec["mic"]).cuda()
    powers = stage._power(x[-K:])
    _mic, boxes, cams = stage._split(seen["packed"])
    yolos = boxes.expand(K, *boxes.shape)
    ref, _, ref_meta = stage.comp(powers, cams, yolos,
                                  stage.comp.init_prev(), count=K)
    if stage.display_transport == "yuv420":
        ref = fused._i420_to_bgr(fused._bgr_to_i420(ref).cpu().numpy(), Hw,
                                 Ww)
    else:
        ref = ref.cpu().numpy()
    imgs = stage.detector_input(cams)
    rd, rm, rc = (t.cpu().numpy() for t in stage.detector.program(imgs))
    det_err = float(np.abs(dets - rd).max())
    print(f"[fused] {label}: a recorded batch again: composites vs "
          f"DeviceCompositor on the stage's own powers equal "
          f"{bool(np.array_equal(comps, ref))}, meta max |diff| "
          f"{np.abs(metas - ref_meta.cpu().numpy()).max():.3e}; detections "
          f"vs det.program on the same resized input max abs {det_err:.3e} "
          f"(atol {FUSED_DET_ATOL:g}), masks equal "
          f"{bool(np.array_equal(mask, rm))}, classes equal "
          f"{bool(np.array_equal(cls_ids, rc))}; {int(mask.sum())} kept")
    assert np.array_equal(comps, ref), f"{label}: composites differ"
    assert det_err <= FUSED_DET_ATOL and np.array_equal(mask, rm)
    assert np.array_equal(cls_ids, rc)
    packed, d = seen["packed"], rec["d"]
    prev0 = stage.comp.init_prev()

    def whole():
        stage._prev = prev0
        return stage._run(packed, d, K)

    t = dict(whole_ms=time_ms(whole, 5),
             power_ms=time_ms(lambda: stage._power(x[-K:]), 10),
             detector_ms=time_ms(lambda: stage.detector.program(imgs), 5),
             composite_ms=time_ms(lambda: stage.comp._run(
                 powers, cams, yolos, prev0, K), 5))
    t["whole_wall_ms"] = call_ms(whole, 3)
    print(f"[fused] {label}: device ms a batch of {K} (CUDA events): whole "
          f"program {t['whole_ms']:.3f} ({t['whole_wall_ms']:.3f} wall a "
          f"call), power {t['power_ms']:.3f}, detector "
          f"{t['detector_ms']:.3f}, composite {t['composite_ms']:.3f} "
          f"[{card}]")
    return t


def phase_fused(card: str) -> dict:
    """10 (b): FusedSensorStage at K=16 on a pre-rendered SceneCamera
    (240x320, unthrottled) with the committed demo detector, from the
    native emulator at line rate (``Config()`` lerp at ``high``: the
    policy's K1), with ``display_transport`` rgb and then yuv420, each
    until FUSED_FRAMES frames are composited; then the parity of a
    recorded batch and the device ms a batch."""
    from zybo_rt_sampler_image_detection_torch.models import detect

    out = {}
    for transport in ("rgb", "yuv420"):
        cfg, p = _fused_pipeline()
        p.q_yolo = queue.Queue(maxsize=2 * FUSED_BATCH)
        det = detect.pretrained_demo_detector(device="cuda")
        stage = _fused_stage(p, det, transport)
        t0 = time.perf_counter()
        stage.warmup()
        warm = time.perf_counter() - t0
        rec = _record_launch(stage, 3)
        launches, elapsed, sent = _drive_fused(cfg, p, stage, 0.0,
                                               frames=FUSED_FRAMES)
        rep = stage.report()
        cam = p.report().get("camera", {})
        n = stage.frames
        print(f"[fused] {transport}: {n} composited frames in "
              f"{elapsed:.2f} s ({n / elapsed:.2f} frames/s; camera "
              f"{cam.get('rate_hz')} frames/s); K1 launches {launches}; "
              f"warm-up {warm:.2f} s; latency p50 {rep['latency_p50_ms']} "
              f"p95 {rep['latency_p95_ms']} ms; phase_p50_ms "
              f"{json.dumps(rep['phase_p50_ms'])}; skipped {stage.skipped}; "
              f"emulator sent {sent} packets [{card}]")
        assert n >= FUSED_FRAMES, f"only {n} composited frames"
        assert launches > 0, "K1 did not launch inside the fused stage"
        t = _fused_parity(transport, stage, rec, card)
        out[transport] = dict(frames_per_s=n / elapsed, launches=launches,
                              phase_p50_ms=rep["phase_p50_ms"], **t)
        if transport == "rgb":
            out["rec"], out["p"] = rec, p
        else:
            del p
        del stage, det
        torch.cuda.empty_cache()
    return out


def phase_fused_wide(card: str, fused_out: dict) -> dict:
    """10 (c): one batch of the stage with the full-width detector
    (``YoloConfig()``: 416 px, width 1.0, seeded weights, random
    BatchNorm statistics) on the recorded batch of (b)."""
    from zybo_rt_sampler_image_detection_torch.models.detect import (
        YoloDetector)
    from zybo_rt_sampler_image_detection_torch.models.yolo import YoloConfig

    det = YoloDetector(cfg=YoloConfig(), device="cuda", seed=7)
    _random_bn(det.model, 7)
    p, rec = fused_out.pop("p"), fused_out.pop("rec")
    stage = _fused_stage(p, det, "rgb")
    stage.warmup()
    t = _fused_parity("full-width detector (416 px, width 1.0)", stage, rec,
                      card)
    del stage, det, p
    torch.cuda.empty_cache()
    return t


class _CountSink:
    """An audio sink that counts the samples written."""

    def __init__(self):
        self.samples = 0

    def write(self, samples):
        self.samples += int(np.asarray(samples).size)

    def close(self):
        pass


def phase_fused_listen(card: str) -> dict:
    """10 (d): the fused stage with ``listen="time"`` and then
    ``listen="mvdr"`` (mic batch 64, K=16), steered at (10°, -5°), 4 s at
    line rate, on the ring ``demo sensorfusion --listen`` sizes (four mic
    batches): 0 underrun frames, audio frames equal to the mic frames the
    program beamed, the audio e2e p50/p95, and a recorded batch's beams
    against ``miso_beam`` / ``mvdr_listen_step`` run apart on the same
    frames (and the same MVDR state)."""
    from zybo_rt_sampler_image_detection_torch.apps.pipeline import (
        _pad_full)
    from zybo_rt_sampler_image_detection_torch.models import detect
    from zybo_rt_sampler_image_detection_torch.ops import beamform, freq

    out = {}
    for listen in ("time", "mvdr"):
        # the ring `demo sensorfusion --listen` sizes: a few cycles of mic
        # batches (apps/demo.py), not one
        cfg, p = _fused_pipeline(ring_frames=max(64, 4 * FUSED_MIC_BATCH))
        p.q_yolo = queue.Queue(maxsize=2 * FUSED_BATCH)
        det = detect.pretrained_demo_detector(device="cuda")
        sink = _CountSink()
        stage = _fused_stage(p, det, "rgb", listen=listen, sink=sink)
        p._miso = stage
        d = p.steer_cartesian_degree(LISTEN_AZ, LISTEN_EL)
        stage.warmup()
        rec = _record_launch(stage, 3)
        beams_seen = []
        write = stage.audio.write

        def keep(beams, skipped, stamps=None):
            beams_seen.append(np.array(beams))
            return write(beams, skipped, stamps)

        stage.audio.write = keep
        launches, elapsed, sent = _drive_fused(cfg, p, stage,
                                               FULLRATE_SECONDS,
                                               cam_fps=60.0)
        rep = stage.report()
        mic_frames = (rec["n"]) * stage.Km
        x = _pad_full(torch.from_numpy(rec["mic"]).cuda(), cfg.n_microphones)
        if listen == "time":
            ref = beamform.miso_beam(x, p.tables, rec["d"]).cpu().numpy()
        else:
            ref = freq.mvdr_listen_step(rec["state"], x, stage._mvdr.tables,
                                        rec["d"], alpha=stage.alpha)[0]
            ref = ref.cpu().numpy()
        got = stage.audio.post_fn(beams_seen[2])
        ref = stage.audio.post_fn(ref)
        err = np.abs(got - ref)
        gate = float((err / (LISTEN_ATOL + LISTEN_RTOL * np.abs(ref))).max())
        print(f"[fused-listen] {listen}: {rec['n']} cycles of "
              f"{stage.Km} mic frames ({mic_frames} frames, "
              f"{mic_frames / elapsed:.1f}/s vs line rate 190.7/s) in "
              f"{elapsed:.2f} s; audio frames {rep['audio_frames']}; "
              f"underrun frames {rep['underrun_frames']}; sink samples "
              f"{sink.samples}; composited {stage.frames}; audio e2e p50 "
              f"{rep.get('audio_e2e_p50_ms')} p95 "
              f"{rep.get('audio_e2e_p95_ms')} ms; K1 launches {launches}; "
              f"phase_p50_ms {json.dumps(rep['phase_p50_ms'])}; emulator "
              f"sent {sent} packets [{card}]")
        print(f"[fused-listen] {listen}: recorded batch (direction "
              f"{rec['d']}, steered {d}): beams after the gain chain vs "
              f"{'miso_beam' if listen == 'time' else 'mvdr_listen_step'} "
              f"run apart max abs {err.max():.3e} ({gate:.3f} of the rtol "
              f"{LISTEN_RTOL:g} / atol {LISTEN_ATOL:g} gate)")
        assert rep["underrun_frames"] == 0, "underruns in the fused stage"
        assert rep["audio_frames"] == len(beams_seen) * stage.Km
        assert sink.samples == rep["audio_frames"] * cfg.n_samples
        assert gate <= 1.0, f"{listen}: beams differ"
        assert launches > 0
        out[listen] = dict(launches=launches, e2e_p50=rep.get(
            "audio_e2e_p50_ms"), e2e_p95=rep.get("audio_e2e_p95_ms"))
        del p, stage, det
        torch.cuda.empty_cache()
    return out


def phase_fused_demo(card: str) -> dict:
    """10 (e): ``demo sensorfusion --replay --frames 30 --out ''`` (the
    fused default) and ``--composite device``, each from the native
    emulator, each exiting 0."""
    import contextlib
    import io

    from zybo_rt_sampler_image_detection_torch.apps import demo
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ingest.streamer import (
        NativeStreamer)
    from zybo_rt_sampler_image_detection_torch.ops import equiv_kernel as ek

    cfg = Config()
    sig = np.tile(_source_frame(cfg, 40, 20), (1, 8))
    out = {}
    for extra in ([], ["--composite", "device"]):
        emu = NativeStreamer(cfg, n_arrays=cfg.active_arrays)
        buf = io.StringIO()
        emu.start(sig, rate=cfg.sample_rate)
        try:
            zero_counts()
            with contextlib.redirect_stdout(buf):
                rc = demo.main(["sensorfusion", "--replay", "--frames", "30",
                                "--out", ""] + extra)
        finally:
            emu.stop()
        text = buf.getvalue()
        rate = [ln for ln in text.splitlines() if "fused rate:" in ln]
        comp = [ln for ln in text.splitlines() if ln.startswith("composite:")]
        name = " ".join(extra) or "--composite fused (default)"
        print(f"[fused-demo] {name}: rc {rc}; "
              f"{rate[0] if rate else 'no rate line'}; "
              f"{comp[0][:400] if comp else ''}; K1 launches "
              f"{ek.equiv_power.launches} [{card}]")
        assert rc == 0, f"demo sensorfusion {name} exited {rc}:\n{text}"
        out[name] = ek.equiv_power.launches
        torch.cuda.empty_cache()
    return out


def phase_fused_all(card: str) -> dict:
    """Phase 10: (a) to (e)."""
    comp = phase_composite(card)
    fused = phase_fused(card)
    wide = phase_fused_wide(card, fused)
    listen = phase_fused_listen(card)
    demos = phase_fused_demo(card)
    rgb, yuv = fused["rgb"], fused["yuv420"]
    print(f"[fused] display transport: rgb {rgb['frames_per_s']:.2f} "
          f"frames/s, yuv420 {yuv['frames_per_s']:.2f} frames/s")
    return dict(composite=comp, fused=fused, wide=wide, listen=listen,
                demos=demos)


# -- phase 11: training on the card ------------------------------------------

TRAIN_LOSS_RTOL = 1e-4      # five steps' losses (tests/test_torch_train.py)
TRAIN_LEAF_RNORM = 3e-4     # every leaf after five steps (test_vision.py:451)
TRAIN_AP_GATE = 0.75        # the demo detector (tests/test_vision.py:189)
# (label, YoloConfig keywords, batch, timed steps)
TRAIN_SHAPES = (
    ("demo", dict(input_size=64, width_mult=0.25, num_classes=1), 8, 200),
    ("416", dict(input_size=416, width_mult=1.0, num_classes=3), 16, 60))
TRAIN_RANGES = ("train/forward", "train/backward", "train/optimizer")


def _leaf_dict(tree, prefix=()) -> dict:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_leaf_dict(tree[k], prefix + (k,)))
    else:
        out[prefix] = np.asarray(tree, np.float64)
    return out


def _five_steps(device: str, batches, order) -> tuple:
    from zybo_rt_sampler_image_detection_torch.models import train, yolo

    cfg = yolo.YoloConfig(input_size=64, width_mult=0.25)
    tr = train.Trainer(cfg, learning_rate=3e-3, seed=0, device=device)
    losses = [tr.train_step(im[order], [bx[i] for i in order])
              for im, bx in batches]
    return losses, _leaf_dict(tr.state.variables)


def phase_train_parity(card: str) -> dict:
    """11 (a): five train steps at the demo shape (64 px, width 0.25,
    B=8) from one seeded init on the card and on the CPU, each in the
    given batch order and in seven fixed permutations of every batch (the
    same training): the losses at rtol 1e-4 and every leaf within a
    relative norm of 3e-4 for at least one (card order, CPU order) pair.
    A near-tie in a max-pool window turns an FP32 gradient by about 1%
    one way or the other, so each side's runs fall on a few branches
    (``tests/test_torch_train.py::test_five_steps_match_jax``)."""
    from zybo_rt_sampler_image_detection_torch.models import data

    rng = np.random.default_rng(6)
    batches = [data.synthetic_detection_batch(rng, 8, 64) for _ in range(5)]
    orders = [np.arange(8)] + [np.random.default_rng(s).permutation(8)
                               for s in range(7)]
    cards = [_five_steps("cuda", batches, o) for o in orders]
    cpus = [_five_steps("cpu", batches, o) for o in orders]
    for got, _ in cards:
        assert np.isfinite(got).all(), got
    dists = {}
    for a, (got, got_leaves) in enumerate(cards):
        for b, (ref, ref_leaves) in enumerate(cpus):
            leaf = max(np.linalg.norm(got_leaves[p] - r)
                       / max(np.linalg.norm(r), 1e-12)
                       for p, r in ref_leaves.items())
            loss = float(np.max(np.abs(np.subtract(got, ref))
                                / np.abs(ref)))
            dists[a, b] = (loss, leaf)
    ok = [k for k, (loss, leaf) in dists.items()
          if loss < TRAIN_LOSS_RTOL and leaf < TRAIN_LEAF_RNORM]
    best = min(dists, key=lambda k: dists[k][1])
    same = [f"{dists[a, a][0]:.2e}/{dists[a, a][1]:.2e}"
            for a in range(len(orders))]
    print(f"[train-parity] five steps, card vs CPU, losses (given order) "
          f"{[round(x, 4) for x in cards[0][0]]}; max loss rel / max leaf "
          f"rnorm in the same order, for each of the 8 orders: {same}; "
          f"{len(ok)} of {len(dists)} (card, CPU) order pairs within the "
          f"gates ({TRAIN_LOSS_RTOL}, {TRAIN_LEAF_RNORM}), the closest "
          f"{best}: {dists[best][0]:.2e} / {dists[best][1]:.2e} [{card}]")
    assert ok, f"card vs CPU training off the gates in every pair: {same}"
    return dict(losses=cards[0][0], pairs_ok=len(ok), best=dists[best])


def _trace_split(logdir: str) -> dict:
    """Device time by ``annotate`` range and by kernel from the Chrome
    trace ``utils.profiling.trace`` wrote: a kernel belongs to the range
    whose host interval holds its launch (matched by correlation id)."""
    import glob

    path = max(glob.glob(os.path.join(logdir, "trace_*.json")),
               key=os.path.getmtime)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation"
              and e.get("name") in TRAIN_RANGES]
    launch_at = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_range = dict.fromkeys(TRAIN_RANGES, 0.0)
    by_name: dict = {}
    other = 0.0
    for k in kernels:
        dur = float(k["dur"])
        t = launch_at.get(k.get("args", {}).get("correlation"))
        owner = next((n for a, b, n in ranges
                      if t is not None and a <= t <= b), None)
        if owner is None:
            other += dur
        else:
            by_range[owner] += dur
        n, c = by_name.get(k["name"], (0.0, 0))
        by_name[k["name"]] = (n + dur, c + 1)
    span = 0.0
    if kernels and ranges:
        start = min(a for a, _, _ in ranges)
        end = max(k["ts"] + k["dur"] for k in kernels)
        span = end - start
    busy = sum(by_range.values()) + other
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(by_range_us=by_range, other_us=other, busy_us=busy,
                span_us=span, n_kernels=len(kernels), top=top)


def _train_bound(cfg, B: int, model) -> dict:
    """A train step's bound: the convs' forward operations (counted by
    ``FlopCounterMode`` on a one-frame CPU run) times 3 (forward, input
    and weight gradients) times B, at FP32 on the CUDA cores (TF32 off);
    bytes: the uint8 batch read once, the weights, gradients and both
    Adam moments read and written once."""
    from torch.utils.flop_counter import FlopCounterMode

    from zybo_rt_sampler_image_detection_torch.models import yolo

    m = yolo.TinyYolo(cfg).eval()
    x = torch.zeros(1, cfg.input_size, cfg.input_size, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        m(x)
    fwd = fc.get_total_flops()
    n_params = sum(p.numel() for p in model.parameters())
    nb = B * cfg.input_size ** 2 * 3 + 2 * 4 * 4 * n_params
    return dict(fwd_gflop_per_frame=fwd / 1e9, step_gflop=3 * fwd * B / 1e9,
                **bound(nb, 3 * fwd * B))


def phase_train_throughput(card: str) -> dict:
    """11 (b): train steps/s at the demo shape (64 px, width 0.25, one
    class, B=8) and at ``YoloConfig(416, width 1.0, 3 classes)`` with
    B=16: ``train.pool_step`` on a device-resident pool of 4 batches,
    CUDA events over the timed steps after 10 warm-up steps; a
    ``utils.profiling.trace`` of 5 steps split into forward, backward and
    optimizer by their ``annotate`` ranges, with the top device kernels
    and the device's idle share over the traced window; the bound."""
    import tempfile

    from zybo_rt_sampler_image_detection_torch.models import data, train, yolo
    from zybo_rt_sampler_image_detection_torch.utils import profiling

    out = {}
    for label, kw, B, steps in TRAIN_SHAPES:
        cfg = yolo.YoloConfig(**kw)
        tr = train.Trainer(cfg, learning_rate=1e-3, seed=0, device="cuda")
        rng = np.random.default_rng(1)
        batches = [data.synthetic_detection_batch(
            rng, B, cfg.input_size, num_classes=cfg.num_classes)
            for _ in range(4)]
        pool = torch.as_tensor(np.stack(
            [(im * 255.0).astype(np.uint8) for im, _ in batches]),
            device="cuda")
        tms = [train.build_targets(cfg, bx) for _, bx in batches]
        targets = [torch.as_tensor(np.stack([tm[h][0] for tm in tms]),
                                   device="cuda") for h in range(2)]
        masks = [torch.as_tensor(np.stack([tm[h][1] for tm in tms]),
                                 device="cuda") for h in range(2)]

        def step(i):
            return train.pool_step(tr, pool, targets, masks, i % 4)

        for i in range(10):
            step(i)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for i in range(steps):
            loss = step(i)
        end.record()
        end.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        ms = start.elapsed_time(end) / steps
        assert np.isfinite(float(loss))
        with tempfile.TemporaryDirectory() as d:
            with profiling.trace(d):
                for i in range(5):
                    step(i)
                torch.cuda.synchronize()
            sp = _trace_split(d)
        b = _train_bound(cfg, B, tr.state.model)
        r = {k.split("/")[1]: v / 5e3 for k, v in sp["by_range_us"].items()}
        idle = 1.0 - sp["busy_us"] / sp["span_us"] if sp["span_us"] else None
        out[label] = dict(ms=ms, wall_ms=wall_ms, steps_per_s=1e3 / ms,
                          imgs_per_s=1e3 / ms * B, split_ms=r, idle=idle,
                          **b)
        print(f"[train] {label} (size {cfg.input_size}, width "
              f"{cfg.width_mult}, {cfg.num_classes} classes, B={B}): "
              f"{ms:.4f} ms a step on CUDA events ({1e3 / ms:.2f} steps/s, "
              f"{1e3 / ms * B:.1f} img/s; host wall {wall_ms:.4f} ms), over "
              f"{steps} steps after 10 warm-up [{card}]")
        print(f"[train] {label} traced 5 steps: device ms a step forward "
              f"{r['forward']:.4f}, backward {r['backward']:.4f}, "
              f"optimizer {r['optimizer']:.4f}, outside the ranges "
              f"{sp['other_us'] / 5e3:.4f}; {sp['n_kernels'] / 5:.0f} "
              f"kernels a step; device idle share "
              f"{'not measured' if idle is None else f'{idle:.1%}'} of the "
              f"traced window; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}; {b['step_gflop']:.2f} GFLOP a step = 3 x "
              f"{b['fwd_gflop_per_frame']:.4f} GFLOP forward x {B}; "
              f"{b['bound_ms'] / ms:.1%} of it)")
        print(f"[train] {label} top device kernels (ms over 5 steps, "
              f"count): " + "; ".join(
                  f"{n[:60]} {t / 1e3:.3f} ({c})" for n, (t, c) in sp["top"]))
        del tr, pool, targets, masks
        torch.cuda.empty_cache()
    reps = 20000

    def ann():
        with profiling.annotate("x"):
            pass

    t0 = time.perf_counter()
    for _ in range(reps):
        ann()
    ann_us = (time.perf_counter() - t0) / reps * 1e6
    print(f"[train] one annotate span with no profiler recording (off: "
          f"a flag check) costs {ann_us:.2f} us of host; a step opens "
          f"3 [{card}]")
    out["annotate_us"] = ann_us
    return out


def phase_train_demo_detector(card: str) -> dict:
    """11 (c): ``train.pretrained_demo_detector(steps=700)`` on the card
    with a temporary cache, then held-out AP@0.5 on the 48 frames of
    ``synthetic_detection_batch(default_rng(999), 48, size=64)`` at least
    0.75; the second call loads the cache."""
    import tempfile

    from zybo_rt_sampler_image_detection_torch.models import data, train
    from zybo_rt_sampler_image_detection_torch.models import eval as ev

    steps = 700
    imgs, boxes = data.synthetic_detection_batch(
        np.random.default_rng(999), 48, size=64)
    with tempfile.TemporaryDirectory() as d:
        cache = os.path.join(d, "det.pkl")
        t0 = time.perf_counter()
        det = train.pretrained_demo_detector(cache_path=cache, steps=steps,
                                             device="cuda")
        train_s = time.perf_counter() - t0
        ap = ev.evaluate_detector(det, imgs, boxes)
        t0 = time.perf_counter()
        again = train.pretrained_demo_detector(cache_path=cache,
                                               device="cuda")
        load_s = time.perf_counter() - t0
        ap2 = ev.evaluate_detector(again, imgs, boxes)
    print(f"[train-demo] pretrained_demo_detector(steps={steps}) on the "
          f"card: {train_s:.2f} s ({steps / train_s:.1f} steps/s with host "
          f"targets "
          f"and uploads), held-out AP@0.5 {ap:.4f} (gate {TRAIN_AP_GATE}); "
          f"cache load {load_s:.3f} s, AP {ap2:.4f} [{card}]")
    assert ap >= TRAIN_AP_GATE, f"AP@0.5 {ap:.3f}"
    assert ap2 == ap
    return dict(ap=ap, train_s=train_s)


def phase_train_recipe(card: str) -> dict:
    """11 (d): ``train_reference_recipe`` at 416 px, width 1.0, 3
    classes, B=16, cut to 300 steps (chunks of 100), a pool of 16
    batches and 64 held-out images; the weights saved, loaded into a
    ``YoloDetector`` and run.  The gate: the loss falls from the first
    chunk's end to the last."""
    import re
    import tempfile

    from zybo_rt_sampler_image_detection_torch.models import detect, train
    from zybo_rt_sampler_image_detection_torch.models import yolo

    lines: list = []
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "w.pkl")
        t0 = time.perf_counter()
        rep = train.train_reference_recipe(
            steps=300, batch_size=16, size=416, width=1.0, num_classes=3,
            pool_batches=16, chunk_steps=100, eval_images=64, map_gate=0.0,
            weights_out=path, progress=lines.append, device="cuda")
        total_s = time.perf_counter() - t0
        det = detect.YoloDetector(model_path=path, cfg=yolo.YoloConfig(
            input_size=416, width_mult=1.0, num_classes=3), device="cuda")
        frame = np.zeros((240, 320, 3), np.uint8)
        dets = det.get_detections(frame, conf_threshold=0.05,
                                  include_class=True)
    losses = [float(m.group(1)) for m in
              (re.search(r"^step \d+/\d+: loss ([0-9.eE+-]+)", ln)
               for ln in lines) if m]
    print(f"[train-recipe] 300 steps at 416 px, width 1.0, 3 classes, B=16"
          f" (pool 16, eval 64): {rep['steps_per_s']} steps/s, "
          f"{rep['imgs_per_s']} img/s (chunk 2), train {rep['train_s']} s, "
          f"whole call {total_s:.1f} s; losses at the chunk ends {losses}; "
          f"final {rep['final_loss']}; held-out mAP@0.5 {rep['map50']} "
          f"(per class {rep['aps']}); backend {rep['backend']}; the saved "
          f"weights load and detect ({len(dets)} rows on a blank frame) "
          f"[{card}]")
    print(f"[train-recipe] {lines[0]}")
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    return rep


def phase_demo_record(card: str) -> dict:
    """11 (e): ``demo record --replay --seconds 1`` from the native
    emulator at ``Config()`` on loopback; the ``.npy`` holds (mics, the
    frames of 1 s x 256) float32, not all zero."""
    import contextlib
    import io
    import tempfile

    from zybo_rt_sampler_image_detection_torch.apps import demo
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ingest.streamer import (
        NativeStreamer)

    cfg = Config()
    sig = np.tile(_source_frame(cfg, 40, 20), (1, 8))
    emu = NativeStreamer(cfg, n_arrays=cfg.active_arrays)
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rec.npy")
        emu.start(sig, rate=cfg.sample_rate)
        try:
            with contextlib.redirect_stdout(buf):
                rc = demo.main(["record", "--replay", "--seconds", "1",
                                "--out", path])
        finally:
            emu.stop()
        rec = np.load(path)
    n_frames = int(np.ceil(cfg.sample_rate / cfg.n_samples))
    want = (cfg.n_microphones, n_frames * cfg.n_samples)
    print(f"[record] demo record 1 s: rc {rc}; {buf.getvalue().strip()}; "
          f"shape {rec.shape} (want {want}), {rec.dtype}, "
          f"{int((np.abs(rec).sum(0) > 0).sum() // cfg.n_samples)} frames "
          f"not all zero [{card}]")
    assert rc in (None, 0) and rec.shape == want and rec.dtype == np.float32
    assert rec.any()
    return dict(shape=rec.shape)


def phase_train_all(card: str) -> dict:
    """Phase 11: (a) to (e)."""
    parity = phase_train_parity(card)
    rate = phase_train_throughput(card)
    demo_det = phase_train_demo_detector(card)
    recipe = phase_train_recipe(card)
    rec = phase_demo_record(card)
    return dict(parity=parity, rate=rate, demo=demo_det, recipe=recipe,
                record=rec)


# -- phase 12: the web monitor ------------------------------------------------

WEB_ROUTES = ("/enableBackend1?fullrate=1", "/enableBackend1?fused=1",
              "/sound", "/sound?beam=mvdr", "/enableBackend3",
              "/enableBackend4")
# routes whose heatmap runs through the policy (K1 at ``high``)
WEB_K1_ROUTES = ("/enableBackend1", "/enableBackend1?fullrate=1",
                 "/enableBackend1?fused=1", "/sound", "/sound?beam=mvdr")
WEB_SECONDS = 4.0          # MJPEG frames counted a route, after 1 s
WEB_SOAK_S, WEB_SOAK_WARMUP_S, WEB_SOAK_GROWTH_MB = 60.0, 15.0, 64.0
MJPEG_BOUNDARY = b"\r\n--frame\r\n"


class _MjpegClient:
    """One /monitor client on its own thread: counts frames on the true
    multipart boundary (not the bare substring) and keeps the newest
    part."""

    def __init__(self, url: str):
        self.frames, self.last = 0, b""
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(url,),
                                        daemon=True)
        self._thread.start()

    def _run(self, url: str):
        import urllib.request

        buf = b""
        with urllib.request.urlopen(url, timeout=30) as r:
            while not self._stop.is_set():
                chunk = r.read1(1 << 16)
                if not chunk:
                    break
                parts = (buf + chunk).split(MJPEG_BOUNDARY)
                self.frames += len(parts) - 1
                if len(parts) > 1:
                    self.last = parts[-2]
                buf = parts[-1]

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
        assert not self._thread.is_alive(), "the MJPEG client hung"


def _vmrss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    raise RuntimeError("no VmRSS")


def _web_stages(rep: dict) -> str:
    """Each pipeline stage's rate and latency p50 from /metrics."""
    pipe = rep.get("pipeline", {})
    parts = [f"{k} {v['rate_hz']}/s p50 {v['latency_p50_ms']} ms"
             for k, v in pipe.items() if isinstance(v, dict)
             and "rate_hz" in v]
    gaps = pipe.get("ingest", {}).get("gaps")
    return "; ".join(parts) + f"; ingest gaps {gaps}"


def _web_jpeg_ok(part: bytes) -> bool:
    return b"\xff\xd8" in part and part.rstrip(b"\r\n").endswith(b"\xff\xd9")


def phase_web(card: str) -> dict:
    """Phase 12: ``make_server(Config() at high, replay=True, port=0,
    device="cuda")`` on loopback, fed by the native emulator at line rate.
    A soak of WEB_SOAK_S on /enableBackend1 with one /monitor client
    (VmRSS every 5 s, growth after WEB_SOAK_WARMUP_S at most
    WEB_SOAK_GROWTH_MB), then WEB_ROUTES, each: MJPEG frames/s, /metrics,
    K1 launches; a route fails when it serves no frame or its overlay
    errors grow after its first second."""
    import urllib.request

    from zybo_rt_sampler_image_detection_torch.apps import web
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ingest.streamer import (
        NativeStreamer)
    from zybo_rt_sampler_image_detection_torch.ops import equiv_kernel as ek

    cfg = Config().replace(matmul_precision="high")
    server = web.make_server(cfg, replay=True, port=0, device="cuda")
    cam = server.camera
    base = f"http://127.0.0.1:{server.server_address[1]}"
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def get(path, timeout=300):
        return urllib.request.urlopen(base + path, timeout=timeout).read()

    def metrics():
        return json.loads(get("/metrics", 10))

    print(f"[web] {card}; JPEG encoder {cam.jpeg_name}; window "
          f"{cfg.window_width}x{cfg.window_height}")
    emu = NativeStreamer(cfg, n_arrays=cfg.active_arrays)
    emu.start(np.tile(_source_frame(cfg, 40, 20), (1, 8)),
              rate=cfg.sample_rate)
    out = {}
    try:
        for route in ("/enableBackend1",) + WEB_ROUTES:
            soak = route == "/enableBackend1"
            zero_counts()
            t0 = time.perf_counter()
            get(route)
            started = time.perf_counter() - t0
            client = _MjpegClient(base + "/monitor")
            time.sleep(1.0)
            m1, f1, t1 = metrics(), client.frames, time.perf_counter()
            rss = []
            if soak:
                while time.perf_counter() - t1 < WEB_SOAK_S:
                    time.sleep(5.0)
                    rss.append((time.perf_counter() - t1, _vmrss_mb()))
                    print(f"[web-soak] {rss[-1][0]:.0f} s VmRSS "
                          f"{rss[-1][1]:.1f} MB, {client.frames} frames")
            else:
                time.sleep(WEB_SECONDS)
            m2, f2, t2 = metrics(), client.frames, time.perf_counter()
            client.stop()
            launches = ek.equiv_power.launches
            fps = (f2 - f1) / (t2 - t1)
            print(f"[web] {route}: started in {started:.2f} s; "
                  f"{fps:.2f} MJPEG frames/s over {t2 - t1:.1f} s; K1 "
                  f"launches {launches}; overlay errors "
                  f"{m1['overlay_errors']} -> {m2['overlay_errors']} "
                  f"({m2['last_overlay_error'] or '-'}); jpeg {m2['jpeg']}; "
                  f"{_web_stages(m2)}"
                  + (f"; fused {json.dumps(m2['fused'])}"
                     if "fused" in m2 else ""))
            assert f2 > f1, f"{route}: no MJPEG frame served"
            assert _web_jpeg_ok(client.last), f"{route}: not a JPEG"
            assert m2["overlay_errors"] == m1["overlay_errors"], (
                f"{route}: overlay errors grew")
            assert m2["running"] and m2["jpeg"] == cam.jpeg_name
            if route in WEB_K1_ROUTES:
                assert launches > 0, f"{route}: K1 never launched"
            out[route] = dict(fps=fps, launches=launches)
            if soak:
                after = [mb for t, mb in rss if t >= WEB_SOAK_WARMUP_S]
                growth = max(after) - after[0]
                print(f"[web-soak] VmRSS {after[0]:.1f} MB at "
                      f"{WEB_SOAK_WARMUP_S:.0f} s, max {max(after):.1f} MB "
                      f"after: growth {growth:.1f} MB (limit "
                      f"{WEB_SOAK_GROWTH_MB:.0f})")
                assert growth <= WEB_SOAK_GROWTH_MB, "the monitor's RSS grew"
        get("/disconnect")
    finally:
        server.shutdown()
        server.server_close()
        cam.stop()
        emu.stop()
    # the NumPy encoder, which a host without cv2 and Pillow serves with
    from zybo_rt_sampler_image_detection_torch.utils import imaging, jpeg

    frame = imaging.resize(web.SyntheticCamera().read()[1],
                           (cfg.window_width, cfg.window_height))
    enc_ms = call_ms(lambda: jpeg.encode(frame), 5)
    buf = jpeg.encode(frame)
    print(f"[web] NumPy JPEG encoder on this host: {enc_ms:.1f} ms a "
          f"{cfg.window_width}x{cfg.window_height} frame ({len(buf)} "
          f"bytes); the server ran {cam.jpeg_name}")
    assert _web_jpeg_ok(buf)
    torch.cuda.empty_cache()
    return out


# -- phase 13: the device mesh ------------------------------------------------

MESH_B = 16


def _mesh_gate(label: str, got, ref, rtol: float, atol: float) -> None:
    a = got.double().cpu().numpy()
    b = ref.double().cpu().numpy()
    err = float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b))))
    print(f"[mesh] {label}: max |got - ref| / (atol + rtol |ref|) = "
          f"{err:.3f} (rtol {rtol:.0e}, atol {atol:.0e})")
    assert err <= 1.0, label


class _MeshRecorder:
    """Wraps a sharded stage's program: keeps one batch (its row shards
    joined on the first device) and its maps."""

    def __init__(self, fn, first):
        self.fn, self.first, self.calls = fn, first, 0
        self.x = self.y = None

    def __call__(self, rows):
        out = self.fn(rows)
        self.calls += 1
        if self.x is None and self.calls > 8:
            self.x = torch.cat([r.to(self.first) for r in rows])
            self.y = out.clone()
        return out


def phase_mesh(card: str) -> dict:
    """Phase 13: the mesh over ``cuda:0`` as (1, 1) and (2, 2) (and every
    card when there are more): each sharded power against its
    single-device result at the gates of tests/test_parallel.py, K1 and
    K2 launches a block, sharded against single-device times; the sharded
    full-rate stage at ``Config()`` for FULLRATE_SECONDS; Trainer(mesh=(2,
    1)) against Trainer(); dryrun_multichip(4)."""
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.models import (
        data, train, yolo)
    from zybo_rt_sampler_image_detection_torch.ops import (
        beamform, equiv_kernel as ek, freq, freq_equiv, fused_kernel as fk)
    from zybo_rt_sampler_image_detection_torch.parallel import (
        dryrun, mesh as pm)

    cfg = Config()
    cfg_h = cfg.replace(matmul_precision="high")
    t = beamform.make_tables(cfg, "lerp", device="cuda")
    th = beamform.make_tables(cfg_h, "lerp", device="cuda")
    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn((MESH_B, cfg.n_microphones, cfg.n_samples),
                    device="cuda", generator=g) * 0.05
    ref, ref_h = beamform.steered_power(x, t), beamform.steered_power(x, th)
    et = freq_equiv.make_equiv_tables(t)
    ref_eq = freq_equiv.equiv_steered_power(x, et)
    ft = freq.make_freq_tables(cfg, 100.0, device="cuda")
    ref_fft = freq.fft_steered_power(x, ft)
    ref_maps, _ = freq.mvdr_maps_scan(freq.init_precision(ft), x, ft)
    k1_single = ek.FusedEquivBeamformer(th)
    k2_single = fk.FusedBeamformer(t)
    dev0 = torch.device("cuda", 0)
    meshes = [("(1, 1) cuda:0", pm.make_mesh(1, 1, devices=[dev0])),
              ("(2, 2) cuda:0 x4", pm.make_mesh(2, 2, devices=[dev0] * 4))]
    if torch.cuda.device_count() > 1:
        meshes.append(("every card", pm.make_mesh()))
    out = {}
    for label, m in meshes:
        n = m.devices.size
        st = pm.shard_tables(t, m)
        _mesh_gate(f"{label} sharded_steered_power",
                   pm.sharded_steered_power(m, st)(x), ref, 1e-6, 1e-12)
        k2 = pm.sharded_fused_power(m, st)
        zero_counts()
        got = k2(x)
        torch.cuda.synchronize()
        n2 = fk.fused_power.launches
        _mesh_gate(f"{label} sharded_fused_power (K2)", got, ref, 1e-4,
                   1e-10)
        k1 = pm.sharded_equiv_kernel_power(m, th)
        zero_counts()
        got, got5 = k1(x), k1(x[:5])
        torch.cuda.synchronize()
        n1 = ek.equiv_power.launches
        _mesh_gate(f"{label} sharded_equiv_kernel_power (K1) B={MESH_B}",
                   got, ref_h, 5e-5, 1e-8)
        _mesh_gate(f"{label} sharded_equiv_kernel_power (K1) B=5", got5,
                   ref_h[:5], 5e-5, 1e-8)
        assert n2 == n and n1 == 2 * n, (n1, n2)
        _mesh_gate(f"{label} sharded_equiv_power vs single",
                   pm.sharded_equiv_power(m, pm.shard_equiv_tables(et, m))(
                       x), ref_eq, 1e-5, 1e-9)
        _mesh_gate(f"{label} sharded_fft_power",
                   pm.sharded_fft_power(m, ft)(x), ref_fft, 1e-6, 1e-12)
        stp, _ = pm.shard_freq_tables(ft, m, axes=("data", "model"))
        maps, _ = pm.sharded_mvdr_maps_scan(
            pm.shard_precision_state(freq.init_precision(stp.tables), m),
            x, stp)
        _mesh_gate(f"{label} sharded MVDR maps", maps, ref_maps, 1e-4, 1e-9)
        k1_ms, k1_one = in_turns(lambda: k1_single(x), lambda: k1(x), 10)
        k2_ms, k2_one = in_turns(lambda: k2_single(x), lambda: k2(x), 10)
        print(f"[mesh] {label}: per call {n1 // 2 // n} K1 and {n2 // n} "
              f"K2 launch(es) a block, {n} blocks; B={MESH_B} K1 sharded "
              f"{k1_ms:.3f} ms vs one device {k1_one:.3f}; K2 sharded "
              f"{k2_ms:.3f} ms vs {k2_one:.3f} (CUDA events, {card})")
        out[label] = dict(k1_launches=n1, k2_launches=n2, k1_ms=k1_ms,
                          k1_single_ms=k1_one, k2_ms=k2_ms,
                          k2_single_ms=k2_one)
        del st, k1, k2, stp, maps
        torch.cuda.empty_cache()

    # the mesh's main path: the sharded full-rate stage through the policy
    m = meshes[1][1]
    p = pipeline.Pipeline(cfg_h, "lerp", replay_mode=True, backend="native",
                          device="cuda")
    stage = p.make_heatmap_batched(batch=FULLRATE_BATCH, mesh=m,
                                   sink=lambda powers, first_seq: None)
    stage.power_fn = rec = _MeshRecorder(stage.power_fn, m.first)
    stage.warmup()
    rec.x = rec.y = None
    rec.calls = 0
    launches, elapsed, sent, marks = _line_rate(
        p, stage, (ek.equiv_power, "launches"))
    gaps = p.receiver.native_stats.gaps
    print(f"[mesh-fullrate] {meshes[1][0]}: processed {stage.processed} "
          f"frames in {elapsed:.2f} s ({stage.processed / elapsed:.1f}/s); "
          f"skipped {stage.skipped}; ingest gaps {gaps}; K1 launches "
          f"{launches} ({launches / max(rec.calls, 1):.1f} a batch); "
          f"emulator {sent / FULLRATE_SECONDS:.0f} pkt/s")
    assert stage.processed > 0 and stage.skipped == 0 and gaps == 0
    assert launches == m.devices.size * rec.calls, (launches, rec.calls)
    assert rec.x is not None, "no batch recorded"
    _mesh_gate("sharded full-rate batch vs plain FP32 steered_power",
               rec.y, beamform.steered_power(rec.x, th), E2E_RTOL, 0.0)
    out["fullrate_launches"] = launches
    del p, stage, rec
    zero_counts()
    pm.sharded_fused_power(m, pm.shard_tables(t, m))(x)
    torch.cuda.synchronize()
    out["time_launches"] = fk.fused_power.launches

    # data-parallel training on one global batch
    ycfg = yolo.YoloConfig(input_size=64, width_mult=0.25)
    images, boxes = data.synthetic_detection_batch(
        np.random.default_rng(6), 8, 64)
    single = train.Trainer(ycfg, learning_rate=3e-3, device="cuda")
    sharded = train.Trainer(ycfg, learning_rate=3e-3,
                            mesh=pm.make_mesh(2, 1, devices=[dev0] * 2))
    l1 = single.train_step(images, boxes)
    l2 = sharded.train_step(images, boxes)
    a, b = (_leaf_dict(tr.state.variables) for tr in (single, sharded))
    leaf = max(np.linalg.norm(b[k] - v) / max(np.linalg.norm(v), 1e-12)
               for k, v in a.items())
    print(f"[mesh-train] Trainer(mesh=(2, 1)) vs Trainer(): loss {l2:.6f} "
          f"vs {l1:.6f} (rel {abs(l2 - l1) / abs(l1):.2e}, gate 1e-4); "
          f"worst leaf {leaf:.2e} (gate 3e-4)")
    assert abs(l2 - l1) <= 1e-4 * abs(l1) and leaf <= 3e-4
    print(f"[mesh-dryrun] "
          f"{json.dumps(dryrun.dryrun_multichip(4, devices=[dev0] * 4))}")
    torch.cuda.empty_cache()
    return out


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
    main_b = phase_bartlett(card)
    phase_mvdr_oracle(card)
    main_q = phase_mvdr_quad_form(card)
    mvdr_full = phase_mvdr_fullrate(card)
    phase_mvdr_listen(card)
    phase_mvdr_live(card)
    t7 = time.perf_counter()
    phase_vision_detector(card)
    phase_vision_demo_detector(card)
    vision = phase_vision_chain(card)
    t8 = time.perf_counter()
    fused = phase_fused_all(card)
    t9 = time.perf_counter()
    phase_train_all(card)
    t10 = time.perf_counter()
    web_out = phase_web(card)
    t11 = time.perf_counter()
    mesh_out = phase_mesh(card)
    t12 = time.perf_counter()
    print(f"[time] build+K1 {t1 - t0:.1f} s, K5 {t2 - t1:.1f} s, K2-4 "
          f"{t3 - t2:.1f} s, live {t4 - t3:.1f} s, full rate+policy "
          f"{t5 - t4:.1f} s, listen {t6 - t5:.1f} s, fft/mvdr "
          f"{t7 - t6:.1f} s, vision {t8 - t7:.1f} s, fused {t9 - t8:.1f} s, "
          f"train {t10 - t9:.1f} s, web {t11 - t10:.1f} s, mesh "
          f"{t12 - t11:.1f} s")
    # launches: the main path's run (phase 5 live / phase 6 full rate);
    # listen_launches: the combined full-rate stage's run (phase 7);
    # vision_launches: the live stage beside the host fusion chain (9 c);
    # fused_launches: inside FusedSensorStage (10 b, the rgb run);
    # fused_listen_launches: the same with listen="time" (10 d);
    # web_launches: the web monitor's /enableBackend1 soak (12);
    # mesh_launches: K1 in the sharded full-rate stage on the (2, 2) mesh,
    # K2 in one sharded_fused_power call on it (13)
    kernels = [dict(name="equiv_power", route="cuda", source=KERNEL_SOURCE,
                    replaces=KERNEL_REPLACES, launches=live["equiv"],
                    listen_launches=listen["equiv"]["launches"],
                    listen_live_launches=listen_live,
                    vision_launches=vision["launches"],
                    fused_launches=fused["fused"]["rgb"]["launches"],
                    fused_listen_launches=fused["listen"]["time"][
                        "launches"],
                    web_launches=web_out["/enableBackend1"]["launches"],
                    mesh_launches=mesh_out["fullrate_launches"],
                    **main_k)]
    kernels.append(dict(
        name="time_power", route="cuda", source=TIME_SOURCE,
        replaces=TIME_REPLACES[0], also_replaces=TIME_REPLACES[1:],
        launches=full["fused"]["launches"],
        listen_launches=listen["fused"]["launches"],
        mesh_launches=mesh_out["time_launches"], **main_t))
    kernels.append(dict(
        name="equiv_power_fd", route="cuda", source=FD_SOURCE,
        replaces=FD_REPLACES, launches=full["fd"]["launches"], **main_fd))
    # launches: the fft full-rate stage of Config.fft_reference() (8 a)
    kernels.append(dict(
        name="bartlett_power", route="cuda", source=BARTLETT_SOURCE,
        replaces=None, **main_b))
    # launches: the full-rate MVDR stage's quadratic forms (8 c)
    kernels.append(dict(
        name="quad_form", route="cuda", source=QUAD_FORM_SOURCE,
        replaces=None, launches=mvdr_full["quad_form_launches"],
        quad_forms=mvdr_full["quad_forms"], **main_q))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
