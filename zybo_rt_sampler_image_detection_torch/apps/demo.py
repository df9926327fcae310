"""CLI entry point — the ``mimo`` heatmap demo, the ``miso`` listening
demo, the full-rate proof, the packet emulator, the sensor-fusion demo
and the MJPEG web monitor.

Examples::

    python -m zybo_rt_sampler_image_detection_torch.apps.demo emulate &
    python -m zybo_rt_sampler_image_detection_torch.apps.demo mimo --replay --headless --equiv-kernel --frames 20
    python -m zybo_rt_sampler_image_detection_torch.apps.demo mimo --replay
    python -m zybo_rt_sampler_image_detection_torch.apps.demo mimo --replay --headless --algorithm mvdr --frames 20
    python -m zybo_rt_sampler_image_detection_torch.apps.demo miso --replay --audio wav --seconds 2
    python -m zybo_rt_sampler_image_detection_torch.apps.demo miso --replay --beam mvdr --audio null
    python -m zybo_rt_sampler_image_detection_torch.apps.demo fullrate --seconds 10 --audio null
    python -m zybo_rt_sampler_image_detection_torch.apps.demo fullrate --seconds 10 --algorithm mvdr --audio null --beam mvdr
    python -m zybo_rt_sampler_image_detection_torch.apps.demo fullrate --device cpu --preset tiny --seconds 3
    python -m zybo_rt_sampler_image_detection_torch.apps.demo sensorfusion --replay --camera -2 --out ''
    python -m zybo_rt_sampler_image_detection_torch.apps.demo sensorfusion --replay --camera -2 --listen time --out ''
    python -m zybo_rt_sampler_image_detection_torch.apps.demo sensorfusion --replay --camera -2 --pretrain 700 --out ''
    python -m zybo_rt_sampler_image_detection_torch.apps.demo record --replay --seconds 1 --out capture.npy
    python -m zybo_rt_sampler_image_detection_torch.apps.demo web --replay --http-port 8000

Ported so far: ``mimo`` (the cv2 heatmap window, or stats when
``--headless``; every algorithm, ``fft`` and ``mvdr`` included), ``miso``
(live or ``--fullrate`` gapless listening; ``--beam mvdr`` always takes
the batched stage), ``fullrate`` (heatmaps, ``--audio`` heatmaps and the
beam from one transfer, ``--audio-only``) and ``emulate`` (parity with
``PC/demo.py`` mimo/miso and ``udp/streamer.c``), and ``sensorfusion``
(``--composite host``: camera, YOLO tracker, heatmap
stage, ``Viewer`` and ``SensorFusionDecider``), ``--composite device``
(the batched device compositor) and ``--composite fused`` (the default:
power, detector and compositor in one device program a batch, with
``--listen time|mvdr`` the gapless beam too; ``--pretrain N`` trains the
demo detector first), ``record`` (the ``.npy`` capture of
``PC/record.py``) and ``web`` (the MJPEG monitor of ``apps/web.py`` on
``--http-port``, fed by the UDP stream on ``--port``).  Every subcommand
runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..config import Config


def _add_common(p):
    p.add_argument("--replay", action="store_true",
                   help="bind loopback (replay/emulator mode)")
    p.add_argument("--algorithm", default="lerp",
                   choices=["pad", "lerp", "convolve", "hybrid",
                            "truncated", "fft", "mvdr"])
    p.add_argument("--backend", default="auto",
                   choices=["auto", "python", "native"])
    p.add_argument("--headless", action="store_true",
                   help="no cv2 windows; print stats instead")
    p.add_argument("--frames", type=int, default=0,
                   help="stop after N heatmaps (0 = run until ^C)")
    p.add_argument("--port", type=int, default=None, help="UDP port override")
    p.add_argument("--preset", default="default",
                   choices=["default", "reference", "fft", "tiny"],
                   help="config preset: default (config.json parity), "
                        "reference (+ dead-mic list), fft (the web "
                        "backend-3 profile), tiny (16ch 9x7)")
    p.add_argument("--equiv", action="store_true",
                   help="exact frequency-domain reformulation of the "
                        "selected time-domain algorithm (same output)")
    p.add_argument("--equiv-kernel", action="store_true",
                   help="force the fused equiv CUDA kernel (the auto "
                        "policy picks it at the high/bf16 rungs)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda raises when no GPU is present)")


def _resolve_arrays(args, cfg) -> int:
    """--arrays default = the config's active_arrays; explicit values are
    validated against capacity (a 3-array stream at the 1-array tiny
    config would overflow the ingest frame buffer)."""
    cap = cfg.n_microphones // (cfg.rows * cfg.columns)
    n = args.arrays if args.arrays else min(cfg.active_arrays, cap)
    if not 1 <= n <= cap:
        raise SystemExit(
            f"--arrays {n} exceeds this config's capacity ({cap} array(s) "
            f"of {cfg.rows}x{cfg.columns} in {cfg.n_microphones} mics)")
    return n


def _preset_config(args) -> Config:
    cfg = {"default": Config, "reference": Config.reference,
           "fft": Config.fft_reference,
           "tiny": Config.tiny}[args.preset]()
    if args.port:
        cfg = cfg.replace(udp_port=args.port)
    return cfg


def _make_pipeline(args, ring_frames: int = 64, audio_sink: str = "null",
                   audio_path=None):
    from .pipeline import Pipeline

    cfg = _preset_config(args)
    algorithm = args.algorithm
    if algorithm in ("fft", "mvdr") and (args.equiv or args.equiv_kernel):
        raise SystemExit(
            f"--equiv/--equiv-kernel reformulate the TIME-domain "
            f"algorithms (pad/lerp/convolve/hybrid/truncated); "
            f"--algorithm {algorithm} computes power its own way and "
            f"the flags would be ignored")
    # mvdr: the route's streaming-inverse (RLS) Capon maps, listening
    # through lerp tables
    return Pipeline(cfg, algorithm=algorithm, replay_mode=args.replay,
                    backend=args.backend, device=args.device,
                    ring_frames=ring_frames, audio_sink=audio_sink,
                    audio_path=audio_path,
                    power_backend=("equiv_kernel" if args.equiv_kernel
                                   else "freq_equiv" if args.equiv
                                   else "auto"))


def cmd_mimo(args):
    """Heatmap demo (``main.pyx:669-736``): the heatmap window, or stats
    per heatmap when headless."""
    p = _make_pipeline(args)
    try:
        p.connect()
        p.start_heatmap()
        if not args.headless:
            _viewer_loop(p, args.frames)
            return
        n = 0
        while not args.frames or n < args.frames:
            power, seq = p.q_power.get(timeout=10.0)
            n += 1
            if n % 10 == 1:
                x, y = np.unravel_index(power.argmax(), power.shape)
                print(f"heatmap #{n} seq={seq} peak=({x},{y}) "
                      f"max={power.max():.3e}")
        print("metrics:", p.report())
    finally:
        p.stop()


def _viewer_loop(p, frames: int = 0, display=None) -> int:
    """Show each heatmap of ``p.q_power`` (``visual.py:143-188``), blended
    50/50 with the previous one, until ``frames`` maps (0 = until ESC).
    ``display`` defaults to a cv2 window (cv2 imported at the first map),
    where a click steers the listening beam (``visual.py:375-386``:
    vertical, 1 - horizontal).  Returns the maps shown."""
    from ..utils import imaging, viz

    w, h = window = (720, 480)
    if display is None:
        def on_click(x, y):
            print(f"steer -> grid cell {p.steer_click(y / h, 1.0 - x / w)}")

        display = viz._CvDisplay("zybo-rt-torch mimo", on_click)
    prev = None
    n = 0
    while not frames or n < frames:
        power, seq = p.q_power.get(timeout=10.0)
        heat, _ = viz.calculate_heatmap(power, threshold=0, window=window)
        if prev is not None:
            heat = imaging.add_weighted(prev, 0.5, heat, 0.5)
        prev = heat
        n += 1
        if display.show(heat) == 27:          # ESC
            break
    return n


def cmd_miso(args):
    """Steered-listening demo (``main.pyx:824-864``): beam -> audio sink,
    steered from the CLI.  ``--fullrate`` switches from the reference's
    latest-frame sampling to the gapless batched stage (every frame
    beamed, sample-count-exact output), which passes only with 0 underrun
    frames; ``--beam mvdr`` (streaming-MVDR distortionless weights)
    always takes that stage."""
    sink = args.audio or ("auto" if not args.headless else "wav")
    p = _make_pipeline(args, ring_frames=max(64, 4 * args.batch),
                       audio_sink=sink, audio_path=args.out)
    stage = None
    try:
        # inside the try: a connect/bring-up failure must still tear the
        # pipeline down (leaked receiver/stage threads keep the process
        # alive after the traceback)
        if args.fullrate or args.beam == "mvdr":
            stage = p.make_miso_batched(batch=args.batch, beam=args.beam)
            # steered before it runs: no batch beams toward direction 0
            p.steer_cartesian_degree(args.azimuth, args.elevation)
            stage.warmup()      # build (and reset an MVDR state) first
            p.connect()
            p.run_stage(stage)
        else:
            p.connect()
            p.start_miso()
            p.steer_cartesian_degree(args.azimuth, args.elevation)
        t0 = time.time()
        while time.time() - t0 < args.seconds:
            time.sleep(0.2)
        print("metrics:", p.report())
    finally:
        p.stop()
    if sink == "wav":
        print(f"beam audio written to {args.out}")
    if stage is None:
        return 0
    elapsed = time.time() - t0
    print(f"beamed {stage.processed} frames -> {stage.samples} samples "
          f"({stage.samples / elapsed:.0f}/s vs line "
          f"{p.cfg.sample_rate:.0f}/s); underrun frames = "
          f"{stage.underrun_frames}")
    _print_audio_latency(stage, args.batch)
    print("GAPLESS" if stage.underrun_frames == 0 else "UNDERRUNS")
    return 0 if stage.underrun_frames == 0 else 1


def _print_audio_latency(stage, batch: int) -> None:
    lat = stage.audio_latency()
    if lat:
        print(f"audio e2e latency (ring->sink) p50 = "
              f"{lat['audio_e2e_p50_ms']} ms  p95 = "
              f"{lat['audio_e2e_p95_ms']} ms at K={batch}")
    if hasattr(stage.sink, "underflow_samples"):
        print(f"mock playback underflow: {stage.sink.underflow_samples} "
              f"samples ({stage.sink.underflow_ms:.1f} ms)")


def cmd_record(args):
    """.npy capture (``PC/record.py``): ``--seconds`` of contiguous frames
    off the receiver (nothing runs on the device)."""
    from ..ingest.receiver import Receiver
    from ..utils import recording

    cfg = _preset_config(args)
    r = Receiver(cfg, replay_mode=args.replay, backend=args.backend)
    r.connect()
    try:
        path = recording.record_npy(r, args.seconds, args.out)
        data = np.load(path)
        print(f"recorded {data.shape} float32 -> {path}")
    finally:
        r.disconnect()


def cmd_emulate(args):
    """Software FPGA (``udp/streamer.c`` parity): stream a synthetic signal
    or an .npy capture to loopback until ^C.  Default engine is the native
    chunk-paced streamer (``ingest/native/ingest.cpp``); ``--python`` keeps
    the loop-for-loop reference-parity generator."""
    cfg = Config()
    if args.port:
        cfg = cfg.replace(udp_port=args.port)
    n_arrays = _resolve_arrays(args, cfg)
    rate = None if args.fast else cfg.sample_rate
    if args.npy:
        sig = np.load(args.npy).astype(np.float32)
    else:
        t = np.arange(cfg.n_samples * 64) / cfg.sample_rate
        sig = np.tile(np.sin(2 * np.pi * args.freq * t).astype(np.float32),
                      (cfg.n_microphones, 1)) * 0.1
    use_python = args.python or args.once   # native streams cyclically
    engine = "python" if use_python else "native"
    print(f"emulating {n_arrays} array(s) on "
          f"{cfg.udp_replay_ip}:{cfg.udp_port} "
          f"({'max rate' if args.fast else 'real-time'}, {engine})")
    if not use_python:
        from ..ingest.streamer import NativeStreamer
        emu = NativeStreamer(cfg, n_arrays=n_arrays)
        emu.start(sig, rate=0.0 if args.fast else cfg.sample_rate)
        try:
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            print(f"sent {emu.stop()} packets")
        return
    from ..ingest.streamer import Streamer
    s = Streamer(cfg, n_arrays=n_arrays)
    s.send_header()
    try:
        while True:
            s.send_signal(sig, rate)
            if args.once:
                break
    except KeyboardInterrupt:
        pass
    finally:
        s.close()


def cmd_fullrate(args):
    """Full-line-rate proof: emulator at the true packet rate (48,828
    pkt/s for the reference config) -> native ingest -> batched device
    beamforming of EVERY frame; prints per-stage accounting.  The pass
    criterion is skipped == 0 (no frame overwritten unread) and ingest
    gaps == 0 for the whole run, and with ``--audio`` 0 underrun frames
    too.  The device program is built (and a stateful MVDR stream reset)
    before the first packet flows, and only the connected channel rows are
    sent to the device (the tail rows are never written)."""
    from ..ingest.streamer import NativeStreamer
    from ..utils import audio as audio_mod

    p = _make_pipeline(args, ring_frames=max(64, 4 * args.batch))
    # the emulator MUST use the pipeline's config (it honors --preset /
    # --port): a mismatched packet layout would make every datagram
    # invalid for the receiver
    cfg = p.cfg
    n_arrays = _resolve_arrays(args, cfg)
    n_ch = n_arrays * cfg.rows * cfg.columns
    line_rate = cfg.sample_rate / cfg.n_samples
    print(f"line rate {line_rate:.1f} frames/s "
          f"({cfg.sample_rate:.0f} pkt/s); batch={args.batch}; "
          f"channels={n_ch}; device={p.device}; running "
          f"{args.seconds:.0f}s ...")
    # the maps are only counted: no display sink
    count_only = lambda powers, first_seq: None      # noqa: E731
    audio_stage = None
    if args.audio:
        a_sink = audio_mod.make_sink(args.audio, cfg.sample_rate,
                                     args.audio_out)
        if args.audio_only:
            # pure listening proof: every frame beamed, gapless stream
            stage = p.make_miso_batched(batch=args.batch, beam=args.beam,
                                        channels=n_ch, sink=a_sink,
                                        transfer=args.transfer)
        else:
            # heatmaps and the beam from one transfer per batch
            stage = p.make_mimo_miso_batched(
                batch=args.batch, beam=args.beam, channels=n_ch,
                sink=a_sink, power_sink=count_only, transfer=args.transfer)
        audio_stage = stage
    else:
        stage = p.make_heatmap_batched(batch=args.batch, sink=count_only,
                                       channels=n_ch,
                                       transfer=args.transfer)
    t0 = time.time()
    stage.warmup()                          # build before packets flow
    print(f"  device program ready in {time.time()-t0:.1f}s; "
          "starting native line-rate emulator")
    t = np.arange(cfg.n_samples * 64) / cfg.sample_rate
    sig = np.tile(np.sin(2 * np.pi * 8000.0 * t).astype(np.float32),
                  (n_ch, 1)) * 0.1
    emu = NativeStreamer(cfg, n_arrays=n_arrays)
    emu.start(sig, rate=cfg.sample_rate)
    try:
        p.connect()                        # first packet = header
        p.run_stage(stage)
        t0 = time.time()
        while time.time() - t0 < args.seconds:
            time.sleep(1.0)
            rate = stage.processed / (time.time() - t0)
            audio = ("" if audio_stage is None else
                     f" underruns={audio_stage.underrun_frames}")
            print(f"  t={time.time()-t0:5.1f}s processed={stage.processed} "
                  f"({rate:.1f}/s) skipped={stage.skipped} "
                  f"ingest_gaps={p.receiver.native_stats.gaps}{audio}")
    finally:
        sent = emu.stop()
        elapsed = time.time() - t0
        p.stop()
    rep = p.report()
    ok = stage.skipped == 0 and p.receiver.native_stats.gaps == 0
    if audio_stage is not None:
        ok = ok and audio_stage.underrun_frames == 0
        print(f"\naudio: beamed {audio_stage.processed} frames -> "
              f"{audio_stage.samples} samples "
              f"({audio_stage.samples / elapsed:.0f}/s vs "
              f"{cfg.sample_rate:.0f}/s), underrun frames = "
              f"{audio_stage.underrun_frames} ("
              f"{'GAPLESS' if audio_stage.underrun_frames == 0 else 'UNDERRUNS'})")
        _print_audio_latency(audio_stage, args.batch)
    print(f"\nemulator sent {sent} packets "
          f"({sent / elapsed:.0f}/s vs line {cfg.sample_rate:.0f}/s)")
    print(f"processed {stage.processed} frames in {elapsed:.1f}s "
          f"({stage.processed / elapsed:.1f}/s vs line rate "
          f"{line_rate:.1f}/s)")
    print(f"skipped (ring overwrites) = {stage.skipped}; "
          f"ingest packet gaps = {p.receiver.native_stats.gaps}")
    key = stage.metric.name
    print("batch latency p50 =", rep[key]["latency_p50_ms"], "ms  p95 =",
          rep[key]["latency_p95_ms"], "ms")
    print("metrics:", rep)
    print("FULL RATE SUSTAINED" if ok else "DROPS DETECTED")
    return 0 if ok else 1


def cmd_sensorfusion(args):
    """Sensor-fusion demo (``main.pyx:669-736`` mimo +
    ``record_sensorfusion``): camera -> YOLO tracker, receiver -> heatmap,
    fused by the decider; the composited frames go to an array display
    and, with ``--out``, an mp4 (cv2).

    ``--composite fused`` (the default) runs the whole display cycle
    (steered power, YOLO forward, and the display chain: log-norm, jet-LUT
    colorize, resizes, power box, EMA, decider gating and blends) as one
    device program per K-frame batch with one packed upload and one packed
    download (``apps.fused.FusedSensorStage``); ``--listen time|mvdr``
    also beams the gapless steered-listening stream in the same program.
    ``--composite device`` runs the display chain alone as one batched
    device program (``fusion.composite.DeviceCompositor``) beside the
    separate heatmap and tracker stages; ``--composite host`` keeps the
    reference-shaped host chain (``utils.viz.Viewer`` +
    ``SensorFusionDecider``).

    ``--heatmap-batch`` > 1 runs the full-rate heatmap stage publishing
    every map to the display queue, at most ``--heatmap-rate`` maps/s (1 =
    the live single-frame stage); ``--tracker-batch`` > 1 runs one YOLO
    device program per K camera frames.  ``--camera -2`` (the detectable
    moving-object scene) without ``--weights`` takes the committed demo
    detector; ``--pretrain N`` trains the demo detector N steps instead
    (``models.train.pretrained_demo_detector``, cached in
    ``~/.cache/zrt_demo_detector_torch.pkl`` and loaded from there when
    present).  Exits 1 when fewer than ``--frames`` frames were
    composited or the fused stage failed."""
    from ..models.detect import YoloDetector, pretrained_demo_detector
    from ..models.yolo import YoloConfig
    from ..utils import imaging
    from ..utils.viz import ArrayDisplay, Viewer
    from .pipeline import put_drop_oldest
    from .web import SyntheticCamera

    if args.out and not imaging._HAS_CV2:
        raise SystemExit(f"--out {args.out} needs cv2 to write the mp4; "
                         f"pass --out '' to skip it")
    device_comp = args.composite == "device"
    fused_comp = args.composite == "fused"
    listen = None if args.listen == "off" else args.listen
    if listen and not fused_comp:
        raise SystemExit("--listen folds listening into the fused stage: "
                         "it needs --composite fused")
    # embedded listening reads counter-contiguous mic batches of
    # mic_batch (default 4x the composite batch): the ring must hold a
    # few cycles' worth or read_batch refuses the batch size
    mic_batch = (args.mic_batch or 4 * args.composite_batch) if listen \
        else 0
    p = _make_pipeline(args, ring_frames=max(64, 4 * mic_batch))
    frames_wanted = args.frames or 30
    disp = ArrayDisplay(keep=frames_wanted)
    stage = viewer = None
    try:
        p.connect()
        if fused_comp:
            # the fused stage owns the heatmap path, and batches K camera
            # frames a cycle: deepen the camera queue (drop-oldest at 2 for
            # the single-frame loops) before start_camera takes it
            import queue as _queue
            p.q_yolo = _queue.Queue(maxsize=2 * args.composite_batch)
        elif args.heatmap_batch > 1:
            def all_maps_sink(powers, first_seq):
                for j, pw in enumerate(powers):
                    put_drop_oldest(p.q_power, (pw, first_seq + j))

            p.start_heatmap_batched(batch=args.heatmap_batch,
                                    sink=all_maps_sink,
                                    max_rate=args.heatmap_rate)
        else:
            p.start_heatmap()
        if args.camera == -2:
            from ..models.data import SceneCamera
            # one Lissajous cycle pre-rendered: read() is a list index
            cam = SceneCamera((240, 320), prerender=1260)
        elif args.camera < 0:
            cam = SyntheticCamera((240, 320))
        else:
            from ..utils.viz import _CvCapture
            cam = _CvCapture(args.camera)
        p.start_camera(cam, fps_limit=args.camera_fps)
        if args.pretrain:
            from ..models import train
            det = train.pretrained_demo_detector(steps=args.pretrain,
                                                 device=p.device)
        elif args.camera == -2 and not args.weights:
            det = pretrained_demo_detector(device=p.device)
        else:
            det = YoloDetector(
                model_path=args.weights, device=p.device,
                cfg=YoloConfig(input_size=args.detector_size,
                               width_mult=args.detector_width,
                               num_classes=args.detector_classes))
        tkw = (dict(max_age=args.track_coast, report_coasted=True)
               if args.track_coast else {})
        if not fused_comp:          # the fused stage detects and tracks
            tkw["emit_boxes"] = device_comp
            if args.tracker_batch > 1:
                p.start_tracker_batched(det, batch=args.tracker_batch,
                                        **tkw)
            else:
                p.start_tracker(det, **tkw)
            tkw.pop("emit_boxes")
        cam_hw = getattr(cam, "size", None)
        if cam_hw is None:          # a real capture: probe one frame
            ok, probe = cam.read()
            cam_hw = probe.shape[:2] if ok else (240, 320)
        grid = (p.cfg.max_res_x, p.cfg.max_res_y)
        if fused_comp or device_comp:
            from ..fusion.composite import DeviceCompositor
            compositor = DeviceCompositor(
                grid, cam_hw, window=(args.width, args.height),
                yolo_shape=cam_hw, max_tracks=8, device=p.device)
        if fused_comp:
            stage = _start_fused(args, p, compositor, det, disp, tkw,
                                 listen)
            t0 = time.time()
            deadline = t0 + max(60.0, frames_wanted * 5.0)
            while (stage.frames < frames_wanted and stage.error is None
                   and time.time() < deadline):
                time.sleep(0.1)
            elapsed = time.time() - t0
        else:
            if device_comp:
                from ..fusion.composite import DeviceViewer
                viewer = DeviceViewer(compositor, disp,
                                      batch=args.composite_batch)
                print("building the device compositor ...")
                t0 = time.time()
                viewer.warmup()
                print(f"  ready in {time.time() - t0:.1f}s")
            else:
                viewer = Viewer(
                    cb=lambda h, v: p.steer_cartesian_degree(h, v),
                    window=(args.width, args.height), display=disp)

            class Running:
                # a wall-clock deadline: if a producer thread dies the
                # queues stop filling, and the demo stops and reports
                # what it composited instead of waiting forever
                deadline = time.time() + max(60.0, frames_wanted * 5.0)

                @property
                def value(self):
                    return time.time() < self.deadline

            t0 = time.time()
            viewer.loop(p.q_power, Running(), q_viewer=p.q_viewer,
                        q_inference=p.q_inference, max_frames=frames_wanted)
            elapsed = time.time() - t0
    finally:
        p.stop()
    n = stage.frames if stage is not None else len(disp.frames)
    print(f"fused rate: {n / elapsed:.1f} fps over {n} composited frames "
          f"({elapsed:.1f}s)")
    if stage is not None:
        print("composite:", stage.report())
    elif device_comp:
        print("composite:", viewer.report())
    if args.out and disp.frames:
        import cv2
        h, w = disp.frames[0].shape[:2]
        vw = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*"mp4v"),
                             15, (w, h))
        for f in disp.frames:
            vw.write(f)
        vw.release()
        print(f"wrote {len(disp.frames)} fused frames -> {args.out}")
    print("metrics:", p.report())
    if stage is not None and stage.error is not None:
        print(f"the fused stage failed: {stage.error!r}")
        return 1
    return 0 if n >= frames_wanted else 1


def _start_fused(args, p, compositor, det, disp, tkw, listen):
    """Build, warm up and start the fused stage of ``demo sensorfusion``."""
    from .fused import FusedSensorStage

    # only the connected channel rows are uploaded (the tail rows are
    # never written), the policy of demo fullrate
    a_sink = None
    if listen:
        from ..utils import audio as audio_mod
        a_sink = audio_mod.make_sink(args.audio or "mock",
                                     p.cfg.sample_rate, args.audio_out)
    stage = FusedSensorStage(
        p.receiver, p.tables, compositor, det, p.q_yolo, disp, p.metrics,
        batch=args.composite_batch, channels=p.connected_channels,
        transfer=args.transfer, display_transport=args.display_transport,
        steer_cb=lambda h, v: p.steer_cartesian_degree(h, v),
        tracker_kwargs=tkw or None, listen=listen, audio_sink=a_sink,
        mic_batch=args.mic_batch)
    if listen:
        p._miso = stage             # steering reaches the embedded beam
    print("building the fused sensor stage ...")
    t0 = time.time()
    stage.warmup()
    print(f"  ready in {time.time() - t0:.1f}s")
    return p.run_stage(stage)


def cmd_web(args):
    from .web import serve

    serve(replay=args.replay, port=args.http_port, headless_camera=True,
          device=args.device, cfg=_preset_config(args))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zybo-rt-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("mimo", help="steered-power heatmap demo")
    _add_common(p)
    p.set_defaults(fn=cmd_mimo)

    p = sub.add_parser("miso", help="steered listening demo")
    _add_common(p)
    p.add_argument("--azimuth", type=float, default=0.0)
    p.add_argument("--elevation", type=float, default=0.0)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--audio", default=None,
                   choices=["wav", "null", "sounddevice", "auto", "mock"],
                   help="audio sink (default: auto = live playback when "
                        "interactive, wav when --headless; mock = "
                        "deadline-accounting playback stand-in)")
    p.add_argument("--out", default="miso.wav")
    p.add_argument("--fullrate", action="store_true",
                   help="gapless batched listening: every frame beamed, "
                        "sample-count-exact stream (vs the reference's "
                        "latest-frame sampling)")
    p.add_argument("--beam", default="time", choices=["time", "mvdr"],
                   help="beam backend: delay-and-sum, or mvdr (adaptive "
                        "streaming-MVDR weights, gapless batched stage)")
    p.add_argument("--batch", type=int, default=16,
                   help="frames per device launch in --fullrate mode")
    p.set_defaults(fn=cmd_miso)

    p = sub.add_parser("record", help="raw .npy capture")
    _add_common(p)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default="recording.npy")
    p.set_defaults(fn=cmd_record)

    p = sub.add_parser("emulate", help="software FPGA packet streamer")
    p.add_argument("--npy", default=None)
    p.add_argument("--freq", type=float, default=8000.0)
    p.add_argument("--arrays", type=int, default=None,
                   help="default: the config's active_arrays")
    p.add_argument("--fast", action="store_true")
    p.add_argument("--once", action="store_true")
    p.add_argument("--python", action="store_true",
                   help="the loop-for-loop Python generator (reference "
                        "parity; the native default costs a few %% of a "
                        "core at line rate)")
    p.add_argument("--port", type=int, default=None)
    p.set_defaults(fn=cmd_emulate)

    p = sub.add_parser("fullrate",
                       help="line-rate emulator -> batched beamforming of "
                            "every frame; pass = zero drops")
    _add_common(p)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--arrays", type=int, default=None,
                   help="default: the config's active_arrays")
    p.add_argument("--audio", default=None,
                   choices=["null", "wav", "mock"],
                   help="also beam every frame into this audio sink, from "
                        "the same transfer as the heatmaps (pass then also "
                        "needs 0 underrun frames)")
    p.add_argument("--audio-only", action="store_true",
                   help="with --audio: listening only, no heatmaps")
    p.add_argument("--audio-out", default="fullrate_miso.wav")
    p.add_argument("--beam", default="time", choices=["time", "mvdr"],
                   help="audio beam backend: delay-and-sum, or mvdr "
                        "(with --audio: MVDR maps and beams from one "
                        "streaming-inverse update per batch)")
    p.add_argument("--transfer", default="f32", choices=["f32", "f16"],
                   help="host->device sample dtype: f16 halves the "
                        "traffic at ~1e-3 relative error (display-grade "
                        "opt-in)")
    p.set_defaults(fn=cmd_fullrate, replay=True)

    p = sub.add_parser("sensorfusion",
                       help="camera + YOLO + heatmap fusion demo -> mp4")
    _add_common(p)
    p.add_argument("--camera", type=int, default=-1,
                   help="camera index (-1 = synthetic gradients, -2 = "
                        "detectable moving-object scene)")
    p.add_argument("--composite", default="fused",
                   choices=["fused", "device", "host"],
                   help="display-chain backend: 'fused' (default) = the "
                        "whole cycle (steered power + YOLO + composite) "
                        "as one device program with one packed upload and "
                        "one packed download a batch; 'device' = separate "
                        "batched stages with the compositor on the "
                        "device; 'host' = the reference-shaped chain "
                        "(Viewer + SensorFusionDecider)")
    p.add_argument("--composite-batch", type=int, default=16,
                   help="frames per device composite program")
    p.add_argument("--listen", default="off",
                   choices=["off", "time", "mvdr"],
                   help="--composite fused: fold gapless steered "
                        "listening into the same program (the beam rides "
                        "the packed download; the loop reads "
                        "counter-contiguous mic batches)")
    p.add_argument("--audio", default=None,
                   choices=["wav", "null", "sounddevice", "auto", "mock"],
                   help="audio sink for --listen (default mock = a "
                        "deadline-accounting playback stand-in)")
    p.add_argument("--audio-out", default="sensorfusion_miso.wav")
    p.add_argument("--mic-batch", type=int, default=0,
                   help="mic frames per fused cycle for --listen (0 = 4x "
                        "the composite batch)")
    p.add_argument("--tracker-batch", type=int, default=4,
                   help="camera frames per YOLO device program (1 = the "
                        "single-frame reference-parity loop)")
    p.add_argument("--track-coast", type=int, default=0,
                   help="report Kalman-predicted boxes for tracks missed "
                        "up to N frames (0 = reference matched-only "
                        "reporting)")
    p.add_argument("--heatmap-batch", type=int, default=16,
                   help="frames per heatmap device program, all maps "
                        "published (1 = single-frame reference loop)")
    p.add_argument("--heatmap-rate", type=float, default=100.0,
                   help="cap the batched heatmap stage at N maps/s (0 = "
                        "line rate); the display needs about twice the "
                        "viewer's fps, and an uncapped stage takes the "
                        "host's cores from the other legs")
    p.add_argument("--camera-fps", type=float, default=60.0,
                   help="camera frame-rate cap")
    p.add_argument("--pretrain", type=int, default=0,
                   help="train the demo detector N steps first (cached "
                        "in ~/.cache/zrt_demo_detector_torch.pkl, loaded "
                        "when present)")
    p.add_argument("--weights", default=None,
                   help="detector weights (.pkl of either package, or "
                        ".npz)")
    p.add_argument("--detector-classes", type=int, default=1,
                   help="detector class count")
    p.add_argument("--detector-size", type=int, default=224,
                   help="detector input size (px)")
    p.add_argument("--detector-width", type=float, default=0.5,
                   help="detector width multiplier")
    p.add_argument("--transfer", default="f32", choices=["f32", "f16"],
                   help="mic-sample upload dtype for --composite fused: "
                        "f16 halves that leg at ~1e-3 relative error "
                        "(display-grade opt-in)")
    p.add_argument("--display-transport", default="rgb",
                   choices=["rgb", "yuv420"],
                   help="video transport for --composite fused (camera "
                        "upload and composite download): rgb (default) "
                        "keeps byte-exact pixels; yuv420 halves both legs "
                        "(chroma 2x2-subsampled like the 4:2:0 mp4 the "
                        "demo writes) at the cost of the host's I420 "
                        "conversions, slower on the H100's host (PERF.md)")
    p.add_argument("--out", default="sensorfusion.mp4",
                   help="mp4 of the composited frames (needs cv2; '' = "
                        "none)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.set_defaults(fn=cmd_sensorfusion)

    p = sub.add_parser("web", help="MJPEG web app")
    _add_common(p)
    p.add_argument("--http-port", type=int, default=8000)
    p.set_defaults(fn=cmd_web)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
