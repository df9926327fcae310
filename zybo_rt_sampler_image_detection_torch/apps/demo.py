"""CLI entry point — the ``mimo`` heatmap demo, the full-rate proof and
the packet emulator.

Examples::

    python -m zybo_rt_sampler_image_detection_torch.apps.demo emulate &
    python -m zybo_rt_sampler_image_detection_torch.apps.demo mimo --replay --headless --equiv-kernel --frames 20
    python -m zybo_rt_sampler_image_detection_torch.apps.demo fullrate --seconds 10
    python -m zybo_rt_sampler_image_detection_torch.apps.demo fullrate --device cpu --preset tiny --seconds 3

Ported so far: ``mimo --headless``, ``fullrate`` (heatmaps only) and
``emulate`` (parity with ``PC/demo.py`` mimo and ``udp/streamer.c``).  The
cv2 viewer, ``miso``, ``fullrate --audio``, ``record``, ``sensorfusion``
and ``web`` are later slices.
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


def _make_pipeline(args, ring_frames: int = 64):
    from .pipeline import Pipeline

    cfg = {"default": Config, "reference": Config.reference,
           "fft": Config.fft_reference,
           "tiny": Config.tiny}[args.preset]()
    if args.port:
        cfg = cfg.replace(udp_port=args.port)
    if args.algorithm in ("fft", "mvdr"):
        raise SystemExit(f"--algorithm {args.algorithm} is not yet ported "
                         f"(ROADMAP queue 1, item 10)")
    return Pipeline(cfg, algorithm=args.algorithm, replay_mode=args.replay,
                    backend=args.backend, device=args.device,
                    ring_frames=ring_frames,
                    power_backend=("equiv_kernel" if args.equiv_kernel
                                   else "freq_equiv" if args.equiv
                                   else "auto"))


def cmd_mimo(args):
    """Heatmap demo (``main.pyx:669-736``), headless: stats per heatmap."""
    if not args.headless:
        raise SystemExit("the cv2 viewer is not yet ported (ROADMAP queue 1, "
                         "item 8); pass --headless")
    p = _make_pipeline(args)
    try:
        p.connect()
        p.start_heatmap()
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
    gaps == 0 for the whole run.  The device program is built before the
    first packet flows, and only the connected channel rows are sent to
    the device (the tail rows are never written)."""
    if args.audio:
        raise SystemExit("fullrate --audio (the listening stages) is not "
                         "yet ported (ROADMAP queue 1, item 9)")
    from ..ingest.streamer import NativeStreamer

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
    stage = p.make_heatmap_batched(batch=args.batch,
                                   sink=lambda powers, first_seq: None,
                                   channels=n_ch, transfer=args.transfer)
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
            print(f"  t={time.time()-t0:5.1f}s processed={stage.processed} "
                  f"({rate:.1f}/s) skipped={stage.skipped} "
                  f"ingest_gaps={p.receiver.native_stats.gaps}")
    finally:
        sent = emu.stop()
        elapsed = time.time() - t0
        p.stop()
    rep = p.report()
    ok = stage.skipped == 0 and p.receiver.native_stats.gaps == 0
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


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zybo-rt-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("mimo", help="steered-power heatmap demo")
    _add_common(p)
    p.set_defaults(fn=cmd_mimo)

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
                   help="the listening stage (not yet ported)")
    p.add_argument("--transfer", default="f32", choices=["f32", "f16"],
                   help="host->device sample dtype: f16 halves the "
                        "traffic at ~1e-3 relative error (display-grade "
                        "opt-in)")
    p.set_defaults(fn=cmd_fullrate, replay=True)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
