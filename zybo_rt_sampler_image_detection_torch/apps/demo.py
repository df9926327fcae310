"""CLI entry point — the ``mimo`` heatmap demo and the packet emulator.

Examples::

    python -m zybo_rt_sampler_image_detection_torch.apps.demo emulate &
    python -m zybo_rt_sampler_image_detection_torch.apps.demo mimo --replay --headless --equiv-kernel --frames 20

Ported so far: ``mimo --headless`` and ``emulate`` (parity with
``PC/demo.py`` mimo and ``udp/streamer.c``).  The cv2 viewer, ``miso``,
``record``, ``fullrate``, ``sensorfusion`` and ``web`` are later slices.
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


def _make_pipeline(args):
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

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
