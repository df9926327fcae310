"""Build + ctypes binding for the native C++ ingest engine.

Compiled on first use with g++ (no pybind11 in the image; plain C ABI via
ctypes).  The shared object is cached under ``build/native`` beside the
package (override with ``ZRT_TORCH_NATIVE_DIR``; git ignores ``build/``)
and rebuilt when the source changes.  A directory of its own keeps the
port's engine a separate library instance from the JAX package's.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "native", "ingest.cpp")
_LOCK = threading.Lock()
_CACHED = None


def _so_path() -> str:
    # the cache dir is shared across checkouts/worktrees, so the binary
    # must be keyed by source CONTENT — an mtime check would let a
    # checkout with an older-mtime but different ingest.cpp silently
    # load another checkout's incompatible binary
    import hashlib

    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    cdir = os.environ.get(
        "ZRT_TORCH_NATIVE_DIR",
        os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                     "native"))
    return os.path.join(cdir, f"libzrtingest-{digest}.so")


def build(force: bool = False) -> str:
    so = _so_path()
    with _LOCK:
        if not force and os.path.exists(so):
            return so
        os.makedirs(os.path.dirname(so), exist_ok=True)
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
               _SRC, "-o", so]
        subprocess.run(cmd, check=True, capture_output=True)
        return so


class NativeIngest:
    """Thin stateful wrapper over the C ABI (one engine per process)."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.zrt_ingest_connect.restype = ctypes.c_int
        lib.zrt_ingest_connect.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_int]
        lib.zrt_ingest_read.restype = ctypes.c_longlong
        lib.zrt_ingest_read.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int]
        lib.zrt_ingest_read_batch.restype = ctypes.c_longlong
        lib.zrt_ingest_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double)]
        lib.zrt_ingest_stats.argtypes = [ctypes.POINTER(ctypes.c_longlong)] * 4
        lib.zrt_emulate_start.restype = ctypes.c_int
        lib.zrt_emulate_start.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong, ctypes.c_double]
        lib.zrt_emulate_sent.restype = ctypes.c_longlong
        self._cfg = None
        # idempotent teardown BEFORE CPython static destruction: a
        # process exiting with the receive thread alive (crash paths
        # that skip pipeline.stop()) hits the C++ "terminate called
        # without an active exception" in the std::thread destructor
        import atexit
        atexit.register(self.disconnect)
        atexit.register(self._lib.zrt_emulate_stop)

    def connect(self, cfg, ip: str, timeout: float,
                exact_reference: bool, ring_frames: int = 64) -> int:
        self._cfg = cfg
        rc = self._lib.zrt_ingest_connect(
            ip.encode(), cfg.udp_port, cfg.n_microphones, cfg.n_samples,
            cfg.rows, cfg.columns, cfg.norm_factor,
            cfg.fpga_protocol_version, int(exact_reference), float(timeout),
            int(ring_frames))
        if rc == -4:
            raise ConnectionError("wrong FPGA protocol version")
        if rc == -5:
            cap = cfg.n_microphones // (cfg.rows * cfg.columns)
            raise ConnectionError(
                f"header array count exceeds this config's capacity "
                f"({cap} array(s) of {cfg.rows}x{cfg.columns} in "
                f"{cfg.n_microphones} mics)")
        if rc < 0:
            raise ConnectionError(f"native ingest connect failed ({rc})")
        return rc

    def read_frame(self, fresh: bool, last_seq: int,
                   timeout: Optional[float]):
        cfg = self._cfg
        out = np.empty((cfg.n_microphones, cfg.n_samples), np.float32)
        # match the python backend: None blocks (effectively) forever,
        # 0 is a non-blocking poll
        ms = int((86400.0 if timeout is None else timeout) * 1000)
        seq = self._lib.zrt_ingest_read(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(fresh), last_seq, ms)
        if seq < 0:
            raise TimeoutError("no fresh frame within timeout")
        return out, int(seq)

    def read_batch(self, k: int, next_seq: int, timeout: Optional[float],
                   channels: int = 0, with_stamps: bool = False):
        """k counter-contiguous frames, oldest first ->
        ((k, channels or n_mics, n_samples) float32, first_seq, skipped
        [, stamps (k,) float64]).  ``channels`` > 0 copies only the
        leading connected rows; ``with_stamps`` appends each frame's
        CLOCK_MONOTONIC publish time (== time.perf_counter)."""
        cfg = self._cfg
        n_ch = channels if 0 < channels <= cfg.n_microphones \
            else cfg.n_microphones
        out = np.empty((k, n_ch, cfg.n_samples), np.float32)
        skipped = ctypes.c_longlong(0)
        stamps = np.zeros(k, np.float64) if with_stamps else None
        sp = (stamps.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
              if with_stamps else
              ctypes.cast(None, ctypes.POINTER(ctypes.c_double)))
        # match the python backend: None blocks (effectively) forever,
        # 0 is a non-blocking poll
        ms = int((86400.0 if timeout is None else timeout) * 1000)
        first = self._lib.zrt_ingest_read_batch(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(k), int(next_seq), ms, ctypes.byref(skipped), n_ch, sp)
        if first == -2:
            raise ValueError("batch size exceeds the ring capacity")
        if first < 0:
            raise TimeoutError("no frame batch within timeout")
        if with_stamps:
            return out, int(first), int(skipped.value), stamps
        return out, int(first), int(skipped.value)

    # -- native packet emulator (streamer.c parity at true line rate) -------

    def emulate_start(self, cfg, signal: np.ndarray, rate: Optional[float],
                      n_arrays: int, ip: str, port: int,
                      exact_reference: bool = True) -> None:
        sig = np.ascontiguousarray(signal, dtype=np.float32)
        self._emulate_sig = sig        # keep alive: C thread reads it once
        rc = self._lib.zrt_emulate_start(
            ip.encode(), int(port), cfg.n_microphones, cfg.rows,
            cfg.columns, int(n_arrays), cfg.fpga_protocol_version,
            int(exact_reference), float(rate or 0.0),
            sig.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            sig.shape[1], cfg.norm_factor)
        if rc != 0:
            raise OSError(f"native emulator failed to start ({rc})")

    def emulate_stop(self) -> int:
        sent = int(self._lib.zrt_emulate_sent())
        self._lib.zrt_emulate_stop()
        return sent

    def emulate_sent(self) -> int:
        return int(self._lib.zrt_emulate_sent())

    def stats(self):
        vals = [ctypes.c_longlong() for _ in range(4)]
        self._lib.zrt_ingest_stats(*[ctypes.byref(v) for v in vals])
        from .receiver import IngestStats
        return IngestStats(packets=vals[0].value, frames=vals[1].value,
                           gaps=vals[2].value, bad_protocol=vals[3].value)

    def disconnect(self) -> None:
        self._lib.zrt_ingest_disconnect()


def load() -> NativeIngest:
    global _CACHED
    if _CACHED is None:
        so = build()
        _CACHED = NativeIngest(ctypes.CDLL(so))
    return _CACHED
