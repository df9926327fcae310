"""Packet generator / replayer — the software FPGA emulator.

Capability parity with the reference's test fixtures: the fake packet
streamer ``udp/streamer.c:20-112`` (upgraded from its v1/TCP protocol to
the real v2/UDP one), replay mode via ``udpreplay`` on loopback
(``main.pyx:664-666,709-710``), and the pcap capture flow
(``main.pyx:602-612``).

Sources: synthetic signals, ``.npy`` recordings (``record.py`` format:
(n_mics, T) float32), or pcap files.

Pacing conventions (they DIFFER between the two streamers — callers
swapping one for the other must map the rate argument):

* ``Streamer`` (Python): ``rate=None`` (the default) sends UNPACED, as
  fast as the socket accepts — the right default for test fixtures;
  pass ``rate=cfg.sample_rate`` for real-time pacing.
* ``NativeStreamer`` (C++ line-rate emulator): ``rate=None`` paces at
  the config sample rate (its whole point is true line rate); ``rate=0``
  is unpaced.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Iterable, Optional

import numpy as np

from ..config import Config
from . import protocol


class Streamer:
    def __init__(self, cfg: Config, n_arrays: Optional[int] = None,
                 ip: Optional[str] = None, port: Optional[int] = None,
                 exact_reference: bool = True):
        self.cfg = cfg
        self.n_arrays = n_arrays if n_arrays is not None else cfg.active_arrays
        self.ip = ip or cfg.udp_replay_ip
        self.port = port or cfg.udp_port
        self.exact_reference = exact_reference
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._counter = 0
        self._next = None          # pacing clock, persists across frames

    def send_header(self) -> None:
        """Bring-up packet consumed by ``connect()`` for n_arrays/protocol
        discovery; keeps subsequent frame boundaries aligned."""
        self._sock.sendto(
            protocol.header_packet(self.cfg, self.n_arrays, self._counter),
            (self.ip, self.port))

    def send_frame(self, frame: np.ndarray,
                   rate: Optional[float] = None) -> None:
        """Send one (n_mics, n_samples) frame as n_samples datagrams.

        Pacing keeps one continuous clock across frames (re-anchored after
        a >0.25 s pause) so long runs hit the exact line rate instead of
        losing the sleep-granularity deficit at every frame boundary."""
        interval = (1.0 / rate) if rate else 0.0
        if interval:
            now = time.perf_counter()
            if self._next is None or now - self._next > 0.25:
                self._next = now
        for pkt in protocol.frame_to_packets(
                self.cfg, frame, self.n_arrays, self._counter,
                self.exact_reference):
            self._sock.sendto(pkt, (self.ip, self.port))
            self._counter += 1
            if interval:
                self._next += interval
                delay = self._next - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)

    def send_signal(self, signal: np.ndarray,
                    rate: Optional[float] = None) -> int:
        """Stream a long (n_mics, T) capture frame by frame; returns the
        number of complete frames sent."""
        cfg = self.cfg
        n_frames = signal.shape[1] // cfg.n_samples
        for i in range(n_frames):
            self.send_frame(
                signal[:, i * cfg.n_samples:(i + 1) * cfg.n_samples], rate)
        return n_frames

    def send_npy(self, path: str, rate: Optional[float] = None) -> int:
        return self.send_signal(np.load(path).astype(np.float32), rate)

    def send_pcap(self, path: str, realtime: bool = False) -> int:
        """Replay raw datagrams from a pcap (the ``udpreplay`` flow)."""
        n = 0
        prev_ts = None
        for ts, payload in protocol.read_pcap(path):
            if realtime and prev_ts is not None and ts > prev_ts:
                time.sleep(min(ts - prev_ts, 0.1))
            prev_ts = ts
            self._sock.sendto(payload, (self.ip, self.port))
            n += 1
        return n

    def close(self) -> None:
        self._sock.close()


class NativeStreamer:
    """C++ packet emulator (``ingest/native/ingest.cpp`` emulate_*):
    prebuilds one signal cycle of datagrams and streams them at the exact
    line rate from a native thread — a few percent of a core, vs ~93% for
    the Python generator at 48,828 pkt/s.  Required on this 1-core host to
    emulate the FPGA while the same machine ingests and feeds the GPU.

    One emulator per process (engine singleton, like the receiver)."""

    def __init__(self, cfg: Config, n_arrays: Optional[int] = None,
                 ip: Optional[str] = None, port: Optional[int] = None,
                 exact_reference: bool = True):
        from . import native_build
        self.cfg = cfg
        self.n_arrays = (n_arrays if n_arrays is not None
                         else cfg.active_arrays)
        self.ip = ip or cfg.udp_replay_ip
        self.port = port or cfg.udp_port
        self.exact_reference = exact_reference
        self._eng = native_build.load()

    def start(self, signal: np.ndarray,
              rate: Optional[float] = None) -> None:
        """Stream ``signal`` ((n_ch, T) float32) cyclically at ``rate``
        packets/s (None = the config sample rate; 0 = unpaced) until
        :meth:`stop`.  A header packet precedes the stream."""
        if rate is None:
            rate = self.cfg.sample_rate
        self._eng.emulate_start(self.cfg, signal, rate, self.n_arrays,
                                self.ip, self.port, self.exact_reference)

    def stop(self) -> int:
        """Stop streaming; returns the number of packets sent."""
        return self._eng.emulate_stop()

    @property
    def sent(self) -> int:
        return self._eng.emulate_sent()


def stream_in_background(cfg: Config, frames: Iterable[np.ndarray],
                         rate: Optional[float] = None,
                         n_arrays: Optional[int] = None,
                         delay: float = 0.05,
                         exact_reference: bool = True) -> threading.Thread:
    """Fire-and-forget emulator thread for tests/demos: streams the given
    frames to loopback after a short delay (so a receiver can bind first)."""
    def run():
        time.sleep(delay)
        s = Streamer(cfg, n_arrays=n_arrays, exact_reference=exact_reference)
        try:
            s.send_header()
            for f in frames:
                s.send_frame(f, rate)
        finally:
            s.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t
