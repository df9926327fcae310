"""Recording / replay artifacts.

Capability parity with the reference's capture tooling:

* raw ``.npy`` audio capture, (n_mics, T) float32 — ``PC/record.py:28-46``;
* UDP packet capture to pcap (+ optional per-packet timestamp CSV) —
  ``main.pyx:602-612,772-791`` (tshark flow, here self-contained);
* video capture to mp4 via cv2 when available — ``main.pyx:618-633``;
* replay comes from ``ingest.streamer`` (udpreplay flow).

A copy of the JAX package's module on the port's ``config`` and
``ingest.protocol``; nothing here touches the device.
"""

from __future__ import annotations

import csv
import socket
import time
import warnings
from typing import Optional

import numpy as np

from ..config import Config
from ..ingest import protocol


def get_recording(receiver, seconds: float,
                  on_skip: str = "zero") -> np.ndarray:
    """Capture ``seconds`` of contiguous frames from a connected
    :class:`~..ingest.receiver.Receiver` -> (n_mics, T) float32
    (``record.py:28-46``).

    The latest-frame buffer only holds the newest frame, so a stalled
    consumer (GC, disk, jit) can miss frames.  Skips are detected from the
    sequence counter; ``on_skip`` picks the policy: ``"zero"`` inserts zero
    frames to keep the timeline contiguous (and warns), ``"raise"`` raises,
    ``"ignore"`` concatenates whatever arrived (the reference behaviour).
    """
    cfg = receiver.cfg
    n_frames = int(np.ceil(seconds * cfg.sample_rate / cfg.n_samples))
    chunks = []
    seq = None
    skipped = 0
    while len(chunks) < n_frames:
        frame, new_seq = receiver.read_frame(
            fresh=True, last_seq=0 if seq is None else seq, timeout=10.0)
        if seq is not None and new_seq > seq + 1:
            n_skip = new_seq - seq - 1
            skipped += n_skip
            if on_skip == "raise":
                raise RuntimeError(
                    f"recording not contiguous: consumer missed {n_skip} "
                    f"frame(s) between seq {seq} and {new_seq}")
            if on_skip == "zero":
                for _ in range(min(n_skip, n_frames - len(chunks))):
                    chunks.append(np.zeros_like(frame))
        seq = new_seq
        if len(chunks) < n_frames:
            chunks.append(frame)
    if skipped and on_skip == "zero":
        warnings.warn(
            f"get_recording: consumer missed {skipped} frame(s); "
            "zero frames inserted to keep the capture contiguous",
            RuntimeWarning, stacklevel=2)
    return np.concatenate(chunks, axis=1)


def record_npy(receiver, seconds: float, path: str) -> str:
    np.save(path, get_recording(receiver, seconds))
    return path


def record_udp_to_pcap(cfg: Config, seconds: float, path: str,
                       timestamps_csv: Optional[str] = None,
                       ip: Optional[str] = None) -> int:
    """Capture raw protocol datagrams off the wire into a pcap (+ timestamp
    CSV), like ``record_udp`` (``main.pyx:772-791``).  Binds the ingest
    port itself — use on a port no receiver currently owns."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind((ip or cfg.udp_replay_ip, cfg.udp_port))
    sock.settimeout(0.5)
    psize = protocol.packet_size(cfg)
    payloads, stamps = [], []
    deadline = time.time() + seconds
    while time.time() < deadline:
        try:
            data = sock.recv(psize)
        except socket.timeout:
            continue
        if len(data) < psize:
            # stray/short datagram (port scan, misconfigured sender):
            # recording it would crash unpack_header AFTER the capture
            # completes, losing the timestamp CSV (the receiver loop has
            # the same guard)
            continue
        payloads.append(data)
        stamps.append(time.time())
    sock.close()
    protocol.write_pcap(path, payloads, stamps)
    if timestamps_csv:
        with open(timestamps_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["index", "timestamp", "counter"])
            for i, (ts, p) in enumerate(zip(stamps, payloads)):
                w.writerow([i, f"{ts:.6f}", protocol.unpack_header(p)[3]])
    return len(payloads)


def record_webcam(path: str, seconds: float, src=0,
                  size=(640, 480), fps: float = 30.0) -> int:
    """mp4 webcam capture (``record_webcam``, ``main.pyx:618-633``);
    requires cv2 + a camera device."""
    import cv2

    cap = cv2.VideoCapture(src)
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    out = cv2.VideoWriter(path, fourcc, fps, size)
    n = 0
    deadline = time.time() + seconds
    while time.time() < deadline:
        ok, frame = cap.read()
        if not ok:
            break
        out.write(cv2.resize(frame, size))
        n += 1
    cap.release()
    out.release()
    return n
