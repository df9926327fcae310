"""Minimal UDP utilities — socket-plumbing test pair, parity with the
reference's ``udp/test_server.c`` / ``udp/test_client.c``.

A copy of ``zybo_rt_sampler_image_detection_tpu/ingest/udptools.py``
(standard library only), kept so that the port never imports the JAX
package.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional


def echo_server(host: str = "127.0.0.1", port: int = 0,
                max_packets: Optional[int] = None):
    """Start a UDP echo server thread; returns (thread, (host, port), stop).

    Mirrors ``udp/test_server.c:9-57``: receive a datagram, send it back.
    """
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind((host, port))
    sock.settimeout(0.2)
    addr = sock.getsockname()
    stop = threading.Event()

    def run():
        n = 0
        while not stop.is_set() and (max_packets is None or n < max_packets):
            try:
                data, client = sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            sock.sendto(data, client)
            n += 1
        sock.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, addr, stop.set


def echo_client(message: bytes, server=("127.0.0.1", 2000),
                timeout: float = 2.0) -> bytes:
    """Send one datagram and return the echo (``udp/test_client.c:9-37``)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(timeout)
    try:
        sock.sendto(message, server)
        data, _ = sock.recvfrom(65536)
        return data
    finally:
        sock.close()
