"""FPGA protocol v2: packet (de)serialization, mic reordering, pcap I/O.

Wire format (one UDP datagram per time sample, ``PC/src/receiver.h:51-59``)::

    struct msg {
        u16 frequency; i8 n_arrays; i8 protocol_ver; i32 counter;
        i32 stream[N_MICROPHONES];
    }                      // little-endian, natural alignment => 8-byte header

A frame is ``n_samples`` consecutive datagrams; samples are int32 and
normalized to float by ``/ 2**24`` (``receiver.c:132``, NORM_FACTOR).

Mic reordering: the boards daisy-chain rows in serpentine order.  The
reference un-serpentines with ``stream[row + COLUMNS - x]`` for odd rows
(``receiver.c:122-145``) — note this reads offsets ``row+8 .. row+1``, one
past the row (an off-by-one; a faithful reversal would be
``row + COLUMNS-1 - x``).  Captures recorded by the reference reflect that
behaviour, so :func:`serpentine_permutation` reproduces it verbatim by
default (``exact_reference=True``, clamping the one out-of-bounds index the
C reads as struct garbage) and offers the corrected variant.
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional, Tuple

import numpy as np

from ..config import Config

HEADER_STRUCT = struct.Struct("<HbbI")       # frequency, n_arrays, ver, counter
HEADER_SIZE = HEADER_STRUCT.size             # 8 bytes


def packet_size(cfg: Config) -> int:
    return HEADER_SIZE + 4 * cfg.n_microphones


def serpentine_permutation(cfg: Config, n_arrays: int,
                           exact_reference: bool = True) -> np.ndarray:
    """perm[s] = index into ``stream`` for logical mic ``s``.

    Logical mic order is (array, row, col) with ascending col — the layout
    every downstream table assumes.
    """
    perm = np.zeros(n_arrays * cfg.rows * cfg.columns, dtype=np.int64)
    s = 0
    for n in range(n_arrays):
        for y in range(cfg.rows):
            row = n * cfg.rows * cfg.columns + y * cfg.columns
            for x in range(cfg.columns):
                if y % 2 == 0:
                    idx = row + x
                elif exact_reference:
                    idx = row + cfg.columns - x      # receiver.c:140 verbatim
                else:
                    idx = row + cfg.columns - 1 - x
                perm[s] = min(idx, cfg.n_microphones - 1)
                s += 1
    return perm


def pack_packet(cfg: Config, samples_i32: np.ndarray, counter: int,
                n_arrays: int, frequency: int = 0,
                protocol_ver: Optional[int] = None) -> bytes:
    """One protocol-v2 datagram from raw int32 channel values (the packet
    generator — capability parity with ``udp/streamer.c``, upgraded to v2)."""
    if protocol_ver is None:
        protocol_ver = cfg.fpga_protocol_version
    body = np.zeros(cfg.n_microphones, dtype="<i4")
    body[: samples_i32.shape[0]] = samples_i32
    return HEADER_STRUCT.pack(frequency, n_arrays, protocol_ver,
                              counter & 0xFFFFFFFF) + body.tobytes()


def header_packet(cfg: Config, n_arrays: int, next_counter: int = 0) -> bytes:
    """A dedicated bring-up packet: the receiver consumes the first datagram
    for n_arrays/protocol discovery (``receiver.c:224-239``), so emulators
    prepend this to keep frame boundaries aligned.  Its counter is
    ``next_counter - 1`` so gap accounting stays continuous."""
    return pack_packet(cfg, np.zeros(0, "<i4"),
                       (next_counter - 1) & 0xFFFFFFFF, n_arrays)


def unpack_header(data: bytes) -> Tuple[int, int, int, int]:
    """(frequency, n_arrays, protocol_ver, counter)."""
    return HEADER_STRUCT.unpack_from(data, 0)


def unpack_stream(cfg: Config, data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype="<i4", count=cfg.n_microphones,
                         offset=HEADER_SIZE)


def frame_to_packets(cfg: Config, frame: np.ndarray, n_arrays: int,
                     start_counter: int = 0,
                     exact_reference: bool = True) -> Iterator[bytes]:
    """Inverse of ingest: float frame (n_mics, n_samples) -> datagrams whose
    reception through the serpentine reorder reproduces ``frame`` exactly.

    Channels beyond ``n_arrays * rows * columns`` are ignored (the FPGA only
    streams connected boards).
    """
    n_ch = n_arrays * cfg.rows * cfg.columns
    perm = serpentine_permutation(cfg, n_arrays, exact_reference)
    raw = np.round(frame[:n_ch] * cfg.norm_factor).astype(np.int64)
    raw = np.clip(raw, -2**31, 2**31 - 1).astype("<i4")
    for step in range(frame.shape[1]):
        stream = np.zeros(cfg.n_microphones, dtype="<i4")
        # stream[perm[s]] = sample of logical mic s; the exact-reference perm
        # can collide on clamped indices — last writer wins, like the C read.
        stream[perm] = raw[:, step]
        yield pack_packet(cfg, stream, start_counter + step, n_arrays)


def packets_to_frame(cfg: Config, packets, n_arrays: int,
                     exact_reference: bool = True) -> np.ndarray:
    """Reference ingest semantics (``receiver.c:94-151``): datagrams ->
    (n_mics_total, n_samples) float32, serpentine-reordered and normalized."""
    perm = serpentine_permutation(cfg, n_arrays, exact_reference)
    n_ch = perm.shape[0]
    frame = np.zeros((cfg.n_microphones, cfg.n_samples), dtype=np.float32)
    for step, pkt in enumerate(packets):
        if step >= cfg.n_samples:
            break
        stream = unpack_stream(cfg, pkt)
        frame[:n_ch, step] = (stream[perm].astype(np.float64)
                              / cfg.norm_factor).astype(np.float32)
    return frame


# ---------------------------------------------------------------------------
# pcap I/O (capability parity with the tshark capture / udpreplay flow,
# ``PC/src/main.pyx:602-612,664-666,772-791``) — classic pcap format,
# linktype 1 (Ethernet), synthetic Eth/IPv4/UDP encapsulation.
# ---------------------------------------------------------------------------

_PCAP_GLOBAL = struct.Struct("<IHHiIII")
_PCAP_REC = struct.Struct("<IIII")
_MAGIC = 0xA1B2C3D4


def write_pcap(path: str, payloads, timestamps=None, sport: int = 40000,
               dport: int = 21844) -> None:
    """Write UDP payloads as a pcap file readable by tcpdump/udpreplay."""
    with open(path, "wb") as f:
        f.write(_PCAP_GLOBAL.pack(_MAGIC, 2, 4, 0, 0, 65535, 1))
        for i, payload in enumerate(payloads):
            ts = timestamps[i] if timestamps is not None else float(i) * 1e-4
            sec, usec = int(ts), int((ts % 1) * 1e6)
            udp_len = 8 + len(payload)
            ip_len = 20 + udp_len
            eth = b"\x02" * 6 + b"\x02" * 6 + b"\x08\x00"
            ip = struct.pack(
                ">BBHHHBBH4s4s", 0x45, 0, ip_len, i & 0xFFFF, 0, 64, 17, 0,
                bytes([127, 0, 0, 1]), bytes([127, 0, 0, 1]))
            udp = struct.pack(">HHHH", sport, dport, udp_len, 0)
            pkt = eth + ip + udp + payload
            f.write(_PCAP_REC.pack(sec, usec, len(pkt), len(pkt)))
            f.write(pkt)


def read_pcap(path: str):
    """Yield (timestamp, udp_payload) for every UDP packet in a pcap file."""
    with open(path, "rb") as f:
        head = f.read(_PCAP_GLOBAL.size)
        magic = struct.unpack("<I", head[:4])[0]
        if magic == _MAGIC:
            endian = "<"
        elif magic == 0xD4C3B2A1:
            endian = ">"
        else:
            raise ValueError("not a classic pcap file")
        rec = struct.Struct(endian + "IIII")
        while True:
            rh = f.read(rec.size)
            if len(rh) < rec.size:
                return
            sec, usec, incl, _orig = rec.unpack(rh)
            pkt = f.read(incl)
            if len(pkt) < incl:
                return
            # Ethernet(14) + IPv4(ihl) + UDP(8)
            if len(pkt) < 42 or pkt[12:14] != b"\x08\x00":
                continue
            ihl = (pkt[14] & 0x0F) * 4
            if pkt[14 + 9] != 17:                    # not UDP
                continue
            off = 14 + ihl + 8
            yield sec + usec * 1e-6, pkt[off:]
