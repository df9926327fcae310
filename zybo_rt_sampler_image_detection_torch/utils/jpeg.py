"""Baseline JPEG encoder in NumPy, for hosts with neither cv2 nor Pillow.

The MJPEG monitor (``apps/web.py``) encodes its frames with cv2 or Pillow
where one is importable; a host with neither (the card's host has no cv2
and no Pillow) takes this encoder.  It writes a baseline sequential JFIF
file: YCbCr with 4:2:0 chroma, the 8x8 DCT, the ITU-T T.81 Annex K
quantisation tables scaled by ``quality`` as libjpeg scales them, the
Annex K Huffman tables and one interleaved scan.  The entropy coder is
vectorised: every symbol's code and magnitude bits are formed as arrays,
ordered by block, and packed with ``np.packbits``.
"""

from __future__ import annotations

import numpy as np

# Annex K.1: luminance and chrominance quantisation, natural order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K.3: (code counts by length 1..16, symbols) of the DC and AC tables
_AC_LUMA_SYMS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA_SYMS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
_HUFFMAN = {
    "dc_luma": ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
                bytes(range(12))),
    "dc_chroma": ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                  bytes(range(12))),
    "ac_luma": ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
                _AC_LUMA_SYMS),
    "ac_chroma": ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
                  _AC_CHROMA_SYMS),
}


def _zigzag() -> np.ndarray:
    """Natural index of each zigzag position."""
    ij = sorted(((i, j) for i in range(8) for j in range(8)),
                key=lambda p: (p[0] + p[1],
                               p[0] if (p[0] + p[1]) % 2 else -p[0]))
    return np.array([i * 8 + j for i, j in ij])


_ZIGZAG = _zigzag()
# the orthonormal 8-point DCT-II matrix
_DCT = np.array([[np.sqrt((1 if k == 0 else 2) / 8)
                  * np.cos((2 * n + 1) * k * np.pi / 16)
                  for n in range(8)] for k in range(8)])


def _codes(counts, symbols) -> tuple:
    """Canonical Huffman (codes, lengths), each indexed by symbol."""
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_TABLES = {name: _codes(*v) for name, v in _HUFFMAN.items()}


def _scaled(q: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's quality scaling of a base table, clamped to 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((q * scale + 50) // 100, 1, 255)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 8, 8) blocks."""
    H, W = plane.shape
    return plane.reshape(H // 8, 8, W // 8, 8).swapaxes(1, 2)


def _magnitude(v: np.ndarray) -> tuple:
    """(size category, magnitude bits) of coefficients, as T.81 F.1.2."""
    a = np.abs(v)
    size = np.zeros(v.shape, np.int64)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    bits = np.where(v >= 0, v, v + (1 << size) - 1)
    return size, bits


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def encode(bgr: np.ndarray, quality: int = 90) -> bytes:
    """(H, W, 3) uint8 BGR (cv2's order) -> JPEG bytes."""
    img = np.asarray(bgr, np.float64)
    H, W = img.shape[:2]
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
    Hp, Wp = -(-H // 16) * 16, -(-W // 16) * 16
    planes = [np.pad(p, ((0, Hp - H), (0, Wp - W)), mode="edge")
              for p in planes]
    # 4:2:0: chroma as the mean of each 2x2
    planes[1:] = [p.reshape(Hp // 2, 2, Wp // 2, 2).mean(axis=(1, 3))
                  for p in planes[1:]]
    qt = [_scaled(_Q_LUMA, quality), _scaled(_Q_CHROMA, quality)]
    coefs = []
    for ci, p in enumerate(planes):
        blk = _blocks(p - 128.0)
        d = _DCT @ blk @ _DCT.T
        q = np.rint(d.reshape(*blk.shape[:2], 64) / qt[min(ci, 1)])
        coefs.append(q[..., _ZIGZAG].astype(np.int64))
    # MCU order: Y00 Y01 Y10 Y11 Cb Cr, MCUs row by row
    my, mx = Hp // 16, Wp // 16
    y = coefs[0].reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4)
    mcu = np.concatenate([y.reshape(my, mx, 4, 64),
                          coefs[1][:, :, None], coefs[2][:, :, None]],
                         axis=2).reshape(-1, 64)
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    chroma = comp > 0
    n = len(mcu)

    # DC: the difference to the same component's previous block
    dc = mcu[:, 0]
    diff = np.empty(n, np.int64)
    for c in range(3):
        sel = np.flatnonzero(comp == c)
        diff[sel] = np.diff(dc[sel], prepend=0)
    size, bits = _magnitude(diff)
    dcode = np.where(chroma, _TABLES["dc_chroma"][0][size],
                     _TABLES["dc_luma"][0][size])
    dlen = np.where(chroma, _TABLES["dc_chroma"][1][size],
                    _TABLES["dc_luma"][1][size])
    ev = [(np.arange(n) * 256, (dcode << size) | bits, dlen + size)]

    # AC: (run, size) symbols, a ZRL per 16 zeros of a run, EOB
    blk, k = np.nonzero(mcu[:, 1:])
    k = k + 1
    first = np.r_[True, blk[1:] != blk[:-1]]
    run = k - np.where(first, 0, np.r_[0, k[:-1]]) - 1
    zrl, run = run // 16, run % 16
    size, bits = _magnitude(mcu[blk, k])
    ac_c = [np.where(chroma[blk], _TABLES["ac_chroma"][i][(run << 4) | size],
                     _TABLES["ac_luma"][i][(run << 4) | size])
            for i in (0, 1)]
    ev.append((blk * 256 + 2 * k, (ac_c[0] << size) | bits, ac_c[1] + size))
    zb = np.repeat(blk, zrl)
    ev.append((np.repeat(blk * 256 + 2 * k - 1, zrl),
               np.where(chroma[zb], _TABLES["ac_chroma"][0][0xF0],
                        _TABLES["ac_luma"][0][0xF0]),
               np.where(chroma[zb], _TABLES["ac_chroma"][1][0xF0],
                        _TABLES["ac_luma"][1][0xF0])))
    last = np.zeros(n, np.int64)
    np.maximum.at(last, blk, k)
    eob = np.flatnonzero(last < 63)
    ev.append((eob * 256 + 255,
               np.where(chroma[eob], _TABLES["ac_chroma"][0][0],
                        _TABLES["ac_luma"][0][0]),
               np.where(chroma[eob], _TABLES["ac_chroma"][1][0],
                        _TABLES["ac_luma"][1][0])))
    order = np.argsort(np.concatenate([e[0] for e in ev]), kind="stable")
    codes = np.concatenate([e[1] for e in ev])[order]
    lens = np.concatenate([e[2] for e in ev])[order]

    # pack the bits, MSB first; pad the last byte with ones; stuff 0xFF
    total = int(lens.sum())
    start = np.repeat(np.cumsum(lens) - lens, lens)
    sym_len = np.repeat(lens, lens)
    shift = sym_len - 1 - (np.arange(total) - start)
    bitstream = (np.repeat(codes, lens) >> shift) & 1
    bitstream = np.r_[bitstream, np.ones(-total % 8, np.int64)]
    data = np.packbits(bitstream.astype(np.uint8))
    ff = np.flatnonzero(data == 0xFF)
    data = np.insert(data, ff + 1, 0).tobytes()

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tid, q in enumerate(qt):
        out.append(_segment(0xDB, bytes([tid])
                            + bytes(q[_ZIGZAG].astype(np.uint8))))
    out.append(_segment(0xC0, bytes([8]) + H.to_bytes(2, "big")
                        + W.to_bytes(2, "big")
                        + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls_id, name in ((0x00, "dc_luma"), (0x10, "ac_luma"),
                         (0x01, "dc_chroma"), (0x11, "ac_chroma")):
        counts, syms = _HUFFMAN[name]
        out.append(_segment(0xC4, bytes([cls_id]) + bytes(counts) + syms))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11,
                                     0, 63, 0])))
    out += [data, b"\xff\xd9"]
    return b"".join(out)
