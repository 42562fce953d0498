"""PNG decoding with the standard library's zlib and numpy, for hosts
without OpenCV: 8-bit gray and RGB images, not interlaced, all five row
filters (PNG specification, section 9). cv2.imread gives the same bytes
for these files (tests/test_torch_data.py). encode_png writes such files
(synthetic datasets, tests)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}   # color type -> channels: gray, RGB


def _unfilter_sequential(ft: int, line: bytearray, prior: bytes,
                         bpp: int) -> None:
    """Average (3) and Paeth (4) rows, in place: each byte depends on the
    reconstructed byte bpp to its left."""
    for x in range(len(line)):
        a = line[x - bpp] if x >= bpp else 0
        b = prior[x]
        if ft == 3:
            line[x] = (line[x] + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[x] = (line[x] + pred) & 0xFF


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C = 1 (gray) or 3 (RGB). Raises
    ValueError for any other kind of PNG."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("PNG truncated mid-chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(
            f"PNG bit depth {depth}, color type {color}, interlace "
            f"{interlace}: only 8-bit gray or RGB, not interlaced, decodes "
            f"without OpenCV")
    c = _CHANNELS[color]
    stride = w * c
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            rec = line
        elif ft == 1:
            rec = np.cumsum(line.reshape(w, c), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ft == 2:
            rec = line + prior
        elif ft in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_sequential(ft, buf, prior.tobytes(), c)
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ft}")
        out[y] = rec
        prior = out[y]
    return out.reshape(h, w, c)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img, filters=(0,)) -> bytes:
    """(H, W), (H, W, 1) or (H, W, 3) uint8 -> 8-bit gray or RGB PNG
    bytes; row y takes filters[y % len(filters)] (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth), each computed from the raw rows."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3):
        raise ValueError(f"encode_png: {c} channels, want 1 or 3")
    cur = img.reshape(h, w * c).astype(np.int64)
    up = np.concatenate([np.zeros((1, w * c), np.int64), cur[:-1]])
    left = np.concatenate([np.zeros((h, c), np.int64), cur[:, :-c]], 1)
    ul = np.concatenate([np.zeros((h, c), np.int64), up[:, :-c]], 1)
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    pred = np.stack([np.zeros_like(cur), left, up, (left + up) // 2, paeth])
    kind = np.asarray(filters, np.int64)[np.arange(h) % len(filters)]
    body = (cur - pred[kind, np.arange(h)]) % 256
    raw = np.concatenate([kind[:, None], body], 1).astype(np.uint8)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                          2 if c == 3 else 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
