"""A PNG writer for the decoder's tests: any colour type and bit depth
from integer samples, each row filter, Adam7-interlaced on request
(each pass filtered on its own). Test data only; data/png.py's
encode_png_rows writes the plain files it builds on."""

import struct
import zlib

import numpy as np

from yolo_tpu_torch.data.png import (_ADAM7, SIGNATURE, _chunk,
                                     encode_png_rows)


def pack(pix, depth):
    """(H, W, samples) integer samples -> (H, stride) PNG row bytes."""
    h = pix.shape[0]
    if depth == 16:
        return np.stack([pix >> 8, pix & 255], -1).reshape(h, -1).astype(
            np.uint8)
    if depth == 8:
        return pix.reshape(h, -1).astype(np.uint8)
    vals = pix.reshape(h, -1)
    n = vals.shape[1]
    bits = np.zeros((h, (n * depth + 7) // 8 * 8), np.uint8)
    for k in range(depth):
        bits[:, np.arange(n) * depth + k] = (vals >> (depth - 1 - k)) & 1
    return np.packbits(bits, axis=1)


def filtered(png):
    """The inflated (filter byte + row) data of a PNG's IDAT chunks."""
    pos, data = 8, b""
    while pos < len(png):
        n, kind = struct.unpack(">I4s", png[pos:pos + 8])
        if kind == b"IDAT":
            data += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    return zlib.decompress(data)


def write_png(pix, depth, color, filters=(0,), palette=None, chunks=(),
              interlace=False):
    """A PNG of (H, W, samples) samples, Adam7-interlaced on request:
    each pass filtered on its own (encode_png_rows), the passes' rows
    concatenated."""
    h, w, _ = pix.shape
    plain = encode_png_rows(pack(pix, depth), w, depth, color, filters,
                            palette, chunks)
    if not interlace:
        return plain
    raw = b""
    for x0, y0, dx, dy in _ADAM7:
        sub = pix[y0::dy, x0::dx]
        if sub.size:
            raw += filtered(encode_png_rows(pack(sub, depth), sub.shape[1],
                                             depth, color, filters, palette))
    ihdr = bytearray(plain[16:29])
    ihdr[12] = 1
    out, pos = SIGNATURE + _chunk(b"IHDR", bytes(ihdr)), 33
    while pos < len(plain):
        n, kind = struct.unpack(">I4s", plain[pos:pos + 8])
        out += (_chunk(b"IDAT", zlib.compress(raw)) if kind == b"IDAT"
                else plain[pos:pos + 12 + n])
        pos += 12 + n
    return out
