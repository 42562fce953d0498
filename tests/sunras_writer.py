"""A Sun raster writer for the decoder tests: every header and pixel kind
that OpenCV's grfmt_sunras.cpp is handed, from numpy arrays, including
what cv2's own encoder never writes (1-bit rows, colour maps, 32-bit
pixels, the old, byte-encoded and RGB types).

write_sunras(pixels, depth, ...): pixels is (h, w) values for depth 1
or 8 (bits, palette indices or gray levels), else (h, w, 3 | 4) bytes in
the order they are stored (depth 24 / 32), row 0 the top row. Rows are
padded to an even number of bytes; ``rle`` stores the rows with the
type's 0x80 escapes (``0x80 0x00`` a literal 0x80, ``0x80 n v`` n + 1
copies of v).
"""

import struct

import numpy as np

MAGIC = b"\x59\xa6\x6a\x95"
RT_OLD, RT_STANDARD, RT_BYTE_ENCODED, RT_FORMAT_RGB = 0, 1, 2, 3
RMT_NONE, RMT_EQUAL_RGB = 0, 1


def rows(pixels, depth):
    """The raw rows, top first, each padded to an even length."""
    h, w = pixels.shape[:2]
    pitch = (((w * depth + 7) // 8) + 1) & ~1
    out = bytearray()
    for y in range(h):
        if depth == 1:
            row = np.packbits(np.asarray(pixels[y], np.uint8) & 1).tobytes()
        else:
            row = np.ascontiguousarray(pixels[y], np.uint8).tobytes()
        out += row + bytes(pitch - len(row))
    return bytes(out)


def rle_encode(data: bytes, min_run: int = 3) -> bytes:
    """The byte-encoded stream of data: runs of min_run or more equal
    bytes as ``0x80 n v`` (at most 256 a run), a lone 0x80 as ``0x80
    0x00``, other bytes as they are."""
    out, i = bytearray(), 0
    while i < len(data):
        v, n = data[i], 1
        while i + n < len(data) and data[i + n] == v and n < 256:
            n += 1
        if n >= min_run or (v == 0x80 and n >= 2):
            out += bytes([0x80, n - 1, v])
            i += n
        elif v == 0x80:
            out += b"\x80\x00"
            i += 1
        else:
            out.append(v)
            i += 1
    return bytes(out)


def write_sunras(pixels, depth, typ=RT_STANDARD, colormap=None,
                 length=None, rle=None) -> bytes:
    """A Sun raster file; colormap: (n, 3) RGB entries (written as the
    format's planes of R, then G, then B); length: the header's data
    length (the raw size by default, 0 for RT_OLD); rle: the stored
    data (rle_encode of the raw rows by default for RT_BYTE_ENCODED)."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    raw = rows(pixels, depth)
    if rle is None and typ == RT_BYTE_ENCODED:
        rle = rle_encode(raw)
    data = raw if rle is None else rle
    cmap = b""
    if colormap is not None:
        cmap = np.ascontiguousarray(np.asarray(colormap, np.uint8).T).tobytes()
    if length is None:
        length = 0 if typ == RT_OLD else len(data)
    head = MAGIC + struct.pack(">7I", w, h, depth, length, typ,
                               RMT_EQUAL_RGB if cmap else RMT_NONE, len(cmap))
    return head + cmap + data
