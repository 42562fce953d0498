"""A BMP writer for the decoder tests: every header and pixel kind that
OpenCV's grfmt_bmp.cpp reads, from numpy arrays, including what cv2's
own encoder never writes (palettes of 1, 2..256 entries, RLE4 and RLE8
streams with their escapes, BI_BITFIELDS, BITMAPCOREHEADER, V4 and V5
headers, top-down rows).

write_bmp(pixels, bpp, ...): pixels is (h, w) palette indices for
bpp <= 8, else (h, w) 16-bit values (bpp 16) or (h, w, 3 | 4) BGR(A)
bytes (bpp 24 / 32), row 0 the top row.
"""

import struct

import numpy as np

HEADER_SIZES = {"core": 12, "info": 40, "v4": 108, "v5": 124}
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


def _rows(pixels, bpp):
    """Uncompressed rows, top first, each padded to 4 bytes."""
    h, w = pixels.shape[:2]
    pitch = ((w * bpp + 7) // 8 + 3) & ~3
    out = []
    for y in range(h):
        if bpp <= 8:
            bits = np.zeros(pitch * 8, np.uint8)
            for k in range(bpp):
                bits[np.arange(w) * bpp + k] = (pixels[y] >> (bpp - 1 - k)) & 1
            out.append(np.packbits(bits).tobytes())
        elif bpp == 16:
            row = pixels[y].astype("<u2").tobytes()
            out.append(row + bytes(pitch - len(row)))
        else:
            row = np.ascontiguousarray(pixels[y, :, :bpp // 8],
                                       np.uint8).tobytes()
            out.append(row + bytes(pitch - len(row)))
    return out


def rle_encode(pixels, bpp, rng=None, escapes=True):
    """An RLE8 (bpp 8) or RLE4 (bpp 4) stream of (h, w) indices, bottom
    row first: runs of equal pixels (RLE4: alternating pairs), absolute
    runs of 3 or more, an end-of-line after each row and an end of
    bitmap. With rng, runs are split at random and some rows end early
    with an end-of-line, a delta or the end of bitmap, leaving pixels
    to the decoder's fill."""
    h, w = pixels.shape
    out = bytearray()
    y = h - 1
    while y >= 0:
        row = pixels[y]
        x = 0
        while x < w:
            if rng is not None and escapes and rng.random() < 0.04:
                kind = rng.integers(0, 3)
                if kind == 0 and y > 0:                 # delta
                    dx = int(rng.integers(0, w - x + 1))
                    dy = int(rng.integers(0, min(y, 2) + 1))
                    out += bytes((0, 2, dx, dy))
                    x += dx
                    if dy:
                        y -= dy
                        row = pixels[y]
                    if x >= w:
                        break
                    continue
                if kind == 1:                           # end of line early
                    break
                if kind == 2 and rng.random() < 0.2:    # end of bitmap
                    return bytes(out + b"\x00\x01")
            n = 1
            limit = min(255, w - x)
            if rng is not None:
                limit = min(limit, int(rng.integers(1, limit + 1)))
            if bpp == 8:
                while n < limit and row[x + n] == row[x]:
                    n += 1
            else:
                while n < limit and row[x + n] == row[x + (n & 1)]:
                    n += 1
            if n >= 2 or limit < 3:
                if bpp == 8:
                    out += bytes((n, int(row[x])))
                else:
                    hi = int(row[x])
                    lo = int(row[x + 1]) if n > 1 else 0
                    out += bytes((n, hi << 4 | lo))
                x += n
                continue
            n = limit
            vals = [int(v) for v in row[x:x + n]]
            if bpp == 8:
                body = bytes(vals)
            else:
                vals += [0] * (n & 1)
                body = bytes(vals[i] << 4 | vals[i + 1]
                             for i in range(0, len(vals), 2))
            body += bytes(len(body) & 1)
            out += bytes((0, n)) + body
            x += n
        out += b"\x00\x00"
        y -= 1
    return bytes(out + b"\x00\x01")


def write_bmp(pixels, bpp, palette=None, header="info", compression=None,
              top_down=False, masks=None, clrused=None, rle=None):
    """A BMP file. palette: (n, 3) BGR entries (bpp <= 8); compression:
    BI_* (default BI_RGB, BI_RLE8 / BI_RLE4 when rle is given, the RLE
    stream itself); masks: (r, g, b) for BI_BITFIELDS, written after
    the header (an INFO header) or in it (V4, V5)."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    size = HEADER_SIZES[header]
    if compression is None:
        compression = ({8: BI_RLE8, 4: BI_RLE4}[bpp] if rle is not None
                       else BI_BITFIELDS if masks is not None else BI_RGB)
    if rle is not None:
        body = rle
    else:
        rows = _rows(pixels, bpp)
        body = b"".join(rows if top_down else rows[::-1])
    pal = b""
    if bpp <= 8:
        palette = np.asarray(palette, np.uint8)
        n = len(palette)
        if header == "core":
            pal = palette[:, :3].tobytes()
        else:
            pal = np.concatenate([palette[:, :3], np.zeros((n, 1), np.uint8)],
                                 1).tobytes()
    if header == "core":
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        n_used = (len(palette) if bpp <= 8 else 0) if clrused is None \
            else clrused
        info = struct.pack("<IiiHHIIiiII", size, w, -h if top_down else h, 1,
                           bpp, compression, len(body), 2835, 2835, n_used, 0)
        extra = b""
        if header in ("v4", "v5"):
            m = masks or (0, 0, 0)
            extra = struct.pack("<IIII", m[0], m[1], m[2], 0)
            extra += b"BGRs" + bytes(36) + bytes(12)
            if header == "v5":
                extra += struct.pack("<IIII", 4, 0, 0, 0)
        info += extra
        assert len(info) == size
        if masks is not None and header == "info":
            pal = struct.pack("<III", *masks) + pal
    offset = 14 + len(info) + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
    return head + info + pal + body
