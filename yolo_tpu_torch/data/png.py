"""PNG decoding with the standard library's zlib and the port's C
unfilter (native/png.c), for hosts without OpenCV. Every PNG cv2.imread
reads decodes here with its pixels: gray, RGB, palette, gray + alpha and
RGBA, at bit depths 1-16, interlaced (Adam7) or not (alpha dropped,
16-bit samples cut to their high byte, palettes expanded; RGB to gray as
libpng's png_set_rgb_to_gray computes it for OpenCV, in linear light
where a gAMA or sRGB chunk states a gamma), turned as its eXIf chunk's
orientation says, as cv2 5 turns it. encode_png writes gray and RGB
files with any row filter (synthetic datasets, tests).
_unfilter_sequential is the plain Python version of the Average and
Paeth rows, kept for the tests of the C unfilter.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> (samples a pixel, the bit depths the specification allows)
_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
          4: (2, (8, 16)), 6: (4, (8, 16))}
# libpng's fixed-point gamma of an sRGB chunk (PNG_GAMMA_sRGB_INVERSE)
_SRGB_GAMMA = 45455
# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_ERR_LEN = 256
# where libpng stops (png_error), so that cv2 gives no image either
_STOPS = "; cv2 gives no image either (libpng stops there)"


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


def unfilter_plain(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The plain version of the C unfilter: h rows of a filter byte and
    stride bytes -> (h, stride) uint8, in numpy and Python."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            rec = line
        elif ft == 1:
            buf = bytearray(line.tobytes())
            for x in range(bpp, stride):
                buf[x] = (buf[x] + buf[x - bpp]) & 0xFF
            rec = np.frombuffer(bytes(buf), np.uint8)
        elif ft == 2:
            rec = line + prior
        elif ft in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_sequential(ft, buf, prior.tobytes(), bpp)
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ft}")
        out[y] = rec
        prior = out[y]
    return out


def unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """h rows of a filter byte and stride bytes -> (h, stride) uint8,
    through the C unfilter (the interpreter lock released)."""
    from yolo_tpu_torch.native.build import library

    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected "
                         f"{h * (stride + 1)}")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((h, stride), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().yolo_png_unfilter(src.ctypes.data, h, stride, bpp,
                                   out.ctypes.data, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return out


def exif_orientation(tiff: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 of a TIFF-structured EXIF
    block, read the way OpenCV's ExifReader reads it; 1 if absent."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if tiff[:2] == b"II" else ">"

    def u16(o):
        return struct.unpack(end + "H", tiff[o:o + 2])[0] \
            if o + 2 <= len(tiff) else None

    if u16(2) != 42:
        return 1
    ifd = struct.unpack(end + "I", tiff[4:8])[0]
    count = u16(ifd)
    orientation = 1
    for i in range(count or 0):
        e = ifd + 2 + i * 12
        tag = u16(e)
        if tag is None:
            break
        if tag == 0x0112:
            v = u16(e + 8)
            if v is None:
                break
            orientation = v
    return orientation


def apply_orientation(img: np.ndarray, o: int) -> np.ndarray:
    """cv2's ApplyExifOrientation: 2 flip x, 3 flip both, 4 flip y,
    5 transpose, 6 transpose + flip x, 7 transpose + flip both,
    8 transpose + flip y."""
    if o < 2 or o > 8:
        return img
    if o >= 5:
        img = img.transpose(1, 0, 2)
    if o in (2, 3, 6, 7):
        img = img[:, ::-1]
    if o in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _rows_to_pixels(raw, h, w, depth, color, pal, channels, gamma):
    from yolo_tpu_torch.native.build import library

    src = np.frombuffer(raw, np.uint8)
    out = np.empty((h, w, channels), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().yolo_png_decode_rows(src.ctypes.data, len(raw), h, w, depth,
                                      color, pal.ctypes.data, channels,
                                      gamma, out.ctypes.data, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return out


def decode_png(data: bytes, channels=None) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 as cv2.imread gives them: C = 3 (RGB,
    IMREAD_COLOR) or 1 (IMREAD_GRAYSCALE); channels=None keeps the
    file's own: 1 for gray (with or without alpha), else 3. Raises
    ValueError for corrupt or truncated files."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat, palette = 8, None, [], b""
    gama = srgb = exif = None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("PNG truncated mid-chunk" + _STOPS)
        if kind in (b"IHDR", b"PLTE", b"IDAT") and struct.unpack(
                ">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG {kind.decode()} chunk: CRC mismatch"
                             + _STOPS)
        pos += 12 + length
        early = not palette and not idat   # libpng: before PLTE and IDAT
        if kind == b"IHDR":
            if length != 13:
                raise ValueError("PNG IHDR chunk of the wrong length" + _STOPS)
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"gAMA" and early and gama is None and length == 4:
            g = struct.unpack(">I", body)[0]
            if 16 <= g <= 625000000:
                gama = g
        elif kind == b"sRGB" and early and length == 1:
            srgb = _SRGB_GAMMA
        elif kind == b"eXIf" and exif is None and body[:2] in (b"II",
                                                                 b"MM"):
            exif = body
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT" + _STOPS)
    w, h, depth, color, _, _, interlace = header
    if color not in _TYPES or depth not in _TYPES[color][1]:
        raise ValueError(f"PNG bit depth {depth} with color type {color}"
                         + _STOPS)
    if interlace > 1:
        raise ValueError(f"PNG interlace method {interlace}" + _STOPS)
    if w == 0 or h == 0:
        raise ValueError("PNG of zero width or height" + _STOPS)
    if color == 3 and not palette:
        raise ValueError("PNG palette image without a PLTE chunk" + _STOPS)
    if channels is None:
        channels = 1 if color in (0, 4) else 3
    if channels not in (1, 3):
        raise ValueError(f"channels={channels} (1 or 3)")
    # an sRGB chunk's gamma wins over gAMA's; an iCCP profile gives none
    gamma = srgb or gama or 0
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG data does not inflate: {e}" + _STOPS) from None
    pal = np.zeros(768, np.uint8)
    pal[:min(len(palette), 768)] = np.frombuffer(palette[:768], np.uint8)
    if not interlace:
        out = _rows_to_pixels(raw, h, w, depth, color, pal, channels, gamma)
    else:
        out = np.empty((h, w, channels), np.uint8)
        bits = _TYPES[color][0] * depth
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            n = ph * (1 + (pw * bits + 7) // 8)
            if at + n > len(raw):
                raise ValueError(f"PNG data holds {len(raw)} bytes, fewer "
                                 f"than its Adam7 passes need")
            out[y0::dy, x0::dx] = _rows_to_pixels(
                raw[at:at + n], ph, pw, depth, color, pal, channels, gamma)
            at += n
        if at != len(raw):
            raise ValueError(f"PNG data holds {len(raw)} bytes, expected "
                             f"{at}")
    return apply_orientation(out, exif_orientation(exif)) if exif else out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png_rows(rows, width: int, depth: int, color: int,
                    filters=(0,), palette=None, chunks=()) -> bytes:
    """(H, stride) uint8 sample bytes of any colour type and bit depth
    -> PNG bytes; row y takes filters[y % len(filters)] (0 None, 1 Sub,
    2 Up, 3 Average, 4 Paeth), each computed from the raw rows. palette:
    (N, 3) uint8 for colour type 3; chunks: extra (type, body) pairs
    written before the image data."""
    cur = np.asarray(rows, np.uint8).astype(np.int64)
    h, stride = cur.shape
    bpp = max(1, _TYPES[color][0] * depth // 8)
    zeros = np.zeros((h, min(bpp, stride)), np.int64)
    up = np.concatenate([np.zeros((1, stride), np.int64), cur[:-1]])
    left = np.concatenate([zeros, cur[:, :-bpp]], 1)[:, :stride]
    ul = np.concatenate([zeros, up[:, :-bpp]], 1)[:, :stride]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    pred = np.stack([np.zeros_like(cur), left, up, (left + up) // 2, paeth])
    kind = np.asarray(filters, np.int64)[np.arange(h) % len(filters)]
    body = (cur - pred[kind, np.arange(h)]) % 256
    raw = np.concatenate([kind[:, None], body], 1).astype(np.uint8)
    out = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, h,
                                                  depth, color, 0, 0, 0))
    for kind_, chunk_body in chunks:
        out += _chunk(kind_, chunk_body)
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (out + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def encode_png(img, filters=(0,)) -> bytes:
    """(H, W), (H, W, 1) or (H, W, 3) uint8 -> 8-bit gray or RGB PNG
    bytes, row filters as encode_png_rows takes them."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3):
        raise ValueError(f"encode_png: {c} channels, want 1 or 3")
    return encode_png_rows(img.reshape(h, w * c), w, 8, 2 if c == 3 else 0,
                           filters)
