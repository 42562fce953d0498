"""TIFF decoding for the port's host decoder: the bytes that OpenCV 5's
grfmt_tiff.cpp gives through libtiff 4.7 (TIFFReadRGBAStrip /
TIFFReadRGBATile) at IMREAD_COLOR (then COLOR_BGR2RGB) and
IMREAD_GRAYSCALE. The IFDs, tags and Deflate (zlib) are read here,
LZW and PackBits in C (native/tiff.c), JPEG strips through the port's
JPEG decoder (native/jpeg.c); the sample conversions are numpy:

  * II and MM byte order, classic and BigTIFF; the first page only;
  * strips and tiles, chunky and planar; compression none, PackBits,
    LZW, Deflate (Adobe and old), JPEG with JPEGTables; horizontal
    predictor 2 on 8- and 16-bit samples of LZW and Deflate data;
    FillOrder 2 (the stored bytes reversed, but for JPEG);
  * libtiff's RGBA conversion: gray of 1, 2, 4, 8 bits scaled by
    ``v * 255 // (2**bits - 1)``, 16-bit gray by its high byte,
    min-is-white inverted; palettes (16-bit entries ``>> 8`` unless all
    are below 256); RGB of 8 bits, or of 16 bits as ``(v + 128) // 257``;
    unassociated alpha premultiplied (``(v * a + 127) // 255``) and then
    dropped, associated alpha dropped; CMYK as ``k * (255 - c) // 255``
    with ``k = 255 - K``; YCbCr only JPEG-compressed (libjpeg converts it);
  * gray of colour pixels by icvCvt_BGRA2Gray's weights (4899, 9617,
    1868 of 1 << 14, rounded);
  * the orientation tag, applied as cv2 applies EXIF orientation. For 5-8
    OpenCV 5.0.0's cv2.imread gives no image (an assertion in imread_),
    while cv2.imdecode rotates: decode(..., from_file=True) raises there.

What libtiff or OpenCV refuses at 8 bits (32-bit, float and signed
samples, old-style JPEG and LZW, uncompressed YCbCr, other codecs,
damaged or missing strips) raises ValueError saying that cv2 gives no
image either, or, where cv2 does give one, that it is not decoded here.

encode_tiff writes the bytes of cv2.imwrite's TIFF (OpenCV 5's
TiffEncoder on libtiff 4.7): LZW with horizontal differencing, strips of
8 KiB of rows, the IFD after the strips and its arrays after it.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from yolo_tpu_torch.data.png import apply_orientation
from yolo_tpu_torch.data.pnm import icv_gray

NO_IMAGE = "; cv2 gives no image either"
SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
_ERR_LEN = 256

# TIFF field types -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
          11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8),
          17: ("q", 8), 18: ("Q", 8)}

WIDTH, HEIGHT, BPS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILLORDER, STRIP_OFFSETS, ORIENTATION, SPP, ROWS_PER_STRIP = (266, 273, 274,
                                                              277, 278)
STRIP_COUNTS, PLANAR, PREDICTOR, COLORMAP = 279, 284, 317, 320
TILE_W, TILE_H, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325
INKSET, EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES = 332, 338, 339, 347


def is_tiff(data: bytes) -> bool:
    return data[:4] in SIGNATURES


def _no_image(msg: str):
    raise ValueError(msg + NO_IMAGE)


def read_ifd(data: bytes) -> tuple:
    """The first IFD -> ({tag: tuple of values or bytes}, byte order)."""
    bo = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\x00", b"\x00+")
    try:
        if big:
            bytesize, _, off = struct.unpack_from(bo + "HHQ", data, 4)
            if bytesize != 8:
                _no_image("corrupt: a BigTIFF offset size of "
                          f"{bytesize}")
            (n,) = struct.unpack_from(bo + "Q", data, off)
            entry, start, inline = 20, off + 8, 8
        else:
            (off,) = struct.unpack_from(bo + "I", data, 4)
            (n,) = struct.unpack_from(bo + "H", data, off)
            entry, start, inline = 12, off + 2, 4
        tags = {}
        for i in range(n):
            e = start + i * entry
            tag, typ = struct.unpack_from(bo + "HH", data, e)
            count = struct.unpack_from(bo + ("Q" if big else "I"), data,
                                       e + 4)[0]
            if typ not in _TYPES:
                continue
            code, size = _TYPES[typ]
            nbytes = size * count
            if nbytes <= inline:
                where = e + (12 if big else 8)
            else:
                where = struct.unpack_from(bo + ("Q" if big else "I"), data,
                                           e + (12 if big else 8))[0]
            if where + nbytes > len(data):
                _no_image(f"corrupt: tag {tag} points past the end")
            if typ in (2, 7):
                tags[tag] = bytes(data[where:where + nbytes])
            else:
                tags[tag] = struct.unpack_from(f"{bo}{count * len(code)}"
                                               f"{code[0]}", data, where)
    except struct.error:
        _no_image("truncated: the file ends inside its header")
    return tags, bo


def _one(tags, tag, default=None):
    v = tags.get(tag)
    if v is None:
        return default
    return v[0]


def _lib():
    from yolo_tpu_torch.native.build import library

    return library()


def _c_codec(fn: str, raw: bytes, size: int) -> np.ndarray:
    out = np.empty(max(size, 1), np.uint8)
    src = np.frombuffer(raw, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    n = getattr(_lib(), fn)(src.ctypes.data, len(raw), out.ctypes.data,
                            size, err, _ERR_LEN)
    if n < 0:
        raise ValueError(err.value.decode())
    return out[:size]


def _inflate(raw: bytes, size: int) -> np.ndarray:
    d = zlib.decompressobj()
    try:
        out = d.decompress(raw, size)
    except zlib.error as e:
        _no_image(f"corrupt: Deflate data ({e})")
    if len(out) < size:
        _no_image("corrupt: Deflate data ends short of its strip or tile")
    return np.frombuffer(out, np.uint8)


def _jpeg_chunk(raw: bytes, tables, ycbcr: bool) -> np.ndarray:
    """One JPEG strip or tile, tables from JPEGTables -> (h, w, 3) RGB
    (libjpeg converting YCbCr only; other data keeps its components)."""
    from yolo_tpu_torch.native.preproc import decode_jpeg_components

    if tables and len(tables) > 4 and raw[:2] == b"\xff\xd8":
        raw = tables[:-2] + raw[2:]
    return decode_jpeg_components(raw, ycbcr)


def _predict(a: np.ndarray, stride: int) -> np.ndarray:
    """Undo horizontal differencing on (rows, samples) of one width."""
    rows, n = a.shape
    a = a.reshape(rows, n // stride, stride)
    return np.cumsum(a, axis=1, dtype=a.dtype).reshape(rows, n)


def _reverse_bits(raw: bytes) -> bytes:
    table = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
    return raw.translate(table)


def _skew(buf: np.ndarray, wr: int, tw: int, per: int,
          bps: int) -> np.ndarray:
    """A tile of the last column, wr of its tw pixels in the image, as
    libtiff's gray put functions for 16 bits or extra samples
    (put16bitbwtile, putgreytile, putagreytile) read it: each row starts
    tw - wr BYTES after the previous one's wr pixels (the skew is not
    scaled by the sample size), so rows after the first shift. Only the
    first sample of a pixel is read."""
    nbytes = bps // 8
    flat = np.frombuffer(buf.astype("<u2" if nbytes == 2 else np.uint8)
                         .tobytes(), np.uint8)
    rows = buf.shape[0]
    stride = wr * nbytes * per + (tw - wr)
    out = buf.copy()
    for r in range(1, rows):
        idx = r * stride + np.arange(wr) * nbytes * per
        v = flat[idx].astype(np.uint16)
        if nbytes == 2:
            v |= flat[idx + 1].astype(np.uint16) << 8
        out[r, :wr * per:per] = v
    return out


def _chunks(data, tags, bo, w, h, spp, bps, planar, compression, ycbcr):
    """Every strip or tile decoded -> (planes, rows, w * samples) numpy
    samples (uint8, or uint16 in native order for 16 bits), planes 1
    (chunky) or spp (planar)."""
    tiled = TILE_OFFSETS in tags
    photometric = _one(tags, PHOTOMETRIC)
    skewed = photometric in (0, 1) and (spp > 1 or bps == 16)
    per = 1 if planar == 2 else spp
    planes = spp if planar == 2 else 1
    if tiled:
        tw, th = _one(tags, TILE_W, 0), _one(tags, TILE_H, 0)
        offsets, counts = tags.get(TILE_OFFSETS), tags.get(TILE_COUNTS)
        if not tw or not th:
            _no_image("corrupt: a tile of width or length 0")
    else:
        tw, th = w, min(_one(tags, ROWS_PER_STRIP, h) or h, h)
        offsets, counts = tags.get(STRIP_OFFSETS), tags.get(STRIP_COUNTS)
    if offsets is None:
        _no_image("corrupt: no strip or tile offsets")
    across, down = -(-w // tw), -(-h // th)
    if counts is None or len(offsets) < across * down * planes or \
            len(counts) < len(offsets):
        _no_image("corrupt: fewer strips or tiles than the image needs")
    row_bytes = (tw * per * bps + 7) // 8
    if tiled and compression == 1 and (th * row_bytes) % 1024:
        # OpenCV 5.0.0 with libtiff 4.7.1 refuses these ("Invalid tile
        # byte count"): an uncompressed tile must be whole kilobytes
        _no_image(f"unsupported: an uncompressed tile of {th * row_bytes} "
                  "bytes, not a multiple of 1024")
    wide = bps == 16
    tables = tags.get(JPEG_TABLES)
    predictor = _one(tags, PREDICTOR, 1)
    fill_order = _one(tags, FILLORDER, 1)
    out = np.zeros((planes, down * th, across * tw * per),
                   np.uint16 if wide else np.uint8)
    if bps < 8:
        out = np.zeros((planes, down * th, across * row_bytes), np.uint8)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                off, cnt = int(offsets[k]), int(counts[k])
                k += 1
                rows = th if tiled else min(th, h - ty * th)
                size = rows * row_bytes
                raw = data[off:off + cnt]
                if cnt == 0 or off + cnt > len(data):
                    _no_image("corrupt: a strip or tile lies past the end "
                              "of the file")
                if fill_order == 2 and compression != 7:
                    raw = _reverse_bits(raw)   # (libtiff's JPEG skips it)
                if compression == 7:
                    pix = _jpeg_chunk(raw, tables, ycbcr)
                    if pix.shape[0] < rows or pix.shape[1] < tw:
                        _no_image("corrupt: a JPEG strip or tile smaller "
                                  "than its place")
                    pix = pix[:rows, :tw, :per].reshape(rows, tw * per)
                    out[p, ty * th:ty * th + rows,
                        tx * tw * per:(tx + 1) * tw * per] = pix
                    continue
                if compression == 1:
                    if len(raw) < size:
                        _no_image("truncated: a strip or tile ends early")
                    buf = np.frombuffer(raw, np.uint8, size)
                elif compression == 32773:
                    buf = _c_codec("yolo_tiff_packbits_decode", raw, size)
                elif compression == 5:
                    if raw[:1] == b"\x00" and raw[1:2] and raw[1] & 1:
                        raise ValueError("unsupported here: old-style LZW "
                                         "(cv2 reads it)")
                    buf = _c_codec("yolo_tiff_lzw_decode", raw, size)
                else:
                    buf = _inflate(raw, size)
                buf = buf.reshape(rows, row_bytes)
                if wide:
                    buf = buf.view(bo + "u2").astype(np.uint16)
                if predictor == 2 and compression in (5, 8, 32946):
                    buf = _predict(buf, per)     # the codecs libtiff predicts
                wr = w - tx * tw
                if tiled and wr < tw and skewed:
                    buf = _skew(buf, wr, tw, per, bps)
                if bps < 8:
                    out[p, ty * th:ty * th + rows,
                        tx * row_bytes:(tx + 1) * row_bytes] = buf
                else:
                    out[p, ty * th:ty * th + rows,
                        tx * tw * per:(tx + 1) * tw * per] = buf
    if bps < 8:   # unpack each chunk's rows of bits to one sample a byte
        bits = np.unpackbits(out, axis=2).reshape(planes, down * th, across,
                                                  row_bytes * 8)
        vals = np.zeros(bits.shape[:3] + (tw * per,), np.uint8)
        for b in range(bps):
            vals = (vals << 1) | bits[..., b:tw * per * bps:bps]
        out = vals.reshape(planes, down * th, across * tw * per)
    out = out[:, :h].reshape(planes, h, across * tw, per)[:, :, :w]
    if planar == 2:
        return np.ascontiguousarray(out[..., 0].transpose(1, 2, 0))
    return out[0]


def _premultiply(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    return ((rgb.astype(np.int32) * a[..., None] + 127) // 255).astype(
        np.uint8)


def _to_rgb(s, tags, photometric, bps, spp, compression):
    """Samples (h, w, spp) -> (h, w, 3) uint8 RGB as TIFFRGBAImage
    makes it, alpha dropped."""
    extra = tags.get(EXTRA_SAMPLES, ())
    alpha = 0
    if extra:
        alpha = extra[0] if extra[0] in (1, 2) else (1 if spp > 3 else 0)
    if photometric in (0, 1):
        if bps == 16:
            v = (s[..., 0] >> 8).astype(np.uint8)
        else:
            rng = (1 << bps) - 1
            v = (s[..., 0].astype(np.int32) * 255 // rng).astype(np.uint8)
        if photometric == 0:
            v = 255 - v
        return np.repeat(v[..., None], 3, 2)
    if photometric == 3:
        cmap = np.asarray(tags.get(COLORMAP, ()), np.int64)
        n = 1 << bps
        if len(cmap) < 3 * n:
            _no_image("corrupt: a palette image without its colour map")
        cmap = cmap[:3 * n].reshape(3, n)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return cmap.T.astype(np.uint8)[s[..., 0]]
    if photometric == 5:
        if spp < 4 or bps != 8 or _one(tags, INKSET, 1) != 1:
            _no_image("unsupported: separated samples other than 8-bit "
                      "CMYK")
        k = 255 - s[..., 3].astype(np.int32)
        return (k[..., None] * (255 - s[..., :3].astype(np.int32))
                // 255).astype(np.uint8)
    if photometric in (2, 6) and (compression == 7 or photometric == 2):
        if bps == 16:
            v = ((s.astype(np.int32) + 128) // 257).astype(np.uint8)
        else:
            v = s.astype(np.uint8)
        rgb = v[..., :3]
        if alpha == 2 and spp >= 4:
            rgb = _premultiply(rgb, v[..., 3].astype(np.int32))
        return rgb
    _no_image(f"unsupported: photometric {photometric} at {bps} bits")


def decode_tiff(data: bytes, channels: int = 3,
                from_file: bool = False) -> np.ndarray:
    """TIFF bytes -> (H, W, channels) uint8 as cv2 reads the first page;
    from_file: as cv2.imread (which gives no image for orientations
    5-8), else as cv2.imdecode."""
    tags, bo = read_ifd(data)
    w, h = _one(tags, WIDTH, 0), _one(tags, HEIGHT, 0)
    if not w or not h:
        _no_image("corrupt: a TIFF of width or height 0")
    spp = _one(tags, SPP, 1)
    bps_all = tags.get(BPS, (1,))
    bps = bps_all[0]
    photometric = _one(tags, PHOTOMETRIC)
    compression = _one(tags, COMPRESSION, 1)
    planar = _one(tags, PLANAR, 1)
    fmt = _one(tags, SAMPLE_FORMAT, 1)
    if photometric is None:
        _no_image("corrupt: no photometric interpretation")
    if bps not in (1, 4, 8, 16) or (bps == 4 and photometric != 3) or \
            fmt not in (1, 4) or any(b != bps for b in bps_all):
        _no_image(f"unsupported: {bps}-bit samples of format {fmt} "
                  "(OpenCV reads 1, 8 and 16 bits, 4 of a palette)")
    if spp not in (1, 3, 4) and not (photometric in (0, 1) and spp == 2):
        _no_image(f"unsupported: {spp} samples a pixel")
    if compression not in (1, 5, 7, 8, 32773, 32946):
        if compression == 6:
            raise ValueError("unsupported here: old-style JPEG in TIFF")
        _no_image(f"unsupported: TIFF compression {compression}")
    if photometric == 6 and compression != 7:
        raise ValueError("unsupported here: uncompressed YCbCr TIFF")
    if photometric == 2 and bps not in (8, 16):
        _no_image(f"unsupported: RGB of {bps}-bit samples")
    if photometric == 3 and bps > 8:
        _no_image(f"unsupported: a palette of {bps}-bit indices")
    if compression == 7 and bps != 8:
        _no_image("unsupported: JPEG of other than 8 bits")
    if (_one(tags, PREDICTOR, 1) == 2 and bps < 8):
        _no_image(f"unsupported: predictor 2 on {bps}-bit samples")
    o = _one(tags, ORIENTATION, 1)
    if from_file and o in (5, 6, 7, 8):
        _no_image(f"unsupported: orientation {o} (OpenCV 5.0.0's imread "
                  "fails there; cv2.imdecode of the same bytes rotates)")
    s = _chunks(data, tags, bo, w, h, spp, bps, planar, compression,
                photometric == 6)
    rgb = _to_rgb(s, tags, photometric, bps, spp, compression)
    if TILE_OFFSETS in tags and o in (2, 3, 6, 7):
        # libtiff mirrors each tile within its width where the
        # orientation flips x; the whole-image flip OpenCV then assumes
        # mirrors the tiles' order back
        tw = _one(tags, TILE_W)
        for x0 in range(0, w, tw):
            rgb[:, x0:x0 + tw] = rgb[:, x0:x0 + tw][:, ::-1]
        rgb = rgb[:, ::-1]
    rgb = apply_orientation(rgb, o)
    return rgb if channels == 3 else icv_gray(rgb)


def _entry(tag: int, typ: int, values, out_of_line: dict) -> tuple:
    """An IFD entry of SHORT (3) or LONG (4) values -> (tag, type,
    count, value field); arrays past 4 bytes go to out_of_line[tag]."""
    code = "H" if typ == 3 else "I"
    raw = struct.pack(f"<{len(values)}{code}", *values)
    if len(raw) > 4:
        out_of_line[tag] = raw
        return tag, typ, len(values), None
    return tag, typ, len(values), raw + bytes(4 - len(raw))


def encode_tiff(image: np.ndarray) -> bytes:
    """(H, W, 3) RGB or (H, W[, 1]) gray uint8 -> the TIFF cv2.imwrite
    writes: little-endian, one IFD of twelve tags, PlanarConfig 1,
    RowsPerStrip max(1, min(H, 8192 // (W * channels))), each strip
    horizontally differenced and LZW-coded as libtiff codes it
    (native/tiff.c), the strips from byte 8, the IFD at the next even
    offset, then (each at an even offset) BitsPerSample, StripByteCounts,
    StripOffsets and SampleFormat where they do not fit in their
    entries."""
    img = np.asarray(image, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"encode_tiff takes (H, W, 3) or (H, W) images, "
                         f"got shape {image.shape}")
    h, w, spp = img.shape
    rows_per_strip = max(1, min(h, 8192 // (w * spp)))
    rows = img.reshape(h, w * spp).astype(np.int16)
    diff = rows.copy()
    diff[:, spp:] -= rows[:, :-spp]
    diff = (diff & 0xFF).astype(np.uint8)
    lib = _lib()
    err = ctypes.create_string_buffer(_ERR_LEN)
    strips = []
    for y in range(0, h, rows_per_strip):
        src = np.ascontiguousarray(diff[y:y + rows_per_strip])
        out = np.empty(2 * src.size + 16, np.uint8)
        n = lib.yolo_tiff_lzw_encode(src.ctypes.data, src.size,
                                     out.ctypes.data, out.size, err,
                                     _ERR_LEN)
        if n < 0:
            raise ValueError(err.value.decode())
        strips.append(out[:n].tobytes())
    offsets, pos = [], 8
    for st in strips:
        offsets.append(pos)
        pos += len(st)
    ifd_at = (pos + 1) & ~1

    def short_or_long(tag, v):
        return _entry(tag, 3 if v <= 0xFFFF else 4, [v], extra)

    extra: dict = {}
    entries = [short_or_long(WIDTH, w), short_or_long(HEIGHT, h),
               _entry(BPS, 3, [8] * spp, extra),
               _entry(COMPRESSION, 3, [5], extra),
               _entry(PHOTOMETRIC, 3, [2 if spp == 3 else 1], extra),
               _entry(STRIP_OFFSETS, 4, offsets, extra),
               _entry(SPP, 3, [spp], extra),
               short_or_long(ROWS_PER_STRIP, rows_per_strip),
               _entry(STRIP_COUNTS, 4, [len(st) for st in strips], extra),
               _entry(PLANAR, 3, [1], extra),
               _entry(PREDICTOR, 3, [2], extra),
               _entry(SAMPLE_FORMAT, 3, [1] * spp, extra)]
    at = ifd_at + 2 + 12 * len(entries) + 4
    where, tail = {}, b""
    for tag in (BPS, STRIP_COUNTS, STRIP_OFFSETS, SAMPLE_FORMAT):
        if tag in extra:
            where[tag] = at + len(tail)
            tail += extra[tag] + b"\0" * (len(extra[tag]) & 1)
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHI", tag, typ, n) + (
            val if val is not None else struct.pack("<I", where[tag]))
        for tag, typ, n, val in entries) + b"\0\0\0\0"
    body = b"".join(strips)
    return (b"II*\0" + struct.pack("<I", ifd_at) + body
            + b"\0" * (ifd_at - pos) + ifd + tail)
