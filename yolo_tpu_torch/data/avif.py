"""AVIF reading for the port's host decoder: the bytes cv2.imread /
cv2.imdecode give (OpenCV 5's grfmt_avif.cpp on libavif 1.4.2, which
decodes AV1 with libaom 3.14.1) after COLOR_BGR2RGB at 3 channels,
IMREAD_GRAYSCALE's at 1. The HEIF boxes are read here; the AV1 frame in
C (native/av1*.c):

  * the signature: an ftyp box whose major or compatible brands hold
    ``avif`` (or ``avis``, which is refused as an image sequence);
  * the meta box: hdlr ``pict``, pitm, iloc (versions 0-2, construction
    method 0, extents concatenated), iinf / infe (versions 2-3), iref,
    iprp with ipco and ipma;
  * the primary item must be an ``av01`` image item with an av1C and an
    ispe that match its sequence header; its AV1 OBUs decode to 8-bit
    4:2:0 Y, U and V planes (yolo_av1_decode);
  * the colour: a ``colr`` nclx box sets the matrix and range, else the
    sequence header's colour description does; BT.601 (matrix 5, 6 or
    unspecified) at full range converts to RGB as libavif runs it through
    libyuv (bilinear chroma upsampling, 6-bit fixed point); gray is
    cv2.cvtColor(COLOR_BGR2GRAY) of that colour image.

The AV1 frame may use every intra tool of a key frame beside those
below, palettes, intra block copy and 64x64 or 128x128 superblocks
among them. What part 1 of the port's AVIF reading leaves out raises
ValueError naming it: 10/12-bit, 4:4:4 / 4:2:2 / monochrome, alpha (an
auxl item with an alpha auxC), grid and other derived items, irot /
imir / clap, image sequences, loop restoration, superres, film grain,
segmentation, delta loop filter levels, lossless frames, colour matrices
other than BT.601 and limited range.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from yolo_tpu_torch.data.webp import cvt_gray

_ERR_LEN = 256
_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
               b"urn:mpeg:hevc:2015:auxid:1")


def _brands(data: bytes):
    if len(data) < 16 or data[4:8] != b"ftyp":
        return None
    (size,) = struct.unpack_from(">I", data, 0)
    if size < 16 or size > len(data):
        return None
    return [data[8:12]] + [data[i:i + 4] for i in range(16, size - 3, 4)]


def is_avif(data: bytes) -> bool:
    """libavif's avifPeekCompatibleFileType: an ftyp box naming the
    avif or avis brand."""
    brands = _brands(data)
    return bool(brands) and (b"avif" in brands or b"avis" in brands)


def _boxes(data: bytes, pos: int, end: int):
    """(type, payload start, payload end) of the boxes in [pos, end)."""
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise ValueError("AVIF: a box's extended size is cut short")
            (size,) = struct.unpack_from(">Q", data, pos + 8)
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"AVIF: box {kind!r} of {size} bytes runs past "
                             f"its parent")
        yield kind, pos + head, pos + size
        pos += size


class _Reader:
    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end

    def take(self, n: int) -> bytes:
        if self.pos + n > self.end:
            raise ValueError("AVIF: a box is cut short")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big") if n else 0


def _meta(data: bytes, start: int, end: int) -> dict:
    r = _Reader(data, start, end)
    r.take(4)                                   # version, flags
    m = {"items": {}, "iloc": {}, "props": [], "assoc": {}, "refs": [],
         "pitm": None, "hdlr": None}
    for kind, s, e in _boxes(data, r.pos, end):
        b = _Reader(data, s, e)
        if kind == b"hdlr":
            b.take(8)
            m["hdlr"] = b.take(4)
        elif kind == b"pitm":
            version = b.uint(1)
            b.take(3)
            m["pitm"] = b.uint(2 if version == 0 else 4)
        elif kind == b"iloc":
            version = b.uint(1)
            b.take(3)
            if version > 2:
                raise ValueError(f"AVIF: iloc version {version}")
            sizes = b.uint(1)
            off_size, len_size = sizes >> 4, sizes & 15
            sizes = b.uint(1)
            base_size = sizes >> 4
            idx_size = sizes & 15 if version in (1, 2) else 0
            if any(n not in (0, 4, 8)
                   for n in (off_size, len_size, base_size, idx_size)):
                raise ValueError("AVIF: iloc fields must be 0, 4 or 8 bytes")
            step = idx_size + off_size + len_size
            count = b.uint(2 if version < 2 else 4)
            for _ in range(count):
                item = b.uint(2 if version < 2 else 4)
                method = b.uint(2) & 15 if version in (1, 2) else 0
                b.uint(2)                       # data_reference_index
                base = b.uint(base_size)
                n = b.uint(2)
                # each extent costs step bytes of the box, and together
                # they hold no more than the file: an upload of a few
                # bytes cannot name the file many times over
                if n * step > b.end - b.pos or (step == 0 and n > 1):
                    raise ValueError(f"AVIF: iloc item {item} declares {n} "
                                     f"extents in {b.end - b.pos} bytes")
                extents, total = [], 0
                for _ in range(n):
                    b.uint(idx_size)
                    off = base + b.uint(off_size)
                    # a length of 0 is the rest of the file
                    length = b.uint(len_size) or max(len(data) - off, 0)
                    total += length
                    if off + length > len(data) or total > len(data):
                        raise ValueError("AVIF: an item's data runs past "
                                         "the file")
                    extents.append((off, length))
                m["iloc"][item] = (method, extents)
        elif kind == b"iinf":
            version = b.uint(1)
            b.take(3)
            b.uint(2 if version == 0 else 4)
            for k2, s2, e2 in _boxes(data, b.pos, e):
                if k2 != b"infe":
                    continue
                ib = _Reader(data, s2, e2)
                version2 = ib.uint(1)
                ib.take(3)
                if version2 < 2:
                    continue
                item = ib.uint(2 if version2 == 2 else 4)
                ib.uint(2)
                m["items"][item] = ib.take(4)
        elif kind == b"iref":
            version = b.uint(1)
            b.take(3)
            n = 2 if version == 0 else 4
            for k2, s2, e2 in _boxes(data, b.pos, e):
                rb = _Reader(data, s2, e2)
                src = rb.uint(n)
                for _ in range(rb.uint(2)):
                    m["refs"].append((k2, src, rb.uint(n)))
        elif kind == b"iprp":
            for k2, s2, e2 in _boxes(data, s, e):
                if k2 == b"ipco":
                    m["props"] = list(_boxes(data, s2, e2))
                elif k2 == b"ipma":
                    pb = _Reader(data, s2, e2)
                    version = pb.uint(1)
                    flags = pb.uint(3)
                    for _ in range(pb.uint(4)):
                        item = pb.uint(2 if version < 1 else 4)
                        assoc = []
                        for _ in range(pb.uint(1)):
                            v = pb.uint(2 if flags & 1 else 1)
                            bits = 15 if flags & 1 else 7
                            assoc.append((v >> bits, v & ((1 << bits) - 1)))
                        m["assoc"][item] = assoc
    return m


def _item_props(data: bytes, m: dict, item: int) -> dict:
    """{kind: payload} of the item's properties, views into data."""
    view = memoryview(data)
    props = {}
    for _, index in m["assoc"].get(item, []):
        if index == 0:
            continue
        if index > len(m["props"]):
            raise ValueError(f"AVIF: property {index} of item {item} is "
                             f"missing")
        kind, s, e = m["props"][index - 1]
        props[kind] = view[s:e]
    return props


def _aux_type(auxc) -> bytes:
    """An auxC property's aux_type: the string after version and flags,
    up to its NUL, read as libavif reads it (at most 64 bytes)."""
    head = bytes(auxc[4:4 + 64])
    return head.split(b"\0", 1)[0]


def _item_data(data: bytes, m: dict, item: int) -> bytes:
    if item not in m["iloc"]:
        raise ValueError(f"AVIF: item {item} has no location")
    method, extents = m["iloc"][item]
    if method != 0:
        raise ValueError(f"AVIF: iloc construction method {method}")
    return b"".join(data[off:off + length] for off, length in extents)


def _primary(data: bytes):
    """(AV1 OBUs, item properties) of the primary image item."""
    brands = _brands(data)
    meta = None
    for kind, s, e in _boxes(data, 0, len(data)):
        if kind == b"meta":
            meta = (s, e)
        elif kind == b"moov":
            raise ValueError("AVIF: an image sequence (moov) is not read")
    if brands and brands[0] == b"avis":
        raise ValueError("AVIF: an image sequence (avis) is not read")
    if meta is None:
        raise ValueError("AVIF: no meta box")
    m = _meta(data, *meta)
    if m["hdlr"] != b"pict":
        raise ValueError(f"AVIF: handler {m['hdlr']!r}, not 'pict'")
    item = m["pitm"]
    if item is None or item not in m["items"]:
        raise ValueError("AVIF: no primary item")
    kind = m["items"][item]
    if kind in (b"grid", b"iovl", b"tmap"):
        raise ValueError(f"AVIF: a derived {kind.decode()} image item is "
                         f"not read")
    if kind != b"av01":
        raise ValueError(f"AVIF: primary item of type {kind!r}")
    props = _item_props(data, m, item)
    for key, name in ((b"irot", "rotation (irot)"),
                      (b"imir", "mirroring (imir)"),
                      (b"clap", "clean aperture (clap)")):
        if key in props:
            raise ValueError(f"AVIF: {name} is not read")
    for src in {src for ref, src, dst in m["refs"]
                if ref == b"auxl" and dst == item}:
        if _aux_type(_item_props(data, m, src).get(b"auxC", b"")) \
                in _ALPHA_URNS:
            raise ValueError("AVIF: alpha (an auxC alpha item) is not read")
    if b"av1C" not in props:
        raise ValueError("AVIF: the primary item has no av1C")
    return _item_data(data, m, item), props


def _decode(data: bytes):
    """(Y, U, V, info, primary item properties) of the primary item."""
    from yolo_tpu_torch.native.build import library

    obus, props = _primary(data)
    lib = library()
    src = np.frombuffer(obus, np.uint8)
    out = ctypes.c_void_p()
    info = np.zeros(9, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.yolo_av1_decode(src.ctypes.data, len(obus), ctypes.byref(out),
                           info.ctypes.data, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    try:
        w, h, cw, ch = (int(v) for v in info[:4])
        n = w * h + 2 * cw * ch
        flat = np.frombuffer((ctypes.c_uint8 * n).from_address(out.value),
                             np.uint8).copy()
    finally:
        lib.yolo_native_free(out)
    y = flat[:w * h].reshape(h, w)
    u = flat[w * h:w * h + cw * ch].reshape(ch, cw)
    v = flat[w * h + cw * ch:].reshape(ch, cw)
    ispe = props.get(b"ispe")
    if ispe is not None and len(ispe) >= 12:
        iw, ih = struct.unpack_from(">II", ispe, 4)
        if (iw, ih) != (w, h):
            raise ValueError(f"AVIF: ispe {iw}x{ih} against a {w}x{h} frame")
    return y, u, v, info, props


def decode_yuv(data: bytes):
    """AVIF bytes -> (Y, U, V uint8 planes, info): the primary item's AV1
    frame as libaom decodes it; info: [w, h, cw, ch, colour description
    present, primaries, transfer, matrix, full range]."""
    return _decode(data)[:4]


def _colour(props: dict, info) -> tuple:
    """(matrix, full range): a colr nclx box's, else the sequence
    header's (unspecified without a colour description)."""
    colr = props.get(b"colr", b"")
    if len(colr) >= 11 and colr[:4] == b"nclx":
        _, _, matrix = struct.unpack_from(">HHH", colr, 4)
        return matrix, colr[10] >> 7
    return (int(info[7]) if info[4] else 2), int(info[8])


def decode_avif(data: bytes, channels: int = 3) -> np.ndarray:
    """AVIF bytes -> (H, W, channels) uint8: RGB at 3 channels, gray at 1,
    cv2.imdecode's bytes after COLOR_BGR2RGB."""
    from yolo_tpu_torch.native.build import library

    y, u, v, info, props = _decode(data)
    h, w = y.shape
    matrix, full = _colour(props, info)
    rgb = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().yolo_avif_yuv_to_rgb(y.ctypes.data, u.ctypes.data,
                                      v.ctypes.data, w, h, matrix, full,
                                      rgb.ctypes.data, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return rgb if channels == 3 else cvt_gray(rgb)
