"""JPEG 2000 reading for the port's host decoder: the bytes cv2.imread /
cv2.imdecode give (OpenCV 5's grfmt_jpeg2000_openjpeg.cpp on OpenJPEG
2.5) after COLOR_BGR2RGB at 3 channels, IMREAD_GRAYSCALE's at 1. A JP2
file's boxes are read here; the codestream in C (native/j2k.c and its
tiers, the samples OpenJPEG decodes):

  * a raw codestream (FF4F FF51) or a JP2 file (the signature box, then
    ftyp, a jp2h with its ihdr, colr, pclr / cmap, cdef, and the jp2c
    codestream, read on to the end of the file as OpenJPEG reads it);
    only the first colr box counts, other boxes are skipped;
  * OpenJPEG's component handling: a palette (pclr with its cmap) maps
    the indices (clamped to the palette) to its columns, each column of
    its own precision; cdef swaps colour channels into their place;
  * OpenCV's conversion: its precision is the widest component's, read
    before the palette; below 8 bits it gives no image, above 8 each
    sample is shifted right by (precision - 8), then cast to 8 bits;
    the colour space sRGB (or none stated, or an ICC profile) takes the
    first three components as R, G, B (a fourth, alpha, dropped), and
    gray is cv2.cvtColor(COLOR_BGR2GRAY) of that colour image; of one or
    two components only the first, at 1 channel (OpenCV gives no
    3-channel image of them); a gray colour space takes the first
    component alone; sYCC takes the first three as Y, U, V through
    cv2.cvtColor(COLOR_YUV2BGR) (gray: Y);
  * cv2 gives no image, and this raises ValueError saying so, for a
    non-zero image origin or sub-sampled components ("tiles are not
    supported"), signed components, precisions below 8, the CMYK and
    e-sYCC colour spaces, and any file OpenJPEG refuses (a codestream
    cut short, damaged boxes).

The Part 2 and Part 15 extensions (multiple component transforms,
other wavelets, high-throughput blocks) raise naming the marker: OpenJPEG
reads some of them, the port does not.

encode_jp2 writes the JP2 file cv2.imwrite writes (OpenCV 5 through
OpenJPEG 2.5.3, one layer at a compression ratio of 4): the boxes here,
the codestream in C (native/j2k_enc.c, whose docstring lists what it
reproduces).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from yolo_tpu_torch.data.webp import cvt_gray

NO_IMAGE = "; cv2 gives no image either"
SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
CODESTREAM = b"\xff\x4f\xff\x51"
_MAX_COMPS = 16384
_ERR_LEN = 256


def is_jp2(data: bytes) -> bool:
    """cv2's two JPEG 2000 signatures: the JP2 signature box, or a raw
    codestream's SOC and SIZ markers."""
    return data[:12] == SIGNATURE or data[:4] == CODESTREAM


def _refused(msg: str) -> ValueError:
    return ValueError(msg + NO_IMAGE)


def _boxes(data: bytes, pos: int, end: int):
    """(type, payload start, payload end) of the boxes in [pos, end); a
    box of length 0 runs to the end."""
    while pos + 8 <= end:
        length, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if length == 1:
            if pos + 16 > end:
                raise _refused("JP2: a box's extended length is cut")
            (length,) = struct.unpack_from(">Q", data, pos + 8)
            head = 16
        elif length == 0:
            length = end - pos
        if length < head or pos + length > end:
            raise _refused(f"JP2: box {kind!r} of {length} bytes runs past "
                           f"the data")
        yield kind, pos + head, pos + length
        pos += length


class _Color:
    def __init__(self):
        self.enumcs = 0
        self.has_colr = False
        self.pclr = None      # entries, (n, columns) int64
        self.cmap = None      # [(cmp, mtyp, pcol)]
        self.cdef = None      # [(cn, typ, asoc)]


def _read_jp2h(data: bytes, start: int, end: int, color: _Color) -> None:
    """The jp2h superbox's ihdr (checked) and colour boxes (into
    color)."""
    boxes = list(_boxes(data, start, end))
    if not boxes or boxes[0][0] != b"ihdr":
        raise _refused("JP2: the jp2h box does not start with ihdr")
    for kind, s, e in boxes:
        body = data[s:e]
        if kind == b"ihdr":
            if len(body) != 14:
                raise _refused("JP2: an ihdr box of a bad size")
            h, w, nc = struct.unpack_from(">IIH", body)
            if h < 1 or w < 1 or nc < 1 or nc > _MAX_COMPS:
                raise _refused(f"JP2: ihdr of {w}x{h}, {nc} components")
        elif kind == b"colr":
            if color.has_colr:
                continue   # a conforming reader ignores all but the first
            if len(body) < 3:
                raise _refused("JP2: a colr box of a bad size")
            meth = body[0]
            if meth == 1:
                if len(body) < 7:
                    raise _refused("JP2: a colr box of a bad size")
                (color.enumcs,) = struct.unpack_from(">I", body, 3)
                color.has_colr = True
            elif meth == 2:
                color.has_colr = True     # ICC: no colour space stated
        elif kind == b"pclr":
            if color.pclr is not None:
                raise _refused("JP2: a second pclr box")
            if len(body) < 3:
                raise _refused("JP2: a pclr box of a bad size")
            ne, npc = struct.unpack_from(">HB", body)
            if ne == 0 or ne > 1024 or npc == 0:
                raise _refused(f"JP2: a pclr of {ne} entries, {npc} columns")
            if len(body) < 3 + npc:
                raise _refused("JP2: a pclr box of a bad size")
            sizes = [(b & 0x7f) + 1 for b in body[3:3 + npc]]
            widths = [(s + 7) // 8 for s in sizes]
            need = 3 + npc + ne * sum(widths)
            if len(body) < need:
                raise _refused("JP2: a pclr box of a bad size")
            entries = np.zeros((ne, npc), np.int64)
            pos = 3 + npc
            for i in range(ne):
                for j in range(npc):
                    entries[i, j] = int.from_bytes(
                        body[pos:pos + widths[j]], "big")
                    pos += widths[j]
            color.pclr = entries
        elif kind == b"cmap":
            if color.pclr is None:
                raise _refused("JP2: a cmap box before its pclr")
            if color.cmap is not None:
                raise _refused("JP2: a second cmap box")
            npc = color.pclr.shape[1]
            if len(body) < 4 * npc:
                raise _refused("JP2: a cmap box of a bad size")
            color.cmap = [struct.unpack_from(">HBB", body, 4 * i)
                          for i in range(npc)]
        elif kind == b"cdef":
            if color.cdef is not None:
                raise _refused("JP2: a second cdef box")
            if len(body) < 2:
                raise _refused("JP2: a cdef box of a bad size")
            (n,) = struct.unpack_from(">H", body)
            if n == 0 or len(body) != 2 + 6 * n:
                raise _refused("JP2: a cdef box of a bad size")
            color.cdef = [list(struct.unpack_from(">HHH", body, 2 + 6 * i))
                          for i in range(n)]


def _container(data: bytes):
    """A JP2 file -> (the codestream on to the end of the file, its
    colour boxes); a raw codestream -> (itself, none stated)."""
    color = _Color()
    if data[:4] == CODESTREAM:
        return data, color
    boxes = _boxes(data, 0, len(data))
    seen_jp2h = False
    for i, (kind, s, e) in enumerate(boxes):
        if i == 1 and kind != b"ftyp":
            raise _refused("JP2: the ftyp box is not the second box")
        if kind == b"jp2h":
            _read_jp2h(data, s, e, color)
            seen_jp2h = True
        elif kind == b"jp2c":
            if not seen_jp2h:
                raise _refused("JP2: no jp2h box before the codestream")
            return data[s:], color
    raise _refused("JP2: no jp2c codestream box")


def _codestream(cs: bytes):
    """The codestream -> ([(prec, sgnd, dx, dy, x0, y0, w, h)], [(h, w)
    int32 samples], image origin (x0, y0))."""
    from yolo_tpu_torch.native.build import library

    lib = library()
    src = np.frombuffer(cs, np.uint8)
    out = ctypes.c_void_p()
    maxc = 16
    info = np.zeros(5 + 8 * maxc, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.yolo_j2k_decode(src.ctypes.data, len(cs), ctypes.byref(out),
                           info.ctypes.data, maxc, err, _ERR_LEN):
        msg = err.value.decode()
        raise ValueError(msg if "not ported" in msg else msg + NO_IMAGE)
    try:
        comps, planes, off = [], [], 0
        total = sum(int(info[5 + 8 * i + 6]) * int(info[5 + 8 * i + 7])
                    for i in range(info[0]))
        flat = np.frombuffer((ctypes.c_int32 * max(total, 1)).from_address(
            out.value), np.int32)
        for i in range(info[0]):
            q = [int(v) for v in info[5 + 8 * i:13 + 8 * i]]
            comps.append(q)
            n = q[6] * q[7]
            planes.append(flat[off:off + n].reshape(q[7], q[6]).copy())
            off += n
    finally:
        lib.yolo_native_free(out)
    return comps, planes, (int(info[1]), int(info[2]))


def _apply_pclr(color: _Color, planes):
    """opj_jp2_check_color's palette checks and opj_jp2_apply_pclr (the
    columns' precisions do not reach OpenCV, whose shift is read before
    the palette)."""
    entries = color.pclr
    cmap = color.cmap
    npc = len(cmap)
    used = [False] * npc
    for i, (cmp, mtyp, pcol) in enumerate(cmap):
        if cmp >= len(planes):
            raise _refused(f"JP2: cmap names component {cmp} of "
                           f"{len(planes)}")
        if mtyp not in (0, 1) or pcol >= npc or (used[pcol] and mtyp == 1) \
                or (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i):
            raise _refused(f"JP2: cmap entry {i} ({mtyp}, {pcol}) is not "
                           f"one OpenJPEG maps")
        used[pcol] = True
    if any(not used[i] and cmap[i][1] != 0 for i in range(npc)):
        raise _refused("JP2: a palette column without a mapping")
    top = entries.shape[0] - 1
    return [planes[cmp] if mtyp == 0 else
            entries[np.clip(planes[cmp], 0, top), pcol].astype(np.int32)
            for cmp, mtyp, pcol in cmap]


def _apply_cdef(color: _Color, planes):
    """opj_jp2_check_color's channel checks and opj_jp2_apply_cdef's
    swaps of colour channels."""
    info = [list(e) for e in color.cdef]
    n = len(planes)
    for cn, _typ, asoc in info:
        if cn >= n or (asoc not in (0, 65535) and asoc - 1 >= n):
            raise _refused(f"JP2: cdef names channel {cn} / {asoc} of {n}")
    for k in range(n):
        if not any(e[0] == k for e in info):
            raise _refused("JP2: incomplete channel definitions")
    planes = list(planes)
    for i, (cn, typ, asoc) in enumerate(info):
        if asoc in (0, 65535):
            continue
        acn = asoc - 1
        if cn != acn and typ == 0:
            planes[cn], planes[acn] = planes[acn], planes[cn]
            for e in info[i + 1:]:
                if e[0] == cn:
                    e[0] = acn
                elif e[0] == acn:
                    e[0] = cn
    return planes


def decode_jp2(data: bytes, channels: int = 3) -> np.ndarray:
    """JP2 or J2K bytes -> (H, W, channels) uint8, as cv2 decodes them
    (module docstring); ValueError where cv2 gives no image and where the
    file needs what is not ported."""
    cs, color = _container(data)
    comps, planes, origin = _codestream(cs)
    n = len(comps)
    if any(c[1] for c in comps):
        raise _refused("JPEG 2000: signed components")
    max_prec = max(c[0] for c in comps)
    if max_prec < 8:
        raise _refused(f"JPEG 2000: a precision of {max_prec} bits (OpenCV "
                       f"reads 8 or more)")
    if color.pclr is not None and color.cmap is not None:
        planes = _apply_pclr(color, planes)
        n = len(planes)
    if color.cdef is not None:
        planes = _apply_cdef(color, planes)
    if origin != (0, 0) or any(c[2] != 1 or c[3] != 1 for c in comps):
        raise _refused("JPEG 2000: a non-zero image origin or sub-sampled "
                       "components (OpenCV: tiles are not supported)")
    if n > 4:
        raise ValueError(f"JPEG 2000: {n} components: OpenCV's conversion "
                         f"of more than 4 is not ported")
    shift = max(0, max_prec - 8)
    u8 = [(p >> shift).astype(np.uint8) for p in planes]
    cs_kind = {16: "srgb", 17: "gray", 18: "sycc", 12: "cmyk",
               24: "esycc"}.get(color.enumcs, "srgb")
    if cs_kind in ("cmyk", "esycc"):
        raise _refused(f"JP2: colour space {color.enumcs} ({cs_kind}), "
                       f"which OpenCV does not convert")
    if cs_kind == "gray" or (n <= 2 and channels == 1):
        img = u8[0][..., None]
        return img if channels == 1 else np.repeat(img, 3, axis=2)
    if n <= 2:
        raise _refused(f"JPEG 2000: {n} component(s) in an sRGB (or "
                       f"unstated) colour space, which OpenCV does not "
                       f"convert to 3 channels")
    if cs_kind == "sycc":
        if channels == 1:
            return u8[0][..., None]
        return _yuv_to_rgb(u8[0], u8[1], u8[2])
    rgb = np.stack(u8[:3], -1)
    if channels == 3:
        return rgb
    return cvt_gray(rgb)


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body) + 8) + kind + body


def encode_jp2(image: np.ndarray) -> bytes:
    """(H, W, 3) RGB or (H, W[, 1]) gray uint8 -> the JP2 file
    cv2.imwrite writes for it (module docstring): the signature, ftyp
    (brand and compatibility "jp2 "), jp2h (ihdr: 8-bit unsigned, type
    7; colr: enumerated sRGB or gray), then the codestream in jp2c.
    OSError, as cv2.imwrite refuses it, for an image under 32 pixels a
    side (too small for OpenJPEG's 5 decomposition levels)."""
    from yolo_tpu_torch.native.build import library
    from yolo_tpu_torch.native.preproc import _image_u8

    img = _image_u8(image)
    h, w, c = img.shape
    if h < 32 or w < 32:
        raise OSError(f"cannot write a {w}x{h} image as JPEG 2000: OpenJPEG "
                      f"needs 32 pixels a side for its 5 resolutions "
                      f"(cv2.imwrite refuses it too)")
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", h, w, c, 7, 7, 0, 0))
    colr = _box(b"colr", struct.pack(">BBBI", 1, 0, 0, 16 if c == 3 else 17))
    head = SIGNATURE + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ") + \
        _box(b"jp2h", ihdr + colr)
    lib = library()
    out, n = ctypes.c_void_p(), ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_LEN)
    # the bytes ahead of the codestream count against its budget
    if lib.yolo_j2k_encode(img.ctypes.data, h, w, c, len(head) + 8,
                           ctypes.byref(out), ctypes.byref(n), err,
                           _ERR_LEN):
        raise ValueError(err.value.decode())
    try:
        cs = ctypes.string_at(out.value, n.value)
    finally:
        lib.yolo_native_free(out)
    return head + _box(b"jp2c", cs)


def _yuv_to_rgb(y, u, v) -> np.ndarray:
    """cv2.cvtColor(COLOR_YUV2BGR) for 8 bits, as RGB: BT.601 YUV in 14-bit
    fixed point (V2R 18678, V2G -9519, U2G -6472, U2B 33292), rounded,
    saturated."""
    y = y.astype(np.int32)
    u = u.astype(np.int32) - 128
    v = v.astype(np.int32) - 128
    half = 1 << 13
    r = y + ((v * 18678 + half) >> 14)
    g = y + ((u * -6472 + v * -9519 + half) >> 14)
    b = y + ((u * 33292 + half) >> 14)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)
