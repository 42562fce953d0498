"""GIF decoding for the port's host decoder: the first frame as OpenCV
5's own GIF decoder (grfmt_gif.cpp, not giflib) gives it to
cv2.imread / cv2.imdecode, after COLOR_BGR2RGB at 3 channels,
IMREAD_GRAYSCALE's at 1. The blocks and the canvas are read here, the
LZW codes in C (native/gif.c):

  * GIF87a and GIF89a; the whole file is walked first: extensions and
    images with their sub-blocks up to the trailer (a file without one,
    a graphic control extension not of 4 bytes, an application
    extension other than NETSCAPE2.0, or an unknown block is no image in
    cv2); the first image is the one decoded (an animation gives its
    first frame);
  * the canvas is the logical screen, filled with the global table's
    background entry (a background index past that table is no image in
    cv2), or black without a global table; the first frame is drawn at
    its offset (a frame past the canvas or of no pixels, or a disposal
    method above 3 in its graphic control extension, is no image);
  * the frame's colours come from its local table, else the global one,
    else a table of gray levels i (but for entry 1, white); an index
    past its table is no image in cv2. Pixels of the graphic control
    extension's transparent index keep the canvas's colour;
  * interlaced rows are put back in order;
  * gray: cv2.cvtColor(COLOR_BGR2GRAY) of the colour canvas, its
    weights 9798, 19235, 3735 of 1 << 15, rounded.

A stream whose data after the last pixel is more than an end code and
padding raises ValueError saying it is not reproduced here (native/
gif.c), as does an end code before the image is whole.

encode_gif writes what cv2.imwrite / cv2.imencode write at their
defaults (OpenCV 5's own encoder, IMWRITE_GIF_FAST_FLOYD_DITHER), byte
for byte: the blocks here, the error diffusion onto the fixed 3-3-2
palette and the LZW stream in C (native/gif_enc.c). cv2 refuses gray
images (an assertion in its ditheringKernel), and so does encode_gif.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

NO_IMAGE = "; cv2 gives no image either"
SIGNATURES = (b"GIF87a", b"GIF89a")
_ERR_LEN = 256

# what cv2.imwrite writes around the image data, whatever the image: the
# logical screen's flags (a global table of 256 entries, 8-bit colour
# resolution), background 0 and aspect 0; the fixed 3-3-2 table (R and
# G at 36 k, B at 85 k; entry r << 5 | g << 2 | b); NETSCAPE2.0 looping
# forever; a graphic control extension of disposal 3, a delay of 100 and
# no transparency; the image descriptor's flags (no local table)
_SCREEN_TAIL = bytes((0xF7, 0, 0))
PALETTE = np.array([((i >> 5) * 36, (i >> 2 & 7) * 36, (i & 3) * 85)
                    for i in range(256)], np.uint8)
_LOOP = b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
_CONTROL = b"\x21\xf9\x04\x0c\x64\x00\x00\x00"
_DESCRIPTOR_FLAGS = 0x07


def is_gif(data: bytes) -> bool:
    return data[:6] in SIGNATURES


def _table(data: bytes, pos: int, flags: int):
    """A colour table after a descriptor of these flags -> ((n, 3) RGB or
    None, position after it)."""
    if not flags & 0x80:
        return None, pos
    n = 2 << (flags & 7)
    if len(data) < pos + 3 * n:
        raise ValueError("truncated: the file ends inside a colour table"
                         + NO_IMAGE)
    return np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3), \
        pos + 3 * n


def _sub_blocks(data: bytes, pos: int):
    """Sub-blocks from pos -> (their data joined, position after the
    terminator)."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError("truncated: the file ends inside its "
                             "sub-blocks" + NO_IMAGE)
        n = data[pos]
        if n == 0:
            return b"".join(parts), pos + 1
        if len(data) < pos + 1 + n:
            raise ValueError("truncated: the file ends inside a sub-block"
                             + NO_IMAGE)
        parts.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n


def _first_frame(data: bytes, pos: int):
    """Walk the blocks to the trailer -> (graphic control of the first
    image or None, the first image's descriptor, local table, minimum
    code size, LZW data)."""
    gce, frame, pending = None, None, None
    while True:
        if pos >= len(data):
            raise ValueError("truncated: the file ends before its trailer"
                             + NO_IMAGE)
        kind = data[pos]
        if kind == 0x3B:
            break
        if kind == 0x21:
            if pos + 2 > len(data):
                raise ValueError("truncated: an extension without its label"
                                 + NO_IMAGE)
            label, size = data[pos + 1], data[pos + 2:pos + 3]
            body, pos = _sub_blocks(data, pos + 2)
            if label == 0xF9:
                if size != b"\x04" or len(body) != 4:
                    raise ValueError("corrupt: a graphic control extension "
                                     "not of 4 bytes" + NO_IMAGE)
                if frame is None:
                    pending = body
            elif label == 0xFF and (size != b"\x0b" or
                                    body[:11] != b"NETSCAPE2.0"):
                raise ValueError(f"unsupported: application extension "
                                 f"{body[:11]!r} (OpenCV 5 reads NETSCAPE2.0 "
                                 f"only)" + NO_IMAGE)
            continue
        if kind != 0x2C:
            raise ValueError(f"corrupt: a block of kind 0x{kind:02x}"
                             + NO_IMAGE)
        if len(data) < pos + 11:
            raise ValueError("truncated: an image descriptor" + NO_IMAGE)
        x, y, w, h, flags = struct.unpack_from("<HHHHB", data, pos + 1)
        table, pos = _table(data, pos + 10, flags)
        if pos >= len(data):
            raise ValueError("truncated: an image without its code size"
                             + NO_IMAGE)
        mcs = data[pos]
        lzw, pos = _sub_blocks(data, pos + 1)
        if frame is None:
            frame = (x, y, w, h, flags, table, mcs, lzw)
            gce = pending
    if frame is None:
        raise ValueError("corrupt: a GIF of no image" + NO_IMAGE)
    return gce, frame


def _default_table() -> np.ndarray:
    t = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    t[1] = 255
    return t


def _deinterlace(idx: np.ndarray) -> np.ndarray:
    h = idx.shape[0]
    order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                            np.arange(2, h, 4), np.arange(1, h, 2)])
    out = np.empty_like(idx)
    out[order] = idx
    return out


def decode_gif(data: bytes, channels: int = 3) -> np.ndarray:
    """GIF bytes -> (H, W, channels) uint8 of the first frame, RGB or
    gray, as cv2 reads it; ValueError where cv2 gives no image or where
    its result is not reproduced (module docstring)."""
    from yolo_tpu_torch.native.build import library

    if not is_gif(data) or len(data) < 13:
        raise ValueError("not a GIF file" + NO_IMAGE)
    cw, ch, flags, bg, _ = struct.unpack_from("<HHBBB", data, 6)
    if cw == 0 or ch == 0:
        raise ValueError(f"corrupt: a {cw}x{ch} canvas" + NO_IMAGE)
    gtable, pos = _table(data, 13, flags)
    if gtable is not None and bg >= len(gtable):
        raise ValueError(f"corrupt: background index {bg} past a table of "
                         f"{len(gtable)}" + NO_IMAGE)
    gce, (x, y, w, h, fflags, ltable, mcs, lzw) = _first_frame(data, pos)
    if gce is not None and (gce[0] >> 2) & 7 > 3:
        raise ValueError(f"corrupt: disposal method {(gce[0] >> 2) & 7} of "
                         f"the first frame" + NO_IMAGE)
    if w == 0 or h == 0 or x + w > cw or y + h > ch:
        raise ValueError(f"corrupt: a {w}x{h} frame at ({x}, {y}) on a "
                         f"{cw}x{ch} canvas" + NO_IMAGE)
    table = ltable if ltable is not None else (
        gtable if gtable is not None else _default_table())
    idx = np.empty(w * h, np.uint8)
    src = np.frombuffer(lzw, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = library().yolo_gif_lzw_decode(src.ctypes.data, src.size, mcs,
                                       idx.ctypes.data, idx.size, err,
                                       _ERR_LEN)
    if rc:
        raise ValueError(err.value.decode())
    idx = idx.reshape(h, w)
    if fflags & 0x40:
        idx = _deinterlace(idx)
    if int(idx.max()) >= len(table):
        raise ValueError(f"corrupt: colour index {int(idx.max())} past a "
                         f"table of {len(table)}" + NO_IMAGE)
    frame = np.take(table, idx, axis=0)
    transparent = gce is not None and gce[0] & 1
    if (w, h) == (cw, ch) and not transparent:
        canvas = frame
    else:
        canvas = np.zeros((ch, cw, 3), np.uint8)
        if gtable is not None:
            canvas[:] = gtable[bg]
        if transparent:
            frame = np.where((idx == gce[3])[..., None],
                             canvas[y:y + h, x:x + w], frame)
        canvas[y:y + h, x:x + w] = frame
    if channels == 3:
        return canvas
    s = canvas.astype(np.int32)
    return ((s[..., 0] * 9798 + s[..., 1] * 19235 + s[..., 2] * 3735 + 16384)
            >> 15).astype(np.uint8)[..., None]


def encode_gif(image: np.ndarray) -> bytes:
    """(H, W, 3) RGB uint8 -> the GIF file that cv2.imencode('.gif',
    image[..., ::-1]) gives at its defaults (module docstring). OSError
    for a gray image or a side past 65535, which cv2 refuses too."""
    from yolo_tpu_torch.native.build import library
    from yolo_tpu_torch.native.preproc import _image_u8

    img = _image_u8(image)
    h, w, c = img.shape
    if c != 3:
        raise OSError("cannot write a gray image as GIF: OpenCV's GIF "
                      "encoder takes colour only (cv2.imwrite refuses it "
                      "too)")
    lib = library()
    out, n = ctypes.c_void_p(), ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.yolo_gif_encode(img.ctypes.data, h, w, ctypes.byref(out),
                           ctypes.byref(n), err, _ERR_LEN):
        raise OSError(err.value.decode())
    try:
        data = ctypes.string_at(out.value, n.value)
    finally:
        lib.yolo_native_free(out)
    screen = b"GIF89a" + struct.pack("<HH", w, h) + _SCREEN_TAIL
    descriptor = b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h,
                                        _DESCRIPTOR_FLAGS)
    return screen + PALETTE.tobytes() + _LOOP + _CONTROL + descriptor + \
        data + b"\x3b"
