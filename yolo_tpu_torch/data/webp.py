"""WebP decoding for the port's host decoder: the bytes cv2.imread /
cv2.imdecode give (OpenCV 5's grfmt_webp.cpp on libwebp 1.x) after
COLOR_BGR2RGB at 3 channels, IMREAD_GRAYSCALE's at 1. The RIFF chunks
are read here; the bitstreams in C (native/webp_lossless.c for "VP8L",
native/webp_lossy.c for "VP8 ", with libwebp's fancy upsampling and
YUV -> RGB):

  * a simple file (one VP8 or VP8L chunk) or an extended one (VP8X):
    its ALPH chunk (or a VP8L image's alpha) is dropped, as IMREAD_COLOR
    drops it (libwebp's RGBA is not premultiplied, so the colours do not
    change);
  * an animation: its first frame, drawn on a transparent canvas of the
    VP8X size at the frame's offset (WebPAnimDecoder), alpha dropped, so
    what lies outside the frame is black;
  * the EXIF chunk's orientation, applied as cv2 applies it;
  * gray: cv2.cvtColor(COLOR_BGR2GRAY) of the colour image, its weights
    9798, 19235, 3735 of 1 << 15, rounded.

A file libwebp refuses raises ValueError saying that cv2 gives no image
either.

encode_webp writes what cv2.imwrite writes for .webp by default, a
lossless (VP8L) file, through the port's own encoder
(native/webp_lossless_enc.c): the same pixels, not libwebp's bytes.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from yolo_tpu_torch.data.png import apply_orientation, exif_orientation

NO_IMAGE = "; cv2 gives no image either"


def is_webp(data: bytes) -> bool:
    return len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _chunks(body: bytes, what: str = "the data"):
    """The chunks of a RIFF body (or an ANMF payload) -> [(fourcc,
    payload)]; a chunk past the end raises."""
    out, pos = [], 0
    while pos + 8 <= len(body):
        tag = body[pos:pos + 4]
        (size,) = struct.unpack_from("<I", body, pos + 4)
        if pos + 8 + size > len(body):
            raise ValueError(f"truncated: chunk {tag!r} runs past {what}"
                             + NO_IMAGE)
        out.append((tag, body[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _bitstream(chunks) -> np.ndarray:
    """The first VP8 / VP8L bitstream among chunks -> (h, w, 3) RGB."""
    from yolo_tpu_torch.native.preproc import _decode_c

    for tag, payload in chunks:
        if tag == b"VP8L":
            return _decode_c("yolo_webp_decode_vp8l", payload, 4)[..., :3]
        if tag == b"VP8 ":
            return _decode_c("yolo_webp_decode_vp8", payload, 3)
    raise ValueError("corrupt: no VP8 or VP8L bitstream" + NO_IMAGE)


def _u24(b: bytes, off: int) -> int:
    return b[off] | b[off + 1] << 8 | b[off + 2] << 16


def _exif_orientation(chunks) -> int:
    for tag, payload in chunks:
        if tag == b"EXIF":
            return exif_orientation(payload)
    return 1


def _first_frame(chunks, canvas_w: int, canvas_h: int) -> np.ndarray:
    for tag, payload in chunks:
        if tag != b"ANMF":
            continue
        if len(payload) < 16:
            raise ValueError("corrupt: an ANMF chunk of its header only"
                             + NO_IMAGE)
        x, y = 2 * _u24(payload, 0), 2 * _u24(payload, 3)
        fw, fh = _u24(payload, 6) + 1, _u24(payload, 9) + 1
        frame = _bitstream(_chunks(payload[16:], "its frame"))
        if frame.shape[:2] != (fh, fw) or x + fw > canvas_w or \
                y + fh > canvas_h:
            raise ValueError("corrupt: a frame outside its canvas" + NO_IMAGE)
        out = np.zeros((canvas_h, canvas_w, 3), np.uint8)
        out[y:y + fh, x:x + fw] = frame
        return out
    raise ValueError("corrupt: an animation without frames" + NO_IMAGE)


def decode_webp(data: bytes, channels: int = 3) -> np.ndarray:
    """WebP bytes -> (H, W, channels) uint8, RGB or gray, as cv2 reads
    them; ValueError where cv2 gives no image."""
    if not is_webp(data):
        raise ValueError("not a WebP file" + NO_IMAGE)
    (riff_size,) = struct.unpack_from("<I", data, 4)
    if riff_size < 12 or riff_size + 8 > len(data):
        raise ValueError("truncated: the RIFF size runs past the data"
                         + NO_IMAGE)
    chunks = _chunks(data[12:riff_size + 8])
    if not chunks:
        raise ValueError("corrupt: a RIFF file of no chunks" + NO_IMAGE)
    o = 1
    if chunks[0][0] == b"VP8X":
        head = chunks[0][1]
        if len(head) < 10:
            raise ValueError("corrupt: a short VP8X chunk" + NO_IMAGE)
        canvas_w, canvas_h = _u24(head, 4) + 1, _u24(head, 7) + 1
        if head[0] & 0x02:                       # animation
            rgb = _first_frame(chunks[1:], canvas_w, canvas_h)
        else:
            rgb = _bitstream(chunks[1:])
            if rgb.shape[:2] != (canvas_h, canvas_w):
                raise ValueError("corrupt: the image is not the VP8X size"
                                 + NO_IMAGE)
        if head[0] & 0x08:                       # EXIF
            o = _exif_orientation(chunks[1:])
    else:
        rgb = _bitstream(chunks[:1])
    rgb = apply_orientation(rgb, o)
    return rgb if channels == 3 else cvt_gray(rgb)


def cvt_gray(rgb: np.ndarray) -> np.ndarray:
    """(h, w, 3) RGB uint8 -> (h, w, 1): cv2.cvtColor(COLOR_BGR2GRAY) of
    the BGR image, weights 9798, 19235, 3735 of 1 << 15, rounded."""
    s = rgb.astype(np.int32)
    return ((s[..., 0] * 9798 + s[..., 1] * 19235 + s[..., 2] * 3735 + 16384)
            >> 15).astype(np.uint8)[..., None]


def encode_webp(image: np.ndarray, predictor: int = -1) -> bytes:
    """(H, W, 3) RGB or (H, W[, 1]) gray uint8 -> a lossless WebP file
    (RIFF, one VP8L chunk) of exactly these pixels; gray is written as
    RGB of three equal channels, as cv2.imwrite writes it. predictor
    0..13 forces every tile's predictor mode (-1: each tile's cheapest)."""
    from yolo_tpu_torch.native.build import library

    img = np.asarray(image, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, 2)
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    lib = library()
    out, n = ctypes.c_void_p(), ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    if lib.yolo_webp_encode_vp8l(img.ctypes.data, w, h, predictor,
                                 ctypes.byref(out), ctypes.byref(n), err,
                                 256):
        raise ValueError(err.value.decode())
    try:
        payload = ctypes.string_at(out.value, n.value)
    finally:
        lib.yolo_native_free(out)
    chunk = b"VP8L" + struct.pack("<I", len(payload)) + payload + \
        b"\0" * (len(payload) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk
