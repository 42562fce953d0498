"""Radiance HDR (RGBE) reading and writing for the port's host decoder
and save_image: the bytes OpenCV 5's grfmt_hdr.cpp and rgbe.cpp read
and write (cv2.imread / cv2.imdecode after COLOR_BGR2RGB at 3 channels,
IMREAD_GRAYSCALE's at 1; cv2.imwrite's .hdr). The header is read here,
the pixels in C (native/hdr.c):

  * the header, line by line as fgets reads them (at most 127 bytes a
    line): ``#?`` and a program type, then lines up to a blank one, of
    which one must be exactly ``FORMAT=32-bit_rle_rgbe`` (GAMMA,
    EXPOSURE and the rest are not applied), then ``-Y <h> +X <w>``
    (sscanf's pattern: another orientation is no image in cv2);
  * the pixels (native/hdr.c): new run-length scanlines, or flat from
    the first scanline that does not start with 2, 2; old run-length
    pixels read as pixels;
  * 8 bits: each channel times 255, rounded half to even, clamped; the
    file's R, G, B are the image's (OpenCV swaps them into its BGR);
  * gray: cv2.cvtColor(COLOR_BGR2GRAY) of the 8-bit colour image, its
    weights 9798, 19235, 3735 of 1 << 15, rounded.

encode_hdr writes what HdrEncoder writes: ``#?RADIANCE``, the FORMAT
line, a blank line, ``-Y <h> +X <w>``, then the pixels as value / 255
(a gray image as three equal channels).
"""

from __future__ import annotations

import ctypes
import re

import numpy as np

from yolo_tpu_torch.native.build import library

NO_IMAGE = "; cv2 gives no image either"
SIGNATURES = (b"#?RADIANCE", b"#?RGBE")
_ERR_LEN = 256
_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_SIZE = re.compile(rb"-Y[ \t\n\v\f\r]*([+-]?[0-9]+)[ \t\n\v\f\r]*\+X"
                   rb"[ \t\n\v\f\r]*([+-]?[0-9]+)")


def is_hdr(data: bytes) -> bool:
    return data.startswith(SIGNATURES)


def _fgets(data: bytes, pos: int):
    """One fgets(buf, 128) -> (line, position after it); None at the
    end of the data."""
    if pos >= len(data):
        return None, pos
    nl = data.find(b"\n", pos, pos + 127)
    end = nl + 1 if nl >= 0 else min(pos + 127, len(data))
    return data[pos:end], end


def read_header(data: bytes):
    """RGBE_ReadHeader as OpenCV 5 runs it -> (width, height, offset of
    the pixels); ValueError where it throws."""
    line, pos = _fgets(data, 0)
    line, pos = _fgets(data, pos)
    found = False
    while True:
        if line is None:
            raise ValueError("truncated: the header ends early" + NO_IMAGE)
        if line[:1] in (b"", b"\n", b"\0"):
            if found:
                break
            raise ValueError("corrupt: no FORMAT=32-bit_rle_rgbe line"
                             + NO_IMAGE)
        if line == _FORMAT:
            found = True
        line, pos = _fgets(data, pos)
    line, pos = _fgets(data, pos)
    m = _SIZE.match(line or b"")
    if m is None:
        raise ValueError("corrupt: no '-Y <height> +X <width>' line (other "
                         "orientations too)" + NO_IMAGE)
    h, w = int(m.group(1)), int(m.group(2))
    if w <= 0 or h <= 0:
        raise ValueError(f"corrupt: a {w}x{h} image" + NO_IMAGE)
    return w, h, pos


def decode_hdr(data: bytes, channels: int = 3) -> np.ndarray:
    """Radiance HDR bytes -> (H, W, channels) uint8, RGB or gray, as cv2
    reads them; ValueError where cv2 gives no image."""
    if not is_hdr(data):
        raise ValueError("not a Radiance HDR file" + NO_IMAGE)
    w, h, pos = read_header(data)
    rgb = np.empty((h, w, 3), np.uint8)
    src = np.frombuffer(data, np.uint8)[pos:]
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().yolo_hdr_decode_pixels(src.ctypes.data, src.size, w, h,
                                        rgb.ctypes.data, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    if channels == 3:
        return rgb
    s = rgb.astype(np.int32)
    return ((s[..., 0] * 9798 + s[..., 1] * 19235 + s[..., 2] * 3735 + 16384)
            >> 15).astype(np.uint8)[..., None]


def encode_hdr(image: np.ndarray) -> bytes:
    """(H, W, 3) RGB or (H, W[, 1]) gray uint8 -> the HDR cv2.imwrite
    writes (module docstring; the pixels in native/hdr.c)."""
    img = np.asarray(image, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, 2)
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    out = np.empty(5 * w * h + 4 * h + 16, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    n = library().yolo_hdr_encode_pixels(img.ctypes.data, w, h,
                                         out.ctypes.data, out.size, err,
                                         _ERR_LEN)
    if n < 0:
        raise ValueError(err.value.decode())
    return (b"#?RADIANCE\n" + _FORMAT + f"\n-Y {h} +X {w}\n".encode()
            + out[:n].tobytes())
