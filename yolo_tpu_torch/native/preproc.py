"""Host image decoding for the port (the counterpart of
yolo_tpu/native/preproc.py), with no OpenCV and no system image library:
JPEG through the port's own decoder (native/jpeg.c), PNG through zlib and
the C unfilter (data/png.py, native/png.c). Both give the bytes
cv2.imread / cv2.imdecode give after COLOR_BGR2RGB (EXIF orientation
applied), and raise ValueError, naming the file and the reason, for what
they do not decode: progressive, lossless, arithmetic, hierarchical,
12-bit, CMYK/YCCK or multi-scan JPEGs, corrupt or truncated data,
interlaced PNGs, and other formats.

decode_letterbox_batch decodes a list of files on a thread pool (each C
call releases the interpreter lock) and letterboxes them with the
pipeline's host letterbox (data/pipeline.py::_host_resize).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from yolo_tpu_torch.data.png import SIGNATURE as PNG_SIGNATURE
from yolo_tpu_torch.data.png import decode_png
from yolo_tpu_torch.native.build import library

JPEG_SOI = b"\xff\xd8"
_ERR_LEN = 256


def _check_channels(channels: int) -> None:
    if channels not in (1, 3):
        raise ValueError(f"channels={channels}: image decoding supports 1 "
                         f"(grayscale) or 3 (RGB)")


def decode_jpeg(data: bytes, channels: int = 3) -> np.ndarray:
    """JPEG bytes -> (H, W, channels) uint8; ValueError on failure."""
    lib = library()
    src = np.frombuffer(data, np.uint8)
    out = ctypes.c_void_p()
    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.yolo_jpeg_decode(src.ctypes.data, len(data), channels,
                            ctypes.byref(out), ctypes.byref(h),
                            ctypes.byref(w), err, _ERR_LEN):
        raise ValueError(err.value.decode())
    try:
        n = h.value * w.value * channels
        img = np.frombuffer((ctypes.c_uint8 * n).from_address(out.value),
                            np.uint8).reshape(h.value, w.value,
                                              channels).copy()
    finally:
        lib.yolo_native_free(out)
    return img


def decode_image_bytes(data: bytes, channels: int = 3,
                       name: str = "image bytes") -> np.ndarray:
    """In-memory JPEG/PNG decode (serving uploads) -> (H, W, channels)
    uint8: RGB at channels=3, gray at channels=1 (cv2.IMREAD_GRAYSCALE's
    gray). Raises ValueError naming ``name`` and the reason."""
    _check_channels(channels)
    data = bytes(data)
    try:
        if data[:2] == JPEG_SOI:
            return decode_jpeg(data, channels)
        if data[:8] == PNG_SIGNATURE:
            return decode_png(data, channels)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    raise ValueError(f"{name}: not a JPEG or PNG file")


def decode_image(path: str, channels: int = 3) -> np.ndarray:
    """JPEG/PNG file -> (H, W, channels) uint8, as decode_image_bytes.
    A missing file raises FileNotFoundError."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_image_bytes(data, channels, name=os.fspath(path))


def decode_letterbox_batch(paths, net, n_threads: int = 8,
                           channels: int = 3):
    """Decode N files and letterbox each to net (int or (net_h, net_w))
    on n_threads threads -> (batch (N, net_h, net_w, channels) float32 in
    [0, 1], dims (N, 2) int32 source (h, w), ok (N,) bool). A file that
    does not decode leaves ok False, dims 0 and its slot zero."""
    from yolo_tpu_torch.data.pipeline import _Pool, _host_resize
    from yolo_tpu_torch.ops.letterbox import as_hw

    _check_channels(channels)
    net_h, net_w = as_hw(net)
    n = len(paths)
    batch = np.zeros((n, net_h, net_w, channels), np.float32)
    dims = np.zeros((n, 2), np.int32)
    ok = np.zeros(n, bool)

    def one(i):
        try:
            img = decode_image(paths[i], channels)
        except (OSError, ValueError):
            return
        batch[i] = _host_resize(img, (net_h, net_w), "letterbox")
        dims[i] = img.shape[:2]
        ok[i] = True

    with _Pool(max(1, min(n_threads, n))) as pool:
        list(pool.map(one, range(n)))
    return batch, dims, ok
