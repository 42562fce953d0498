"""Host image decoding for the port (the counterpart of
yolo_tpu/native/preproc.py), with no OpenCV and no system image library.
The decoder is chosen by the file's signature, as cv2 chooses it (never
by the extension), and gives the bytes cv2.imread / cv2.imdecode give
after COLOR_BGR2RGB (IMREAD_COLOR) or those of IMREAD_GRAYSCALE:

  * JPEG (native/jpeg.c): baseline, multi-scan, progressive and
    arithmetic-coded, CMYK and YCCK, 8-bit lossless where libjpeg-turbo
    converts it, EXIF orientation applied; coefficients that overflow
    the IDCT saturate as libjpeg-turbo's SIMD IDCT saturates them, and
    damaged scans decode as libjpeg decodes them (bad codes, data cut by
    a marker, lost or wrong restart markers);
  * PNG (data/png.py, native/png.c): every type, interlaced or not, gray
    in linear light where a gamma is stated;
  * BMP (native/bmp.c): 1-32 bits, palettes, RLE4 / RLE8, bit fields,
    core and V4 / V5 headers;
  * PNM and PAM (data/pnm.py): P1-P7, ASCII and binary;
  * TIFF (data/tiff.py, native/tiff.c): libtiff's RGBA reading of the
    first page, strips or tiles, none / PackBits / LZW / Deflate / JPEG;
  * WebP (data/webp.py, native/webp_lossless.c, native/webp_lossy.c):
    lossless and lossy, alpha dropped, an animation's first frame, EXIF
    orientation;
  * GIF (data/gif.py, native/gif.c): GIF87a / GIF89a, the first frame
    on its canvas, global and local tables, interlace, transparency;
  * Sun raster (data/sunras.py): depths 1, 8, 24 and 32, colour maps;
  * PFM (data/pfm.py): RGB and gray, both byte orders, the scale;
  * Radiance HDR (data/hdr.py, native/hdr.c): flat and run-length
    scanlines, converted to 8 bits as cv2 converts them;
  * JPEG 2000 (data/jp2.py, native/j2k.c, j2k_t2.c, j2k_t1.c,
    j2k_dwt.c): JP2 files and raw J2K codestreams, Part 1 whole (every
    progression order, code-block style, tiling, POC, PPM / PPT, ROI,
    5/3 and 9/7), converted to 8 bits as OpenCV converts OpenJPEG's
    components.

What cv2 gives no image for raises ValueError naming the file and
saying so (hierarchical or 12-bit JPEGs, truncated files, ...), as do
the format not ported (AVIF) and the few kinds each
decoder names where cv2 gives an image that is not reproduced here. No
path hands a file to cv2 or PIL.

letterbox_batch and stretch are the host resizes of the loaders
(native/letterbox.c): the bytes of the JAX package's native
letterbox_batch, on threads of its own, and of its
numpy_ref.stretch_resize. decode_letterbox_batch decodes a list of
files on a thread pool (each C call releases the interpreter lock) and
letterboxes each.

encode_jpeg writes the JPEG cv2.imwrite writes (native/jpeg_enc.c);
gaussian_blur_u8, warp_affine_u8 and hsv2rgb_u8 are cv2.GaussianBlur,
cv2.warpAffine and cv2.cvtColor(COLOR_HSV2RGB) as the training
augmentation calls them (native/resample.c).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from yolo_tpu_torch.data.gif import decode_gif, is_gif
from yolo_tpu_torch.data.hdr import decode_hdr, is_hdr
from yolo_tpu_torch.data.jp2 import decode_jp2, is_jp2
from yolo_tpu_torch.data.pfm import decode_pfm, is_pfm
from yolo_tpu_torch.data.png import SIGNATURE as PNG_SIGNATURE
from yolo_tpu_torch.data.png import decode_png
from yolo_tpu_torch.data.pnm import decode_pnm, is_pnm
from yolo_tpu_torch.data.sunras import decode_sunras, is_sunras
from yolo_tpu_torch.data.tiff import decode_tiff, is_tiff
from yolo_tpu_torch.data.webp import decode_webp, is_webp
from yolo_tpu_torch.native.build import library

JPEG_SOI = b"\xff\xd8"
READ_FORMATS = ("JPEG, PNG, BMP, PNM, TIFF, WebP, GIF, Sun raster, PFM, HDR, "
                "JPEG 2000")
_ERR_LEN = 256


def _check_channels(channels: int) -> None:
    if channels not in (1, 3):
        raise ValueError(f"channels={channels}: image decoding supports 1 "
                         f"(grayscale) or 3 (RGB)")


def _decode_c(fn: str, data: bytes, channels: int) -> np.ndarray:
    """One of the C whole-file decoders (build.DECODERS) -> (H, W,
    channels) uint8; ValueError with its message on failure."""
    lib = library()
    src = np.frombuffer(data, np.uint8)
    out = ctypes.c_void_p()
    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if getattr(lib, fn)(src.ctypes.data, len(data), channels,
                        ctypes.byref(out), ctypes.byref(h), ctypes.byref(w),
                        err, _ERR_LEN):
        raise ValueError(err.value.decode())
    try:
        n = h.value * w.value * channels
        img = np.frombuffer((ctypes.c_uint8 * n).from_address(out.value),
                            np.uint8).reshape(h.value, w.value,
                                              channels).copy()
    finally:
        lib.yolo_native_free(out)
    return img


def decode_jpeg(data: bytes, channels: int = 3) -> np.ndarray:
    """JPEG bytes -> (H, W, channels) uint8; ValueError on failure."""
    return _decode_c("yolo_jpeg_decode", data, channels)


def decode_bmp(data: bytes, channels: int = 3) -> np.ndarray:
    """BMP bytes -> (H, W, channels) uint8 (native/bmp.c); ValueError on
    failure."""
    return _decode_c("yolo_bmp_decode", data, channels)


def decode_jpeg_components(data: bytes, ycbcr: bool) -> np.ndarray:
    """A TIFF strip or tile's JPEG stream -> (H, W, 3) uint8, libjpeg
    converting from YCbCr only where ycbcr is set (libtiff's colour
    modes); a 1-component stream repeats its samples."""
    return _decode_c("yolo_jpeg_decode_ycc" if ycbcr
                     else "yolo_jpeg_decode_raw", data, 3)


def _decode(data: bytes, channels: int, name: str,
            from_file: bool) -> np.ndarray:
    """The decoder the file's signature names, as cv2 chooses it (never
    by the extension); from_file: as cv2.imread (rather than imdecode)
    gives it, which differs for TIFF orientations 5-8."""
    _check_channels(channels)
    data = bytes(data)
    try:
        if data[:2] == JPEG_SOI:
            return decode_jpeg(data, channels)
        if data[:8] == PNG_SIGNATURE:
            return decode_png(data, channels)
        if data[:2] == b"BM":
            return decode_bmp(data, channels)
        if is_pnm(data):
            return decode_pnm(data, channels)
        if is_tiff(data):
            return decode_tiff(data, channels, from_file)
        if is_webp(data):
            return decode_webp(data, channels)
        if is_gif(data):
            return decode_gif(data, channels)
        if is_sunras(data):
            return decode_sunras(data, channels)
        if is_pfm(data):
            return decode_pfm(data, channels)
        if is_hdr(data):
            return decode_hdr(data, channels)
        if is_jp2(data):
            return decode_jp2(data, channels)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    raise ValueError(f"{name}: not an image format the decoder reads "
                     f"({READ_FORMATS}; AVIF is not ported)")


def decode_image_bytes(data: bytes, channels: int = 3,
                       name: str = "image bytes") -> np.ndarray:
    """In-memory decode (serving uploads) of JPEG, PNG, BMP, PNM, TIFF,
    WebP, GIF, Sun raster, PFM, HDR or JPEG 2000 bytes -> (H, W,
    channels) uint8:
    RGB at channels=3, gray at
    channels=1, the bytes cv2.imdecode gives (IMREAD_COLOR then
    COLOR_BGR2RGB, or IMREAD_GRAYSCALE). Raises ValueError naming
    ``name`` and the reason."""
    return _decode(data, channels, name, from_file=False)


def decode_image(path: str, channels: int = 3) -> np.ndarray:
    """An image file -> (H, W, channels) uint8, the bytes cv2.imread
    gives, as decode_image_bytes (a TIFF of orientation 5-8, which
    OpenCV 5.0.0's imread gives no image for, raises). A missing file
    raises FileNotFoundError."""
    with open(path, "rb") as f:
        data = f.read()
    return _decode(data, channels, os.fspath(path), from_file=True)


def available() -> bool:
    """Whether the host library builds and loads here (it needs a C
    compiler the first time); the functions of this module raise where
    it does not, having no other implementation to fall back on."""
    try:
        library()
    except (OSError, RuntimeError):
        return False
    return True


def letterbox_batch(images_u8: np.ndarray, net,
                    n_threads: int = 8) -> np.ndarray:
    """(B, H, W, C) uint8, C = 1 (gray) or 3 (RGB) -> (B, net_h, net_w, C)
    float32 in [0, 1] on a gray (0.5) canvas; net: int (square) or
    (net_h, net_w). cv2.INTER_LINEAR with half-pixel centres, the bytes
    of the JAX package's native letterbox_batch, on min(n_threads, B)
    threads. Any other C raises ValueError."""
    from yolo_tpu_torch.ops.letterbox import as_hw

    net_h, net_w = as_hw(net)
    src = np.ascontiguousarray(images_u8, dtype=np.uint8)
    if src.ndim != 4:
        raise ValueError(f"expected (B, H, W, C) uint8 images, got shape "
                         f"{src.shape}")
    b, h, w, c = src.shape
    out = np.empty((b, net_h, net_w, c), np.float32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().yolo_letterbox_batch(src.ctypes.data, b, h, w, c,
                                      out.ctypes.data, net_h, net_w,
                                      int(n_threads), err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return out


def stretch(image_u8: np.ndarray, net) -> np.ndarray:
    """(H, W, C) uint8, C = 1 or 3 -> (net_h, net_w, C) float32 in [0, 1],
    aspect ratio not kept: the bytes of the JAX package's host stretch
    (numpy_ref.stretch_resize, cv2.resize INTER_LINEAR of the image / 255
    on OpenCV's Intel IPP path; native/letterbox.c)."""
    from yolo_tpu_torch.ops.letterbox import as_hw

    net_h, net_w = as_hw(net)
    src = np.ascontiguousarray(image_u8, dtype=np.uint8)
    if src.ndim != 3:
        raise ValueError(f"expected an (H, W, C) uint8 image, got shape "
                         f"{src.shape}")
    h, w, c = src.shape
    out = np.empty((net_h, net_w, c), np.float32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().yolo_stretch(src.ctypes.data, h, w, c, out.ctypes.data,
                              net_h, net_w, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return out


def decode_letterbox_batch(paths, net, n_threads: int = 8,
                           channels: int = 3):
    """Decode N files and letterbox each to net (int or (net_h, net_w))
    on n_threads threads -> (batch (N, net_h, net_w, channels) float32 in
    [0, 1], dims (N, 2) int32 source (h, w), ok (N,) bool). A file that
    does not decode leaves ok False, dims 0 and its slot zero."""
    from yolo_tpu_torch.data.pipeline import _Pool
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
        batch[i] = letterbox_batch(img[None], (net_h, net_w), 1)[0]
        dims[i] = img.shape[:2]
        ok[i] = True

    with _Pool(max(1, min(n_threads, n))) as pool:
        list(pool.map(one, range(n)))
    return batch, dims, ok


def _image_u8(img: np.ndarray) -> np.ndarray:
    """(H, W) or (H, W, 1 | 3) uint8 -> a C-contiguous (H, W, C) array."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"expected a uint8 image, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"expected an (H, W[, 1 | 3]) image, got shape "
                         f"{img.shape}")
    return np.ascontiguousarray(img)


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) RGB or (H, W[, 1]) gray uint8 -> baseline JPEG bytes,
    the file cv2.imwrite writes at this quality (native/jpeg_enc.c)."""
    img = _image_u8(image)
    h, w, c = img.shape
    lib = library()
    out, n = ctypes.c_void_p(), ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.yolo_jpeg_encode(img.ctypes.data, h, w, c, int(quality),
                            ctypes.byref(out), ctypes.byref(n), err,
                            _ERR_LEN):
        raise ValueError(err.value.decode())
    try:
        return ctypes.string_at(out.value, n.value)
    finally:
        lib.yolo_native_free(out)


def gaussian_blur_u8(img: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.GaussianBlur(img, (ksize, ksize), 0) for uint8 with 1 or 3
    channels, byte for byte (BORDER_REFLECT_101). Keeps img's shape: an
    (H, W, 1) image stays 3-D, where cv2 drops the channel axis."""
    src = _image_u8(img)
    h, w, c = src.shape
    dst = np.empty_like(src)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().yolo_gaussian_blur_u8(src.ctypes.data, h, w, c,
                                       int(ksize), dst.ctypes.data, err,
                                       _ERR_LEN):
        raise ValueError(err.value.decode())
    return dst.reshape(np.shape(img))


def hsv2rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) for (H, W, 3) uint8, hue range
    180, byte for byte as OpenCV 5's AVX2 build computes it
    (native/resample.c)."""
    src = np.ascontiguousarray(hsv, dtype=np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got shape "
                         f"{src.shape}")
    h, w, _ = src.shape
    dst = np.empty_like(src)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().yolo_hsv2rgb_u8(src.ctypes.data, h, w, dst.ctypes.data,
                                 err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return dst


def warp_affine_u8(img: np.ndarray, m: np.ndarray, size) -> np.ndarray:
    """cv2.warpAffine(img, m, size, flags=INTER_LINEAR |
    WARP_INVERSE_MAP, borderMode=BORDER_REPLICATE) for uint8 with 1 or 3
    channels, byte for byte: output pixel (x, y) samples img at
    m @ (x, y, 1). m is 2x3 (float32 or float64; the warp rounds it to
    float32), size is (width, height). Returns (height, width, C), or
    (height, width) for a 2-D img."""
    src = _image_u8(img)
    sh, sw, c = src.shape
    dw, dh = (int(v) for v in size)
    mat = np.ascontiguousarray(np.asarray(m, np.float64).reshape(6))
    dst = np.empty((dh, dw, c), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().yolo_warp_affine_u8(src.ctypes.data, sh, sw, c,
                                     mat.ctypes.data, dh, dw,
                                     dst.ctypes.data, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return dst[..., 0] if np.ndim(img) == 2 else dst
