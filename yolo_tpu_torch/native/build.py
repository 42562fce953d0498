"""Build the port's host C library (``yolo_tpu_torch/native/*.c``: the
JPEG decoder and encoder, the PNG unfilter and pixel conversion, the
BMP, GIF, HDR, TIFF, WebP and JPEG 2000 codecs, the AV1 decoder of AVIF
files, the blur, warp and HSV -> RGB of the augmentation, the letterbox
and the stretch) and load it with ctypes.

The sources are compiled by the host C compiler (``cc``, else ``gcc``;
``CC`` overrides) with ``-O2 -std=c11 -fPIC -shared``, ``-lm`` and ``-lpthread``: no fast-math, no
``-march=native`` and (in ISO C mode) no contraction of multiply-adds,
since the code must give the same bytes on every machine. The library is named by a hash of the
sources, the flags and the compiler, and written to
``build/yolo_tpu_torch/native/`` beside the package (git-ignored) at
first use. Processes that build at once (pytest workers) take an
``fcntl`` lock, and each writes a temporary file that ``os.replace``
publishes. A failed build raises with the compiler's output; there is no
other decoder to fall back on.

Kept apart from ``ops/cuda/build.py``: the CPU tests need this library
and have no ``nvcc``. Loaded with ``ctypes.CDLL`` (not ``PyDLL``), so
every call releases the interpreter lock and decodes on several threads
run in parallel.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(NATIVE_DIR)),
                         "build", "yolo_tpu_torch", "native")
# the whole-file decoders: bytes -> a malloc'd (h, w, channels) image
DECODERS = ("yolo_jpeg_decode", "yolo_jpeg_decode_ycc", "yolo_jpeg_decode_raw",
            "yolo_bmp_decode", "yolo_webp_decode_vp8l", "yolo_webp_decode_vp8")
CC_FLAGS = ("-O2", "-std=c11", "-fPIC", "-shared")
LIBS = ("-lm", "-lpthread")


def compiler() -> str:
    for name in (os.environ.get("CC"), "cc", "gcc"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("cannot build yolo_tpu_torch/native: no C compiler "
                       "(cc or gcc) on PATH; set CC")


def _sources():
    srcs = sorted(glob.glob(os.path.join(NATIVE_DIR, "*.c")))
    if not srcs:
        raise RuntimeError(f"no C sources under {NATIVE_DIR}")
    return srcs, sorted(glob.glob(os.path.join(NATIVE_DIR, "*.h")))


def library_path() -> str:
    """Where the library for the current sources, flags and compiler
    lives."""
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join((compiler(),) + CC_FLAGS + LIBS).encode())
    for path in srcs + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"yolo_tpu_native_{h.hexdigest()[:16]}.so")


def build() -> tuple:
    """Compile the library if it is missing.
    Returns (library path, seconds spent compiling; 0.0 if built)."""
    out = library_path()
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):   # another process built it meanwhile
            return out, 0.0
        srcs, _ = _sources()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [compiler(), *CC_FLAGS, "-o", tmp, *srcs, *LIBS]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"C build failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded host library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    ptr, i32, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    i32p = ctypes.POINTER(ctypes.c_int)
    for name in DECODERS:
        fn = getattr(lib, name)
        fn.restype = i32
        # data, len, channels, &out, &h, &w, err, errlen
        fn.argtypes = [ptr, size, i32, ctypes.POINTER(ctypes.c_void_p), i32p,
                       i32p, ctypes.c_char_p, size]
    for name in ("yolo_tiff_lzw_decode", "yolo_tiff_packbits_decode",
                 "yolo_tiff_lzw_encode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        # in, inlen, out, outlen, err, errlen
        fn.argtypes = [ptr, size, ptr, size, ctypes.c_char_p, size]
    lib.yolo_j2k_decode.restype = i32
    # data, len, &out (int32 samples), info, maxcomps, err, errlen
    lib.yolo_j2k_decode.argtypes = [ptr, size, ctypes.POINTER(ctypes.c_void_p),
                                    ptr, i32, ctypes.c_char_p, size]
    lib.yolo_av1_decode.restype = i32
    # data, len, &out (Y, U, V planes), info (9 ints), err, errlen
    lib.yolo_av1_decode.argtypes = [ptr, size, ctypes.POINTER(ctypes.c_void_p),
                                    ptr, ctypes.c_char_p, size]
    lib.yolo_avif_yuv_to_rgb.restype = i32
    # y, u, v, w, h, matrix, full_range, rgb, err, errlen
    lib.yolo_avif_yuv_to_rgb.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                         ptr, ctypes.c_char_p, size]
    lib.yolo_j2k_encode.restype = i32
    # pixels, h, w, channels, bytes before the codestream, &out, &len,
    # err, errlen
    lib.yolo_j2k_encode.argtypes = [
        ptr, i32, i32, i32, size, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(size), ctypes.c_char_p, size]
    lib.yolo_gif_lzw_decode.restype = i32
    # data, len, min_code_size, out, n, err, errlen
    lib.yolo_gif_lzw_decode.argtypes = [ptr, size, i32, ptr, size,
                                        ctypes.c_char_p, size]
    lib.yolo_gif_encode.restype = i32
    # rgb, h, w, &out, &len, err, errlen
    lib.yolo_gif_encode.argtypes = [ptr, i32, i32,
                                    ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(size), ctypes.c_char_p,
                                    size]
    lib.yolo_hdr_decode_pixels.restype = i32
    # data, len, w, h, rgb, err, errlen
    lib.yolo_hdr_decode_pixels.argtypes = [ptr, size, i32, i32, ptr,
                                           ctypes.c_char_p, size]
    lib.yolo_hdr_encode_pixels.restype = ctypes.c_long
    # rgb, w, h, out, outcap, err, errlen
    lib.yolo_hdr_encode_pixels.argtypes = [ptr, i32, i32, ptr, size,
                                           ctypes.c_char_p, size]
    lib.yolo_png_unfilter.restype = i32
    # raw, h, stride, bpp, out, err, errlen
    lib.yolo_png_unfilter.argtypes = [ptr, i32, size, i32, ptr,
                                      ctypes.c_char_p, size]
    lib.yolo_png_decode_rows.restype = i32
    # raw, rawlen, h, w, depth, color, palette, channels, gamma, out, err,
    # errlen
    lib.yolo_png_decode_rows.argtypes = [ptr, size, i32, i32, i32, i32, ptr,
                                         i32, i32, ptr, ctypes.c_char_p, size]
    lib.yolo_webp_encode_vp8l.restype = i32
    # rgb, w, h, mode, &out, &len, err, errlen
    lib.yolo_webp_encode_vp8l.argtypes = [
        ptr, i32, i32, i32, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(size), ctypes.c_char_p, size]
    lib.yolo_jpeg_encode.restype = i32
    # pixels, h, w, channels, quality, &out, &len, err, errlen
    lib.yolo_jpeg_encode.argtypes = [
        ptr, i32, i32, i32, i32, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(size), ctypes.c_char_p, size]
    lib.yolo_gaussian_blur_u8.restype = i32
    # src, h, w, channels, ksize, dst, err, errlen
    lib.yolo_gaussian_blur_u8.argtypes = [ptr, i32, i32, i32, i32, ptr,
                                          ctypes.c_char_p, size]
    lib.yolo_warp_affine_u8.restype = i32
    # src, sh, sw, channels, m (6 doubles), dh, dw, dst, err, errlen
    lib.yolo_warp_affine_u8.argtypes = [ptr, i32, i32, i32, ptr, i32, i32,
                                        ptr, ctypes.c_char_p, size]
    lib.yolo_hsv2rgb_u8.restype = i32
    # src, h, w, dst, err, errlen
    lib.yolo_hsv2rgb_u8.argtypes = [ptr, i32, i32, ptr, ctypes.c_char_p,
                                    size]
    lib.yolo_letterbox_batch.restype = i32
    # src, batch, src_h, src_w, c, dst, net_h, net_w, threads, err, errlen
    lib.yolo_letterbox_batch.argtypes = [ptr, i32, i32, i32, i32, ptr, i32,
                                         i32, i32, ctypes.c_char_p, size]
    lib.yolo_stretch.restype = i32
    # src, src_h, src_w, c, dst, net_h, net_w, err, errlen
    lib.yolo_stretch.argtypes = [ptr, i32, i32, i32, ptr, i32, i32,
                                 ctypes.c_char_p, size]
    lib.yolo_native_free.restype = None
    lib.yolo_native_free.argtypes = [ptr]
    return lib
