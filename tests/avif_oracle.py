"""The Y, U and V planes libavif decodes from an AVIF file, for the tests
of the port's AV1 decoder: opencv-python's bundled libavif (1.4.2, with
libaom 3.14.1) called through ctypes. Only the tests use it; the port
never loads libavif or libaom. available() is False where the library
is missing."""

from __future__ import annotations

import ctypes
import glob
import os

import numpy as np


class _Image(ctypes.Structure):
    # the leading fields of libavif's avifImage
    _fields_ = [("width", ctypes.c_uint32), ("height", ctypes.c_uint32),
                ("depth", ctypes.c_uint32), ("yuvFormat", ctypes.c_int),
                ("yuvRange", ctypes.c_int),
                ("yuvChromaSamplePosition", ctypes.c_int),
                ("yuvPlanes", ctypes.c_void_p * 3),
                ("yuvRowBytes", ctypes.c_uint32 * 3)]


def _library():
    try:
        import cv2
    except ImportError:
        return None
    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        cv2.__file__)), "opencv_python.libs", "libavif-*.so*"))
    if not libs:
        return None
    lib = ctypes.CDLL(libs[0])
    lib.avifDecoderCreate.restype = ctypes.c_void_p
    lib.avifImageCreateEmpty.restype = ctypes.c_void_p
    lib.avifDecoderReadMemory.restype = ctypes.c_int
    lib.avifDecoderReadMemory.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_char_p, ctypes.c_size_t]
    lib.avifDecoderDestroy.argtypes = [ctypes.c_void_p]
    lib.avifImageDestroy.argtypes = [ctypes.c_void_p]
    return lib


_LIB = _library()


def available() -> bool:
    return _LIB is not None


def decode_planes(data: bytes):
    """AVIF bytes -> (Y, U, V) uint8 planes as libavif decodes them;
    ValueError where libavif fails."""
    dec = _LIB.avifDecoderCreate()
    img = _LIB.avifImageCreateEmpty()
    try:
        rc = _LIB.avifDecoderReadMemory(dec, img, data, len(data))
        if rc != 0:
            raise ValueError(f"libavif: result {rc}")
        im = _Image.from_address(img)
        if im.depth != 8:
            raise ValueError(f"libavif: depth {im.depth}")
        w, h = im.width, im.height
        cw, ch = (w + 1) // 2, (h + 1) // 2
        planes = []
        for p, (pw, ph) in enumerate(((w, h), (cw, ch), (cw, ch))):
            stride = im.yuvRowBytes[p]
            buf = (ctypes.c_uint8 * (stride * ph)).from_address(
                im.yuvPlanes[p])
            planes.append(np.frombuffer(buf, np.uint8).reshape(
                ph, stride)[:, :pw].copy())
        return tuple(planes)
    finally:
        _LIB.avifImageDestroy(img)
        _LIB.avifDecoderDestroy(dec)
