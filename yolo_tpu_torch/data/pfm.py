"""PFM reading and writing for the port's host decoder and save_image:
the bytes OpenCV 5's grfmt_pfm.cpp reads and writes (cv2.imread /
cv2.imdecode after COLOR_BGR2RGB at 3 channels, IMREAD_GRAYSCALE's at
1; cv2.imwrite's .pfm). In numpy:

  * the header: ``PF`` (RGB) or ``Pf`` (gray) and one line break, then
    the width, the height and the scale, each a word ended by one
    blank byte (C's atoi / atof of the word); the scale's sign is the
    byte order (negative: little-endian); rows bottom-up, float32;
  * the samples are multiplied by the float 1 / |scale| and converted
    as OpenCV converts float to uint8: rounded half to even, clamped to
    0..255, and 0 where the rounding leaves int32 (NaN, +-Inf, +-2**31
    and beyond: the x86 conversion's 0x80000000);
  * cv2 gives an RGB file's three channels at IMREAD_GRAYSCALE and a
    gray file's one channel at IMREAD_COLOR (the conversion keeps the
    file's channel count): neither is an image of the asked channels,
    so the port raises ValueError for both.

encode_pfm writes what PFMEncoder writes: ``PF`` or ``Pf``, the width
and height, the scale -1 (little-endian), the uint8 samples as float32,
rows bottom-up, RGB.
"""

from __future__ import annotations

import re

import numpy as np

NO_IMAGE = "; cv2 gives no image either"
_BLANK = b" \t\n\v\f\r"
_INT = re.compile(rb"[ \t\n\v\f\r]*([+-]?[0-9]+)")
_FLOAT = re.compile(rb"[ \t\n\v\f\r]*([+-]?(?:inf(?:inity)?|nan|"
                    rb"(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?))",
                    re.IGNORECASE)


def is_pfm(data: bytes) -> bool:
    """cv2's signature: P, then f or F, then a blank byte."""
    return len(data) >= 3 and data[:1] == b"P" and data[1:2] in b"fF" and \
        data[2] in _BLANK


def _word(data: bytes, pos: int):
    """grfmt_pfm.cpp's read_number: bytes up to one blank byte (consumed)
    -> (word, position after it)."""
    end = pos
    while end < len(data) and data[end] not in _BLANK:
        if data[end] > 127:
            raise ValueError("corrupt: a PFM header byte above 127"
                             + NO_IMAGE)
        end += 1
    if end >= len(data):
        raise ValueError("truncated: the PFM header has no end" + NO_IMAGE)
    return data[pos:end], end + 1


def _atoi(word: bytes) -> int:
    m = _INT.match(word)
    return int(m.group(1)) if m else 0


def _atof(word: bytes) -> float:
    m = _FLOAT.match(word)
    return float(m.group(1)) if m else 0.0


def to_u8(x: np.ndarray) -> np.ndarray:
    """float32 -> uint8 as OpenCV's saturate_cast through cvRound on
    x86: half to even, 0..255, and 0 for what int32 cannot hold."""
    with np.errstate(invalid="ignore"):
        r = np.rint(x.astype(np.float32))
        out = np.where(np.isnan(r) | (r >= 2.0 ** 31) | (r < -2.0 ** 31), 0,
                       np.clip(r, 0, 255))
    return out.astype(np.uint8)


def decode_pfm(data: bytes, channels: int = 3) -> np.ndarray:
    """PFM bytes -> (H, W, channels) uint8, RGB or gray, as cv2 reads
    them; ValueError where cv2 gives no image or not one of the asked
    channels."""
    if not is_pfm(data) or data[2:3] != b"\n":
        raise ValueError("corrupt: a PFM header not of P, f or F and a line "
                         "break" + NO_IMAGE)
    nch = 3 if data[1:2] == b"F" else 1
    word, pos = _word(data, 3)
    w = _atoi(word)
    word, pos = _word(data, pos)
    h = _atoi(word)
    word, pos = _word(data, pos)
    scale = _atof(word)
    if w <= 0 or h <= 0:
        raise ValueError(f"corrupt: a {w}x{h} PFM" + NO_IMAGE)
    if not abs(scale) > 0.0:
        raise ValueError(f"corrupt: a PFM scale of {scale}" + NO_IMAGE)
    n = w * h * nch
    if len(data) - pos < 4 * n:
        raise ValueError("truncated: the file ends inside its pixel data"
                         + NO_IMAGE)
    if nch != channels:
        raise ValueError(
            f"unsupported here: cv2 5 gives a {'RGB' if nch == 3 else 'gray'}"
            f" PFM's {nch} channel(s) where {channels} are asked")
    dt = np.dtype(">f4" if scale > 0 else "<f4")
    vals = np.frombuffer(data, dt, n, pos).astype(np.float32)
    vals = vals.reshape(h, w, nch)[::-1]
    with np.errstate(over="ignore", invalid="ignore"):
        vals = vals * np.float32(1.0 / abs(scale))
    return to_u8(vals)


def encode_pfm(image: np.ndarray) -> bytes:
    """(H, W, 3) RGB or (H, W[, 1]) gray uint8 -> the PFM cv2.imwrite
    writes (module docstring)."""
    img = np.asarray(image, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    tag = b"Pf" if img.ndim == 2 else b"PF"
    return tag + f"\n{w} {h}\n-1\n".encode() + \
        img[::-1].astype("<f4").tobytes()
