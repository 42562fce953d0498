"""PNM (P1-P6) and PAM (P7) decoding for the port's host decoder, the
bytes cv2.imread / cv2.imdecode give (OpenCV 5's grfmt_pxm.cpp and
grfmt_pam.cpp) after COLOR_BGR2RGB at 3 channels, IMREAD_GRAYSCALE's
at 1. Header and copy only, in numpy:

  * numbers are read as grfmt_pxm.cpp's ReadNumber reads them: blanks and
    ``#`` comments (to a CR or LF) before each, one byte consumed after
    it (a file that ends right after its last number gives no image in
    cv2 either), any other byte an error; P1's pixels are single digits;
  * binary 8-bit samples are copied as they are, whatever the maxval (a
    maxval of 100 keeps 0..100); ASCII samples above the maxval are cut
    to it, and 8-bit ASCII ones scaled by ``v * 255 // maxval``;
  * 16-bit samples (maxval above 255) keep their high byte (``>> 8``);
  * bitmaps (P1, P4, and PAM's BLACKANDWHITE) read 1 as black;
  * RGB becomes gray by icvCvt_BGR2Gray_8u_C3C1R's weights (4899, 9617,
    1868 of 1 << 14, rounded), gray becomes RGB by repetition; PAM's
    alpha channel is dropped.

Files that cv2 gives no image for (a bad header, a maxval of 0 or
above 65535, data that ends early) raise ValueError saying so.

encode_pam writes cv2.imwrite's .pam: a P7 header of WIDTH, HEIGHT,
DEPTH and MAXVAL 255 and no TUPLTYPE (OpenCV writes one only when
asked), then the samples in cv2's channel order (B, G, R).
"""

from __future__ import annotations

import re

import numpy as np

NO_IMAGE = "; cv2 gives no image either"
_BLANKS = b" \t\n\v\f\r"
# ReadNumber: blanks and comments, the digits, then one byte consumed
_NUMBER = re.compile(rb"(?:[ \t\n\v\f\r]+|#[^\r\n]*[\r\n])*([0-9]+)([^0-9])",
                     re.DOTALL)
_DIGIT = re.compile(rb"(?:[ \t\n\v\f\r]+|#[^\r\n]*[\r\n])*([0-9])",
                    re.DOTALL)


def is_pnm(data: bytes) -> bool:
    """cv2's signatures: P1-P6 (PxMDecoder) or P7 (PAMDecoder), then a
    blank."""
    return (len(data) >= 3 and data[0:1] == b"P" and data[1] in b"1234567"
            and data[2] in _BLANKS)


def _numbers(data: bytes, pos: int, n: int, single: bool = False):
    """n numbers from pos -> (int64 array, position after them)."""
    pat = _DIGIT if single else _NUMBER
    out = np.empty(n, np.int64)
    for i in range(n):
        m = pat.match(data, pos)
        if m is None:
            raise ValueError("corrupt or truncated: a number expected at "
                             f"byte {pos}" + NO_IMAGE)
        out[i] = int(m.group(1))
        if out[i] > 0x7FFFFFFF:
            raise ValueError("corrupt: a number too large" + NO_IMAGE)
        pos = m.end()
    return out, pos


def icv_gray(rgb: np.ndarray) -> np.ndarray:
    """(h, w, 3) RGB uint8 -> (h, w, 1) gray as OpenCV's decoders make it
    (icvCvt_BGR2Gray_8u_C3C1R: 4899, 9617, 1868 of 1 << 14, rounded)."""
    s = rgb.astype(np.int32)
    return ((s[..., 0] * 4899 + s[..., 1] * 9617 + s[..., 2] * 1868 + 8192)
            >> 14).astype(np.uint8)[..., None]


def _to_channels(samples: np.ndarray, nch: int, channels: int) -> np.ndarray:
    """(h, w, nch) uint8 gray or RGB -> (h, w, channels)."""
    if nch == 1:
        return samples if channels == 1 else np.repeat(samples, 3, 2)
    return samples if channels == 3 else icv_gray(samples)


def _take(data: bytes, pos: int, n: int) -> np.ndarray:
    if len(data) - pos < n:
        raise ValueError("truncated: the file ends inside its pixel data"
                         + NO_IMAGE)
    return np.frombuffer(data, np.uint8, n, pos)


def _decode_pxm(data: bytes, channels: int) -> np.ndarray:
    kind = data[1] - ord("0")
    binary = kind >= 4
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    nch = 3 if bpp == 24 else 1
    (w, h), pos = _numbers(data, 2, 2)
    maxval = 1
    if bpp != 1:
        (maxval,), pos = _numbers(data, pos, 1)
    if maxval > 65535 or not (w > 0 and h > 0 and maxval > 0):
        raise ValueError(f"corrupt: a {w}x{h} PNM of maxval {maxval}"
                         + NO_IMAGE)
    w, h, maxval = int(w), int(h), int(maxval)
    if bpp == 1:
        if binary:
            pitch = (w + 7) // 8
            bits = np.unpackbits(_take(data, pos, pitch * h).reshape(h, pitch),
                                 axis=1)[:, :w]
        else:
            bits, _ = _numbers(data, pos, w * h, single=True)
            bits = (bits != 0).reshape(h, w)
        samples = np.where(bits.astype(bool), 0, 255).astype(np.uint8)
        return _to_channels(samples[..., None], 1, channels)
    wide = maxval > 255
    n = w * h * nch
    if binary:
        raw = _take(data, pos, n * (2 if wide else 1))
        samples = (raw.view(">u2") >> 8).astype(np.uint8) if wide else raw
    else:
        vals, _ = _numbers(data, pos, n)
        vals = np.minimum(vals, maxval)
        if wide:
            samples = (vals >> 8).astype(np.uint8)
        else:
            samples = (vals * 255 // maxval).astype(np.uint8)
    return _to_channels(samples.reshape(h, w, nch), nch, channels)


# PAM tuple types and the depth each gives, of what cv2 reads sanely
_TUPLTYPES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"RGB": 3}


def _decode_pam(data: bytes, channels: int) -> np.ndarray:
    """grfmt_pam.cpp as OpenCV 5 runs it: a known TUPLTYPE is needed;
    a maxval of 1 reads each row's first bits (rows of width * depth
    bytes), 1 as white; RGB samples land in cv2's BGR image unswapped
    (so the port's RGB is the file's order reversed), while the gray is
    weighted in the file's R, G, B order. Alpha tuple types, which cv2 5
    reads into shifted channels, raise."""
    end = data.find(b"ENDHDR", 3)
    nl = data.find(b"\n", end) if end >= 0 else -1
    if nl < 0:
        raise ValueError("corrupt: a PAM header without ENDHDR" + NO_IMAGE)
    fields = {}
    for line in data[3:end].splitlines():
        line = line.split(b"#", 1)[0].strip()
        if line:
            key, _, val = line.partition(b" ")
            fields[key.upper()] = val.strip()
    try:
        w, h = int(fields[b"WIDTH"]), int(fields[b"HEIGHT"])
        depth, maxval = int(fields[b"DEPTH"]), int(fields[b"MAXVAL"])
    except (KeyError, ValueError):
        raise ValueError("corrupt: a PAM header without WIDTH, HEIGHT, DEPTH "
                         "and MAXVAL" + NO_IMAGE) from None
    tupl = fields.get(b"TUPLTYPE", b"").upper()
    if tupl not in _TUPLTYPES and tupl not in (b"GRAYSCALE_ALPHA",
                                              b"RGB_ALPHA"):
        # cv2 5 reads such a file by what an earlier PAM left behind
        raise ValueError(f"unsupported here: PAM TUPLTYPE {tupl!r}")
    if not (w > 0 and h > 0 and 0 < maxval <= 65535):
        raise ValueError(f"corrupt: a {w}x{h}x{depth} PAM of maxval "
                         f"{maxval}" + NO_IMAGE)
    if _TUPLTYPES.get(tupl) != depth:
        raise ValueError(f"unsupported here: a PAM of TUPLTYPE "
                         f"{tupl.decode()} and depth {depth} (cv2 5 reads its "
                         f"channels shifted)")
    if maxval == 1 and depth != 1:
        raise ValueError("unsupported here: an RGB PAM of maxval 1 (cv2 5 "
                         "reads its bits shifted)")
    wide = maxval > 255
    raw = _take(data, nl + 1, w * h * depth * (2 if wide else 1))
    if maxval == 1:
        bits = np.unpackbits(raw.reshape(h, w * depth)[:, :(w + 7) // 8],
                             axis=1)[:, :w]
        samples = (bits * 255).astype(np.uint8)[..., None]
    else:
        samples = (raw.view(">u2") >> 8).astype(np.uint8) if wide else raw
        samples = samples.reshape(h, w, depth)
    if depth == 1:
        return _to_channels(samples, 1, channels)
    if channels == 1:
        return _to_channels(samples, 3, 1)
    return np.ascontiguousarray(samples[..., ::-1])


def decode_pnm(data: bytes, channels: int = 3) -> np.ndarray:
    """PNM / PAM bytes -> (H, W, channels) uint8, RGB or gray, as cv2
    reads them; ValueError where cv2 gives no image."""
    if not is_pnm(data):
        raise ValueError("not a PNM file" + NO_IMAGE)
    if data[1:2] == b"7":
        return _decode_pam(data, channels)
    return _decode_pxm(data, channels)


def encode_pam(image: np.ndarray) -> bytes:
    """(H, W, 3) RGB or (H, W[, 1]) gray uint8 -> the PAM cv2.imwrite
    writes (module docstring). Without a TUPLTYPE the port's own reader
    refuses it, as cv2 reads such a file by an earlier file's type."""
    img = np.asarray(image, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    depth = 1 if img.ndim == 2 else 3
    h, w = img.shape[:2]
    body = img if depth == 1 else img[..., ::-1]
    return (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL 255\n"
            f"ENDHDR\n").encode() + np.ascontiguousarray(body).tobytes()
