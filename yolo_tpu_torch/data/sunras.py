"""Sun raster reading and writing for the port's host decoder and
save_image: the bytes OpenCV 5's grfmt_sunras.cpp reads and writes
(cv2.imread / cv2.imdecode after COLOR_BGR2RGB at 3 channels,
IMREAD_GRAYSCALE's at 1; cv2.imwrite's .ras / .sr). Header and copy
only, in numpy:

  * the header: the signature 59 a6 6a 95, then big-endian width,
    height, depth, length, type, map type and map length. OpenCV takes
    depths 1, 8, 24 and 32 of the old (0) and standard (1) types; its
    check of the byte-encoded (2) and RGB (3) types reads the decoder's
    image type, which is unset there, so it gives no image for either
    (nor does the port). A colour map (map type 1, at most 3 << depth
    bytes, depths 1 and 8) is three planes, R then G then B, of length
    // 3 entries; entries past it are black. The length field is not
    read;
  * rows of ((width * depth + 7) // 8 + 1) & ~1 bytes; 24-bit pixels
    are B, G, R; 32-bit ones X, B, G, R (the first byte dropped);
  * 1- and 8-bit pixels go through the colour map, or without one
    through a gray ramp (1 bit: 0 and 255), at IMREAD_COLOR. At
    IMREAD_GRAYSCALE they go through the map's gray (icvCvt's weights
    4899, 9617, 1868 of 1 << 14, rounded), and without a map through
    an unfilled table: every pixel is 0, as cv2 gives them;
  * colour pixels' gray: the same weights.

encode_sunras writes what SunRasterEncoder writes: a standard-type
header of no map, the length width * channels rounded up to even
bytes times height, BGR (or gray) rows. Each odd-length row is padded
with the byte after it in memory, so with the next row's first byte;
the last row's pad byte lies past cv2's image (whatever memory follows
it) and is 0 here.
"""

from __future__ import annotations

import struct

import numpy as np

from yolo_tpu_torch.data.pnm import icv_gray

SIGNATURE = b"\x59\xa6\x6a\x95"
NO_IMAGE = "; cv2 gives no image either"
RT_OLD, RT_STANDARD = 0, 1


def is_sunras(data: bytes) -> bool:
    return data[:4] == SIGNATURE


def decode_sunras(data: bytes, channels: int = 3) -> np.ndarray:
    """Sun raster bytes -> (H, W, channels) uint8, RGB or gray, as cv2
    reads them; ValueError where cv2 gives no image."""
    if len(data) < 32 or not is_sunras(data):
        raise ValueError("corrupt: a Sun raster header of under 32 bytes"
                         + NO_IMAGE)
    w, h, depth, _, typ, maptype, maplen = struct.unpack_from(">7i", data,
                                                               4)
    pal_size = (1 << depth) * 3 if 0 < depth <= 8 else 0
    if not (w > 0 and h > 0 and depth in (1, 8, 24, 32)):
        raise ValueError(f"corrupt: a {w}x{h} Sun raster of depth {depth}"
                         + NO_IMAGE)
    if typ not in (RT_OLD, RT_STANDARD):
        raise ValueError(f"unsupported: Sun raster type {typ} (OpenCV 5 "
                         f"checks the byte-encoded and RGB types against "
                         f"an unset field)" + NO_IMAGE)
    if not ((maptype == 0 and maplen == 0) or
            (maptype == 1 and 0 < maplen <= pal_size and depth <= 8)):
        raise ValueError(f"unsupported: a colour map of type {maptype} and "
                         f"{maplen} bytes at depth {depth}" + NO_IMAGE)
    pitch = (((w * depth + 7) // 8) + 1) & ~1
    start = 32 + maplen
    if len(data) < start + pitch * h:
        raise ValueError("truncated: the file ends inside its pixel data"
                         + NO_IMAGE)
    rows = np.frombuffer(data, np.uint8, pitch * h, start).reshape(h, pitch)
    if depth > 8:
        nb = depth // 8
        px = rows[:, :w * nb].reshape(h, w, nb)
        bgr = px[..., nb - 3:]
        if channels == 1:
            return icv_gray(bgr[..., ::-1])
        return np.ascontiguousarray(bgr[..., ::-1])
    if depth == 1:
        idx = np.unpackbits(rows, axis=1)[:, :w]
    else:
        idx = rows[:, :w]
    pal = np.zeros((256, 3), np.uint8)
    if maplen:
        n = maplen // 3
        cmap = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)
        pal[:n] = cmap.T
    else:
        levels = 1 << depth
        pal[:levels] = (np.arange(levels) * 255 // (levels - 1))[:, None]
    if channels == 1:
        if not maplen:
            return np.zeros((h, w, 1), np.uint8)
        return icv_gray(pal)[idx]
    return pal[idx]


def encode_sunras(image: np.ndarray) -> bytes:
    """(H, W, 3) RGB or (H, W[, 1]) gray uint8 -> the Sun raster
    cv2.imwrite writes (module docstring)."""
    img = np.asarray(image, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    ch = 1 if img.ndim == 2 else 3
    h, w = img.shape[:2]
    step = w * ch
    pitch = (step + 1) & ~1
    flat = (img if ch == 1 else img[..., ::-1]).reshape(-1).tobytes() + b"\0"
    rows = b"".join(flat[y * step:y * step + pitch] for y in range(h))
    return SIGNATURE + struct.pack(">7I", w, h, ch * 8, pitch * h,
                                   RT_STANDARD, 0, 0) + rows
