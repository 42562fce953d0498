"""Draw detections on images and save them (port of
yolo_tpu/utils/viz.py, which draws and writes with cv2; the card machine
has no OpenCV).

draw_detections gives cv2's pixels for everything but the label text:
each box is cv2.rectangle's 2-px outline (the 3-px band |d| <= 1 around
each edge, square corners cut), the label background its filled
rectangle, sized as cv2.getTextSize sizes the label in
FONT_HERSHEY_SIMPLEX at scale 0.5 (HERSHEY_ADVANCE: each character's
advance at that scale; height 14). The text itself is drawn in black by
the port's own small stroke font (STROKES) inside that background, where
cv2 anti-aliases its Hershey glyphs.

save_image writes by the file's extension what cv2.imwrite writes:
PNG (data/png.py, zlib), baseline JPEG (native/jpeg_enc.c: q95 4:2:0,
cv2.imwrite's defaults; encode_jpeg lives in native/preproc.py), BMP,
PGM / PPM / PNM and PAM, TIFF (data/tiff.py: LZW), Sun raster
(data/sunras.py), PFM (data/pfm.py), Radiance HDR (data/hdr.py) and JPEG
2000 (data/jp2.py: OpenJPEG's rate allocation at a ratio of 4) and GIF
(data/gif.py: OpenCV's fixed 3-3-2 palette, Floyd-Steinberg diffusion),
each with cv2's bytes, and lossless WebP (data/webp.py) with cv2's
pixels. .apng is the .png file and .pic the .hdr file, as cv2 writes
them for one image. AVIF, which cv2 writes through a lossy encoder, is
not ported.
"""

from __future__ import annotations

import os
import struct
from typing import Sequence

import numpy as np

from yolo_tpu_torch.native.preproc import encode_jpeg

# advance of each printable ASCII character (32..126) in
# FONT_HERSHEY_SIMPLEX at scale 0.5: cv2.getTextSize(text, simplex, 0.5,
# 1) is (sum of the text's advances + 1, 14)
HERSHEY_ADVANCE = (
    3, 3, 5, 10, 9, 11, 10, 3, 9, 9, 6, 9, 3, 7, 3, 7, 9, 9, 9, 9, 9, 9, 9,
    9, 9, 9, 3, 4, 7, 8, 7, 7, 12, 10, 10, 9, 10, 9, 8, 10, 10, 4, 9, 9, 8,
    11, 10, 10, 9, 10, 9, 9, 8, 10, 9, 11, 9, 9, 8, 4, 7, 4, 6, 11, 5, 8, 8,
    8, 8, 8, 5, 8, 9, 3, 3, 7, 3, 13, 9, 8, 8, 8, 5, 7, 5, 9, 8, 12, 8, 8, 7,
    5, 3, 5, 8)
TEXT_HEIGHT = 14
# the stroke font: polylines over a 3x3 grid of points, a b c on the cap
# line, d e f at mid height, g h i on the baseline (left, middle, right)
_POINTS = {k: (u, v) for k, (u, v) in zip(
    "abcdefghi", [(u, v) for v in (0.0, 0.5, 1.0) for u in (0.0, 0.5, 1.0)])}
STROKES = {
    "0": "aciga gc", "1": "dbh", "2": "acfdgi", "3": "acig ef",
    "4": "adf ci", "5": "cadfig", "6": "cagifd", "7": "ach",
    "8": "aciga df", "9": "fdacig",
    "A": "gbi df", "B": "gacfig de", "C": "cagi", "D": "gabfhg",
    "E": "cagi de", "F": "cag de", "G": "cagife", "H": "ag ci df",
    "I": "ac bh gi", "J": "cihgd", "K": "ag cdi", "L": "agi", "M": "gaeci",
    "N": "gaic", "O": "aciga", "P": "gacfd", "Q": "aciga ei",
    "R": "gacfd ei", "S": "cadfig", "T": "ac bh", "U": "agic", "V": "ahc",
    "W": "ageic", "X": "ai cg", "Y": "aec eh", "Z": "acgi",
    " ": "", ".": "hh", ",": "hg", ":": "ee hh", ";": "ee hg", "-": "df",
    "_": "gi", "+": "df bh", "=": "df gi", "/": "gc", "\\": "ai",
    "|": "bh", "(": "bdh", ")": "bfh", "[": "bagh", "]": "bcih",
    "{": "bedeh", "}": "befeh", "<": "cdi", ">": "afg", "!": "be hh",
    "?": "acfe hh", '"': "ad cf", "'": "be", "`": "ae", "^": "dbf",
    "~": "debf", "#": "bh ci df", "$": "cadfig bh", "%": "gc aa ii",
    "&": "iabegh", "*": "ai cg bh", "@": "feacig",
}


def class_color(cls: int) -> tuple:
    rng = np.random.default_rng(cls * 7919 + 17)
    return tuple(int(v) for v in rng.integers(60, 255, 3))


def _printable(text: str) -> str:
    """cv2's Hershey text renders a character outside 32..126 as '?'."""
    return "".join(c if 32 <= ord(c) <= 126 else "?" for c in text)


def text_size(text: str) -> tuple:
    """(width, height) cv2.getTextSize gives ``text`` in
    FONT_HERSHEY_SIMPLEX at scale 0.5, thickness 1."""
    return (sum(HERSHEY_ADVANCE[ord(c) - 32] for c in _printable(text)) + 1,
            TEXT_HEIGHT)


def _fill(out: np.ndarray, x1: int, y1: int, x2: int, y2: int,
          color) -> None:
    """Inclusive rectangle, clipped to the image."""
    h, w = out.shape[:2]
    xa, xb = max(min(x1, x2), 0), min(max(x1, x2), w - 1)
    ya, yb = max(min(y1, y2), 0), min(max(y1, y2), h - 1)
    if xa <= xb and ya <= yb:
        out[ya:yb + 1, xa:xb + 1] = color


def _outline(out: np.ndarray, x1: int, y1: int, x2: int, y2: int,
             color) -> None:
    """cv2.rectangle(..., thickness=2): each edge's 3-px band."""
    xa, xb = min(x1, x2), max(x1, x2)
    ya, yb = min(y1, y2), max(y1, y2)
    for y in (ya, yb):
        _fill(out, xa, y - 1, xb, y + 1, color)
    for x in (xa, xb):
        _fill(out, x - 1, ya, x + 1, yb, color)


def _line(out: np.ndarray, x0: int, y0: int, x1: int, y1: int,
          color) -> None:
    """Bresenham, clipped per pixel."""
    h, w = out.shape[:2]
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx, sy = (1 if x0 < x1 else -1), (1 if y0 < y1 else -1)
    err = dx + dy
    while True:
        if 0 <= x0 < w and 0 <= y0 < h:
            out[y0, x0] = color
        if x0 == x1 and y0 == y1:
            return
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x0 += sx
        if e2 <= dx:
            err += dx
            y0 += sy


def draw_text(out: np.ndarray, text: str, x: int, baseline: int,
              color=(0, 0, 0)) -> None:
    """The stroke font, cap height 8 px above ``baseline``, each
    character in its Hershey advance (lower case drawn as upper case)."""
    for ch in _printable(text):
        adv = HERSHEY_ADVANCE[ord(ch) - 32]
        gw = max(adv - 3, 1)
        for stroke in STROKES.get(ch.upper(), STROKES["?"]).split():
            pts = [(x + 1 + int(round(_POINTS[p][0] * gw)),
                    baseline - 8 + int(round(_POINTS[p][1] * 8)))
                   for p in stroke]
            for (ax, ay), (bx, by) in zip(pts, pts[1:] or pts):
                _line(out, ax, ay, bx, by, color)
        x += adv


def draw_detections(image_rgb: np.ndarray, boxes_xyxy, scores, classes,
                    class_names: Sequence[str], valid=None) -> np.ndarray:
    """A copy of image_rgb (H, W, 3 uint8) with boxes and labels. Gray
    inputs ((H, W, 1) or (H, W)) are expanded to RGB so the colours
    render."""
    if image_rgb.ndim == 2:
        image_rgb = image_rgb[..., None]
    if image_rgb.shape[-1] == 1:
        image_rgb = np.repeat(image_rgb, 3, axis=-1)
    out = np.ascontiguousarray(image_rgb.copy())
    for i in range(len(boxes_xyxy)):
        if valid is not None and not bool(valid[i]):
            continue
        x1, y1, x2, y2 = (int(round(float(v))) for v in boxes_xyxy[i])
        cls = int(classes[i])
        color = class_color(cls)
        _outline(out, x1, y1, x2, y2, color)
        label = f"{class_names[cls]} {float(scores[i]):.2f}"
        tw, th = text_size(label)
        _fill(out, x1, max(y1 - th - 6, 0), x1 + tw + 2, y1, color)
        draw_text(out, label, x1 + 1, y1 - 4)
    return out


def encode_bmp(image: np.ndarray) -> bytes:
    """(H, W, 3) RGB or (H, W[, 1]) gray uint8 -> the BMP cv2.imwrite
    writes (grfmt_bmp.cpp BmpEncoder): a BITMAPINFOHEADER, rows bottom-up
    padded to 4 bytes, 24-bit BGR, or 8-bit with a gray palette."""
    img = np.asarray(image, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    gray = img.ndim == 2
    h, w = img.shape[:2]
    ch = 1 if gray else 3
    step = (w * ch + 3) & -4
    palette = b""
    if gray:
        pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, 1)
        pal[:, 3] = 0
        palette = pal.tobytes()
    header_size = 14 + 40 + len(palette)
    rows = img[::-1] if gray else img[::-1, :, ::-1]
    body = np.zeros((h, step), np.uint8)
    body[:, :w * ch] = rows.reshape(h, w * ch)
    head = b"BM" + struct.pack("<IIIIiiHHIIIIII", step * h + header_size, 0,
                               header_size, 40, w, h, 1, ch * 8, 0, 0, 0, 0,
                               0, 0)
    return head + palette + body.tobytes()


def encode_pnm(image: np.ndarray, ext: str) -> bytes:
    """The binary PGM (gray) or PPM (RGB) cv2.imwrite writes for ext
    ".pgm", ".ppm" or ".pnm" (either, by the image): "P5" or "P6", the
    size, maxval 255, the samples. OSError for a colour .pgm or a gray
    .ppm, which cv2 refuses too."""
    img = np.asarray(image, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    gray = img.ndim == 2
    if (ext == ".pgm" and not gray) or (ext == ".ppm" and gray):
        raise OSError(f"cannot write a {'gray' if gray else 'colour'} image "
                      f"as {ext} (cv2.imwrite refuses it too)")
    h, w = img.shape[:2]
    return f"P{5 if gray else 6}\n{w} {h}\n255\n".encode() + \
        np.ascontiguousarray(img).tobytes()


# cv2.imwrite's lossy encoders that the port does not reproduce
LOSSY_NOT_PORTED = (".avif",)


def _writers() -> tuple:
    """save_image's table: (extensions, writer) pairs in the order its
    messages list them; each writer takes the image (encode_pnm also the
    extension) and returns the file's bytes."""
    from yolo_tpu_torch.data.gif import encode_gif
    from yolo_tpu_torch.data.hdr import encode_hdr
    from yolo_tpu_torch.data.jp2 import encode_jp2
    from yolo_tpu_torch.data.pfm import encode_pfm
    from yolo_tpu_torch.data.png import encode_png
    from yolo_tpu_torch.data.pnm import encode_pam
    from yolo_tpu_torch.data.sunras import encode_sunras
    from yolo_tpu_torch.data.tiff import encode_tiff
    from yolo_tpu_torch.data.webp import encode_webp

    return (((".png", ".apng"), encode_png),
            ((".jpg", ".jpeg", ".jpe"), encode_jpeg),
            ((".bmp", ".dib"), encode_bmp),
            ((".pgm", ".ppm", ".pnm"), encode_pnm), ((".pam",), encode_pam),
            ((".tif", ".tiff"), encode_tiff), ((".ras", ".sr"), encode_sunras),
            ((".pfm",), encode_pfm), ((".hdr", ".pic"), encode_hdr),
            ((".webp",), encode_webp), ((".jp2",), encode_jp2),
            ((".gif",), encode_gif))


def save_image(path: str, image_rgb: np.ndarray) -> None:
    """Write an RGB (or gray) uint8 image by the path's extension, what
    cv2.imwrite writes (module docstring; the extensions: _writers).
    OSError for .avif (a lossy encoder, not ported), another extension,
    an image cv2 refuses to write (a gray .gif, a .jp2 under 32 pixels a
    side), or a missing directory; no file is written then."""
    ext = os.path.splitext(path)[1].lower()
    table = _writers()
    writer = next((fn for exts, fn in table if ext in exts), None)
    if writer is encode_pnm:
        data = encode_pnm(image_rgb, ext)
    elif writer is not None:
        data = writer(image_rgb)
    elif ext in LOSSY_NOT_PORTED:
        raise OSError(f"cannot write {path}: cv2.imwrite writes {ext} with a "
                      f"lossy encoder that the port does not reproduce")
    else:
        names = ["/".join(exts) for exts, _ in table]
        raise OSError(f"cannot write {path}: the port writes "
                      f"{', '.join(names[:-1])} and {names[-1]} only")
    with open(path, "wb") as f:
        f.write(data)
