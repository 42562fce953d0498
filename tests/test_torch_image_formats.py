"""The image formats the port's decoder reads beside JPEG and PNG, byte
for byte as cv2 gives them, at 3 channels (after COLOR_BGR2RGB) and 1
(IMREAD_GRAYSCALE), through bytes (cv2.imdecode) and through a file
(cv2.imread, and the JAX package's load_image under its cv2 decoder):

  * BMP (native/bmp.c): 1/4/8-bit palettes, gray ones among them, RLE4
    and RLE8 with their escapes, 16-bit 555 and BI_BITFIELDS 565, 24-
    and 32-bit, core / INFO / V4 / V5 headers, top-down rows;
  * PNM and PAM (data/pnm.py): P1-P7, ASCII and binary, comments, a
    maxval of 100 kept raw, 16-bit samples;
  * TIFF (data/tiff.py, native/tiff.c): what PIL writes (every mode and
    codec) and tests/tiff_writer.py writes (tiles, planar, MM, BigTIFF,
    predictor, palettes, orientations), libtiff's quirks as OpenCV 5
    meets them;
  * WebP (data/webp.py, native/webp_lossless.c, native/webp_lossy.c):
    lossless and lossy, with alpha, EXIF orientation, an animation's first
    frame;
  * GIF (data/gif.py, native/gif.c): PIL's and cv2's files and
    tests/gif_writer.py's (canvases, local tables, interlace,
    transparency, animations, LZW edge cases), the first frame as
    OpenCV 5's own decoder composes it;
  * Sun raster (data/sunras.py): depths 1, 8, 24, 32, the old and
    standard types, colour maps (tests/sunras_writer.py, cv2's files);
  * PFM (data/pfm.py): RGB and gray, both byte orders, scales, the float
    conversion's special values;
  * Radiance HDR (data/hdr.py, native/hdr.c): flat, old and new
    run-length scanlines, cv2's files.

Where cv2 gives no image the port raises ValueError naming the file.
The decoder is chosen by signature, not extension. At the slice's
level, a seeded scene saved as BMP, TIFF and WebP gives the port's
detect_raw the boxes of the JAX detector on cv2's decode; and
predict --image, detect --images and POST /detect give the JAX
package's answers on these files.
"""

import io
import json
import os
import shutil
import struct

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from tests.bmp_writer import rle_encode, write_bmp
from tests.gif_writer import lzw_encode, write_gif
from tests.sunras_writer import (RT_BYTE_ENCODED, RT_FORMAT_RGB, RT_OLD,
                                 RT_STANDARD, write_sunras)
from tests.tiff_writer import DEFLATE, LZW, NONE, PACKBITS, write_tiff
from yolo_tpu.data import pipeline as jpipe
from yolo_tpu_torch.data.png import apply_orientation
from yolo_tpu_torch.native.preproc import decode_image, decode_image_bytes

torch.set_num_threads(1)


def _cv2(data, channels):
    img = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_COLOR if channels == 3
                       else cv2.IMREAD_GRAYSCALE)
    if img is None:
        return None
    return img[..., ::-1] if channels == 3 else img[..., None]


@pytest.fixture
def jax_cv2_decoder():
    """The JAX package's load_image under its default decoder, cv2."""
    old = jpipe.get_decoder()
    jpipe.set_decoder("cv2")
    yield jpipe.load_image
    jpipe.set_decoder(old)


def same_as_cv2(data, tmp_path=None, load=None, suffix=".img"):
    """The port's bytes equal cv2.imdecode's at 3 and 1 channels, and,
    given tmp_path and the JAX package's load_image, the file's."""
    path = None
    if tmp_path is not None:
        path = str(tmp_path / f"kind{suffix}")
        with open(path, "wb") as f:
            f.write(data)
    for c in (3, 1):
        want = _cv2(data, c)
        assert want is not None, "cv2 gives no image"
        got = decode_image_bytes(data, c)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        if path is not None:
            np.testing.assert_array_equal(decode_image(path, c), got)
            np.testing.assert_array_equal(load(path, c).reshape(got.shape),
                                          got)


def same_or_both_refuse(data):
    """cv2's bytes where it gives an image, a ValueError where it gives
    none; True if cv2 gave one."""
    gave = False
    for c in (3, 1):
        want = _cv2(data, c)
        if want is None:
            with pytest.raises(ValueError):
                decode_image_bytes(data, c)
            continue
        np.testing.assert_array_equal(decode_image_bytes(data, c), want)
        gave = True
    return gave


def refused_naming_the_file(data, tmp_path, suffix, reason):
    for c in (3, 1):
        assert _cv2(data, c) is None
    path = str(tmp_path / f"bad{suffix}")
    with open(path, "wb") as f:
        f.write(data)
    for c in (3, 1):
        with pytest.raises(ValueError) as err:
            decode_image(path, c)
        assert path in str(err.value) and reason in str(err.value)
        assert "cv2 gives no image either" in str(err.value)


def _picture(rng, h, w, kind=1):
    """Noise (kind 0), smooth ramps with mild noise (1) or flat bands
    (2), RGB uint8."""
    if kind == 0:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx * yy) % 256], -1)
    if kind == 2:
        img = img // 64 * 64
    return np.clip(img + rng.integers(-3, 4, img.shape), 0, 255).astype(
        np.uint8)


# --- BMP -----------------------------------------------------------------------

def _bmp_kinds():
    rng = np.random.default_rng(0)
    h, w = 13, 21
    out = {}
    for bpp in (1, 4, 8):
        n = 1 << bpp
        pal = rng.integers(0, 256, (n, 3))
        idx = rng.integers(0, n, (h, w))
        out[f"{bpp}-bit palette"] = write_bmp(idx, bpp, palette=pal)
        gray = np.repeat(np.arange(0, 256, 256 // n)[:n, None], 3, 1)
        out[f"{bpp}-bit gray palette"] = write_bmp(idx, bpp, palette=gray)
        out[f"{bpp}-bit core header"] = write_bmp(idx, bpp, palette=pal,
                                                 header="core")
    pal16 = rng.integers(0, 256, (16, 3))
    pal256 = rng.integers(0, 256, (256, 3))
    runs = np.repeat(rng.integers(0, 16, (h, 7)), 3, 1)
    out["RLE4"] = write_bmp(runs, 4, palette=pal16, rle=rle_encode(runs, 4))
    out["RLE8"] = write_bmp(runs, 8, palette=pal256, rle=rle_encode(runs, 8))
    out["RLE4 escapes"] = write_bmp(runs, 4, palette=pal16, rle=rle_encode(
        runs, 4, np.random.default_rng(1)))
    out["RLE8 escapes"] = write_bmp(runs, 8, palette=pal256, rle=rle_encode(
        runs, 8, np.random.default_rng(2)))
    out["RLE8 top-down"] = write_bmp(runs, 8, palette=pal256, top_down=True,
                                     rle=rle_encode(runs[::-1], 8))
    v16 = rng.integers(0, 65536, (h, w))
    out["16-bit 555"] = write_bmp(v16, 16)
    out["16-bit 565 bitfields"] = write_bmp(v16, 16,
                                            masks=(0xF800, 0x7E0, 0x1F))
    out["16-bit 555 bitfields"] = write_bmp(v16, 16,
                                            masks=(0x7C00, 0x3E0, 0x1F))
    bgr = rng.integers(0, 256, (h, w, 3))
    bgra = rng.integers(0, 256, (h, w, 4))
    out["24-bit"] = write_bmp(bgr, 24)
    out["24-bit top-down"] = write_bmp(bgr, 24, top_down=True)
    out["24-bit V4"] = write_bmp(bgr, 24, header="v4")
    out["24-bit V5"] = write_bmp(bgr, 24, header="v5")
    out["24-bit core"] = write_bmp(bgr, 24, header="core")
    out["32-bit"] = write_bmp(bgra, 32)
    out["32-bit bitfields"] = write_bmp(bgra, 32,
                                        masks=(0xFF0000, 0xFF00, 0xFF))
    out["32-bit V5 bitfields"] = write_bmp(bgra, 32, header="v5",
                                           masks=(0xFF0000, 0xFF00, 0xFF))
    ok, enc = cv2.imencode(".bmp", bgr.astype(np.uint8))
    out["cv2's own"] = enc.tobytes()
    return out


@pytest.mark.parametrize("kind", sorted(_bmp_kinds()))
def test_bmp_kinds_match_cv2(tmp_path, jax_cv2_decoder, kind):
    same_as_cv2(_bmp_kinds()[kind], tmp_path, jax_cv2_decoder, ".bmp")


@pytest.mark.parametrize("seed", range(3))
def test_random_bmps_match_cv2(seed):
    """Random headers, depths, palettes and RLE streams with escapes
    (deltas, early ends of line and of bitmap): cv2's bytes where it
    gives an image, a refusal where it gives none."""
    rng = np.random.default_rng(seed)
    gave = 0
    for _ in range(40):
        h, w = int(rng.integers(1, 20)), int(rng.integers(1, 40))
        bpp = int(rng.choice([1, 4, 8, 16, 24, 32]))
        header = str(rng.choice(["info", "v4", "v5"] +
                                (["core"] if bpp not in (16,) else [])))
        kw = {"header": header,
              "top_down": bool(rng.random() < 0.3) and header != "core"}
        if bpp <= 8:
            n = int(rng.integers(1, (1 << bpp) + 1))
            pal = rng.integers(0, 256, (n, 3))
            if header == "core":
                pal = np.concatenate([pal, np.zeros(((1 << bpp) - n, 3),
                                                    int)])
            px = rng.integers(0, n, (h, w))
            kw["palette"] = pal
            if bpp in (4, 8) and header != "core" and rng.random() < 0.6:
                px = np.repeat(px[:, ::3], 3, 1)[:, :w]
                kw["rle"] = rle_encode(px[::-1] if kw["top_down"] else px,
                                       bpp, rng)
        elif bpp == 16:
            px = rng.integers(0, 65536, (h, w))
            if rng.random() < 0.5:
                kw["masks"] = [(0x7C00, 0x3E0, 0x1F),
                               (0xF800, 0x7E0, 0x1F)][int(rng.integers(2))]
        else:
            px = rng.integers(0, 256, (h, w, bpp // 8))
        gave += same_or_both_refuse(write_bmp(px, bpp, **kw))
    assert gave >= 30


def _bmp_refusals():
    rng = np.random.default_rng(3)
    bgr = rng.integers(0, 256, (4, 6, 3))
    good = write_bmp(bgr, 24)
    jpeg = bytearray(good)
    jpeg[30:34] = struct.pack("<I", 4)             # BI_JPEG
    pal = rng.integers(0, 256, (256, 3))
    past = write_bmp(np.zeros((2, 4), int), 8, palette=pal,
                     rle=bytes([5, 1, 0, 0, 0, 1]))
    return {
        "BI_JPEG": (bytes(jpeg), "compression"),
        "truncated rows": (good[:-5], "truncated"),
        "RLE run past its row": (past, "RLE"),
        "16-bit masks 444": (write_bmp(rng.integers(0, 65536, (3, 3)), 16,
                                       masks=(0xF00, 0xF0, 0xF)), "masks"),
        "RLE4 without its end": (write_bmp(
            np.zeros((3, 4), int), 4, palette=pal[:16],
            rle=bytes([2, 0x12, 0, 0, 0, 1])), "truncated"),
    }


@pytest.mark.parametrize("case", sorted(_bmp_refusals()))
def test_bmp_cv2_refuses_raise_naming_the_file(tmp_path, case):
    data, reason = _bmp_refusals()[case]
    refused_naming_the_file(data, tmp_path, ".bmp", reason)


# --- PNM -----------------------------------------------------------------------

def _pnm_kinds():
    rng = np.random.default_rng(4)
    h, w = 5, 7
    bits = rng.integers(0, 2, (h, w))
    g100 = rng.integers(0, 101, (h, w))
    g16 = rng.integers(0, 65536, (h, w))
    rgb = rng.integers(0, 256, (h, w, 3))
    rgb16 = rng.integers(0, 65536, (h, w, 3))

    def ascii_rows(a):
        return b"".join(b" ".join(b"%d" % v for v in row.ravel()) + b"\n"
                        for row in a)

    head = b"P%d\n# a comment\n%d %d\n"
    return {
        "P1": head % (1, w, h) + ascii_rows(bits),
        "P1 packed digits": head % (1, w, h) + b"".join(
            b"".join(b"%d" % v for v in row) + b"\n" for row in bits),
        "P2 maxval 100": head % (2, w, h) + b"100\n" + ascii_rows(g100),
        "P2 16-bit": head % (2, w, h) + b"65535\n" + ascii_rows(g16),
        "P3": head % (3, w, h) + b"255\n" + ascii_rows(rgb),
        "P4": head % (4, w, h) + np.packbits(bits.astype(bool), 1).tobytes(),
        "P5 maxval 100": head % (5, w, h) + b"100\n" +
        g100.astype(np.uint8).tobytes(),
        "P5 16-bit": head % (5, w, h) + b"65535\n" +
        g16.astype(">u2").tobytes(),
        "P6": b"P6 %d %d 255\n" % (w, h) + rgb.astype(np.uint8).tobytes(),
        "P6 16-bit": head % (6, w, h) + b"1023\n" +
        (rgb16 % 1024).astype(">u2").tobytes(),
        "P7 gray": b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 1\nMAXVAL 255\n"
        b"TUPLTYPE GRAYSCALE\nENDHDR\n" % (w, h) +
        g100.astype(np.uint8).tobytes(),
        "P7 RGB": b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 3\nMAXVAL 255\n"
        b"TUPLTYPE RGB\nENDHDR\n" % (w, h) + rgb.astype(np.uint8).tobytes(),
        "P7 bitmap": b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 1\nMAXVAL 1\n"
        b"TUPLTYPE BLACKANDWHITE\nENDHDR\n" % (w, h) +
        rng.integers(0, 256, (h, w)).astype(np.uint8).tobytes(),
        "cv2's PGM": cv2.imencode(".pgm", g100.astype(np.uint8))[1].tobytes(),
        "cv2's PPM": cv2.imencode(".ppm", rgb.astype(np.uint8))[1].tobytes(),
    }


@pytest.mark.parametrize("kind", sorted(_pnm_kinds()))
def test_pnm_kinds_match_cv2(tmp_path, jax_cv2_decoder, kind):
    same_as_cv2(_pnm_kinds()[kind], tmp_path, jax_cv2_decoder, ".pnm")


def test_pnm_maxval_100_is_not_rescaled():
    data = b"P5 3 1 100\n" + bytes([0, 50, 100])
    np.testing.assert_array_equal(decode_image_bytes(data, 1)[0, :, 0],
                                  [0, 50, 100])


@pytest.mark.parametrize("case", ["no byte after the last number",
                                  "maxval 0", "maxval 70000",
                                  "truncated binary", "PAM without ENDHDR"])
def test_pnm_cv2_refuses_raise_naming_the_file(tmp_path, case):
    data = {"no byte after the last number": b"P2 2 1 255\n1 2",
            "maxval 0": b"P5 2 1 0\n\x00\x00",
            "maxval 70000": b"P5 2 1 70000\n" + bytes(8),
            "truncated binary": b"P6 2 2 255\n" + bytes(11),
            "PAM without ENDHDR": b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 1\nMAXVAL "
                                  b"255\nTUPLTYPE GRAYSCALE\n\x00"}[case]
    refused_naming_the_file(data, tmp_path, ".pnm", "cv2")


# --- TIFF ----------------------------------------------------------------------

PIL_MODES = ["1", "L", "P", "RGB", "RGBA", "CMYK", "LA", "I;16"]
PIL_CODECS = ["raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
              "packbits"]


def _pil_tiff(img, codec, **kw):
    b = io.BytesIO()
    img.save(b, format="TIFF", compression=codec, **kw)
    return b.getvalue()


@pytest.mark.parametrize("mode", PIL_MODES)
def test_pil_tiffs_match_cv2(tmp_path, jax_cv2_decoder, mode):
    """Every codec PIL writes (with the horizontal predictor where it
    applies, and strips of a few rows), at one of PIL's modes."""
    rng = np.random.default_rng(PIL_MODES.index(mode))
    h, w = 23, 29
    n = {"RGB": 3, "RGBA": 4, "CMYK": 4, "LA": 2}.get(mode)
    if n:
        img = Image.fromarray(rng.integers(0, 256, (h, w, n), np.uint8),
                              mode)
    elif mode == "I;16":
        img = Image.fromarray(rng.integers(0, 65536, (h, w), np.uint16))
    else:
        img = Image.fromarray(_picture(rng, h, w)[..., 0]).convert(mode)
    for i, codec in enumerate(PIL_CODECS):
        kw = {"strip_size": w * 8 * (i + 1)}
        if mode not in ("1", "P") and codec in ("tiff_lzw", "tiff_deflate"):
            kw["tiffinfo"] = {317: 2}
        same_as_cv2(_pil_tiff(img, codec, **kw), tmp_path, jax_cv2_decoder,
                    ".tif")


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_jpeg_tiffs_match_cv2(tmp_path, jax_cv2_decoder, mode):
    """JPEG-compressed strips (PIL: YCbCr for RGB, JPEGTables) through
    the port's JPEG decoder."""
    rng = np.random.default_rng(7)
    img = Image.fromarray(_picture(rng, 45, 37)).convert(mode)
    for kw in ({}, {"strip_size": 37 * 3 * 16}, {"quality": 30}):
        same_as_cv2(_pil_tiff(img, "jpeg", **kw), tmp_path, jax_cv2_decoder,
                    ".tif")


def _random_tiff(rng):
    h, w = int(rng.integers(1, 60)), int(rng.integers(1, 60))
    kind = str(rng.choice(["gray", "white", "rgb", "rgba", "palette"]))
    bits = int(rng.choice({"gray": [1, 8, 16], "white": [1, 8, 16],
                           "rgb": [8, 16], "rgba": [8, 16],
                           "palette": [1, 4, 8]}[kind]))
    spp = {"rgb": 3, "rgba": 4}.get(kind, 1)
    s = rng.integers(0, 1 << bits, (h, w, spp)).astype(
        np.uint16 if bits == 16 else np.uint8)
    if rng.random() < 0.5:
        s = np.sort(s, axis=1)
    codec = int(rng.choice([NONE, LZW, DEFLATE, PACKBITS]))
    kw = {"bits": bits, "compression": codec,
          "byte_order": str(rng.choice(["<", ">"])),
          "bigtiff": bool(rng.random() < 0.3)}
    if rng.random() < 0.4:
        kw["tile"] = (16 * int(rng.integers(1, 4)),
                      16 * int(rng.integers(1, 4)))
    else:
        kw["rows_per_strip"] = int(rng.integers(1, h + 1))
    if spp > 1 and rng.random() < 0.4:
        kw["planar"] = 2
    if bits >= 8 and rng.random() < 0.5:
        kw["predictor"] = 2
    if kind == "palette":
        cmap = rng.integers(0, 65536, (3, 1 << bits))
        kw["colormap"] = cmap % 256 if rng.random() < 0.5 else cmap
    if kind == "rgba":
        kw["extra_samples"] = [int(rng.integers(0, 3))]
    if bits == 1 and rng.random() < 0.5:
        kw["fill_order"] = 2
    if rng.random() < 0.3:
        kw["orientation"] = int(rng.integers(1, 9))
    photometric = {"gray": 1, "white": 0, "rgb": 2, "rgba": 2,
                   "palette": 3}[kind]
    return write_tiff(s, photometric, **kw)


@pytest.mark.parametrize("seed", range(4))
def test_written_tiffs_match_cv2(seed):
    """tests/tiff_writer.py's layouts: tiles (libtiff mirrors each tile
    where the orientation flips x, and reads 16-bit gray tiles of the
    last column with its unscaled skew; uncompressed tiles must be whole
    kilobytes), planar, MM, BigTIFF, predictor (LZW and Deflate only),
    palettes of 8- and 16-bit entries, FillOrder 2, orientations."""
    rng = np.random.default_rng(100 + seed)
    gave = sum(same_or_both_refuse(_random_tiff(rng)) for _ in range(30))
    assert gave >= 20


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_file_and_bytes(tmp_path, jax_cv2_decoder,
                                         orientation):
    """The orientation tag rotates as EXIF does. For 5-8 OpenCV 5.0.0's
    imread gives no image (the JAX load_image raises), and the port's
    decode_image raises too; imdecode of the same bytes rotates."""
    img = _picture(np.random.default_rng(orientation), 6, 10)
    data = _pil_tiff(Image.fromarray(img), "tiff_lzw",
                     tiffinfo={274: orientation})
    want = apply_orientation(img, orientation)
    np.testing.assert_array_equal(decode_image_bytes(data), want)
    np.testing.assert_array_equal(decode_image_bytes(data), _cv2(data, 3))
    path = str(tmp_path / "o.tif")
    with open(path, "wb") as f:
        f.write(data)
    if orientation < 5:
        same_as_cv2(data, tmp_path, jax_cv2_decoder, ".tif")
        return
    assert cv2.imread(path) is None
    with pytest.raises(FileNotFoundError):
        jax_cv2_decoder(path, 3)
    with pytest.raises(ValueError, match="imread"):
        decode_image(path)


def _tiff_refusals():
    rng = np.random.default_rng(9)
    g = rng.integers(0, 4, (8, 8)).astype(np.uint8)
    return {
        "float": (_pil_tiff(Image.fromarray(rng.random((4, 4), np.float32)),
                            "raw"), "format"),
        "32-bit": (_pil_tiff(Image.fromarray(
            rng.integers(0, 1 << 20, (4, 4), np.int32)), "raw"), "32-bit"),
        "2-bit gray": (write_tiff(g, 1, bits=2), "2-bit"),
        "uncompressed 16x16 gray tile": (write_tiff(
            rng.integers(0, 256, (20, 20)).astype(np.uint8), 1,
            tile=(16, 16)), "1024"),
        "strip past the end": (write_tiff(g * 60, 1)[:-120], "cv2"),
    }


@pytest.mark.parametrize("case", sorted(_tiff_refusals()))
def test_tiff_cv2_refuses_raise_naming_the_file(tmp_path, case):
    data, reason = _tiff_refusals()[case]
    refused_naming_the_file(data, tmp_path, ".tif", reason)


# --- WebP ----------------------------------------------------------------------

def _webp(img, **kw):
    b = io.BytesIO()
    img.save(b, format="WEBP", **kw)
    return b.getvalue()


def _riff(chunks):
    body = b"WEBP" + b"".join(tag + struct.pack("<I", len(p)) + p +
                              bytes(len(p) & 1) for tag, p in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _u24(v):
    return struct.pack("<I", v)[:3]


def _webp_kinds():
    rng = np.random.default_rng(11)
    out = {}
    for kind in range(3):
        img = Image.fromarray(_picture(rng, 37, 53, kind))
        out[f"lossless {kind}"] = _webp(img, lossless=True, method=kind * 3)
        out[f"lossy q80 {kind}"] = _webp(img, quality=80, method=kind * 3)
    img = Image.fromarray(_picture(rng, 61, 70))
    out["lossy q5"] = _webp(img, quality=5)
    out["lossy q100"] = _webp(img, quality=100)
    rgba = np.concatenate([_picture(rng, 30, 41),
                           rng.integers(0, 256, (30, 41, 1), np.uint8)], 2)
    out["lossy with alpha"] = _webp(Image.fromarray(rgba, "RGBA"))
    out["lossless with alpha"] = _webp(Image.fromarray(rgba, "RGBA"),
                                       lossless=True)
    frames = [Image.fromarray(_picture(rng, 21, 33, k)) for k in range(3)]
    b = io.BytesIO()
    frames[0].save(b, format="WEBP", save_all=True, append_images=frames[1:],
                   duration=100)
    out["animation"] = b.getvalue()
    # a first frame smaller than its canvas, at an offset
    still = _webp(Image.fromarray(_picture(rng, 9, 13)), lossless=True)
    chunk = still[12:20 + struct.unpack("<I", still[16:20])[0]]
    anmf = (_u24(2) + _u24(3) + _u24(12) + _u24(8) + _u24(100) + b"\x00" +
            chunk)
    out["animation subframe"] = _riff([
        (b"VP8X", b"\x12\x00\x00\x00" + _u24(29) + _u24(23)),
        (b"ANIM", b"\xff\xff\xff\xff\x00\x00"), (b"ANMF", anmf)])
    for o in (3, 6, 8):
        exif = Image.Exif()
        exif[0x0112] = o
        out[f"EXIF orientation {o}"] = _webp(
            Image.fromarray(_picture(rng, 6, 10)), exif=exif.tobytes())
    return out


@pytest.mark.parametrize("kind", sorted(_webp_kinds()))
def test_webp_kinds_match_cv2(tmp_path, jax_cv2_decoder, kind):
    same_as_cv2(_webp_kinds()[kind], tmp_path, jax_cv2_decoder, ".webp")


@pytest.mark.parametrize("lossless", [False, True])
def test_random_webps_match_cv2(lossless):
    rng = np.random.default_rng(20 + lossless)
    for i in range(12):
        h, w = int(rng.integers(1, 90)), int(rng.integers(1, 90))
        img = _picture(rng, h, w, i % 3)
        kw = {"quality": int(rng.integers(0, 101)),
              "method": int(rng.integers(0, 7))}
        same_as_cv2(_webp(Image.fromarray(img), lossless=lossless, **kw))


@pytest.mark.parametrize("case", ["RIFF size past the data",
                                  "cut lossy bitstream",
                                  "cut lossless bitstream"])
def test_webp_cv2_refuses_raise_naming_the_file(tmp_path, case):
    img = Image.fromarray(_picture(np.random.default_rng(5), 40, 40, 0))
    lossy, lossless = _webp(img), _webp(img, lossless=True)

    def cut(data):
        n = len(data) // 2
        return data[:4] + struct.pack("<I", n - 8) + data[8:16] + \
            struct.pack("<I", n - 20) + data[20:n]

    data = {"RIFF size past the data": lossy[:-10],
            "cut lossy bitstream": cut(lossy),
            "cut lossless bitstream": cut(lossless)}[case]
    refused_naming_the_file(data, tmp_path, ".webp", "cv2")


# --- GIF -----------------------------------------------------------------------

def _pil_gif(frames, **kw):
    ims = []
    for idx, pal in frames:
        im = Image.fromarray(np.asarray(idx, np.uint8), "P")
        im.putpalette(np.asarray(pal, np.uint8).ravel().tolist())
        ims.append(im)
    b = io.BytesIO()
    ims[0].save(b, format="GIF", save_all=len(ims) > 1,
                append_images=ims[1:], **kw)
    return b.getvalue()


def _gif_kinds():
    rng = np.random.default_rng(30)
    pal = rng.integers(0, 256, (16, 3))
    pal256 = rng.integers(0, 256, (256, 3))

    def idx(h, w, n=16):
        return rng.integers(0, n, (h, w))

    out = {
        "PIL": _pil_gif([(idx(17, 29), pal)]),
        "PIL interlaced": _pil_gif([(idx(23, 31), pal)], interlace=True),
        "PIL transparent": _pil_gif([(idx(19, 26), pal)], transparency=4),
        "PIL 256 colours": _pil_gif([(idx(40, 50, 256), pal256)]),
        "PIL animation with disposal": _pil_gif(
            [(idx(16, 20), pal) for _ in range(3)], duration=80,
            disposal=2, loop=0),
        "local table over a global one": write_gif(30, 20, [
            {"idx": idx(20, 30), "palette": rng.integers(0, 256, (16, 3))}],
            palette=pal, background=7),
        "local table only": write_gif(30, 20, [
            {"idx": idx(12, 17), "x": 4, "y": 3,
             "palette": rng.integers(0, 256, (16, 3))}], background=9),
        "no table at all": write_gif(16, 16, [
            {"idx": np.arange(256).reshape(16, 16)}], min_code_size=8),
        "frame smaller than the canvas": write_gif(40, 30, [
            {"idx": idx(11, 13), "x": 20, "y": 15}], palette=pal,
            background=3),
        "transparent interlaced subframe": write_gif(40, 30, [
            {"idx": idx(13, 21), "x": 5, "y": 9, "interlace": True,
             "transparent": 1, "disposal": 3},
            {"idx": idx(30, 40)}], palette=pal, background=2),
        "table full, no clear code": write_gif(
            300, 200, [{"idx": idx(200, 300)}], palette=pal,
            defer_clear=True),
        "clear codes every 50 codes": write_gif(
            60, 40, [{"idx": idx(40, 60)}], palette=pal, clear_every=50),
        "no end code": write_gif(30, 20, [{"idx": idx(20, 30)}],
                                 palette=pal, end_code=False),
        "code size 11": write_gif(30, 20, [{"idx": idx(20, 30)}],
                                  palette=pal, min_code_size=11),
        "GIF87a": write_gif(30, 20, [{"idx": idx(20, 30)}], palette=pal,
                            version=b"87a"),
    }
    plain = write_gif(30, 20, [{"idx": idx(20, 30)}], palette=pal)
    out["comment, plain text and unknown extensions"] = (
        plain[:61] + b"\x21\xfe\x03abc\x00\x21\x01\x0c" + bytes(12) +
        b"\x02ab\x00\x21\x99\x02ab\x00" + plain[61:])
    for i, shape in enumerate([(20, 28, 3), (9, 7, 3)]):
        ok, buf = cv2.imencode(".gif", rng.integers(0, 256, shape, np.uint8))
        out[f"cv2 {i}"] = buf.tobytes()
    return out


@pytest.mark.parametrize("kind", sorted(_gif_kinds()))
def test_gif_kinds_match_cv2(tmp_path, jax_cv2_decoder, kind):
    same_as_cv2(_gif_kinds()[kind], tmp_path, jax_cv2_decoder, ".gif")


def _gif_refusals():
    rng = np.random.default_rng(31)
    pal = rng.integers(0, 256, (16, 3))
    img = rng.integers(0, 16, (10, 12))
    good = write_gif(12, 10, [{"idx": img}], palette=pal)
    return {
        "background past the table": write_gif(12, 10, [{"idx": img}],
                                               palette=pal, background=20),
        "frame past the canvas": write_gif(12, 10, [
            {"idx": img, "x": 3}], palette=pal),
        "no trailer": good[:-1],
        "short data": write_gif(12, 10, [{"idx": img[:5]}], palette=pal)
        .replace(b"\x0c\x00\x05\x00", b"\x0c\x00\x0a\x00", 1),
        "index past the table": write_gif(12, 10, [{"idx": img}],
                                          palette=pal[:4]),
        "code size 1": write_gif(12, 10, [{"idx": img % 2}], palette=pal,
                                 min_code_size=1),
        "control extension of 5 bytes": good[:61] +
        b"\x21\xf9\x05\x01\x00\x00\x03\x00\x00" + good[61:],
        "first frame's disposal method 5": write_gif(
            12, 10, [{"idx": img, "disposal": 5}], palette=pal),
        "XMP application extension": good[:61] +
        b"\x21\xff\x0bXMP DataXMP\x03\x01\x00\x00\x00" + good[61:],
    }


@pytest.mark.parametrize("case", sorted(_gif_refusals()))
def test_gif_cv2_refuses_raise_naming_the_file(tmp_path, case):
    refused_naming_the_file(_gif_refusals()[case], tmp_path, ".gif", "cv2")


@pytest.mark.parametrize("case", ["two bytes past the end code",
                                  "end code before the last pixel"])
def test_gif_kinds_not_reproduced_raise(case):
    """LZW data beyond an end code and its padding: cv2 5 keeps or
    refuses such streams by rules of its own (ROADMAP C20); the port
    raises saying so, whatever cv2 gives."""
    rng = np.random.default_rng(32)
    pal = rng.integers(0, 256, (16, 3))
    img = rng.integers(0, 16, (8, 8))
    if case == "two bytes past the end code":
        data = lzw_encode(img, 4) + b"\x00\x00"
    else:   # a clear code before each pixel: 5-bit codes throughout
        codes = [c for v in img.ravel() for c in (16, int(v))]
        codes = codes[:40] + [17] + codes[40:]
        acc = sum(c << (5 * i) for i, c in enumerate(codes))
        data = acc.to_bytes((5 * len(codes) + 7) // 8, "little")
    head = write_gif(8, 8, [{"idx": img}], palette=pal)
    start = head.index(b"\x2c") + 10
    gif = head[:start] + bytes([4, len(data)]) + data + b"\x00\x3b"
    for c in (3, 1):
        with pytest.raises(ValueError, match="unsupported here"):
            decode_image_bytes(gif, c)


# --- Sun raster ----------------------------------------------------------------

def _sunras_kinds():
    rng = np.random.default_rng(33)
    out = {}
    for depth in (1, 8, 24, 32):
        for typ in (RT_OLD, RT_STANDARD):
            for h, w in ((7, 11), (4, 16)):
                px = (rng.integers(0, 2, (h, w)) if depth == 1 else
                      rng.integers(0, 256, (h, w)) if depth == 8 else
                      rng.integers(0, 256, (h, w, depth // 8)))
                out[f"{depth}-bit type {typ} {w} wide"] = write_sunras(
                    px, depth, typ)
                if depth <= 8:
                    n = 1 << depth
                    out[f"{depth}-bit type {typ} {w} wide, colour map"] = \
                        write_sunras(px, depth, typ,
                                     rng.integers(0, 256, (n, 3)))
    px = rng.integers(0, 256, (6, 9))
    out["8-bit, a short colour map"] = write_sunras(
        px, 8, colormap=rng.integers(0, 256, (40, 3)))
    out["8-bit, a gray colour map"] = write_sunras(
        px, 8, colormap=np.repeat(rng.integers(0, 256, (256, 1)), 3, 1))
    for i, shape in enumerate([(9, 13, 3), (8, 11)]):
        ok, buf = cv2.imencode(".ras", rng.integers(0, 256, shape, np.uint8))
        out[f"cv2 {i}"] = buf.tobytes()
    return out


@pytest.mark.parametrize("kind", sorted(_sunras_kinds()))
def test_sunras_kinds_match_cv2(tmp_path, jax_cv2_decoder, kind):
    same_as_cv2(_sunras_kinds()[kind], tmp_path, jax_cv2_decoder, ".ras")


def _sunras_refusals():
    rng = np.random.default_rng(34)
    px8, px24 = rng.integers(0, 256, (6, 9)), rng.integers(0, 256, (6, 9, 3))
    good = write_sunras(px24, 24)
    return {
        # OpenCV 5 checks these two types against its unset image type
        "byte-encoded (RLE) type": write_sunras(px8, 8, RT_BYTE_ENCODED),
        "RGB type": write_sunras(px24, 24, RT_FORMAT_RGB),
        "depth 4": good[:12] + struct.pack(">I", 4) + good[16:],
        "colour map on a 24-bit file": write_sunras(
            px24, 24, colormap=rng.integers(0, 256, (4, 3))),
        "colour map past 3 << depth": write_sunras(
            px8 % 2, 1, colormap=rng.integers(0, 256, (3, 3))),
        "truncated rows": good[:-5],
    }


@pytest.mark.parametrize("case", sorted(_sunras_refusals()))
def test_sunras_cv2_refuses_raise_naming_the_file(tmp_path, case):
    refused_naming_the_file(_sunras_refusals()[case], tmp_path, ".ras",
                            "cv2")


# --- PFM -----------------------------------------------------------------------

def _pfm(values, scale, header=None):
    tag = b"PF" if values.ndim == 3 else b"Pf"
    h, w = values.shape[:2]
    head = header or tag + f"\n{w} {h}\n{scale}\n".encode()
    return head + np.ascontiguousarray(values[::-1]).astype(
        "<f4" if scale < 0 else ">f4").tobytes()


_SPECIAL = np.array([0, 0.49, 0.5, 0.51, 1.5, 2.5, 254.5, 255.5, 300, -0.5,
                     -3, np.nan, np.inf, -np.inf, 1e10, 2.0 ** 31,
                     2.0 ** 31 - 128, 127.5], np.float32)


def _pfm_kinds():
    rng = np.random.default_rng(35)
    rgb = rng.normal(120, 100, (9, 21, 3)).astype(np.float32)
    rgb[0, :len(_SPECIAL), 0] = _SPECIAL
    gray = rng.normal(120, 100, (11, 19)).astype(np.float32)
    gray[1, :len(_SPECIAL)] = _SPECIAL
    return {
        "RGB little-endian": (_pfm(rgb, -1.0), 3),
        "RGB big-endian": (_pfm(rgb, 1.0), 3),
        "RGB scale 3": (_pfm(rgb, -3.0), 3),
        "RGB scale 0.25, big-endian": (_pfm(rgb, 0.25), 3),
        "gray little-endian": (_pfm(gray, -1.0), 1),
        "gray big-endian scale 2": (_pfm(gray, 2.0), 1),
    }


@pytest.mark.parametrize("kind", sorted(_pfm_kinds()))
def test_pfm_kinds_match_cv2(tmp_path, kind):
    """At the file's own channel count the port gives cv2's bytes (the
    float conversion's rounding, saturation, NaN and Inf included); at
    the other, where cv2 gives an image of the file's channels (imdecode)
    or none (imread), the port raises."""
    data, nch = _pfm_kinds()[kind]
    path = str(tmp_path / "kind.pfm")
    with open(path, "wb") as f:
        f.write(data)
    want = _cv2(data, nch)
    np.testing.assert_array_equal(decode_image_bytes(data, nch), want)
    np.testing.assert_array_equal(decode_image(path, nch), want)
    other = 4 - nch
    assert cv2.imread(path, cv2.IMREAD_COLOR if other == 3
                      else cv2.IMREAD_GRAYSCALE) is None
    with pytest.raises(ValueError, match="unsupported here"):
        decode_image(path, other)
    with pytest.raises(ValueError, match="unsupported here"):
        decode_image_bytes(data, other)


@pytest.mark.parametrize("case", ["scale 0", "width 0", "truncated",
                                  "two blanks between numbers",
                                  "no line break after PF"])
def test_pfm_cv2_refuses_raise_naming_the_file(tmp_path, case):
    v = np.ones((3, 4, 3), np.float32)
    data = {"scale 0": _pfm(v, -1.0, b"PF\n4 3\n0\n"),
            "width 0": _pfm(v, -1.0, b"PF\n0 3\n-1\n"),
            "truncated": _pfm(v, -1.0)[:-7],
            "two blanks between numbers": _pfm(v, -1.0, b"PF\n4  3\n-1\n"),
            "no line break after PF": _pfm(v, -1.0, b"PF 4 3\n-1\n")}[case]
    path = str(tmp_path / "bad.pfm")
    with open(path, "wb") as f:
        f.write(data)
    for c in (3, 1):
        try:   # a size of 0 fails an assertion in cv2 (cv2.error)
            assert _cv2(data, c) is None
        except cv2.error:
            pass
        with pytest.raises(ValueError) as err:
            decode_image(path, c)
        assert path in str(err.value)
        assert "cv2 gives no image either" in str(err.value)


# --- Radiance HDR --------------------------------------------------------------

def _hdr(rgbe_bytes, w, h, header=None):
    head = header or (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                      + f"-Y {h} +X {w}\n".encode())
    return head + rgbe_bytes


def _rgbe(rng, h, w):
    px = rng.integers(0, 256, (h, w, 4))
    px[..., 3] = rng.integers(118, 140, (h, w))
    px[rng.random((h, w)) < 0.1] = 0
    return px.astype(np.uint8)


def _rle_line(line):
    """One new-RLE scanline of (w, 4) RGBE: runs of 4+, literals."""
    out = bytearray([2, 2, line.shape[0] >> 8, line.shape[0] & 0xFF])
    for c in range(4):
        v = line[:, c].tobytes()
        i = 0
        while i < len(v):
            n = 1
            while i + n < len(v) and v[i + n] == v[i] and n < 127:
                n += 1
            if n >= 4:
                out += bytes([128 + n, v[i]])
            else:
                j = i
                while j < len(v) and j - i < 128 and not (
                        j + 3 < len(v) and v[j] == v[j + 1] == v[j + 2]
                        == v[j + 3]):
                    j += 1
                n = max(j - i, 1)
                out += bytes([n]) + v[i:i + n]
            i += n
    return bytes(out)


def _hdr_kinds():
    rng = np.random.default_rng(36)
    flat = _rgbe(rng, 5, 7)
    runs = np.repeat(_rgbe(rng, 6, 5), 4, 1)
    old = _rgbe(rng, 6, 12)
    old[rng.random((6, 12)) < 0.2] = [1, 1, 1, 2]
    out = {
        "flat, 7 wide": _hdr(flat.tobytes(), 7, 5),
        "flat, 20 wide": _hdr(_rgbe(rng, 3, 20).tobytes(), 20, 3),
        "old run-length pixels": _hdr(old.tobytes(), 12, 6),
        "new run-length": _hdr(b"".join(_rle_line(r) for r in runs), 20, 6),
        "run-length, then flat": _hdr(_rle_line(runs[0]) +
                                      runs[1:].tobytes(), 20, 6),
        "#?RGBE and lines after FORMAT": _hdr(
            flat.tobytes(), 7, 5, b"#?RGBE\n# made by hand\nFORMAT=32-bit_"
            b"rle_rgbe\nEXPOSURE=2.0\nGAMMA=2.2\n\n-Y 5 +X 7\n"),
    }
    for i, shape in enumerate([(9, 13, 3), (8, 11), (4, 5, 3)]):
        ok, buf = cv2.imencode(".hdr", rng.integers(0, 256, shape, np.uint8))
        out[f"cv2 {i}"] = buf.tobytes()
    return out


@pytest.mark.parametrize("kind", sorted(_hdr_kinds()))
def test_hdr_kinds_match_cv2(tmp_path, jax_cv2_decoder, kind):
    same_as_cv2(_hdr_kinds()[kind], tmp_path, jax_cv2_decoder, ".hdr")


@pytest.mark.parametrize("case", [
    "no FORMAT line", "XYZE format", "+Y orientation", "CRLF lines",
    "truncated run-length", "truncated flat", "scanline of another width",
    "run past the scanline", "zero count"])
def test_hdr_cv2_refuses_raise_naming_the_file(tmp_path, case):
    rng = np.random.default_rng(37)
    line = _rle_line(np.repeat(_rgbe(rng, 1, 3), 4, 1)[0])
    good = _hdr(line * 2, 12, 2)
    data = {
        "no FORMAT line": _hdr(line, 12, 1, b"#?RADIANCE\n\n-Y 1 +X 12\n"),
        "XYZE format": _hdr(line, 12, 1, b"#?RADIANCE\nFORMAT=32-bit_rle_"
                            b"xyze\n\n-Y 1 +X 12\n"),
        "+Y orientation": _hdr(line, 12, 1, b"#?RADIANCE\nFORMAT=32-bit_"
                               b"rle_rgbe\n\n+Y 1 +X 12\n"),
        "CRLF lines": _hdr(line, 12, 1, b"#?RADIANCE\r\nFORMAT=32-bit_rle_"
                           b"rgbe\r\n\r\n-Y 1 +X 12\r\n"),
        "truncated run-length": good[:-3],
        "truncated flat": _hdr(bytes(4 * 5), 3, 2),
        "scanline of another width": _hdr(line + b"\x02\x02\x00\x0d"
                                          + line[4:], 12, 2),
        "run past the scanline": _hdr(b"\x02\x02\x00\x0c\x8d\x05", 12, 1),
        "zero count": _hdr(b"\x02\x02\x00\x0c\x00\x05", 12, 1),
    }[case]
    refused_naming_the_file(data, tmp_path, ".hdr", "cv2")


# --- dispatch ----------------------------------------------------------------

def test_the_signature_chooses_the_decoder(tmp_path, jax_cv2_decoder):
    """A BMP named .jpg, a WebP named .png: cv2 and the port both read
    by the bytes; an unknown signature raises naming the file."""
    rng = np.random.default_rng(12)
    img = _picture(rng, 8, 9)
    same_as_cv2(write_bmp(img[..., ::-1], 24), tmp_path, jax_cv2_decoder,
                ".jpg")
    same_as_cv2(_webp(Image.fromarray(img), lossless=True), tmp_path,
                jax_cv2_decoder, ".png")
    path = str(tmp_path / "x.bmp")
    with open(path, "wb") as f:
        f.write(b"\0\0\0\x0cjX  \r\n\x87\n" + bytes(40))   # no format
    with pytest.raises(ValueError, match="not an image format") as err:
        decode_image(path)
    assert path in str(err.value)


@pytest.mark.parametrize("ext", [".avif", ".jp2"])
def test_avif_and_jpeg2000_raise_as_not_ported(tmp_path, ext):
    """cv2 writes and reads AVIF (libavif) and JPEG 2000 (OpenJPEG); the
    port reads JPEG 2000 (data/jp2.py) to cv2's bytes, and says AVIF is
    not ported (ROADMAP A9a), naming the file (cv2's JPEG 2000 encoder
    refused a 16x24 image, so the image is 32x40)."""
    img = _picture(np.random.default_rng(13), 32, 40)
    ok, buf = cv2.imencode(ext, img[..., ::-1])
    assert ok and _cv2(buf.tobytes(), 3) is not None
    path = str(tmp_path / f"x{ext}")
    with open(path, "wb") as f:
        f.write(buf.tobytes())
    for c in (3, 1):
        if ext == ".jp2":
            np.testing.assert_array_equal(decode_image(path, c),
                                          _cv2(buf.tobytes(), c))
            continue
        with pytest.raises(ValueError, match="AVIF is not ported") as err:
            decode_image(path, c)
        assert path in str(err.value)


# --- the slice ---------------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A seeded scene as BMP, PGM, TIFF (LZW) and WebP (lossless and
    lossy) files, seeded tiny-voc weights shaped like a trained
    detector's."""
    from tests.torch_port import he_weights
    from yolo_tpu_torch.configs import get_variant
    from yolo_tpu_torch.data.synthetic import write_voc_scenes

    d = tmp_path_factory.mktemp("formats")
    pairs = write_voc_scenes(str(d), [(90, 120)], np.random.default_rng(13),
                             jpeg_quality=95)
    rgb = decode_image(pairs[0][0])
    files = {}
    for name, data in {
            "scene.bmp": write_bmp(rgb[..., ::-1], 24),
            "scene.pgm": b"P5 120 90 255\n" + cv2.cvtColor(
                rgb, cv2.COLOR_RGB2GRAY).tobytes(),
            "scene.tif": _pil_tiff(Image.fromarray(rgb), "tiff_lzw"),
            "scene.webp": _webp(Image.fromarray(rgb), lossless=True),
            "lossy.webp": _webp(Image.fromarray(rgb), quality=80)}.items():
        files[name] = str(d / name)
        with open(files[name], "wb") as f:
            f.write(data)
    weights = str(d / "tiny-voc.weights")
    he_weights(get_variant("tiny-voc"), weights, box_scale=0.1,
               objectness_shift=-2.0)
    return {"dir": d, "files": files, "weights": weights}


def test_slice_detections_match_jax_on_cv2s_decode(scene):
    """BMP, TIFF and WebP-lossless: the port's decode + detect_raw give
    the JAX detector's boxes on cv2's decode of the same file (fp32)."""
    import jax.numpy as jnp

    from tests.torch_port import to_jax_config
    from yolo_tpu.io import darknet_weights as jdw
    from yolo_tpu.models import graph as jgraph
    from yolo_tpu.models.predict import make_detector as jax_make_detector
    import yolo_tpu_torch
    from yolo_tpu_torch.models.predict import detect_raw

    model = yolo_tpu_torch.load(scene["weights"], "tiny-voc", device="cpu",
                                precision="fp32", input_size=160)
    jcfg = to_jax_config(model.cfg)
    params, _ = jdw.load(scene["weights"], jcfg.layers)
    jparams = jgraph.params_to_jax(jgraph.fold_params(jcfg.layers, params,
                                                      jcfg.bn_eps))
    detector = jax_make_detector(jcfg, compute_dtype=jnp.float32,
                                 head="fused")
    for name in ("scene.bmp", "scene.tif", "scene.webp"):
        path = scene["files"][name]
        frame = decode_image(path)
        ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(frame, ref)
        got = detect_raw(model.cfg, model.params,
                         torch.from_numpy(frame[None]), head="fused")
        want = detector(jparams, jnp.asarray(ref[None]))
        v = np.asarray(want["valid"])
        assert v.sum() >= 1, name
        np.testing.assert_array_equal(got["valid"].numpy(), v)
        np.testing.assert_array_equal(got["classes"].numpy()[v],
                                      np.asarray(want["classes"])[v])
        np.testing.assert_allclose(got["boxes"].numpy()[v],
                                   np.asarray(want["boxes"])[v], rtol=0,
                                   atol=1e-2)


def _cli(argv, capsys, port):
    from yolo_tpu import cli as jcli
    from yolo_tpu_torch import cli as tcli

    if port:
        tcli.main(list(argv) + ["--device", "cpu"])
    else:
        jcli.main(list(argv))
    return [json.loads(l) for l in capsys.readouterr().out.splitlines() if l]


def _same_dets(want, got):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g["class"] == w["class"]
        assert abs(g["score"] - w["score"]) <= 1e-4 + 1e-9
        np.testing.assert_allclose(g["box_xyxy"], w["box_xyxy"], rtol=0,
                                   atol=0.1 + 1e-6)


@pytest.mark.parametrize("name", ["scene.bmp", "scene.pgm", "scene.tif",
                                  "scene.webp", "lossy.webp"])
def test_predict_image_matches_jax(scene, capsys, name):
    argv = ["predict", "--model", "tiny-voc", "--input-size", "96",
            "--weights", scene["weights"], "--precision", "fp32",
            "--image", scene["files"][name], "--conf", "0.1"]
    want = _cli(argv, capsys, port=False)
    got = _cli(argv, capsys, port=True)
    assert len(want) >= 1
    _same_dets(want, got)


def test_detect_images_with_a_bmp_matches_jax(scene, capsys, tmp_path):
    images = tmp_path / "images"
    images.mkdir()
    shutil.copy(scene["files"]["scene.bmp"], images / "a.bmp")
    shutil.copy(scene["files"]["scene.webp"], images / "b.webp")  # unlisted
    with open(images / "c.png", "wb") as f:
        from yolo_tpu_torch.data.png import encode_png

        f.write(encode_png(decode_image(scene["files"]["scene.tif"])[::2]))
    argv = ["detect", "--model", "tiny-voc", "--input-size", "96",
            "--weights", scene["weights"], "--precision", "fp32",
            "--images", str(images), "--conf", "0.1"]
    want = _cli(argv, capsys, port=False)
    got = _cli(argv, capsys, port=True)
    assert [r["image"] for r in got] == [r["image"] for r in want]
    assert [os.path.basename(r["image"]) for r in want] == ["a.bmp", "c.png"]
    for w, g in zip(want, got):
        _same_dets(w["detections"], g["detections"])


def test_server_bodies_of_every_format_equal_direct_calls(scene):
    """POST /detect with BMP, PGM, TIFF and WebP bodies: the port's
    answer is its detection on cv2.imdecode's frame, the one the JAX
    server decodes."""
    import http.client

    import yolo_tpu_torch
    from yolo_tpu_torch.serve import DetectionServer, detections_to_json

    model = yolo_tpu_torch.load(scene["weights"], "tiny-voc", device="cpu",
                                precision="fp32", input_size=96,
                                conf_threshold=0.1)
    server = DetectionServer(model.cfg, model.params, port=0,
                             conf_threshold=0.1)
    server.start()
    try:
        for name, path in sorted(scene["files"].items()):
            body = open(path, "rb").read()
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=120)
            try:
                conn.request("POST", "/detect", body=body,
                             headers={"Content-Type": "image/" + name[-4:]})
                resp = conn.getresponse()
                status, answer = resp.status, json.loads(resp.read())
            finally:
                conn.close()
            frame = cv2.cvtColor(cv2.imdecode(np.frombuffer(body, np.uint8),
                                              cv2.IMREAD_COLOR),
                                 cv2.COLOR_BGR2RGB)
            direct = detections_to_json(model(frame[None]),
                                        model.cfg.class_names)[0]
            assert status == 200 and answer["detections"] == direct, name
    finally:
        server.stop()


def test_image_dims_of_the_new_formats(scene):
    from yolo_tpu_torch.data.darknet_list import image_dims

    for path in scene["files"].values():
        assert image_dims(path) == (120, 90)


def _cli_rc(argv, capsys, port):
    """_cli, or the SystemExit's message where the command exits."""
    try:
        return _cli(argv, capsys, port)
    except SystemExit as e:
        capsys.readouterr()
        return str(e)


def _outside_labels(shape, dets):
    """Pixels outside the label texts of a command's detection lines
    (tests/test_torch_viz.py's glyph boxes, grown by a pixel: the lines
    round the boxes to 0.1 px, the drawings take them unrounded)."""
    from tests.test_torch_viz import _glyph_mask
    from yolo_tpu_torch.configs import get_variant

    names = get_variant("tiny-voc").class_names
    mask = _glyph_mask(shape, [d["box_xyxy"] for d in dets],
                       [d["score"] for d in dets],
                       [names.index(d["class"]) for d in dets], names)
    grown = mask.copy()
    grown[1:] |= mask[:-1]
    grown[:-1] |= mask[1:]
    grown[:, 1:] |= grown[:, :-1].copy()
    grown[:, :-1] |= grown[:, 1:].copy()
    return ~grown


@pytest.mark.parametrize("ext", [".tif", ".webp"])
def test_predict_output_tif_and_webp_match_jax(scene, capsys, tmp_path, ext):
    """predict --image X --output Y.tif / Y.webp: JAX writes through
    cv2.imwrite, the port through its own writers. Decoded, the two files
    agree outside the label texts (whose glyphs are the port's own font,
    tests/test_torch_viz.py), and cv2 and the port read the port's file
    alike."""
    src = scene["files"]["scene.tif" if ext == ".tif" else "scene.webp"]
    outs = {}
    for port in (False, True):
        out = str(tmp_path / f"{'port' if port else 'jax'}{ext}")
        argv = ["predict", "--model", "tiny-voc", "--input-size", "96",
                "--weights", scene["weights"], "--precision", "fp32",
                "--image", src, "--conf", "0.1", "--output", out]
        outs[port] = (_cli(argv, capsys, port), out)
    (want, jpath), (got, ppath) = outs[False], outs[True]
    assert len(want) >= 1
    _same_dets(want, got)
    jax_img = cv2.imread(jpath)[..., ::-1]
    port_img = decode_image(ppath)
    np.testing.assert_array_equal(cv2.imread(ppath)[..., ::-1], port_img)
    outside = _outside_labels(jax_img.shape, got)
    assert outside.mean() > 0.4
    np.testing.assert_array_equal(port_img[outside], jax_img[outside])


def test_detect_images_output_dir_lists_the_same_files(scene, capsys,
                                                       tmp_path):
    """detect --images --output-dir: both CLIs list .jpg/.jpeg/.png/.bmp
    only (yolo_tpu/cli/detect_cmds.py), so a folder of a .tif and a .webp
    ends both with 'no images found'; beside a .bmp, both annotate the
    .bmp alone, under its own name, to the same pixels outside the label
    texts."""
    images = tmp_path / "images"
    images.mkdir()
    shutil.copy(scene["files"]["scene.tif"], images / "a.tif")
    shutil.copy(scene["files"]["scene.webp"], images / "b.webp")
    base = ["detect", "--model", "tiny-voc", "--input-size", "96",
            "--weights", scene["weights"], "--precision", "fp32",
            "--images", str(images), "--conf", "0.1"]
    refusals = [_cli_rc(base + ["--output-dir", str(tmp_path / f"o{p}")],
                        capsys, p) for p in (False, True)]
    assert refusals[0] == refusals[1] and "no images found" in refusals[0]
    shutil.copy(scene["files"]["scene.bmp"], images / "c.bmp")
    lines = {}
    for port in (False, True):
        lines[port] = _cli(base + ["--output-dir", str(tmp_path /
                                                       f"o{port}")],
                           capsys, port)
        assert sorted(os.listdir(tmp_path / f"o{port}")) == ["c.bmp"]
    assert [os.path.basename(r["image"]) for r in lines[True]] == ["c.bmp"]
    _same_dets(lines[False][0]["detections"], lines[True][0]["detections"])
    jax_img = cv2.imread(str(tmp_path / "oFalse" / "c.bmp"))[..., ::-1]
    port_img = decode_image(str(tmp_path / "oTrue" / "c.bmp"))
    outside = _outside_labels(jax_img.shape, lines[True][0]["detections"])
    assert outside.mean() > 0.4
    np.testing.assert_array_equal(port_img[outside], jax_img[outside])
