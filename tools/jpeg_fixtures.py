#!/usr/bin/env python3
"""Write the image parity fixtures of tests/data/torch_jpeg/ and the
hashes of what OpenCV decodes from them.

    python3 tools/jpeg_fixtures.py [--out tests/data/torch_jpeg]

Needs OpenCV and Pillow (the encoders; the card machine has neither).
Each fixture is encoded from a seeded image by cv2.imencode or PIL, or
from seeded coefficient blocks by the tests' own writers
(tests/jpeg_writer.py: multi-scan, smoothed progressive, YCCK and
arithmetic-coded JPEGs; tests/png_writer.py: an interlaced PNG), and
hashes.json records, for each file, the sha256 and shape of
cv2.imread(IMREAD_COLOR) after COLOR_BGR2RGB ("rgb") and of
cv2.imread(IMREAD_GRAYSCALE) ("gray"). tests/test_torch_decode.py and
chip_smoke.py hold the port's decoder to those hashes;
PROGRESSIVE_FRAME is the 480x640 progressive file whose decode rate
chip_smoke.py's phase 14 (c) reads.
"""

import argparse
import hashlib
import io
import json
import os
import struct
import sys

import cv2
import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests import jpeg_writer as jw  # noqa: E402
from tests.png_writer import write_png  # noqa: E402

SEED = 7
PROGRESSIVE_FRAME = "prog_420_q85_480x640.jpg"


def picture(rng, h, w):
    """Ramps, a few filled shapes and mild noise: an image with edges
    and smooth regions, so that every coefficient range is used."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx + yy) * 127 // max(w + h - 2, 1)], -1).astype(np.int64)
    for _ in range(4):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0:y0 + max(h // 3, 1), x0:x0 + max(w // 3, 1)] = rng.integers(
            0, 256, 3)
    img += rng.integers(-12, 13, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def cv2_jpeg(img, quality, sampling=None, restart=0, optimize=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_OPTIMIZE, optimize]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, {
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}[sampling]]
    src = img[..., ::-1] if img.ndim == 3 else img
    ok, buf = cv2.imencode(".jpg", src, params)
    assert ok
    return buf.tobytes()


def cv2_progressive(img, quality, sampling, restart=0):
    flag = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}[sampling]
    ok, buf = cv2.imencode(".jpg", img[..., ::-1], [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag,
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    return buf.tobytes()


def writer_kinds(rng):
    """The files neither cv2 nor PIL writes, from coefficient blocks."""
    f422 = jw.Frame(43, 29, [(2, 1), (1, 1), (1, 1)])
    scans = jw.sequential_script(f422, [[2], [0], [1]])
    scans[1].restart = 2
    f420 = jw.Frame(45, 37, [(2, 2), (1, 1), (1, 1)])
    smoothed = [jw.Scan([0, 1, 2], 0, 0, 0, 0)] + [
        jw.Scan([i], 1, 5, 0, 1) for i in range(3)]
    ycck = jw.Frame(41, 23, [(2, 2), (1, 1), (1, 1), (2, 2)])
    arith = jw.Frame(53, 31, [(2, 2), (1, 1), (1, 1)])
    f444 = jw.Frame(37, 29, [(1, 1)] * 3)
    return {
        "multiscan_422_29x43.jpg": jw.write_jpeg(
            f422, jw.random_coefficients(rng, f422), scans, late_dqt=True),
        "prog_smoothed_420_37x45.jpg": jw.write_jpeg(
            f420, jw.random_coefficients(rng, f420, ac_scale=0.6), smoothed,
            progressive=True),
        "ycck_adobe2_2211_23x41.jpg": jw.write_jpeg(
            ycck, jw.random_coefficients(rng, ycck, dc_range=120),
            jfif=False, adobe=2),
        "arith_420_rst2_31x53.jpg": jw.write_jpeg(
            arith, jw.random_coefficients(rng, arith),
            jw.sequential_script(arith, restart=2), arithmetic=True),
        "arith_prog_444_29x37.jpg": jw.write_jpeg(
            f444, jw.random_coefficients(rng, f444),
            jw.progressive_script(f444, restart=3, al=2),
            progressive=True, arithmetic=True),
    }


def pil_jpeg(img, quality, subsampling, orientation=None):
    b = io.BytesIO()
    kw = {}
    if orientation is not None:
        exif = Image.Exif()
        exif[0x0112] = orientation
        kw["exif"] = exif.tobytes()
    Image.fromarray(img).save(b, "JPEG", quality=quality,
                              subsampling=subsampling, **kw)
    return b.getvalue()


def fixtures():
    rng = np.random.default_rng(SEED)
    noise = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    return {
        "444_q75_333x517.jpg": cv2_jpeg(picture(rng, 333, 517), 75, "444"),
        "422_q90_7x13.jpg": cv2_jpeg(picture(rng, 7, 13), 90, "422"),
        "420_q95_333x517.jpg": cv2_jpeg(picture(rng, 333, 517), 95, "420"),
        "440_q85_17x33.jpg": cv2_jpeg(picture(rng, 17, 33), 85, "440"),
        "411_q80_61x97.jpg": cv2_jpeg(picture(rng, 61, 97), 80, "411"),
        "420_q90_1x1.jpg": cv2_jpeg(picture(rng, 1, 1), 90, "420"),
        "gray_q90_121x160.jpg": cv2_jpeg(picture(rng, 121, 160)[..., 0], 90),
        "420_q70_rst3_optimize_121x160.jpg": cv2_jpeg(
            picture(rng, 121, 160), 70, "420", restart=3, optimize=1),
        "444_q100_noise_64x64.jpg": cv2_jpeg(noise, 100, "444"),
        "420_q100_noise_64x64.jpg": cv2_jpeg(noise, 100, "420"),
        "pil_420_q90_exif6_40x64.jpg": pil_jpeg(picture(rng, 40, 64), 90, 2,
                                                orientation=6),
        "pil_444_q60_exif5_33x21.jpg": pil_jpeg(picture(rng, 33, 21), 60, 0,
                                                orientation=5),
    }


def new_kinds():
    """The kinds the decoder reads since the buffered path: progressive
    (cv2's script, with restarts, and a 480x640 frame), CMYK (PIL),
    the writers' files, an interlaced PNG and a gamma PNG."""
    rng = np.random.default_rng(SEED + 1)
    b = io.BytesIO()
    Image.fromarray(picture(rng, 24, 40)).convert("CMYK").save(
        b, "JPEG", quality=90)
    out = {
        "prog_420_q85_61x97.jpg": cv2_progressive(picture(rng, 61, 97), 85,
                                                  "420"),
        "prog_444_q80_rst2_40x64.jpg": cv2_progressive(
            picture(rng, 40, 64), 80, "444", restart=2),
        PROGRESSIVE_FRAME: cv2_progressive(picture(rng, 480, 640), 85,
                                           "420"),
        "cmyk_pil_q90_24x40.jpg": b.getvalue(),
        **writer_kinds(rng),
    }
    pix = picture(rng, 33, 47).astype(np.int64)
    out["adam7_rgb_33x47.png"] = write_png(pix, 8, 2, (0, 1, 2, 3, 4),
                                           interlace=True)
    out["srgb_rgb16_33x47.png"] = write_png(
        pix * 257 + rng.integers(0, 257, pix.shape), 16, 2, (4,),
        chunks=[(b"sRGB", b"\0"), (b"gAMA", struct.pack(">I", 45455))])
    return out


def digest(img: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest(), "shape": list(img.shape)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "torch_jpeg"))
    out = ap.parse_args().out
    os.makedirs(out, exist_ok=True)
    hashes = {}
    for name, data in {**fixtures(), **new_kinds()}.items():
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(data)
        rgb = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                           cv2.COLOR_BGR2RGB)
        gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE)[..., None]
        hashes[name] = {"rgb": digest(rgb), "gray": digest(gray)}
    with open(os.path.join(out, "hashes.json"), "w") as f:
        json.dump({"decoder": f"OpenCV {cv2.__version__}",
                   "files": hashes}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
