#!/usr/bin/env python3
"""Write the JPEG parity fixtures of tests/data/torch_jpeg/ and the
hashes of what OpenCV decodes from them.

    python3 tools/jpeg_fixtures.py [--out tests/data/torch_jpeg]

Needs OpenCV and Pillow (the encoders; the card machine has neither).
Each fixture is encoded by cv2.imencode or PIL from a seeded image, and
hashes.json records, for each file, the sha256 and shape of
cv2.imread(IMREAD_COLOR) after COLOR_BGR2RGB ("rgb") and of
cv2.imread(IMREAD_GRAYSCALE) ("gray"). tests/test_torch_decode.py and
chip_smoke.py hold the port's decoder to those hashes.
"""

import argparse
import hashlib
import io
import json
import os

import cv2
import numpy as np
from PIL import Image

SEED = 7


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


def digest(img: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest(), "shape": list(img.shape)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "data", "torch_jpeg"))
    out = ap.parse_args().out
    os.makedirs(out, exist_ok=True)
    hashes = {}
    for name, data in fixtures().items():
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
