#!/usr/bin/env python3
"""The JPEG 2000 writer (data/jp2.py::encode_jp2) against cv2.imwrite's
.jp2 bytes on seeded images of many sizes and textures.

    python3 tools/jp2_write_fuzz.py [--seed 0] [--cases 300] [--big]

Needs OpenCV (the reference writer; the card machine has none). Each
case is a random size from 32 to 259 a side, colour or gray, one of:
uniform noise, ramps with seeded noise, a Gaussian blur of noise (the
frames that tend to fit whole at rate 4, where the rate allocation's
early stop decides), sparse dots, or flat blocks. --big adds 480x640 to
1080x1920 frames and extreme aspect ratios. Prints one JSON line: the
cases, how many gave cv2's bytes, the first mismatches (their seed,
index, shape and kind), and the port's and cv2's encode seconds in all.
Exit 1 on any mismatch.
"""

import argparse
import json
import os
import sys
import time

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from yolo_tpu_torch.data.jp2 import encode_jp2  # noqa: E402

KINDS = ("noise", "ramps", "blur", "dots", "blocks")
BIG = ((480, 640, 3), (720, 1280, 3), (1080, 1920, 3), (32, 2000, 3),
       (2000, 32, 1), (1000, 1000, 1), (513, 769, 3))


def image(rng, h, w, c, kind) -> np.ndarray:
    if kind == "noise":
        return rng.integers(0, 256, (h, w, c), np.uint8)
    if kind == "ramps":
        yy, xx = np.mgrid[0:h, 0:w]
        base = (xx * int(rng.integers(1, 5)) + yy * int(rng.integers(1, 5)))
        amp = int(rng.integers(0, 30))
        noise = rng.integers(-amp, amp + 1, (h, w, c))
        return np.clip((base % 256)[..., None] + noise, 0,
                       255).astype(np.uint8)
    if kind == "blur":
        sigma = float(rng.uniform(0.5, 6.0))
        return cv2.GaussianBlur(rng.integers(0, 256, (h, w, c), np.uint8),
                                (0, 0), sigma).reshape(h, w, c)
    if kind == "dots":
        p = float(rng.uniform(0.001, 0.2))
        return ((rng.random((h, w, c)) < p) * 255).astype(np.uint8)
    img = np.full((h, w, c), int(rng.integers(0, 256)), np.uint8)
    for _ in range(int(rng.integers(1, 20))):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0:y0 + int(rng.integers(1, 40)),
            x0:x0 + int(rng.integers(1, 40))] = rng.integers(0, 256, c)
    return img


def cv2_bytes(img) -> bytes:
    ok, data = cv2.imencode(".jp2", img[..., ::-1] if img.shape[2] == 3
                            else img[..., 0])
    assert ok
    return data.tobytes()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", type=int, default=300)
    ap.add_argument("--big", action="store_true")
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    cases = []
    for i in range(args.cases):
        h, w = int(rng.integers(32, 260)), int(rng.integers(32, 260))
        c = 3 if rng.random() < 0.7 else 1
        kind = KINDS[int(rng.integers(0, len(KINDS)))]
        cases.append((i, (h, w, c), kind, image(rng, h, w, c, kind)))
    if args.big:
        for j, shape in enumerate(BIG):
            for kind in ("noise", "ramps", "blur"):
                cases.append((args.cases + len(cases), shape, kind,
                              image(rng, *shape, kind)))
    same, bad, t_port, t_cv2 = 0, [], 0.0, 0.0
    for i, shape, kind, img in cases:
        t0 = time.perf_counter()
        got = encode_jp2(img)
        t1 = time.perf_counter()
        want = cv2_bytes(img)
        t_port += t1 - t0
        t_cv2 += time.perf_counter() - t1
        if got == want:
            same += 1
        else:
            bad.append({"index": i, "shape": list(shape), "kind": kind,
                        "bytes": len(got), "cv2_bytes": len(want)})
    print(json.dumps({"seed": args.seed, "cases": len(cases), "same": same,
                      "mismatches": bad[:10], "port_s": round(t_port, 3),
                      "cv2_s": round(t_cv2, 3),
                      "cv2": cv2.__version__}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
