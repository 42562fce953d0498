#!/usr/bin/env python3
"""The GIF writer (data/gif.py::encode_gif) against cv2.imencode's .gif
bytes on seeded images of many sizes and textures.

    python3 tools/gif_write_fuzz.py [--seed 0] [--cases 1000] [--big]

Needs OpenCV (the reference writer; the card machine has none). Each
case is a colour image of a random size from 1 to 300 a side (one case
in eight a single row or column), one of: uniform noise, ramps with
seeded noise (the diffusion's carries), a Gaussian blur of noise, sparse
dots, flat blocks, flat areas at and beside the palette's rounding
thresholds, or saturated extremes (0 and 255, whose errors run past the
top level). --big adds 480x640 to 1080x1920 frames and extreme aspect
ratios. Prints one JSON line: the cases, how many gave cv2's bytes, the
first mismatches (their index, shape and kind), and the port's and
cv2's encode seconds in all. Exit 1 on any mismatch.
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

from yolo_tpu_torch.data.gif import encode_gif  # noqa: E402

KINDS = ("noise", "ramps", "blur", "dots", "blocks", "ties", "extremes")
BIG = ((480, 640), (720, 1280), (1080, 1920), (1, 1920), (1080, 1),
       (2, 4000), (1000, 1000), (513, 769))
# where a lone pixel changes level: 18 + 36 k (R, G), 43, 128, 213 (B)
THRESHOLDS = np.array([18 + 36 * k for k in range(7)] + [43, 128, 213])


def image(rng, h, w, kind) -> np.ndarray:
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), np.uint8)
    if kind == "ramps":
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * int(rng.integers(1, 5)),
                         yy * int(rng.integers(1, 5)), xx + yy], -1)
        amp = int(rng.integers(0, 30))
        noise = rng.integers(-amp, amp + 1, (h, w, 3))
        return np.clip(base % 256 + noise, 0, 255).astype(np.uint8)
    if kind == "blur":
        sigma = float(rng.uniform(0.5, 6.0))
        return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                                (0, 0), sigma)
    if kind == "dots":
        p = float(rng.uniform(0.001, 0.2))
        return ((rng.random((h, w, 3)) < p) * 255).astype(np.uint8)
    if kind == "extremes":
        return (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8)
    if kind == "ties":
        img = np.empty((h, w, 3), np.uint8)
        img[:] = rng.choice(THRESHOLDS, 3) + rng.integers(-1, 2, 3)
    else:
        img = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
    for _ in range(int(rng.integers(1, 20))):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        val = rng.choice(THRESHOLDS, 3) + rng.integers(-1, 2, 3) \
            if kind == "ties" else rng.integers(0, 256, 3)
        img[y0:y0 + int(rng.integers(1, 40)),
            x0:x0 + int(rng.integers(1, 40))] = val
    return img


def cv2_bytes(img) -> bytes:
    ok, data = cv2.imencode(".gif", np.ascontiguousarray(img[..., ::-1]))
    assert ok
    return data.tobytes()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", type=int, default=1000)
    ap.add_argument("--big", action="store_true")
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    cases = []
    for i in range(args.cases):
        h, w = int(rng.integers(1, 301)), int(rng.integers(1, 301))
        if rng.random() < 0.125:
            h, w = (1, w) if rng.random() < 0.5 else (h, 1)
        kind = KINDS[int(rng.integers(0, len(KINDS)))]
        cases.append((i, (h, w, 3), kind, image(rng, h, w, kind)))
    if args.big:
        for h, w in BIG:
            for kind in ("noise", "ramps", "blur", "ties"):
                cases.append((len(cases), (h, w, 3), kind,
                              image(rng, h, w, kind)))
    same, bad, t_port, t_cv2 = 0, [], 0.0, 0.0
    for i, shape, kind, img in cases:
        t0 = time.perf_counter()
        got = encode_gif(img)
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
