#!/usr/bin/env python3
"""The port's AVIF reading (data/avif.py, native/av1*.c) against
cv2.imdecode on the files cv2 and PIL write at their defaults, for
seeded images of many sizes and textures.

    python3 tools/avif_fuzz.py [--seed 0] [--cases 500] [--big] [--jobs 4]
    python3 tools/avif_fuzz.py --mutate [--seed 0] [--cases 5000]

Needs OpenCV and PIL with AVIF support (the reference decoder and the
encoders; the card machine has neither). Each case is a colour image of
a random size from 1 to 300 a side (one case in eight a single row or
column), one of: uniform noise, ramps with seeded noise, a Gaussian blur
of noise, synthetic detection scenes (data/synthetic.py), flat frames, or
sparse dots (scenes below 32 a side are flat); it is written by cv2.imencode('.avif') or by PIL's
Image.save(format='AVIF'), both at their defaults, and decoded by
decode_image_bytes at 3 and 1 channels. --big adds 480x640 to 1080x1920
frames. Prints one JSON line: the cases, how many gave cv2's bytes at
both channel counts, the first mismatches (index, shape, kind, encoder,
the port's error where it raised) and the port's and cv2's decode
seconds in all. Exit 1 on any mismatch.

--mutate damages whole files instead, most often their boxes: each case
is a small cv2 or PIL file (a third PIL's RGBA, whose alpha item adds
iref and auxC) damaged one to three times: bytes flipped, a box's size
or an 8/16/32-bit field (anywhere before the mdat payload, or inside
one of meta's boxes: iloc, iinf, ipco, ipma, ...) set to 0, 1, the
largest value or a random one, the iloc's fields rewritten (widths of
0-15 bytes, up to 65535 extents), bytes inserted or removed, or the
file cut. decode_image_bytes must return an image or raise ValueError,
within MUTATE_SECONDS, with the worker under MUTATE_RSS_MB and its peak
raised by no more than MUTATE_GROWTH_MB in the case. Prints one JSON line (cases, decoded, refused, the
faults, the slowest case's seconds, the largest worker RSS); exit 1 on
any fault.
"""

import argparse
import io
import json
import os
import resource
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import cv2
import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from yolo_tpu_torch.data.synthetic import scene  # noqa: E402
from yolo_tpu_torch.native.preproc import decode_image_bytes  # noqa: E402

KINDS = ("noise", "ramps", "blur", "scene", "flat", "dots")
# a case's limits; a file of up to 96x96 decodes in well under a MB, so a
# case that raises the worker's peak by MUTATE_GROWTH_MB built much more
# than its file
MUTATE_SECONDS, MUTATE_RSS_MB, MUTATE_GROWTH_MB = 5.0, 1024, 16
BIG = ((480, 640), (720, 1280), (1080, 1920), (513, 769), (1000, 1000),
       (1, 1920), (1080, 1))


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
    if kind == "scene" and min(h, w) >= 32:
        return scene(rng, h, w)[0]
    if kind in ("flat", "scene"):
        return np.broadcast_to(rng.integers(0, 256, 3).astype(np.uint8),
                               (h, w, 3)).copy()
    p = float(rng.uniform(0.001, 0.2))
    return ((rng.random((h, w, 3)) < p) * 255).astype(np.uint8)


def encode(img: np.ndarray, encoder: str) -> bytes:
    if encoder == "cv2":
        ok, buf = cv2.imencode(".avif", np.ascontiguousarray(img[..., ::-1]))
        if not ok:
            raise RuntimeError("cv2 wrote no AVIF")
        return buf.tobytes()
    f = io.BytesIO()
    Image.fromarray(img).save(f, format="AVIF")
    return f.getvalue()


def case(args):
    seed, i, big = args
    rng = np.random.default_rng([seed, i])
    if big and i % 4 == 0:
        h, w = BIG[(i // 4) % len(BIG)]
    else:
        h, w = (int(v) for v in rng.integers(1, 301, 2))
        if rng.integers(0, 8) == 0:
            h, w = (1, w) if rng.integers(0, 2) else (h, 1)
    kind = KINDS[int(rng.integers(0, len(KINDS)))]
    encoder = ("cv2", "pil")[i % 2]
    data = encode(image(rng, h, w, kind), encoder)
    buf = np.frombuffer(data, np.uint8)
    t0 = time.perf_counter()
    ref3 = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    ref1 = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
    t1 = time.perf_counter()
    try:
        got3 = decode_image_bytes(data, 3)
        got1 = decode_image_bytes(data, 1)
        err = None
    except ValueError as e:
        err = str(e)
    t2 = time.perf_counter()
    ok = (err is None and ref3 is not None
          and np.array_equal(got3, ref3[..., ::-1])
          and np.array_equal(got1[..., 0], ref1))
    return {"index": i, "shape": [h, w], "kind": kind, "encoder": encoder,
            "ok": bool(ok), "error": err, "port_s": t2 - t1,
            "cv2_s": t1 - t0}


def _meta_boxes(data: bytes) -> list:
    """(type, start, end) of the payloads of the meta box's children and
    of iprp's (ipco, ipma)."""
    from yolo_tpu_torch.data import avif

    spans = []
    try:
        for kind, s, e in avif._boxes(data, 0, len(data)):
            if kind == b"meta":
                for k2, s2, e2 in avif._boxes(data, s + 4, e):
                    spans.append((k2, s2, e2))
                    if k2 == b"iprp":
                        spans += list(avif._boxes(data, s2, e2))
    except ValueError:
        pass
    return [(k, s, e) for k, s, e in spans if e > s]


def _iloc_header(rng) -> bytes:
    """The start of an iloc payload with seeded fields: version 0-2,
    field widths of 0, 4, 8 or any 4-bit value, one item whose extent
    count is 0, 1, 2, 65535 or random."""
    version = int(rng.integers(0, 3))
    width = [(0, 4, 8, int(rng.integers(0, 16)))[int(rng.integers(0, 4))]
             for _ in range(4)]
    n = 2 if version < 2 else 4
    out = bytes([version, 0, 0, 0, width[0] << 4 | width[1],
                 width[2] << 4 | (width[3] if version else 0)])
    out += (1).to_bytes(n, "big") + int(rng.integers(1, 3)).to_bytes(n, "big")
    if version:
        out += int(rng.integers(0, 2)).to_bytes(2, "big")
    out += bytes(2) + bytes(width[2])
    extents = (0, 1, 2, 65535, int(rng.integers(0, 65536)))
    return out + extents[int(rng.integers(0, 5))].to_bytes(2, "big")


def mutate(rng, data: bytes) -> bytes:
    """data damaged once, most often before the mdat payload (the
    boxes), or inside one of meta's boxes."""
    if len(data) < 2:
        return data
    b = bytearray(data)
    mdat = data.find(b"mdat")
    head = mdat + 4 if mdat > 0 else len(b)
    op = int(rng.integers(0, 8))
    if op == 5:
        return bytes(b[:int(rng.integers(0, len(b)))])
    lo, hi = 0, head if rng.integers(0, 4) else len(b)
    spans = _meta_boxes(data)
    iloc = [(s, e) for k, s, e in spans if k == b"iloc"]
    if op == 7 and iloc:
        # the iloc's fields rewritten in place, its size kept
        s, e = iloc[0]
        new = _iloc_header(rng)[:e - s]
        b[s:s + len(new)] = new
        return bytes(b)
    if op in (6, 7) and spans:
        _, lo, hi = spans[int(rng.integers(0, len(spans)))]
        op = int(rng.integers(1, 3))
    pos = int(rng.integers(lo, hi))
    if op == 0:
        for _ in range(int(rng.integers(1, 9))):
            p = int(rng.integers(0, head))
            b[p] ^= 1 << int(rng.integers(0, 8))
    elif op in (1, 2, 6, 7):
        width = (1, 2, 4)[int(rng.integers(0, 3))] if op == 1 else 4
        top = (1 << (8 * width)) - 1
        v = (0, 1, top, int(rng.integers(0, top + 1)))[int(rng.integers(0, 4))]
        if op == 2 and rng.integers(0, 2):
            # a box's size field: the 4 bytes before a box type
            kinds = [i - 4 for i in range(4, head - 3)
                     if bytes(b[i:i + 4]).isalpha()]
            if kinds:
                pos = kinds[int(rng.integers(0, len(kinds)))]
        b[pos:pos + width] = v.to_bytes(width, "big")
    elif op == 3:
        b[pos:pos] = rng.integers(0, 256, int(rng.integers(1, 17)),
                                  np.uint8).tobytes()
    else:
        del b[pos:pos + int(rng.integers(1, 17))]
    return bytes(b)


def mutate_case(args):
    seed, i = args
    rng = np.random.default_rng([seed, i, 1])
    h, w = (int(v) for v in rng.integers(1, 97, 2))
    img = image(rng, h, w, KINDS[int(rng.integers(0, len(KINDS)))])
    encoder = ("cv2", "pil", "pil-rgba")[int(rng.integers(0, 3))]
    if encoder == "pil-rgba":
        f = io.BytesIO()
        alpha = rng.integers(0, 256, (h, w, 1), np.uint8)
        Image.fromarray(np.concatenate([img, alpha], -1)).save(
            f, format="AVIF")
        data = f.getvalue()
    else:
        data = encode(img, encoder)
    for _ in range(int(rng.integers(1, 4))):
        data = mutate(rng, data)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    t0 = time.perf_counter()
    try:
        decode_image_bytes(data, 3)
        out, fault = "decoded", None
    except ValueError:
        out, fault = "refused", None
    except Exception as e:                     # noqa: BLE001
        out, fault = "fault", f"{type(e).__name__}: {e}"
    seconds = time.perf_counter() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    if (seconds > MUTATE_SECONDS or rss > MUTATE_RSS_MB
            or rss - rss0 > MUTATE_GROWTH_MB):
        out, fault = "fault", (f"{seconds:.2f} s, {rss:.0f} MB RSS, "
                               f"+{rss - rss0:.0f} MB in the case")
    return {"index": i, "encoder": encoder, "bytes": len(data),
            "out": out, "fault": fault, "seconds": seconds, "rss_mb": rss}


def run_mutate(args) -> int:
    work = [(args.seed, i) for i in range(args.cases)]
    with ProcessPoolExecutor(args.jobs) as pool:
        results = list(pool.map(mutate_case, work, chunksize=16))
    faults = [r for r in results if r["out"] == "fault"]
    print(json.dumps({
        "mode": "mutate", "seed": args.seed, "cases": len(results),
        "decoded": sum(r["out"] == "decoded" for r in results),
        "refused": sum(r["out"] == "refused" for r in results),
        "faults": faults[:10], "n_faults": len(faults),
        "slowest_s": max(r["seconds"] for r in results),
        "max_rss_mb": max(r["rss_mb"] for r in results)}))
    return 1 if faults else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", type=int, default=500)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--mutate", action="store_true")
    args = ap.parse_args()
    if args.mutate:
        return run_mutate(args)
    work = [(args.seed, i, args.big) for i in range(args.cases)]
    with ProcessPoolExecutor(args.jobs) as pool:
        results = list(pool.map(case, work, chunksize=4))
    bad = [r for r in results if not r["ok"]]
    print(json.dumps({
        "seed": args.seed, "cases": len(results),
        "matched": len(results) - len(bad),
        "by_encoder": {e: sum(r["ok"] for r in results if r["encoder"] == e)
                       for e in ("cv2", "pil")},
        "mismatches": bad[:10],
        "port_seconds": sum(r["port_s"] for r in results),
        "cv2_seconds": sum(r["cv2_s"] for r in results)}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
