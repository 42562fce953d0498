#!/usr/bin/env python3
"""Sizes and times of save_image's writers against cv2.imwrite's files.

    python3 tools/writer_sizes.py

Needs OpenCV (the reference writer; the card machine has none). For the
480x640 frames of tests/data/torch_jpeg/ (the lossless WebP fixture's
frame with seeded detections drawn, the frame of tests/test_torch_viz.py's
WebP size bound, and the noisy progressive-JPEG frame), prints one JSON
line a
format: the port's bytes, cv2.imwrite's bytes, their ratio, whether
the two files are the same bytes, and the port's encode ms on this
host (median of 5).
"""

import json
import os
import statistics
import sys
import tempfile
import time

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from yolo_tpu_torch.configs import VARIANTS  # noqa: E402
from yolo_tpu_torch.native.preproc import decode_image  # noqa: E402
from yolo_tpu_torch.utils.viz import draw_detections, save_image  # noqa

FORMATS = (".webp", ".tif", ".png", ".pam", ".ras", ".pfm", ".hdr", ".jp2",
           ".gif")
FIXTURES = os.path.join(REPO, "tests", "data", "torch_jpeg")


def annotated_frame() -> np.ndarray:
    """The lossless WebP fixture frame with seeded detections drawn (also
    the frame of tests/test_torch_viz.py's WebP size bound)."""
    frame = decode_image(os.path.join(FIXTURES,
                                      "frame_webp_lossless_480x640.webp"))
    rng = np.random.default_rng(7)
    x1, y1 = rng.uniform(0, 560, 8), rng.uniform(20, 400, 8)
    boxes = np.stack([x1, y1, x1 + rng.uniform(30, 200, 8),
                      y1 + rng.uniform(30, 200, 8)], -1)
    return draw_detections(frame, boxes, rng.uniform(0.3, 1, 8),
                           rng.integers(0, 80, 8),
                           VARIANTS["coco"].class_names)


def main() -> None:
    frames = {"annotated": annotated_frame(),
              "noisy": decode_image(os.path.join(
                  FIXTURES, "prog_420_q85_480x640.jpg"))}
    with tempfile.TemporaryDirectory() as tmp:
        for name, img in frames.items():
            for ext in FORMATS:
                ours, ref = (os.path.join(tmp, f"{w}{ext}")
                             for w in ("port", "cv2"))
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    save_image(ours, img)
                    times.append((time.perf_counter() - t0) * 1e3)
                assert cv2.imwrite(ref, img[..., ::-1])
                a, b = (open(p, "rb").read() for p in (ours, ref))
                print(json.dumps({
                    "frame": name, "format": ext, "port_bytes": len(a),
                    "cv2_bytes": len(b), "ratio": len(a) / len(b),
                    "same_bytes": a == b,
                    "encode_ms": statistics.median(times),
                    "host_cores": os.cpu_count()}))


if __name__ == "__main__":
    main()
