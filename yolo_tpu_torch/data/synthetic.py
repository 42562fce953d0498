"""Seeded synthetic VOC-style datasets: PNG images (data/png.py's
encoder, no OpenCV) with VOC XML annotations, for tests and on-card
checks of the training and evaluation paths.

Each scene is a smooth background (a horizontal and a vertical ramp and
one flat channel) with 1-4 filled rectangles, each labelled with a VOC
class; with a palette, a rectangle takes its class's color, so that a
detector can learn the classes.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from yolo_tpu_torch.configs import VOC_NAMES
from yolo_tpu_torch.data.png import encode_png


def voc_xml(filename: str, w: int, h: int, objects) -> str:
    """A VOC annotation; objects: (name, x1, y1, x2, y2, difficult or
    None for no <difficult> tag), 1-based inclusive pixel boxes."""
    objs = []
    for name, x1, y1, x2, y2, diff in objects:
        d = "" if diff is None else f"<difficult>{diff}</difficult>"
        objs.append(f"<object><name>{name}</name>{d}<bndbox>"
                    f"<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax>"
                    f"<ymax>{y2}</ymax></bndbox></object>")
    return (f"<annotation><filename>{filename}</filename><size><width>{w}"
            f"</width><height>{h}</height><depth>3</depth></size>"
            f"{''.join(objs)}</annotation>")


def scene(rng: np.random.Generator, h: int, w: int, *,
          palette: Optional[np.ndarray] = None, difficult: float = 0.0):
    """(H, W, 3) uint8 image and its objects (voc_xml's form). Without a
    palette each rectangle takes a random color; ``difficult`` is the
    share of objects that carry a drawn <difficult> flag."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    np.full((h, w), int(rng.integers(0, 256)))],
                   -1).astype(np.uint8)
    objects = []
    for _ in range(int(rng.integers(1, 5))):
        cls = int(rng.integers(0, len(VOC_NAMES)))
        bw = int(rng.integers(w // 8, w // 2))
        bh = int(rng.integers(h // 8, h // 2))
        x1 = int(rng.integers(1, w - bw))
        y1 = int(rng.integers(1, h - bh))
        img[y1 - 1:y1 - 1 + bh, x1 - 1:x1 - 1 + bw] = (
            rng.integers(0, 256, 3) if palette is None else palette[cls])
        diff = (int(rng.integers(0, 2))
                if difficult and rng.uniform() < difficult else None)
        objects.append((VOC_NAMES[cls], x1, y1, x1 + bw - 1, y1 + bh - 1,
                        diff))
    return img, objects


def write_voc_scenes(root: str, sizes: Sequence[Tuple[int, int]],
                     rng: np.random.Generator, *,
                     palette: Optional[np.ndarray] = None,
                     filters=(0, 1, 2), difficult: float = 0.0
                     ) -> List[Tuple[str, str]]:
    """One scene per (h, w) in sizes under root, as NNN.png (rows in the
    given PNG filters) + NNN.xml -> [(image path, annotation path)]."""
    pairs = []
    for i, (h, w) in enumerate(sizes):
        img, objects = scene(rng, h, w, palette=palette, difficult=difficult)
        image = os.path.join(root, f"{i:03d}.png")
        ann = os.path.join(root, f"{i:03d}.xml")
        with open(image, "wb") as f:
            f.write(encode_png(img, filters))
        with open(ann, "w") as f:
            f.write(voc_xml(f"{i:03d}.png", w, h, objects))
        pairs.append((image, ann))
    return pairs
