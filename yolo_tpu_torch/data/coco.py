"""COCO-format JSON annotation loading (port of yolo_tpu/data/coco.py):
the COCO-80 detectors are evaluated against COCO ``instances_*.json``
ground truth, which VOC XML parsing cannot read.

Samples are returned in the exact schema ``data/voc.parse_annotation``
produces (normalized xywh ``boxes``, contiguous ``classes``,
``difficult``, ``width``/``height``/``filename``), plus the
annotations' ``areas``, so one downstream path (train_batches / eval)
serves both dataset formats. COCO ``iscrowd`` regions map onto the VOC
``difficult`` flag: both mean "ignore in matching, never a false
positive".

COCO category ids are non-contiguous (1..90 with gaps for the 80-class
set); they are mapped to contiguous class ids BY NAME via the config's
``class_names``, so the mapping is robust to id-scheme drift.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def load_coco(json_path: str, class_names: Sequence[str],
              image_root: str = "") -> List[Tuple[str, Dict]]:
    """COCO instances JSON -> [(image_path, annotation), ...].

    ``image_path`` is ``image_root``/``file_name``. Annotations whose
    category name is not in ``class_names`` are skipped (same behavior
    as the VOC parser). Images with zero annotations are kept — they
    contribute negatives to evaluation, as pycocotools does.
    """
    with open(json_path) as f:
        doc = json.load(f)

    name_to_id = {n: i for i, n in enumerate(class_names)}
    cat_to_cls = {c["id"]: name_to_id[c["name"]]
                  for c in doc.get("categories", [])
                  if c["name"] in name_to_id}

    per_image: Dict[int, List] = {img["id"]: [] for img in doc["images"]}
    n_total = n_kept = 0
    for ann in doc.get("annotations", []):
        n_total += 1
        cls = cat_to_cls.get(ann["category_id"])
        if cls is None or ann["image_id"] not in per_image:
            continue
        n_kept += 1
        per_image[ann["image_id"]].append(
            (cls, ann["bbox"], int(ann.get("iscrowd", 0)),
             # pycocotools areaRng buckets by ann['area'] (SEGMENTATION
             # area), not the bbox area — carry it for the COCO eval's
             # small/medium/large breakdowns; fall back to bbox area
             # for jsons that omit it
             float(ann.get("area", ann["bbox"][2] * ann["bbox"][3]))))

    if n_total and not n_kept:
        # the wrong names list makes cat_to_cls empty and EVERY
        # annotation silently drops: training would fit pure background
        # with no signal (the VOC pipeline has the same tripwire)
        import sys

        print(f"WARNING: {json_path}: all {n_total} annotations "
              f"dropped — no category name matches the class list "
              f"(wrong --names?); detector training on this data "
              f"would fit pure background", file=sys.stderr)
    return _samples_from_doc(doc, per_image, image_root)


def category_ids(json_path: str, class_names: Sequence[str]) -> dict:
    """{contiguous class id: original COCO category id} — the inverse of
    load_coco's name-based mapping, for writing pycocotools-compatible
    results files."""
    with open(json_path) as f:
        doc = json.load(f)
    name_to_id = {n: i for i, n in enumerate(class_names)}
    return {name_to_id[c["name"]]: c["id"]
            for c in doc.get("categories", []) if c["name"] in name_to_id}


def _samples_from_doc(doc, per_image, image_root):
    samples = []
    for img in doc["images"]:
        w, h = float(img["width"]), float(img["height"])
        boxes, classes, difficult, areas = [], [], [], []
        for cls, (bx, by, bw, bh), crowd, area in per_image[img["id"]]:
            # COCO bbox is top-left xywh in pixels -> normalized center xywh
            boxes.append([(bx + bw / 2) / w, (by + bh / 2) / h,
                          bw / w, bh / h])
            classes.append(cls)
            difficult.append(crowd)
            areas.append(area)
        ann_dict = {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int32),
            "difficult": np.asarray(difficult, np.int32),
            "areas": np.asarray(areas, np.float64),
            "width": int(w),
            "height": int(h),
            "filename": img["file_name"],
            "image_id": img["id"],  # original id, for results-file interop
        }
        samples.append((os.path.join(image_root, img["file_name"]),
                        ann_dict))
    return samples
