"""PASCAL VOC annotation parsing (port of yolo_tpu/data/voc.py):
VOC XML -> normalized boxes and class ids."""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence, Tuple

import numpy as np


def parse_annotation(xml_path: str, class_names: Sequence[str],
                     keep_difficult: bool = False) -> Dict:
    """One VOC XML -> {'boxes' (G,4) normalized xywh, 'classes' (G,),
    'difficult' (G,), 'width', 'height', 'filename', 'n_unknown'}.
    Objects whose name is not in ``class_names`` train as background and
    are counted in n_unknown."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    w = float(size.find("width").text)
    h = float(size.find("height").text)
    name_to_id = {n: i for i, n in enumerate(class_names)}

    boxes, classes, difficult = [], [], []
    n_unknown = 0
    for obj in root.findall("object"):
        cls = obj.find("name").text.strip()
        if cls not in name_to_id:
            n_unknown += 1
            continue
        diff = int((obj.find("difficult").text or "0")
                   if obj.find("difficult") is not None else 0)
        if diff and not keep_difficult:
            continue
        bb = obj.find("bndbox")
        # VOC pixel coords are 1-based inclusive
        x1 = float(bb.find("xmin").text) - 1
        y1 = float(bb.find("ymin").text) - 1
        x2 = float(bb.find("xmax").text) - 1
        y2 = float(bb.find("ymax").text) - 1
        boxes.append([((x1 + x2) / 2) / w, ((y1 + y2) / 2) / h,
                      (x2 - x1) / w, (y2 - y1) / h])
        classes.append(name_to_id[cls])
        difficult.append(diff)

    return {
        "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
        "classes": np.asarray(classes, np.int32),
        "difficult": np.asarray(difficult, np.int32),
        "width": int(w),
        "height": int(h),
        "filename": (root.find("filename").text
                     if root.find("filename") is not None else ""),
        "n_unknown": n_unknown,
    }


def list_split(voc_root: str, split: str = "train") -> List[Tuple[str, str]]:
    """(image_path, annotation_path) pairs for an ImageSets/Main split."""
    split_file = os.path.join(voc_root, "ImageSets", "Main", f"{split}.txt")
    with open(split_file) as f:
        ids = [line.split()[0] for line in f if line.strip()]
    return [(os.path.join(voc_root, "JPEGImages", f"{i}.jpg"),
             os.path.join(voc_root, "Annotations", f"{i}.xml")) for i in ids]
