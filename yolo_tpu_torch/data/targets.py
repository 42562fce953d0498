"""Ground-truth encoder for the region head (port of
yolo_tpu/data/targets.py, region single-head only).

Darknet region-layer assignment: each GT box goes to the cell holding
its center and to the anchor whose (w, h) has the best IoU with the
box's, both placed at the origin. Targets are on the activation scale:
(sigma(tx), sigma(ty)) in-cell offsets and (tw, th) = log(wh / prior).
Host-side numpy; the loss reads the fixed-shape result on the device.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

MAX_GT = 30  # fixed GT capacity per image (darknet uses 30 for v2-era)


def _wh_iou(w1, h1, w2, h2) -> float:
    inter = min(w1, w2) * min(h1, h2)
    union = w1 * h1 + w2 * h2 - inter
    return inter / union if union > 0 else 0.0


def _as_hw(v) -> tuple:
    """int -> (v, v); (h, w) kept."""
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def encode(gt_boxes: np.ndarray, gt_classes: np.ndarray, *, grid,
           anchors: Sequence, num_classes: int,
           max_gt: int = MAX_GT) -> Dict[str, np.ndarray]:
    """Encode one image's ground truth.

    gt_boxes: (G, 4) normalized (cx, cy, w, h); gt_classes: (G,). grid:
    int or (gh, gw); each axis uses its own cell count. Returns
      obj_mask   (GH, GW, A)    1.0 where an anchor is responsible for a GT
      tcoord     (GH, GW, A, 4) targets (sx, sy, tw, th)
      tcls       (GH, GW, A)    int32 class id (0 where unassigned)
      coord_w    (GH, GW, A)    darknet coord scale factor (2 - w*h)
      tiou_boxes (GH, GW, A, 4) the GT xywh for the rescore obj target
      gt_boxes   (max_gt, 4)    padded GT (for the noobj best-IoU mask)
      gt_mask    (max_gt,)      validity of the padded GT rows
    """
    (gh, gw), a = _as_hw(grid), len(anchors)
    anchors = np.asarray(anchors, dtype=np.float32)
    out = {
        "obj_mask": np.zeros((gh, gw, a), np.float32),
        "tcoord": np.zeros((gh, gw, a, 4), np.float32),
        "tcls": np.zeros((gh, gw, a), np.int32),
        "coord_w": np.zeros((gh, gw, a), np.float32),
        "tiou_boxes": np.zeros((gh, gw, a, 4), np.float32),
        "gt_boxes": np.zeros((max_gt, 4), np.float32),
        "gt_mask": np.zeros((max_gt,), np.float32),
    }
    g = 0
    for box, cls in zip(np.asarray(gt_boxes, np.float64), gt_classes):
        cx, cy, w, h = box
        if w <= 0 or h <= 0 or g >= max_gt:
            continue
        out["gt_boxes"][g] = box
        out["gt_mask"][g] = 1.0
        g += 1
        # darknet fill_truth_detection constrains x, y to [0, 1] before
        # the cell computation
        ci = min(max(int(cx * gw), 0), gw - 1)
        cj = min(max(int(cy * gh), 0), gh - 1)
        ious = [_wh_iou(w * gw, h * gh, pw, ph) for pw, ph in anchors]
        best = int(np.argmax(ious))
        out["obj_mask"][cj, ci, best] = 1.0
        out["tcoord"][cj, ci, best] = (
            cx * gw - ci,
            cy * gh - cj,
            np.log(max(w * gw / anchors[best, 0], 1e-9)),
            np.log(max(h * gh / anchors[best, 1], 1e-9)),
        )
        out["tcls"][cj, ci, best] = int(cls)
        out["coord_w"][cj, ci, best] = 2.0 - w * h
        out["tiou_boxes"][cj, ci, best] = box
    return out


def encode_batch(batch_boxes, batch_classes, **kw) -> Dict[str, np.ndarray]:
    encoded = [encode(b, c, **kw) for b, c in zip(batch_boxes, batch_classes)]
    return {k: np.stack([e[k] for e in encoded]) for k in encoded[0]}
