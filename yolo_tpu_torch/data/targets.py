"""Ground-truth encoders for the region head, the [yolo] heads and the
yolov1 [detection] head (port of yolo_tpu/data/targets.py).

Darknet region-layer assignment: each GT box goes to the cell holding
its center and to the anchor whose (w, h) has the best IoU with the
box's, both placed at the origin. Targets are on the activation scale:
(sigma(tx), sigma(ty)) in-cell offsets and (tw, th) = log(wh / prior).
The [yolo] assignment (encode_yolo) picks the best anchor over all
heads' anchors in pixels and trains every head whose mask holds it.
The yolov1 encoder (encode_v1) gives each object to the cell holding its
center, the first object of a cell winning.
Host-side numpy; the loss reads the fixed-shape result on the device.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np

from yolo_tpu_torch.configs.specs import YoloHead, layer_strides

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


MAX_GT_V3 = 90  # darknet yolo_layer reads up to 90 truths per image


def encode_yolo(gt_boxes: np.ndarray, gt_classes: np.ndarray, *,
                input_size, anchors_px: Sequence,
                masks: Sequence[Sequence[int]], strides: Sequence[int],
                max_gt: int = MAX_GT_V3,
                assign_iou_thresh: float = 1.0) -> Dict[str, np.ndarray]:
    """Encode one image's ground truth for the [yolo] multi-head loss.
    input_size: int or (net_h, net_w); strides: each head's feature
    stride, so its grid is net // stride.

    Each GT box picks the best anchor by wh-IoU at the origin over all
    anchors (pixels); every head whose mask holds that anchor gets the
    target at the cell of the box center on its own grid (yolov3-tiny's
    masks share anchor 3). assign_iou_thresh < 1 also assigns every
    anchor whose wh-IoU exceeds it (yolov4: 0.213). Returns per head h
      obj_mask_h (S,S,A)  tcoord_h (S,S,A,4)  tcls_h (S,S,A)
      coord_w_h  (S,S,A)  tbox_h   (S,S,A,4) (the assigned GT xywh)
    and gt_boxes (max_gt, 4), gt_mask (max_gt,), gt_cls (max_gt,)."""
    net_h, net_w = _as_hw(input_size)
    anchors_px = np.asarray(anchors_px, dtype=np.float32)
    out: Dict[str, np.ndarray] = {
        "gt_boxes": np.zeros((max_gt, 4), np.float32),
        "gt_mask": np.zeros((max_gt,), np.float32),
        "gt_cls": np.zeros((max_gt,), np.int32),
    }
    grids = [(net_h // st, net_w // st) for st in strides]
    for h, (mask, (sh, sw)) in enumerate(zip(masks, grids)):
        a = len(mask)
        out[f"obj_mask_{h}"] = np.zeros((sh, sw, a), np.float32)
        out[f"tcoord_{h}"] = np.zeros((sh, sw, a, 4), np.float32)
        out[f"tcls_{h}"] = np.zeros((sh, sw, a), np.int32)
        out[f"coord_w_{h}"] = np.zeros((sh, sw, a), np.float32)
        out[f"tbox_{h}"] = np.zeros((sh, sw, a, 4), np.float32)
    # anchor index -> [(head, slot), ...]: each [yolo] layer checks its
    # own mask, so a shared anchor trains every head that holds it
    anchor_homes: Dict[int, list] = {}
    for h, mask in enumerate(masks):
        for slot, ai in enumerate(mask):
            anchor_homes.setdefault(int(ai), []).append((h, slot))

    g = 0
    for box, cls in zip(np.asarray(gt_boxes, np.float64), gt_classes):
        cx, cy, w, h_ = box
        if w <= 0 or h_ <= 0 or g >= max_gt:
            continue
        out["gt_boxes"][g] = box
        out["gt_mask"][g] = 1.0
        out["gt_cls"][g] = int(cls)
        g += 1
        ious = [_wh_iou(w * net_w, h_ * net_h, pw, ph)
                for pw, ph in anchors_px]
        best = int(np.argmax(ious))
        assign = {best} | {ai for ai, iou in enumerate(ious)
                           if iou > assign_iou_thresh}
        for anchor in assign:
            # an anchor in no mask trains no head (yolov3-tiny's 0)
            for hd, slot in anchor_homes.get(anchor, ()):
                sh, sw = grids[hd]
                ci = min(max(int(cx * sw), 0), sw - 1)
                cj = min(max(int(cy * sh), 0), sh - 1)
                out[f"obj_mask_{hd}"][cj, ci, slot] = 1.0
                out[f"tcoord_{hd}"][cj, ci, slot] = (
                    cx * sw - ci,
                    cy * sh - cj,
                    np.log(max(w * net_w / anchors_px[anchor, 0], 1e-9)),
                    np.log(max(h_ * net_h / anchors_px[anchor, 1], 1e-9)),
                )
                out[f"tcls_{hd}"][cj, ci, slot] = int(cls)
                out[f"coord_w_{hd}"][cj, ci, slot] = 2.0 - w * h_
                out[f"tbox_{hd}"][cj, ci, slot] = box
    return out


def encode_batch_yolo(batch_boxes, batch_classes, **kw
                      ) -> Dict[str, np.ndarray]:
    encoded = [encode_yolo(b, c, **kw)
               for b, c in zip(batch_boxes, batch_classes)]
    return {k: np.stack([e[k] for e in encoded]) for k in encoded[0]}


@functools.lru_cache(maxsize=64)
def _head_strides(layers) -> tuple:
    """Each [yolo] head's feature stride, per (hashable) layer tuple:
    encode_for runs once per image in the pipeline."""
    strides = layer_strides(layers)
    return tuple(strides[i] for i, l in enumerate(layers)
                 if isinstance(l, YoloHead))


def encode_for(model_cfg, boxes, classes,
               input_size=None) -> Dict[str, np.ndarray]:
    """One image encoded for ``model_cfg``'s head kind. input_size: int,
    (net_h, net_w), or None for the config's input_hw."""
    size = input_size if input_size is not None else model_cfg.input_hw
    net_h, net_w = _as_hw(size)
    if model_cfg.head_kind == "yolo":
        return encode_yolo(boxes, classes, input_size=(net_h, net_w),
                           anchors_px=model_cfg.anchors,
                           masks=[h.mask for h in model_cfg.yolo_heads],
                           strides=_head_strides(model_cfg.layers),
                           assign_iou_thresh=model_cfg.assign_iou_thresh)
    if model_cfg.head_kind == "detection":
        return encode_v1(boxes, classes, side=model_cfg.detection_head.side)
    return encode(boxes, classes, grid=(net_h // 32, net_w // 32),
                  anchors=model_cfg.anchors,
                  num_classes=model_cfg.num_classes)


def encode_batch_for(model_cfg, batch_boxes, batch_classes,
                     input_size=None) -> Dict[str, np.ndarray]:
    """A batch encoded for ``model_cfg``'s loss (region, [yolo] or
    [detection])."""
    encoded = [encode_for(model_cfg, b, c, input_size=input_size)
               for b, c in zip(batch_boxes, batch_classes)]
    return {k: np.stack([e[k] for e in encoded]) for k in encoded[0]}


def encode_v1(boxes: np.ndarray, classes: np.ndarray, side: int
              ) -> Dict[str, np.ndarray]:
    """YOLOv1 targets (arXiv:1506.02640 §2): the cell holding an
    object's center is responsible for it, one object a cell, the first
    box of a cell winning (darknet's fill_truth skips an occupied cell).
    boxes (G, 4) normalized xywh, classes (G,) -> v1_obj (S*S,) the cell
    holds an object, v1_box (S*S, 4) its xywh, v1_cls (S*S,) its class
    (0 where empty)."""
    s2 = side * side
    obj = np.zeros(s2, np.float32)
    tbox = np.zeros((s2, 4), np.float32)
    tcls = np.zeros(s2, np.int32)
    for g in range(len(boxes)):
        x, y, w, h = boxes[g]
        if w <= 0 or h <= 0:
            continue
        col = min(max(int(x * side), 0), side - 1)
        row = min(max(int(y * side), 0), side - 1)
        i = row * side + col
        if obj[i]:
            continue
        obj[i] = 1.0
        tbox[i] = (x, y, w, h)
        tcls[i] = classes[g]
    return {"v1_obj": obj, "v1_box": tbox, "v1_cls": tcls}
