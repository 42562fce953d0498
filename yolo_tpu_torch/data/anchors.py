"""Anchor-box k-means (port of yolo_tpu/data/anchors.py; numpy, the
same draws for a seed) — YOLO9000 'dimension clusters' (arXiv:1612.08242
§2, the procedure that produced the cfg-pinned anchors in
configs/variants.py; darknet ships it as `calc_anchors`).

Cluster ground-truth box (w, h) pairs with k-means under the IoU
distance d(box, centroid) = 1 - IoU(box, centroid), boxes compared at a
common origin so only the shape matters. Centroids are reported in
GRID units (w·S, h·S for an S×S output grid) — the unit the region
layer's decode expects (ops/decode.py).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np


def _iou_wh(wh: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """(N, 2) boxes vs (K, 2) centroids at a common origin -> (N, K)."""
    inter = (np.minimum(wh[:, None, 0], centroids[None, :, 0]) *
             np.minimum(wh[:, None, 1], centroids[None, :, 1]))
    union = (wh[:, 0] * wh[:, 1])[:, None] + \
            (centroids[:, 0] * centroids[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def kmeans_anchors(wh: np.ndarray, k: int, *, units_wh=13,
                   iters: int = 300, seed: int = 0) -> Dict:
    """wh: (N, 2) normalized [0, 1] box sizes. Returns
    {'anchors': (k, 2) float in grid units, sorted by area ascending
     (darknet's convention), 'avg_iou': mean best-IoU of the data}.
    units_wh: int, or (units_w, units_h) for rectangular nets —
    **(w, h) order**, matching the (w, h) anchor pairs it scales and
    calc_anchors' per-axis convention. Deliberately NOT the repo's
    (h, w) net-size convention (ops/letterbox.as_hw): these are anchor
    units, not an image shape — hence the _wh-suffixed name.
    """
    wh = np.asarray(wh, np.float64).reshape(-1, 2)
    wh = wh[(wh > 0).all(axis=1)]
    if len(wh) < k:
        raise ValueError(f"need at least k={k} boxes, got {len(wh)}")
    rng = np.random.default_rng(seed)
    centroids = wh[rng.choice(len(wh), k, replace=False)].copy()

    assign = np.full(len(wh), -1)
    for _ in range(iters):
        new_assign = np.argmax(_iou_wh(wh, centroids), axis=1)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for j in range(k):
            members = wh[assign == j]
            if len(members):
                centroids[j] = members.mean(axis=0)
            else:  # dead centroid: reseed on the worst-covered box
                worst = np.argmin(_iou_wh(wh, centroids).max(axis=1))
                centroids[j] = wh[worst]

    order = np.argsort(centroids[:, 0] * centroids[:, 1])
    centroids = centroids[order]
    avg_iou = float(_iou_wh(wh, centroids).max(axis=1).mean())
    units = np.asarray(units_wh, np.float64).reshape(-1)  # scalar or (w, h)
    return {"anchors": (centroids * units).astype(np.float32),
            "avg_iou": avg_iou}


def collect_wh(samples: Iterable[Tuple[str, object]],
               class_names=None) -> np.ndarray:
    """(image_path, annotation) samples (VOC XML paths or pre-parsed
    dicts — cli._dataset_samples output) -> (N, 2) normalized wh."""
    from yolo_tpu_torch.data.voc import parse_annotation

    out = []
    for _path, ann in samples:
        if isinstance(ann, dict):
            # pre-parsed (COCO): exclude crowd regions, matching both the
            # VOC parser's keep_difficult=False default and the training
            # encoder (pipeline.py) — crowds would skew k-means large
            keep = np.asarray(ann["difficult"]) == 0
            boxes = np.asarray(ann["boxes"], np.float64)[keep]
        else:
            ann = parse_annotation(ann, class_names)
            boxes = np.asarray(ann["boxes"], np.float64)
        if len(boxes):
            out.append(boxes[:, 2:4])
    if not out:
        return np.zeros((0, 2))
    return np.concatenate(out, axis=0)
