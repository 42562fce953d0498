"""COCO-style mAP@[.5:.95] evaluation (port of yolo_tpu/eval/coco_map.py).

Implements the pycocotools ``bbox`` protocol, including the full 12-cell
summary surface:

* AP averaged over IoU thresholds 0.50:0.05:0.95 (``map``), plus the
  ``map50`` / ``map75`` slices;
* area-range breakdowns ``map_small/medium/large`` (GT area in
  [0,32²), [32²,96²), [96²,1e10) px² — pycocotools areaRng, on the
  annotations' ``areas`` where the ground truth carries them) with the
  matching/ignore semantics of COCOeval.evaluateImg: out-of-range GTs
  are *ignored* (not removed) — a detection matched to an ignored GT is
  dropped from the PR curve, and an UNMATCHED detection whose own area
  is out of range is dropped too;
* average recall ``ar`` (= AR@max_dets, default 100), ``ar1``/``ar10``
  (matches computed once at the top-``max_dets`` cap, then re-sliced to
  the first 1/10 detections per image per class — pycocotools
  accumulate), and ``ar_small/medium/large``;
* 101-point interpolated precision (precision envelope sampled at
  recalls linspace(0, 1, 101));
* greedy matching per detection (score-descending) iterating GTs
  ignored-last; a detection may upgrade to a later equal-or-better IoU
  GT exactly as COCOeval does, and crowd GTs (``iscrowd``, carried in
  the ``difficult`` field) stay matchable after a first match;
* crowd IoU = intersection / detection-area (pycocotools convention).

The maxDets cap follows pycocotools' actual implementation
(COCOeval.evaluateImg runs per category and truncates dt[0:maxDet]
there): top ``max_dets`` by score per image PER CLASS.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from yolo_tpu_torch.eval.voc_map import _iou_xyxy

COCO_IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05).round(2)
_RECALL_POINTS = np.linspace(0.0, 1.0, 101)
# pycocotools areaRng (px^2), on the GT/detection box area
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _crowd_iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """pycocotools crowd convention: intersection / detection area."""
    ix1 = np.maximum(box[0], boxes[:, 0])
    iy1 = np.maximum(box[1], boxes[:, 1])
    ix2 = np.minimum(box[2], boxes[:, 2])
    iy2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(ix2 - ix1, 0.0) * np.maximum(iy2 - iy1, 0.0)
    det_area = (box[2] - box[0]) * (box[3] - box[1])
    return np.where(det_area > 0, inter / max(det_area, 1e-12), 0.0)


def _ap_101pt(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point interpolated AP (precision envelope sampled on the
    fixed recall grid — COCO's `accumulate`)."""
    mpre = precision.copy()
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    # first detection index reaching each recall point
    idx = np.searchsorted(recall, _RECALL_POINTS, side="left")
    ok = idx < len(recall)
    return float(np.where(ok, mpre[np.minimum(idx, len(recall) - 1)],
                          0.0).sum() / len(_RECALL_POINTS))


def _box_areas(boxes: np.ndarray) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros(0)
    return np.maximum(boxes[:, 2] - boxes[:, 0], 0.0) * np.maximum(
        boxes[:, 3] - boxes[:, 1], 0.0)


def _match_image(ious: np.ndarray, gt_crowd: np.ndarray,
                 gt_ig: np.ndarray, dt_areas: np.ndarray,
                 area_rng: Tuple[float, float],
                 thr: float) -> Tuple[np.ndarray, np.ndarray]:
    """COCOeval.evaluateImg matching for one (image, class, areaRng,
    IoU threshold). Returns (matched (D,) bool, dt_ignored (D,) bool).
    GTs are iterated ignored-last (stable); crowd GTs stay available
    after matching; a det keeps upgrading to any GT with IoU >= its
    current best (ties resolve to the last examined, as pycocotools)."""
    n_dt, n_gt = ious.shape
    order = np.argsort(gt_ig, kind="stable")
    gtm = np.zeros(n_gt, bool)
    dtm = np.full(n_dt, -1, np.int64)
    dt_ig = np.zeros(n_dt, bool)
    for d in range(n_dt):
        best = min(thr, 1.0 - 1e-10)
        m = -1
        for g in order:
            if gtm[g] and not gt_crowd[g]:
                continue
            # GTs sorted ignored-last: once we hold a real (non-ignored)
            # match, stop at the first ignored GT
            if m > -1 and not gt_ig[m] and gt_ig[g]:
                break
            if ious[d, g] < best:
                continue
            best = ious[d, g]
            m = g
        if m == -1:
            continue
        dtm[d] = m
        dt_ig[d] = gt_ig[m]
        gtm[m] = True
    # unmatched detections whose own area is out of range are ignored
    out = (dt_areas < area_rng[0]) | (dt_areas > area_rng[1])
    dt_ig |= (dtm == -1) & out
    return dtm >= 0, dt_ig


def evaluate_coco(detections: Dict[int, List], ground_truth: Dict[int, Dict],
                  num_classes: int,
                  iou_thresholds: Optional[Sequence[float]] = None,
                  max_dets: int = 100,
                  area_ranges: Optional[Sequence[str]] = None) -> Dict:
    """Same input schema as `voc_map.evaluate`:
    detections: {image_id: [(class_id, score, x1, y1, x2, y2), ...]}
    ground_truth: {image_id: {'boxes' (G,4) xyxy pixel, 'classes' (G,),
                              'difficult' (G,)}}  (difficult == iscrowd)
    Returns {'map', 'map50', 'map75', 'ar' (AR@max_dets), 'ar1', 'ar10',
    'map_small/medium/large', 'ar_small/medium/large',
    'ap': {class_id: ap_over_ious (all-range)}}.
    """
    thresholds = np.asarray(
        COCO_IOU_THRESHOLDS if iou_thresholds is None else iou_thresholds,
        np.float64)
    rng_names = list(area_ranges or AREA_RANGES)
    unknown = [n for n in rng_names if n not in AREA_RANGES]
    if unknown:
        raise ValueError(f"unknown area range(s) {unknown} "
                         f"(have: {', '.join(AREA_RANGES)})")
    if "all" not in rng_names:
        # 'map'/'map50'/'ar'/... summarize the 'all' range; without it
        # they would silently report some other range's numbers
        raise ValueError("area_ranges must include 'all'")
    n_thr, n_rng = len(thresholds), len(rng_names)
    ap = np.full((n_rng, n_thr, num_classes), np.nan)
    # recall for the maxDets ladder (1, 10, max_dets) on every range;
    # only the 'all' range's 1/10 slices are reported (pycocotools)
    det_caps = sorted({1, 10, max_dets})
    ar = np.full((n_rng, len(det_caps), n_thr, num_classes), np.nan)

    for cls in range(num_classes):
        # per-image data, matching done once per (areaRng, thr) at the
        # top-max_dets cap; smaller caps re-slice (pycocotools
        # accumulate semantics)
        imgs = []
        any_gt = False
        # union of images: a detection on an image absent from the GT
        # dict is a false positive (zero-annotation images are a valid
        # schema — voc_map.evaluate treats them the same way)
        img_ids = list(ground_truth)
        img_ids += [i for i in detections if i not in ground_truth]
        empty_gt = {"boxes": np.zeros((0, 4)), "classes": np.zeros(0),
                    "difficult": np.zeros(0)}
        for img_id in img_ids:
            gt = ground_truth.get(img_id, empty_gt)
            mask = np.asarray(gt["classes"]) == cls
            g_boxes = np.asarray(gt["boxes"], np.float64)[mask]
            crowd = np.asarray(
                gt.get("difficult", np.zeros(len(mask))))[mask].astype(bool)
            # pycocotools areaRng buckets GTs by ann['area'] (the
            # SEGMENTATION area, carried by the COCO loader as
            # 'areas'); bbox area is only the fallback for VOC-style
            # GT without it (thin or diagonal objects land in other
            # size buckets otherwise)
            g_areas = (np.asarray(gt["areas"], np.float64)[mask]
                       if "areas" in gt else _box_areas(g_boxes))
            dets = sorted((d for d in detections.get(img_id, [])
                           if d[0] == cls), key=lambda d: -d[1])[:max_dets]
            d_boxes = np.asarray([d[2:6] for d in dets],
                                 np.float64).reshape(len(dets), 4)
            scores = np.asarray([d[1] for d in dets], np.float64)
            ious = np.zeros((len(dets), len(g_boxes)))
            for di, box in enumerate(d_boxes):
                if len(g_boxes) == 0:
                    continue
                std = _iou_xyxy(box, g_boxes)
                crw = _crowd_iou(box, g_boxes)
                ious[di] = np.where(crowd, crw, std)
            imgs.append({
                "scores": scores,
                "dt_areas": _box_areas(d_boxes),
                "gt_areas": g_areas,
                "crowd": crowd,
                "ious": ious,
            })
            any_gt = any_gt or (~crowd).sum() > 0
        if not any_gt:
            continue

        for ri, rname in enumerate(rng_names):
            lo, hi = AREA_RANGES[rname]
            npos = 0
            per_img = []  # (scores, matched[T,D], ignored[T,D])
            for im in imgs:
                gt_ig = im["crowd"] | (im["gt_areas"] < lo) | (
                    im["gt_areas"] > hi)
                npos += int((~gt_ig).sum())
                mt = np.zeros((n_thr, len(im["scores"])), bool)
                ig = np.zeros((n_thr, len(im["scores"])), bool)
                for ti, thr in enumerate(thresholds):
                    mt[ti], ig[ti] = _match_image(
                        im["ious"], im["crowd"], gt_ig, im["dt_areas"],
                        (lo, hi), float(thr))
                per_img.append((im["scores"], mt, ig))
            if npos == 0:
                continue

            for ci, cap in enumerate(det_caps):
                scores = np.concatenate([s[:cap] for s, _, _ in per_img])
                order = np.argsort(-scores, kind="stable")
                for ti in range(n_thr):
                    mt = np.concatenate(
                        [m[ti, :cap] for _, m, _ in per_img])[order]
                    ig = np.concatenate(
                        [g[ti, :cap] for _, _, g in per_img])[order]
                    tp = np.cumsum(mt & ~ig)
                    fp = np.cumsum(~mt & ~ig)
                    if tp.size == 0:
                        if cap == max_dets:
                            ap[ri, ti, cls] = 0.0
                        ar[ri, ci, ti, cls] = 0.0
                        continue
                    recall = tp / npos
                    precision = tp / np.maximum(tp + fp, 1e-12)
                    if cap == max_dets:
                        ap[ri, ti, cls] = _ap_101pt(recall, precision)
                    ar[ri, ci, ti, cls] = recall[-1]

    def _mean(rows: np.ndarray) -> float:
        v = rows[~np.isnan(rows)]
        return float(v.mean()) if v.size else 0.0

    ra = rng_names.index("all")  # presence validated above
    cmax = det_caps.index(max_dets)
    out = {
        "map": _mean(ap[ra]),
        "ar": _mean(ar[ra, cmax]),
        "ap": {c: _mean(ap[ra, :, c]) for c in range(num_classes)
               if not np.isnan(ap[ra, :, c]).all()},
    }
    # map50/map75 only when that threshold is actually in the grid:
    # a nearest-neighbor choice would label another threshold's AP so
    # under custom iou_thresholds
    for key, thr in (("map50", 0.5), ("map75", 0.75)):
        hits = np.nonzero(np.isclose(thresholds, thr))[0]
        if hits.size:
            out[key] = _mean(ap[ra, int(hits[0])])
    if 1 in det_caps:
        out["ar1"] = _mean(ar[ra, det_caps.index(1)])
    if 10 in det_caps:
        out["ar10"] = _mean(ar[ra, det_caps.index(10)])
    for rname in ("small", "medium", "large"):
        if rname in rng_names:
            ri = rng_names.index(rname)
            out[f"map_{rname}"] = _mean(ap[ri])
            out[f"ar_{rname}"] = _mean(ar[ri, cmax])
    return out
