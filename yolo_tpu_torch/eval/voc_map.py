"""VOC mAP evaluation (port of yolo_tpu/eval/voc_map.py, the whole
module, numpy only: the metric the port is scored by).

VOC2007 protocol: per class, detections sorted by score, greedy-matched
to GT at IoU >= 0.5 with the DEVKIT's +1 pixel-inclusive IoU
(VOCevaldet.m; each GT matched at most once, difficult GT ignored),
11-point interpolated AP; mAP = mean over classes. ``use_07_metric=False``
switches to the continuous AUC variant (VOC2010+).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _iou_xyxy(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Continuous IoU — the pycocotools bbox convention (COCO eval
    imports this; w = x2 - x1, no pixel inclusivity)."""
    ix1 = np.maximum(box[0], boxes[:, 0])
    iy1 = np.maximum(box[1], boxes[:, 1])
    ix2 = np.minimum(box[2], boxes[:, 2])
    iy2 = np.minimum(box[3], boxes[:, 3])
    iw = np.maximum(ix2 - ix1, 0.0)
    ih = np.maximum(iy2 - iy1, 0.0)
    inter = iw * ih
    area_a = (box[2] - box[0]) * (box[3] - box[1])
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = area_a + area_b - inter
    # guarded denominator: np.where evaluates inter/union eagerly, so a
    # degenerate zero-area pair would emit a RuntimeWarning per call
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _iou_xyxy_voc(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """VOC devkit IoU (VOCevaldet.m / py-faster-rcnn voc_eval): the +1
    pixel-inclusive convention — iw = ixmax - ixmin + 1, areas
    (x2-x1+1)*(y2-y1+1). Published VOC2007 numbers use this; near the
    0.5 threshold small-box matches flip vs the continuous form, so the
    VOC evaluator must not use the COCO convention."""
    ix1 = np.maximum(box[0], boxes[:, 0])
    iy1 = np.maximum(box[1], boxes[:, 1])
    ix2 = np.minimum(box[2], boxes[:, 2])
    iy2 = np.minimum(box[3], boxes[:, 3])
    iw = np.maximum(ix2 - ix1 + 1.0, 0.0)
    ih = np.maximum(iy2 - iy1 + 1.0, 0.0)
    inter = iw * ih
    area_a = (box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
    area_b = ((boxes[:, 2] - boxes[:, 0] + 1.0)
              * (boxes[:, 3] - boxes[:, 1] + 1.0))
    union = area_a + area_b - inter
    # guarded denominator: np.where evaluates inter/union eagerly, so a
    # degenerate zero-area pair would emit a RuntimeWarning per call
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def average_precision(recall: np.ndarray, precision: np.ndarray,
                      use_07_metric: bool = True) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    # continuous: envelope + area under PR curve
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def detection_stats(detections: Dict[int, List],
                    ground_truth: Dict[int, Dict], num_classes: int, *,
                    conf_thresh: float = 0.25,
                    iou_thresh: float = 0.5) -> Dict:
    """darknet `-map`'s conf-threshold console block
    (detector.c validate_detector_map — recall-pinned, reference tree
    empty): over detections with score strictly > conf_thresh (its
    thresh_calc_avg_iou, default .25), per class in descending-score
    order, each detection matches the best-IoU same-class GT whose IoU
    is strictly > iou_thresh — continuous box_iou, NOT the VOC devkit
    +1 form — and counts TP if that GT is not yet flagged, else FP
    (no fallback to the second-best GT, matching the truth_index walk).
    FN = total GT - TP. avg_iou accumulates the matched IoU on TPs but
    divides by (TP + FP) — darknet's documented quirk (false positives
    drag the average down); precision/recall/F1 as printed.

    Filtering to score > conf_thresh before the walk is exact: darknet
    accumulates these stats during its full AP walk, but the sort is
    descending, so no below-threshold detection can flag a truth
    before an above-threshold one is scored.

    Difficult GT follow darknet's -difficult semantics exactly: they
    live in a SEPARATE list consulted only when no regular (non-
    difficult) truth matched over iou_thresh — so a detection whose
    best overlap is a difficult box still scores TP against a regular
    box that also clears the threshold (the VOC "best-match steals"
    convention differs in that corner). A
    detection whose only over-threshold matches are difficult is
    neither TP nor FP; difficult GT are excluded from the GT count.
    darknet-list datasets carry no difficult flags, so they reproduce
    the plain tool exactly either way.

    Returns {tp, fp, fn, precision, recall, f1, avg_iou,
    unique_truth_count} (zero-division guarded to 0.0 where C prints
    nan)."""
    tp = fp = 0
    iou_sum = 0.0
    npos = 0
    for img_id, gt in ground_truth.items():
        difficult = np.asarray(
            gt.get("difficult",
                   np.zeros(len(gt["classes"])))).astype(bool)
        npos += int((~difficult).sum())
    for cls in range(num_classes):
        recs = []
        for img_id, dets in detections.items():
            for d in dets:
                if d[0] == cls and d[1] > conf_thresh:
                    recs.append((img_id, d[1],
                                 np.asarray(d[2:6], np.float64)))
        recs.sort(key=lambda r: -r[1])
        gt_cls = {}
        for img_id, gt in ground_truth.items():
            mask = np.asarray(gt["classes"]) == cls
            boxes = np.asarray(gt["boxes"], np.float64)[mask]
            difficult = np.asarray(
                gt.get("difficult",
                       np.zeros(len(mask))))[mask].astype(bool)
            gt_cls[img_id] = {"boxes": boxes[~difficult],
                              "diff_boxes": boxes[difficult],
                              "matched": np.zeros(int((~difficult).sum()),
                                                  bool)}
        for img_id, _score, box in recs:
            g = gt_cls.get(img_id)
            if g is None:
                fp += 1
                continue
            if len(g["boxes"]):
                ious = _iou_xyxy(box, g["boxes"])
                # truth_index walk: best IoU among those > iou_thresh
                over = ious > iou_thresh
                if np.any(over):
                    j = int(np.argmax(np.where(over, ious, -1.0)))
                    if not g["matched"][j]:
                        g["matched"][j] = True
                        tp += 1
                        iou_sum += float(ious[j])
                    else:
                        fp += 1
                    continue
            # no regular truth matched: consult the difficult list —
            # an over-threshold difficult match is neither TP nor FP
            if len(g["diff_boxes"]):
                if np.any(_iou_xyxy(box, g["diff_boxes"]) > iou_thresh):
                    continue
            fp += 1
    fn = npos - tp
    precision = tp / (tp + fp) if (tp + fp) else 0.0
    recall = tp / (tp + fn) if (tp + fn) else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) else 0.0)
    avg_iou = iou_sum / (tp + fp) if (tp + fp) else 0.0
    return {"tp": tp, "fp": fp, "fn": fn, "precision": precision,
            "recall": recall, "f1": f1, "avg_iou": avg_iou,
            "unique_truth_count": npos}


def print_detection_stats(stats: Dict, conf_thresh: float,
                          file=None) -> None:
    """The two validate_detector_map console lines, format-exact
    (leading/trailing spaces, %1.2f / %2.2f widths)."""
    import sys

    file = sys.stderr if file is None else file
    print(f" for conf_thresh = {conf_thresh:1.2f}, precision = "
          f"{stats['precision']:1.2f}, recall = {stats['recall']:1.2f}"
          f", F1-score = {stats['f1']:1.2f} ", file=file)
    print(f" for conf_thresh = {conf_thresh:1.2f}, TP = {stats['tp']}"
          f", FP = {stats['fp']}, FN = {stats['fn']}, average IoU = "
          f"{stats['avg_iou'] * 100:2.2f} % ", file=file)


def evaluate(detections: Dict[int, List], ground_truth: Dict[int, Dict],
             num_classes: int, iou_thresh: float = 0.5,
             use_07_metric: bool = True,
             return_curves: bool = False) -> Dict:
    """detections: {image_id: [(class_id, score, x1, y1, x2, y2), ...]}
    ground_truth: {image_id: {'boxes' (G,4) xyxy pixel, 'classes' (G,),
                              'difficult' (G,)}}
    Returns {'map': float, 'ap': {class_id: ap}}; with
    return_curves=True also 'curves': {class_id: {'scores', 'recall',
    'precision'}} — the raw PR points behind each AP (analysis /
    threshold tuning).
    """
    aps = {}
    curves = {}
    for cls in range(num_classes):
        # collect per-class detections
        recs = []
        for img_id, dets in detections.items():
            for d in dets:
                if d[0] == cls:
                    recs.append((img_id, d[1], np.asarray(d[2:6], np.float64)))
        recs.sort(key=lambda r: -r[1])

        # per-image GT bookkeeping
        gt_cls = {}
        npos = 0
        for img_id, gt in ground_truth.items():
            mask = np.asarray(gt["classes"]) == cls
            boxes = np.asarray(gt["boxes"], np.float64)[mask]
            difficult = np.asarray(
                gt.get("difficult", np.zeros(len(mask))))[mask].astype(bool)
            gt_cls[img_id] = {"boxes": boxes, "difficult": difficult,
                              "matched": np.zeros(len(boxes), bool)}
            npos += int((~difficult).sum())

        if npos == 0:
            aps[cls] = float("nan")
            continue

        tp = np.zeros(len(recs))
        fp = np.zeros(len(recs))
        for i, (img_id, _score, box) in enumerate(recs):
            g = gt_cls.get(img_id)
            if g is None or len(g["boxes"]) == 0:
                fp[i] = 1
                continue
            ious = _iou_xyxy_voc(box, g["boxes"])
            j = int(np.argmax(ious))
            if ious[j] >= iou_thresh:
                if g["difficult"][j]:
                    continue  # ignore
                if not g["matched"][j]:
                    tp[i] = 1
                    g["matched"][j] = True
                else:
                    fp[i] = 1
            else:
                fp[i] = 1

        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        recall = tp_cum / npos
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        aps[cls] = average_precision(recall, precision, use_07_metric)
        if return_curves:
            curves[cls] = {
                "scores": [round(float(r[1]), 5) for r in recs],
                "recall": np.round(recall, 5).tolist(),
                "precision": np.round(precision, 5).tolist(),
            }

    valid = [v for v in aps.values() if not np.isnan(v)]
    out = {"map": float(np.mean(valid)) if valid else 0.0, "ap": aps}
    if return_curves:
        out["curves"] = curves
    return out
