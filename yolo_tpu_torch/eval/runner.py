"""Evaluation: dataset -> ground truth, model -> detections, VOC mAP
(port of yolo_tpu/eval/runner.py); COCO mAP@[.5:.95] scores the same
detections with eval/coco_map.py.

collect_detections runs the exact reference head (full decode and
per-class NMS) at the PR-curve threshold 0.005, where the fused head's
exactness precondition does not hold. On the card the per-class
suppression is the CUDA NMS kernel over the (B*C, K) grid; the plain
version runs only on the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from yolo_tpu_torch.data.pipeline import DevicePrefetcher, inference_batches
from yolo_tpu_torch.data.voc import parse_annotation
from yolo_tpu_torch.device import resolve as resolve_device
from yolo_tpu_torch.eval.voc_map import evaluate
from yolo_tpu_torch.models.graph import Darknet, fold_params
from yolo_tpu_torch.models.predict import make_detector_preprocessed
from yolo_tpu_torch.ops.letterbox import (unletterbox_boxes_xyxy,
                                          unstretch_boxes_xyxy)


def build_ground_truth(samples: Sequence[Tuple[str, object]],
                       class_names) -> Tuple[Dict, Dict]:
    """(image_path, annotation) samples -> ({img_id: gt}, {img_id:
    original image id}). Annotations are VOC XML paths or dicts in
    parse_annotation's schema (data/coco.py's carry ``areas`` too);
    difficult (crowd) flags kept."""
    gt, orig_ids = {}, {}
    for img_id, (_path, ann) in enumerate(samples):
        if not isinstance(ann, dict):
            ann = parse_annotation(ann, class_names, keep_difficult=True)
        orig_ids[img_id] = ann.get("image_id", img_id)
        w, h = ann["width"], ann["height"]
        if len(ann["boxes"]):
            b = ann["boxes"]
            xyxy = np.stack([
                (b[:, 0] - b[:, 2] / 2) * w, (b[:, 1] - b[:, 3] / 2) * h,
                (b[:, 0] + b[:, 2] / 2) * w, (b[:, 1] + b[:, 3] / 2) * h,
            ], axis=-1)
        else:
            xyxy = np.zeros((0, 4))
        gt[img_id] = {"boxes": xyxy, "classes": ann["classes"],
                      "difficult": ann["difficult"],
                      "width": int(w), "height": int(h)}
        if "areas" in ann:
            # COCO segmentation areas: pycocotools' areaRng buckets by
            # ann['area'], not the box's area; VOC XML has none, and the
            # COCO evaluator falls back to box areas without the key
            gt[img_id]["areas"] = ann["areas"]
    return gt, orig_ids


def collect_detections(cfg, folded_params,
                       samples: Sequence[Tuple[str, object]], *,
                       batch: int = 32, eval_conf: float = 0.005,
                       compute_dtype=torch.float32,
                       resize: str = "letterbox",
                       device="cuda",
                       conv_impl: str = "torch",
                       use_tree_map: bool = False,
                       hier_thresh=None) -> Dict[int, List]:
    """Run the reference decode + exact per-class NMS over the samples
    -> {img_id: [(cls, score, x1, y1, x2, y2) pixel], ...}.

    folded_params: fold_params output (numpy). device: "cuda" by
    default, raising without a card, where the suppression is the CUDA
    NMS kernel; "cpu" only when asked for, with the plain suppression.
    conv_impl="cuda" sends the eligible convs through the conv kernel
    (models/predict.py forward). Images are preprocessed on the host to
    one (net_h, net_w) shape. use_tree_map / hier_thresh: a YOLO9000
    tree model's decode (models/predict.py detect)."""
    net = Darknet(cfg.layers, folded_params, device=resolve_device(device),
                  dtype=compute_dtype)
    det = make_detector_preprocessed(
        cfg, conf_threshold=eval_conf, head="reference",
        nms_impl="cuda" if net.device.type == "cuda" else "torch",
        conv_impl=conv_impl, use_tree_map=use_tree_map,
        hier_thresh=hier_thresh)
    # duplicate paths must all receive the detections of their image
    path_to_ids: Dict[str, List[int]] = {}
    for i, (p, _) in enumerate(samples):
        path_to_ids.setdefault(p, []).append(i)
    host_iter = inference_batches(list(path_to_ids), batch,
                                  net_size=cfg.input_hw, resize=resize,
                                  channels=cfg.in_channels)
    detections: Dict[int, List] = {}
    with DevicePrefetcher(host_iter, depth=2, device=net.device) as staged:
        for b in staged:
            out = det(net, b["images"])
            boxes = []
            for bi, (src_h, src_w) in enumerate(b["shapes"]):
                if resize == "stretch":
                    boxes.append(unstretch_boxes_xyxy(
                        out["boxes"][bi], src_h=src_h, src_w=src_w))
                else:
                    boxes.append(unletterbox_boxes_xyxy(
                        out["boxes"][bi], src_h=src_h, src_w=src_w,
                        net_size=cfg.input_hw))
            # one device -> host copy per output array per batch
            boxes_np = torch.stack(boxes).cpu().numpy().astype(np.float64)
            valid_np = out["valid"].cpu().numpy()
            scores_np = out["scores"].cpu().numpy()
            classes_np = out["classes"].cpu().numpy()
            for bi, path in enumerate(b["paths"]):
                dets = [(int(classes_np[bi, i]), float(scores_np[bi, i]),
                         *boxes_np[bi, i])
                        for i in np.nonzero(valid_np[bi])[0]]
                for sid in path_to_ids[path]:
                    detections[sid] = list(dets)
    return detections


def quick_map(cfg, train_params, samples, *, batch: int = 16,
              eval_conf: float = 0.005, compute_dtype=torch.float32,
              use_07_metric: bool = True, resize: str = "letterbox",
              device="cuda") -> float:
    """Validation mAP of unfolded train params (numpy, e.g.
    train.loop.ema_params_of): fold them, run collect_detections on
    ``device`` and score by VOC mAP."""
    folded = fold_params(cfg.layers, train_params, cfg.bn_eps)
    gt, _ = build_ground_truth(samples, cfg.class_names)
    dets = collect_detections(cfg, folded, samples, batch=batch,
                              eval_conf=eval_conf,
                              compute_dtype=compute_dtype, resize=resize,
                              device=device)
    return float(evaluate(dets, gt, cfg.num_classes,
                          use_07_metric=use_07_metric)["map"])
