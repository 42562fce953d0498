"""darknet `detector recall` (detector.c validate_detector_recall):
class-agnostic region-proposal recall over a validation set (port of
yolo_tpu/eval/recall.py).

On the port the forward and the objectness decode run on the device
(``device="cuda"`` by default; "cpu" only when asked for); the
objectness NMS and the IoU accounting run on the host in float64, as in
the JAX package. This path does not reach the CUDA NMS kernel: darknet's
recall suppresses by objectness across classes (box.c do_nms_obj, one
greedy pass over every proposal), where the kernel suppresses within a
class over a top-K grid. A YOLO9000 tree [region] head decodes its
objectness as any [region] head.

Semantics are recall-pinned (the reference tree is empty — SURVEY.md
§0); the pinned behavior, per image:

  1. decode EVERY candidate box with its OBJECTNESS only (no class
     scores) — [region]/[yolo]/[Gaussian_yolo] objectness is
     sigmoid(t_obj) (raw for new_coords heads, whose conv already
     applied logistic); yolov1 [detection] uses its per-box confidence
     (get_detection_detections sets dets.objectness = scale);
  2. objectness NMS (box.c do_nms_obj): sort descending by objectness,
     greedily zero any LATER box whose IoU with a survivor is
     strictly > the nms threshold — class-agnostic, one pass;
  3. proposals = boxes with objectness strictly > thresh;
  4. for every ground-truth box, best_iou = max IoU over the
     above-threshold proposals; correct += (best_iou > iou_thresh),
     avg_iou += best_iou (best_iou contributes even when the image has
     no proposals: 0);
  5. print the cumulative line after each image
     (validate_detector_recall's fprintf):
       '%5d %5d %5d\\tRPs/Img: %.2f\\tIOU: %.2f%%\\tRecall:%.2f%%'

Defaults thresh=.001, nms=.4, iou_thresh=.5 — the constants hardcoded
in validate_detector_recall.

Coordinate space: all IoUs are computed in net-normalized space with
the ground truth mapped through the SAME resize geometry as the
images. IoU is invariant under any axis-aligned affine rescale applied
to both boxes, so stretch mode reproduces darknet's relative-space
numbers exactly (pjreddie's recall resizes with plain resize_image and
compares relative coords) and letterbox mode equals AlexeyAB's
letter_box-corrected source-space comparison. Boxes are NOT clipped to
the image (darknet's relative coords may exceed [0,1]; the eval
pipeline's clipping unmapper would inflate IoU for edge-spilling
proposals).

Exactness note on the pre-NMS objectness filter: darknet's [region]
path feeds ALL H*W*A boxes into do_nms_obj while [yolo] feeds only the
objectness>thresh survivors (get_yolo_detections filters, the region
getter doesn't). Filtering FIRST is equivalent for the final numbers
in both cases: the sort is descending, so a box at objectness<=thresh
can only suppress boxes ranked below it — all themselves <=thresh, and
boxes <=thresh never count as proposals nor enter best_iou.

Difficult ground truth: VOC XML datasets skip difficult objects here
— darknet recall consumes voc_label.py-generated label files, and
voc_label.py drops difficult objects at conversion; darknet-list
datasets score exactly the boxes their .txt files carry.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# the hardcoded validate_detector_recall constants
DEFAULT_THRESH = 0.001
DEFAULT_NMS = 0.4
DEFAULT_IOU_THRESH = 0.5


def decode_boxes_objectness(cfg, logits):
    """Raw head logits -> (boxes (B, N, 4) net-normalized xywh,
    objectness (B, N)) over every candidate box, fp32 on the logits'
    device: the class-free decode validate_detector_recall runs on."""
    from yolo_tpu_torch.ops.decode import (decode_detection,
                                           decode_head_boxes,
                                           decode_region_boxes)

    if cfg.head_kind == "yolo":
        boxes_parts, obj_parts = [], []
        for t_logits, hd in zip(logits, cfg.yolo_heads):
            b, h, w, _ = t_logits.shape
            a = len(hd.mask)
            ch = (9 if hd.gaussian else 5) + cfg.num_classes
            t = t_logits.float().reshape(b, h, w, a, ch)
            if hd.gaussian:
                # interleaved [x ux y uy w uw h uh obj cls...]; the
                # uncertainty scales class probs only, the objectness
                # stays sigmoid(obj)
                boxes = decode_head_boxes(t[..., [0, 2, 4, 6]], cfg.anchors,
                                          hd.mask, hd.scale_xy, cfg.input_hw)
                conf = torch.sigmoid(t[..., 8])
            else:
                boxes = decode_head_boxes(t, cfg.anchors, hd.mask,
                                          hd.scale_xy, cfg.input_hw,
                                          new_coords=hd.new_coords)
                conf = (t[..., 4] if hd.new_coords
                        else torch.sigmoid(t[..., 4]))
            boxes_parts.append(boxes.reshape(b, -1, 4))
            obj_parts.append(conf.reshape(b, -1))
        return torch.cat(boxes_parts, 1), torch.cat(obj_parts, 1)
    if cfg.head_kind == "detection":
        # yolov1: the box confidence is the objectness (detection_layer.c
        # get_detection_detections: dets[index].objectness = scale)
        hd = cfg.detection_head
        s, n, c = hd.side, hd.num, hd.classes
        b = logits.shape[0]
        boxes, _ = decode_detection(logits, hd)
        t = logits.float().reshape(b, -1)
        return boxes, t[:, s * s * c:s * s * (c + n)].reshape(b, s * s * n)
    if cfg.head_kind != "region":
        raise ValueError(f"recall needs a detection model; {cfg.name} "
                         f"is a {cfg.head_kind} model")
    # [region], plain or YOLO9000 tree: the tree changes the class math
    # only, the objectness is the same sigmoid
    b, h, w, _ = logits.shape
    a = len(cfg.anchors)
    t = logits.float().reshape(b, h, w, a, 5 + cfg.num_classes)
    boxes = decode_region_boxes(torch.sigmoid(t[..., 0]),
                                torch.sigmoid(t[..., 1]), t[..., 2],
                                t[..., 3], cfg.anchors, h, w)
    conf = torch.sigmoid(t[..., 4])
    return boxes.reshape(b, -1, 4), conf.reshape(b, -1)


def nms_objectness(boxes_xyxy: np.ndarray, obj: np.ndarray,
                   nms_thresh: float) -> np.ndarray:
    """box.c do_nms_obj on host: descending-objectness greedy pass,
    suppression (objectness := 0) when IoU is strictly > nms_thresh,
    class-agnostic. Ties sort stably (darknet's qsort order for equal
    keys is unspecified). Returns the objectness vector with suppressed
    entries zeroed."""
    obj = np.asarray(obj, np.float64).copy()
    if nms_thresh <= 0 or len(obj) == 0:
        return obj
    order = np.argsort(-obj, kind="stable")
    b = np.asarray(boxes_xyxy, np.float64)[order]
    o = obj[order]
    # garbage weights can exp-overflow box extents to inf; inf-inf IoU
    # terms go NaN, and NaN compares False everywhere below — exactly
    # darknet's float behavior (nan > thresh is false in C too), so
    # only the numpy warnings are suppressed
    with np.errstate(invalid="ignore", over="ignore"):
        area = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(
            b[:, 3] - b[:, 1], 0)
        for i in range(len(o) - 1):
            if o[i] == 0:
                continue
            rest = slice(i + 1, None)
            iw = (np.minimum(b[i, 2], b[rest, 2])
                  - np.maximum(b[i, 0], b[rest, 0]))
            ih = (np.minimum(b[i, 3], b[rest, 3])
                  - np.maximum(b[i, 1], b[rest, 1]))
            inter = np.maximum(iw, 0) * np.maximum(ih, 0)
            union = area[i] + area[rest] - inter
            iou = np.divide(inter, union,
                            out=np.zeros_like(inter),
                            where=union > 0)  # box_iou: I/U==0 -> 0
            o[i + 1:][iou > nms_thresh] = 0.0
    out = np.zeros_like(obj)
    out[order] = o
    return out


def _iou_matrix(a_xyxy: np.ndarray, b_xyxy: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M) continuous IoU (box.c box_iou:
    zero when I or U is zero)."""
    a = np.asarray(a_xyxy, np.float64)
    b = np.asarray(b_xyxy, np.float64)
    # see nms_objectness: NaN from inf-extent boxes resolves to 0 here,
    # matching darknet's nan-compares-false float behavior
    with np.errstate(invalid="ignore", over="ignore"):
        iw = (np.minimum(a[:, None, 2], b[None, :, 2])
              - np.maximum(a[:, None, 0], b[None, :, 0]))
        ih = (np.minimum(a[:, None, 3], b[None, :, 3])
              - np.maximum(a[:, None, 1], b[None, :, 1]))
        inter = np.maximum(iw, 0) * np.maximum(ih, 0)
        area_a = (np.maximum(a[:, 2] - a[:, 0], 0)
                  * np.maximum(a[:, 3] - a[:, 1], 0))
        area_b = (np.maximum(b[:, 2] - b[:, 0], 0)
                  * np.maximum(b[:, 3] - b[:, 1], 0))
        union = area_a[:, None] + area_b[None, :] - inter
        return np.divide(inter, union, out=np.zeros_like(inter),
                         where=union > 0)


def _gt_net_norm(gt_img: Dict, net_hw: Tuple[int, int],
                 resize: str) -> np.ndarray:
    """One image's ground truth (pixel xyxy + width/height +
    difficult, eval.runner.build_ground_truth layout) -> net-normalized
    xyxy through the active resize geometry; difficult boxes dropped
    (voc_label.py drops them at label conversion — see module
    docstring). darknet-list GT carries difficult=False throughout."""
    from yolo_tpu_torch.ops.letterbox import letterbox_geometry

    boxes = np.asarray(gt_img["boxes"], np.float64).reshape(-1, 4)
    keep = ~np.asarray(gt_img["difficult"], bool).reshape(-1)
    boxes = boxes[keep]
    w, h = float(gt_img["width"]), float(gt_img["height"])
    net_h, net_w = net_hw
    if resize == "stretch":
        return boxes / np.array([w, h, w, h])
    scale, _rh, _rw, px, py = letterbox_geometry(int(h), int(w),
                                                 (net_h, net_w))
    out = boxes * scale
    out[:, 0::2] = (out[:, 0::2] + px) / net_w
    out[:, 1::2] = (out[:, 1::2] + py) / net_h
    return out


def recall_image(boxes_xywh: np.ndarray, obj: np.ndarray,
                 gt_xyxy: np.ndarray, *, thresh: float = DEFAULT_THRESH,
                 nms: float = DEFAULT_NMS,
                 iou_thresh: float = DEFAULT_IOU_THRESH
                 ) -> Tuple[int, int, int, float]:
    """One image's recall accounting. boxes_xywh (N, 4) net-normalized
    center-format candidates with objectness obj (N,); gt_xyxy (M, 4)
    in the SAME normalized space. Returns (proposals, correct, total,
    sum_best_iou)."""
    b = np.asarray(boxes_xywh, np.float64).reshape(-1, 4)
    obj = np.asarray(obj, np.float64).reshape(-1)
    # pre-filter to objectness > thresh (exact — module docstring)
    keep = obj > thresh
    b, obj = b[keep], obj[keep]
    xyxy = np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                     b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2],
                    axis=-1)
    obj = nms_objectness(xyxy, obj, nms)
    live = obj > thresh
    proposals = int(np.count_nonzero(live))
    total = int(len(gt_xyxy))
    if total == 0:
        return proposals, 0, 0, 0.0
    if proposals == 0:
        return proposals, 0, total, 0.0
    best = _iou_matrix(np.asarray(gt_xyxy, np.float64),
                       xyxy[live]).max(axis=1)
    correct = int(np.count_nonzero(best > iou_thresh))
    return proposals, correct, total, float(best.sum())


def recall_detector(cfg, folded_params,
                    samples: Sequence[Tuple[str, object]], *,
                    batch: int = 32, thresh: float = DEFAULT_THRESH,
                    nms: float = DEFAULT_NMS,
                    iou_thresh: float = DEFAULT_IOU_THRESH,
                    compute_dtype=torch.float32, resize: str = "letterbox",
                    print_lines: bool = True, out=None,
                    names: Optional[Sequence[str]] = None,
                    device="cuda") -> Dict[str, float]:
    """validate_detector_recall over ``samples`` ((path, annotation)
    pairs): forward + objectness decode on ``device``, host NMS and IoU
    accounting, darknet's cumulative per-image stderr lines, and a
    summary dict {recall, avg_iou, proposals_per_img, correct, total,
    proposals, images}. folded_params: fold_params output (numpy).
    ``names`` overrides the class vocabulary the annotations are parsed
    against (default cfg.class_names): recall is class-agnostic, but
    name-mapped annotations drop boxes whose names do not resolve, so
    recall and eval must parse the same list."""
    from yolo_tpu_torch.data.pipeline import (DevicePrefetcher,
                                              inference_batches)
    from yolo_tpu_torch.device import resolve as resolve_device
    from yolo_tpu_torch.eval.runner import build_ground_truth
    from yolo_tpu_torch.models.graph import Darknet

    out = sys.stderr if out is None else out
    net = Darknet(cfg.layers, folded_params, device=resolve_device(device),
                  dtype=compute_dtype)
    gt, _ = build_ground_truth(samples,
                               cfg.class_names if names is None
                               else list(names))
    gt_net = {i: _gt_net_norm(gt[i], cfg.input_hw, resize) for i in gt}
    path_ids: Dict[str, list] = {}
    for i, (p, _a) in enumerate(samples):
        path_ids.setdefault(p, []).append(i)
    host_iter = inference_batches(list(path_ids), batch,
                                  net_size=cfg.input_hw, resize=resize,
                                  channels=cfg.in_channels)
    img_i = correct = total = proposals = 0
    sum_iou = 0.0
    seen: set = set()
    with DevicePrefetcher(host_iter, depth=2, device=net.device) as staged, \
            torch.no_grad():
        for bt in staged:
            logits = net(bt["images"].to(net.compute_dtype))
            boxes_d, obj_d = decode_boxes_objectness(cfg, logits)
            # one device -> host copy per output array per batch
            boxes_np = boxes_d.cpu().numpy().astype(np.float64)
            obj_np = obj_d.cpu().numpy().astype(np.float64)
            for bi, path in enumerate(bt["paths"]):
                for sid in path_ids[path]:
                    p, c, t, s = recall_image(
                        boxes_np[bi], obj_np[bi], gt_net[sid],
                        thresh=thresh, nms=nms, iou_thresh=iou_thresh)
                    proposals += p
                    correct += c
                    total += t
                    sum_iou += s
                    if print_lines:
                        # validate_detector_recall's fprintf, with the
                        # 0-total division guarded to 0.0 (C prints nan)
                        aiou = 100.0 * sum_iou / total if total else 0.0
                        rec = 100.0 * correct / total if total else 0.0
                        print(f"{img_i:5d} {correct:5d} {total:5d}\t"
                              f"RPs/Img: {proposals / (img_i + 1):.2f}\t"
                              f"IOU: {aiou:.2f}%\tRecall:{rec:.2f}%",
                              file=out)
                    img_i += 1
                    seen.add(sid)
    # images the loader skipped (unreadable) still carry ground truth:
    # their boxes count as missed, as eval counts them
    unscored = [sid for sid in gt_net if sid not in seen]
    if unscored:
        missed = sum(len(gt_net[sid]) for sid in unscored)
        total += missed
        print(f"WARNING: {len(unscored)} image(s) could not be read — "
              f"their {missed} GT box(es) count as missed (darknet "
              f"errors out here)", file=out)
    return {
        "recall": correct / total if total else 0.0,
        "avg_iou": sum_iou / total if total else 0.0,
        "proposals_per_img": proposals / img_i if img_i else 0.0,
        "correct": correct, "total": total,
        "proposals": proposals, "images": img_i,
    }
