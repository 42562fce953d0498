"""YOLOv2 region loss (port of yolo_tpu/train/loss.py, the region head
with flat classes).

Darknet region-layer semantics, each squared error weighted once by its
scale:

  L = sum coord_scale*(2 - w*h) * [(sx-tx)^2+(sy-ty)^2+(tw-ttw)^2+(th-tth)^2]   (assigned)
    + object_scale   * (iou - conf)^2        (assigned; rescore=1)
      or (1 - conf)^2 when rescore=0
    + noobject_scale * (0 - conf)^2          (unassigned anchors whose best
                                              IoU vs any GT < thresh)
    + class_scale    * ||softmax - onehot||^2 (assigned)
    + 0.01 * prior matching on unassigned anchors while seen < 12800
      images, targets (0.5, 0.5, prior).

Every term is computed from the raw head logits in fp32 and divided by
the batch size. The rescore target and the noobj gate carry no gradient,
as darknet's deltas. YOLO9000 tree classes and the yolov3/v4 losses are
ROADMAP A8/A10.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from yolo_tpu_torch.ops.decode import decode_region_boxes


@dataclasses.dataclass(frozen=True)
class LossConfig:
    coord_scale: float = 1.0
    object_scale: float = 5.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    iou_thresh: float = 0.6
    rescore: bool = True
    warmup_seen: int = 12800
    warmup_scale: float = 0.01


def region_loss_config(mcfg) -> LossConfig:
    """LossConfig from a ModelConfig's [region] training keys."""
    return LossConfig(coord_scale=mcfg.region_coord_scale,
                      object_scale=mcfg.region_object_scale,
                      noobject_scale=mcfg.region_noobject_scale,
                      class_scale=mcfg.region_class_scale,
                      iou_thresh=mcfg.region_thresh,
                      rescore=mcfg.region_rescore)


def _iou_xywh_pairwise(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """pred (..., N, 4), gt (..., G, 4) xywh -> IoU (..., N, G)."""
    px1 = pred[..., :, None, 0] - pred[..., :, None, 2] / 2
    py1 = pred[..., :, None, 1] - pred[..., :, None, 3] / 2
    px2 = pred[..., :, None, 0] + pred[..., :, None, 2] / 2
    py2 = pred[..., :, None, 1] + pred[..., :, None, 3] / 2
    gx1 = gt[..., None, :, 0] - gt[..., None, :, 2] / 2
    gy1 = gt[..., None, :, 1] - gt[..., None, :, 3] / 2
    gx2 = gt[..., None, :, 0] + gt[..., None, :, 2] / 2
    gy2 = gt[..., None, :, 1] + gt[..., None, :, 3] / 2
    iw = (torch.minimum(px2, gx2) - torch.maximum(px1, gx1)).clamp_min(0.0)
    ih = (torch.minimum(py2, gy2) - torch.maximum(py1, gy1)).clamp_min(0.0)
    inter = iw * ih
    pa = pred[..., :, None, 2] * pred[..., :, None, 3]
    ga = gt[..., None, :, 2] * gt[..., None, :, 3]
    union = pa + ga - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _diag_iou(p: torch.Tensor, g: torch.Tensor,
              eps: float = 1e-9) -> torch.Tensor:
    """Elementwise IoU of matching (..., 4) xywh boxes."""
    px1, py1 = p[..., 0] - p[..., 2] / 2, p[..., 1] - p[..., 3] / 2
    px2, py2 = p[..., 0] + p[..., 2] / 2, p[..., 1] + p[..., 3] / 2
    gx1, gy1 = g[..., 0] - g[..., 2] / 2, g[..., 1] - g[..., 3] / 2
    gx2, gy2 = g[..., 0] + g[..., 2] / 2, g[..., 1] + g[..., 3] / 2
    iw = (torch.minimum(px2, gx2) - torch.maximum(px1, gx1)).clamp_min(0.0)
    ih = (torch.minimum(py2, gy2) - torch.maximum(py1, gy1)).clamp_min(0.0)
    inter = iw * ih
    union = p[..., 2] * p[..., 3] + g[..., 2] * g[..., 3] - inter
    return inter / (union + eps)


def region_loss(logits: torch.Tensor, targets: Dict[str, torch.Tensor],
                anchors, num_classes: int, cfg: LossConfig, seen
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits (B, S, S, A*(5+C)); targets from data.targets.encode_batch
    as tensors on the logits' device; seen: images trained on before
    this batch (int). Returns (total loss per image, parts dict with
    coord / obj / noobj / class / warmup)."""
    b, sh, sw, _ = logits.shape
    a = len(anchors)
    c = num_classes
    t = logits.to(torch.float32).reshape(b, sh, sw, a, 5 + c)

    sx = torch.sigmoid(t[..., 0])
    sy = torch.sigmoid(t[..., 1])
    tw = t[..., 2]
    th = t[..., 3]
    conf = torch.sigmoid(t[..., 4])
    probs = torch.softmax(t[..., 5:], dim=-1)

    obj = targets["obj_mask"]                    # (B,S,S,A)
    tc = targets["tcoord"]                       # (B,S,S,A,4)
    coord_w = targets["coord_w"]

    pred_boxes = decode_region_boxes(sx, sy, tw, th, anchors, sh, sw)

    # noobj: anchors whose best IoU vs any valid GT < thresh
    flat_pred = pred_boxes.reshape(b, -1, 4)
    iou_all = _iou_xywh_pairwise(flat_pred, targets["gt_boxes"])  # (B,N,G)
    iou_all = iou_all * targets["gt_mask"][:, None, :]
    best_iou = iou_all.amax(dim=-1).reshape(b, sh, sw, a)
    noobj_mask = (1.0 - obj) * (best_iou < cfg.iou_thresh).to(torch.float32)
    loss_noobj = cfg.noobject_scale * torch.sum(noobj_mask * conf ** 2)

    # obj (rescore: the target is the live IoU vs the assigned GT)
    iou_truth = _diag_iou(pred_boxes, targets["tiou_boxes"])
    obj_target = iou_truth.detach() if cfg.rescore else 1.0
    loss_obj = cfg.object_scale * torch.sum(obj * (obj_target - conf) ** 2)

    sq = ((sx - tc[..., 0]) ** 2 + (sy - tc[..., 1]) ** 2 +
          (tw - tc[..., 2]) ** 2 + (th - tc[..., 3]) ** 2)
    loss_coord = cfg.coord_scale * torch.sum(obj * coord_w * sq)

    onehot = torch.nn.functional.one_hot(
        targets["tcls"].long(), c).to(torch.float32)
    loss_cls = cfg.class_scale * torch.sum(
        obj[..., None] * (probs - onehot) ** 2)

    # warm-up prior matching (darknet seen < 12800)
    warm = float(int(seen) < cfg.warmup_seen)
    sq_warm = ((sx - 0.5) ** 2 + (sy - 0.5) ** 2 + tw ** 2 + th ** 2)
    loss_warm = warm * cfg.warmup_scale * torch.sum((1.0 - obj) * sq_warm)

    parts = {
        "coord": loss_coord / b,
        "obj": loss_obj / b,
        "noobj": loss_noobj / b,
        "class": loss_cls / b,
        "warmup": loss_warm / b,
    }
    total = sum(parts.values())
    return total, parts
