"""YOLOv2 region loss (YOLO9000 trees too), the yolov3/v4 [yolo] loss,
the yolov1 [detection] loss and the darknet classifiers' cross-entropy
(port of yolo_tpu/train/loss.py).

Darknet region-layer semantics, each squared error weighted once by its
scale:

  L = sum coord_scale*(2 - w*h) * [(sx-tx)^2+(sy-ty)^2+(tw-ttw)^2+(th-tth)^2]   (assigned)
    + object_scale   * (iou - conf)^2        (assigned; rescore=1)
      or (1 - conf)^2 when rescore=0
    + noobject_scale * (0 - conf)^2          (unassigned anchors whose best
                                              IoU vs any GT < thresh)
    + class_scale    * ||softmax - onehot||^2 (assigned; with a YOLO9000
                                              tree, summed over the sibling
                                              groups on the target's root
                                              path)
    + 0.01 * prior matching on unassigned anchors while seen < 12800
      images, targets (0.5, 0.5, prior).

Every term is computed from the raw head logits in fp32 and divided by
the batch size. The rescore target and the noobj gate carry no gradient,
as darknet's deltas. yolo_loss is documented at YoloLossConfig, with
the scaled-yolov4 new_coords heads and the Gaussian YOLOv3 heads;
classifier_loss and detection_loss at their definitions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from yolo_tpu_torch.ops.decode import (_tree_consts, decode_head_boxes,
                                       decode_region_boxes,
                                       tree_absolute_probs,
                                       tree_conditional_probs,
                                       tree_log_conditional)
from yolo_tpu_torch.ops.letterbox import as_hw


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


def _diag_iou_variant(p: torch.Tensor, g: torch.Tensor, kind: str,
                      eps: float = 1e-9) -> torch.Tensor:
    """Elementwise IoU / GIoU / DIoU / CIoU of matching (..., 4) xywh
    boxes (GIoU arXiv:1902.09630; D/CIoU arXiv:1911.08287). CIoU's
    alpha carries no gradient, as the JAX package's stop_gradient."""
    px1, py1 = p[..., 0] - p[..., 2] / 2, p[..., 1] - p[..., 3] / 2
    px2, py2 = p[..., 0] + p[..., 2] / 2, p[..., 1] + p[..., 3] / 2
    gx1, gy1 = g[..., 0] - g[..., 2] / 2, g[..., 1] - g[..., 3] / 2
    gx2, gy2 = g[..., 0] + g[..., 2] / 2, g[..., 1] + g[..., 3] / 2
    iw = (torch.minimum(px2, gx2) - torch.maximum(px1, gx1)).clamp_min(0.0)
    ih = (torch.minimum(py2, gy2) - torch.maximum(py1, gy1)).clamp_min(0.0)
    inter = iw * ih
    union = p[..., 2] * p[..., 3] + g[..., 2] * g[..., 3] - inter
    iou = inter / (union + eps)
    if kind == "iou":
        return iou
    cw = torch.maximum(px2, gx2) - torch.minimum(px1, gx1)  # enclosing box
    ch = torch.maximum(py2, gy2) - torch.minimum(py1, gy1)
    if kind == "giou":
        area_c = cw * ch + eps
        return iou - (area_c - union) / area_c
    rho2 = (p[..., 0] - g[..., 0]) ** 2 + (p[..., 1] - g[..., 1]) ** 2
    c2 = cw ** 2 + ch ** 2 + eps
    if kind == "diou":
        return iou - rho2 / c2
    if kind != "ciou":
        raise ValueError(f"unknown iou_loss {kind!r}")
    v = (4.0 / math.pi ** 2) * (
        torch.atan(g[..., 2] / (g[..., 3] + eps))
        - torch.atan(p[..., 2] / (p[..., 3] + eps))) ** 2
    alpha = (v / (1.0 - iou + v + eps)).detach()
    return iou - rho2 / c2 - alpha * v


def _diag_iou(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of matching (..., 4) xywh boxes."""
    return _diag_iou_variant(p, g, "iou")


def detection_loss(flat: torch.Tensor, targets: Dict[str, torch.Tensor],
                   head, batch_total: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """YOLOv1's loss, eq. 3 of arXiv:1506.02640 with the [detection]
    scale keys (loss.py::detection_loss):

      coord_scale    sum 1obj_ij [(tx-x_rel)^2 + (ty-y_rel)^2
                                  + (tw-sqrt w)^2 + (th-sqrt h)^2]  (sqrt=1)
      object_scale   sum 1obj_ij (C - conf)^2, C the live IoU (rescore=1)
                                               or 1
      noobject_scale sum (1 - 1obj_ij) conf^2
      class_scale    sum 1obj_i ||probs - onehot||^2, per cell

    The responsible predictor of an object cell is its max-IoU box
    against the truth, or, where every IoU is 0, the box nearest the
    truth (darknet's min-RMSE fallback). flat (B, side²(classes +
    num(1+coords))) raw activations (any trailing shape); targets of
    data.targets.encode_v1. Parts and total are divided by the batch
    size (batch_total: the whole batch's, where flat is a shard of it);
    the rescore target carries no gradient."""
    s, n, c = head.side, head.num, head.classes
    b = flat.shape[0]
    nb = b if batch_total is None else batch_total
    t = flat.to(torch.float32).reshape(b, -1)
    probs = t[:, :s * s * c].reshape(b, s * s, c)
    conf = t[:, s * s * c:s * s * (c + n)].reshape(b, s * s, n)
    boxt = t[:, s * s * (c + n):].reshape(b, s * s, n, head.coords)
    obj = targets["v1_obj"].float()                # (B, S²)
    tbox = targets["v1_box"].float()               # (B, S², 4)
    tcls = targets["v1_cls"].long()                # (B, S²)

    cell = torch.arange(s * s, dtype=torch.float32, device=t.device)
    col, row = (cell % s)[None, :, None], (cell // s)[None, :, None]
    pw = boxt[..., 2].square() if head.sqrt else boxt[..., 2]
    ph = boxt[..., 3].square() if head.sqrt else boxt[..., 3]
    pred = torch.stack([(boxt[..., 0] + col) / s, (boxt[..., 1] + row) / s,
                        pw, ph], dim=-1)                    # (B, S², N, 4)
    iou = _iou_xywh_pairwise(pred, tbox[:, :, None, :])[..., 0]
    dist2 = (pred - tbox[:, :, None, :]).square().sum(dim=-1)
    best = torch.where(iou.amax(dim=-1) > 0, iou.argmax(dim=-1),
                       dist2.argmin(dim=-1))
    resp = F.one_hot(best, n).float() * obj[..., None]       # (B, S², N)

    xr = tbox[..., 0] * s - col[..., 0]
    yr = tbox[..., 1] * s - row[..., 0]
    tw = tbox[..., 2].sqrt() if head.sqrt else tbox[..., 2]
    th = tbox[..., 3].sqrt() if head.sqrt else tbox[..., 3]
    sq = ((boxt[..., 0] - xr[..., None]).square()
          + (boxt[..., 1] - yr[..., None]).square()
          + (boxt[..., 2] - tw[..., None]).square()
          + (boxt[..., 3] - th[..., None]).square())
    ctarget = iou.detach() if head.rescore else torch.ones_like(iou)
    onehot = F.one_hot(tcls, c).float()
    parts = {
        "coord": head.coord_scale * (resp * sq).sum() / nb,
        "obj": head.object_scale * (resp * (ctarget - conf).square()).sum()
        / nb,
        "noobj": head.noobject_scale * ((1.0 - resp) * conf.square()).sum()
        / nb,
        "class": head.class_scale * (obj[..., None]
                                     * (probs - onehot).square()).sum() / nb,
    }
    return sum(parts.values()), parts


def classifier_loss(logits: torch.Tensor, labels: torch.Tensor, tree=None,
                    temperature: float = 1.0,
                    batch_total: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Softmax cross-entropy of classifier training (loss.py::
    classifier_loss; darknet softmax_x_ent: error -log p(truth), delta
    truth - p on the logits).

    With a YOLO9000 tree the label's root path adds one CE term per
    sibling group (every ancestor is a truth, paper section 4); groups
    off the path carry no gradient; labels may be internal nodes. The
    temperature divides the logits in the forward only: darknet's
    backward applies no 1/T, so the scaling is straight-through.

    logits (B, C) before the softmax (Darknet*(softmax_logits=True));
    labels (B,) int. Returns (mean CE, {"ce", "top1"}); top1 is the
    batch's accuracy (with a tree: the leaf-masked absolute argmax, an
    internal-node label counted when it lies on that leaf's path).
    batch_total: the whole batch, where logits are a shard of it (the
    means become this shard's sums over it)."""
    mean = ((lambda v: v.mean()) if batch_total is None
            else (lambda v: v.sum() / batch_total))
    logits = logits.to(torch.float32)
    labels = labels.long()
    if temperature != 1.0:
        scaled = logits / temperature
        logits = logits + (scaled - logits).detach()
    if tree is None:
        logp = torch.log_softmax(logits, dim=-1)
        ce = -torch.gather(logp, 1, labels[:, None])[:, 0]
        pred = torch.argmax(logits, dim=-1)
        mean_ce = mean(ce)
        top1 = mean((pred == labels).to(torch.float32))
        return mean_ce, {"ce": mean_ce, "top1": top1}
    consts = _tree_consts(tree, logits.device)
    logc = tree_log_conditional(logits, tree)
    paths = consts["paths"]
    pnodes = paths[labels]                           # (B, max_depth)
    mask = (pnodes >= 0).to(torch.float32)
    ce = -torch.sum(mask * torch.gather(logc, 1, pnodes.clamp_min(0)),
                    dim=-1)
    with torch.no_grad():
        absolute = tree_absolute_probs(tree_conditional_probs(logits, tree),
                                       tree)
        pred = torch.argmax(torch.where(consts["leaf"], absolute,
                                        torch.zeros_like(absolute)), dim=-1)
        hit = torch.any(paths[pred] == labels[:, None], dim=-1)
    mean_ce = mean(ce)
    return mean_ce, {"ce": mean_ce, "top1": mean(hit.to(torch.float32))}


def _tree_class_sq(logits_c: torch.Tensor, tcls: torch.Tensor,
                   tree) -> torch.Tensor:
    """The hierarchical class squared error per anchor (loss.py::
    _tree_class_sq): for target node t, over the sibling groups g on
    path(t), ||cond_g - onehot_g||^2 = sumsq(g) - 2 cond[node_g] + 1.
    (..., C) logits and (...,) int targets -> (...,)."""
    cond = tree_conditional_probs(logits_c, tree)
    lead = cond.shape[:-1]
    cond = cond.reshape(-1, cond.shape[-1])
    consts = _tree_consts(tree, cond.device)
    g = consts["node_group"]
    sumsq = torch.zeros((cond.shape[0], tree.n_groups),
                        device=cond.device).scatter_add(
                            1, g[None, :].expand(cond.shape[0], -1),
                            cond ** 2)
    pnodes = consts["paths"][tcls.reshape(-1).long()]
    mask = (pnodes >= 0).to(torch.float32)
    safe = pnodes.clamp_min(0)
    cond_at = torch.gather(cond, 1, safe)
    sumsq_at = torch.gather(sumsq, 1, g[safe])
    return torch.sum(mask * (sumsq_at - 2.0 * cond_at + 1.0),
                     dim=-1).reshape(lead)


def region_loss(logits: torch.Tensor, targets: Dict[str, torch.Tensor],
                anchors, num_classes: int, cfg: LossConfig, seen,
                tree=None, batch_total: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits (B, S, S, A*(5+C)); targets from data.targets.encode_batch
    as tensors on the logits' device; seen: images trained on before
    this batch (int). Returns (total loss per image, parts dict with
    coord / obj / noobj / class / warmup). A YOLO9000 tree swaps the
    class term for _tree_class_sq's: the squared error within each
    sibling group on the target's root path only. batch_total: the
    batch the parts divide by, where logits are a shard of it."""
    b, sh, sw, _ = logits.shape
    nb = b if batch_total is None else batch_total
    a = len(anchors)
    c = num_classes
    t = logits.to(torch.float32).reshape(b, sh, sw, a, 5 + c)

    sx = torch.sigmoid(t[..., 0])
    sy = torch.sigmoid(t[..., 1])
    tw = t[..., 2]
    th = t[..., 3]
    conf = torch.sigmoid(t[..., 4])

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

    if tree is not None:
        loss_cls = cfg.class_scale * torch.sum(
            obj * _tree_class_sq(t[..., 5:], targets["tcls"], tree))
    else:
        onehot = torch.nn.functional.one_hot(
            targets["tcls"].long(), c).to(torch.float32)
        loss_cls = cfg.class_scale * torch.sum(
            obj[..., None] * (torch.softmax(t[..., 5:], dim=-1)
                              - onehot) ** 2)

    # warm-up prior matching (darknet seen < 12800)
    warm = float(int(seen) < cfg.warmup_seen)
    sq_warm = ((sx - 0.5) ** 2 + (sy - 0.5) ** 2 + tw ** 2 + th ** 2)
    loss_warm = warm * cfg.warmup_scale * torch.sum((1.0 - obj) * sq_warm)

    parts = {
        "coord": loss_coord / nb,
        "obj": loss_obj / nb,
        "noobj": loss_noobj / nb,
        "class": loss_cls / nb,
        "warmup": loss_warm / nb,
    }
    total = sum(parts.values())
    return total, parts


@dataclasses.dataclass(frozen=True)
class YoloLossConfig:
    """yolov3/yolov4 [yolo]-layer loss (darknet yolo_layer semantics),
    the JAX package's YoloLossConfig field for field.

    Darknet's deltas on the sigmoid outputs (target - sigmoid) are the
    BCE gradient with respect to the logit, so the xy, objectness and
    class terms are sigmoid BCE, and wh is 0.5*MSE on the raw logits.
    Anchors whose predicted box overlaps any truth above ignore_thresh
    pay no objectness penalty. iou_loss != "mse" (yolov4: ciou) puts
    iou_normalizer * (1 - IoU_kind) on the decoded boxes in place of the
    xy/wh terms. With obj_normalizer None, cls_normalizer scales the
    objectness terms (classic AlexeyAB); a float obj_normalizer scales
    objectness and cls_normalizer then scales the class BCE. max_delta
    clamps each box-term gradient element (darknet clips the per-image
    delta, so the bound here is max_delta / batch); label_smooth_eps
    smooths class targets to y*(1 - eps) + eps/2; focal_loss swaps the
    class BCE for the focal loss (gamma 2, alpha 0.5); truth_thresh < 1
    trains anchors whose best predicted-box IoU beats it as positives
    toward that truth.

    Scaled-yolov4 heads (new_coords) arrive logistic-activated (the head
    conv's activation), and darknet's delta (target - output) on them is
    the gradient of 0.5*MSE on the activations, so their objectness and
    class terms are 0.5*MSE and their box term an iou-family loss (mse
    raises, as in the JAX package). [Gaussian_yolo] heads take the
    paper's per-coordinate Gaussian NLL (arXiv:1904.04620, gaussian_nll)
    over the encoded targets with sigma = sigmoid(u), weighted by
    (2 - w*h), and BCE objectness and classes at their shifted slots."""
    ignore_thresh: float = 0.7
    iou_loss: str = "mse"  # "mse" (yolov3) | "iou"|"giou"|"diou"|"ciou"
    iou_normalizer: float = 1.0
    cls_normalizer: float = 1.0
    obj_normalizer: Optional[float] = None
    max_delta: float = 0.0
    label_smooth_eps: float = 0.0
    focal_loss: bool = False
    truth_thresh: float = 1.0


def yolo_loss_config(mcfg) -> YoloLossConfig:
    """YoloLossConfig from a ModelConfig's [yolo] training keys, as the
    JAX package's train command builds it (cli/train_cmd.py)."""
    return YoloLossConfig(ignore_thresh=mcfg.ignore_thresh,
                          iou_loss=mcfg.iou_loss,
                          iou_normalizer=mcfg.iou_normalizer,
                          cls_normalizer=mcfg.cls_normalizer,
                          obj_normalizer=mcfg.obj_normalizer,
                          focal_loss=mcfg.focal_loss,
                          truth_thresh=mcfg.truth_thresh)


def _bce(logit: torch.Tensor, target) -> torch.Tensor:
    """Sigmoid binary cross-entropy, elementwise, from the raw logit."""
    return (logit.clamp_min(0.0) - logit * target
            + torch.log1p(torch.exp(-logit.abs())))


class _ClipGrad(torch.autograd.Function):
    """Identity forward; the backward clamps the incoming gradient to
    [-m, m] per element (darknet max_delta clips l.delta the same
    way)."""

    @staticmethod
    def forward(ctx, x, m):
        ctx.m = m
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-ctx.m, ctx.m), None


def _clip_grad(x: torch.Tensor, m: float) -> torch.Tensor:
    return _ClipGrad.apply(x, m)


def gaussian_nll(target: torch.Tensor, mu: torch.Tensor,
                 sigma: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Gaussian YOLOv3 per-coordinate negative log likelihood
    (loss.py::gaussian_nll, arXiv:1904.04620 eq. 9): -log(N(target | mu,
    sigma^2) + eps), the variance stabilized by eps, computed in log
    space (logaddexp) so that no pdf under- or overflows."""
    var = torch.square(sigma) + eps
    log_pdf = (-0.5 * torch.log(2.0 * math.pi * var)
               - torch.square(target - mu) / (2.0 * var))
    return -torch.logaddexp(log_pdf, torch.log(
        torch.tensor(eps, dtype=torch.float32, device=log_pdf.device)))


def _ignore_gate(best_iou: torch.Tensor, thresh: float) -> torch.Tensor:
    """1.0 where an anchor's best predicted-box IoU with any truth is
    below the ignore threshold (it pays the noobj term), else 0.0."""
    return (best_iou < thresh).to(torch.float32)


def yolo_loss(head_logits, targets: Dict[str, torch.Tensor], anchors_px,
              masks, num_classes: int, net_size, cfg: YoloLossConfig,
              scales=None, max_deltas=None, smooth_eps=None,
              new_coords=None, gaussian=None,
              batch_total: Optional[int] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Multi-head [yolo] loss. head_logits: the tuple of (B, S, S,
    A*(5+C)) raw outputs (DarknetTrain's; A*(9+C) for a Gaussian head);
    targets from data.targets.encode_batch_yolo as tensors on the
    logits' device; net_size int or (net_h, net_w). scales: per-head
    scale_x_y (the mse xy term becomes 0.5*MSE on the scaled sigmoid
    where != 1). max_deltas / smooth_eps: per-head overrides of
    cfg.max_delta / cfg.label_smooth_eps (None falls back to the cfg; an
    explicit 0 disables). new_coords / gaussian: per-head flags of the
    scaled-yolov4 and Gaussian heads (YoloLossConfig). batch_total: the
    batch the parts and the max_delta clip divide by, where the logits
    are a shard of it. Returns (total loss per image, parts dict with
    coord / obj / noobj / class)."""
    net_h, net_w = as_hw(net_size)
    c = num_classes
    b = head_logits[0].shape[0]
    nb = b if batch_total is None else batch_total
    dev = head_logits[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    parts = {"coord": zero, "obj": zero, "noobj": zero, "class": zero}
    n_heads = len(masks)
    scales = scales or [1.0] * n_heads
    max_deltas = max_deltas or [None] * n_heads
    smooth_eps = smooth_eps or [None] * n_heads
    new_coords = new_coords or [False] * n_heads
    gaussian = gaussian or [False] * n_heads
    if any(gaussian) and any(new_coords):
        raise NotImplementedError(
            "[Gaussian_yolo] + new_coords heads cannot be combined")
    if any(new_coords) and cfg.iou_loss == "mse":
        raise NotImplementedError(
            "[yolo] new_coords=1 training requires an iou-family "
            "iou_loss (iou/giou/diou/ciou — every scaled-yolov4 cfg "
            "uses ciou); the mse combination's sqrt wh targets are "
            "not encoded")
    if cfg.focal_loss and any(new_coords):
        raise NotImplementedError(
            "[yolo] focal_loss=1 with new_coords=1 heads is not "
            "supported (the scaled family's class term is "
            "activation-space MSE, not BCE; no published cfg combines "
            "them)")
    if cfg.focal_loss and (cfg.label_smooth_eps
                           or any(e for e in smooth_eps if e)):
        raise NotImplementedError(
            "[yolo] focal_loss=1 with label_smooth_eps is not supported "
            "(the focal p_t is undefined for soft targets)")
    if cfg.truth_thresh < 1.0 and any(gaussian):
        raise NotImplementedError(
            "[yolo] truth_thresh < 1 with [Gaussian_yolo] heads is "
            "not supported (the multi-truth box term would need the "
            "Gaussian NLL; no published cfg combines them)")
    # classic AlexeyAB: cls_normalizer scales objectness; with
    # obj_normalizer set it scales objectness and cls_normalizer the
    # class term
    on = (cfg.cls_normalizer if cfg.obj_normalizer is None
          else cfg.obj_normalizer)
    cls_n = 1.0 if cfg.obj_normalizer is None else cfg.cls_normalizer

    for h, (logits, mask, s_xy, nc, ga) in enumerate(zip(
            head_logits, masks, scales, new_coords, gaussian, strict=True)):
        _, sh, sw, _ = logits.shape
        a = len(mask)
        sig = None
        if ga:
            # interleaved (9+C): the means and the rest as a 5+C view
            tg = logits.to(torch.float32).reshape(b, sh, sw, a, 9 + c)
            sig = torch.sigmoid(tg[..., [1, 3, 5, 7]])
            t = torch.cat([tg[..., [0, 2, 4, 6]], tg[..., 8:]], dim=-1)
        else:
            t = logits.to(torch.float32).reshape(b, sh, sw, a, 5 + c)
        md = None if ga else (max_deltas[h] if max_deltas[h] is not None
                              else cfg.max_delta)
        # the clamp reaches the box terms only; obj and class keep t
        t_box = (torch.cat([_clip_grad(t[..., :4], md / nb), t[..., 4:]],
                           dim=-1) if md else t)
        obj = targets[f"obj_mask_{h}"]
        tc = targets[f"tcoord_{h}"]
        coord_w = targets[f"coord_w_{h}"]

        pred_boxes = decode_head_boxes(t_box, anchors_px, mask, s_xy,
                                       net_size, new_coords=nc)
        off = (s_xy - 1.0) / 2.0
        iou_all = _iou_xywh_pairwise(pred_boxes.reshape(b, -1, 4),
                                     targets["gt_boxes"])
        iou_all = iou_all * targets["gt_mask"][:, None, :]
        best_iou = iou_all.amax(dim=-1).reshape(b, sh, sw, a).detach()

        mt = None
        if cfg.truth_thresh < 1.0:
            best_g = iou_all.detach().argmax(dim=-1)            # (B, N)
            mt = (best_iou > cfg.truth_thresh).to(torch.float32) * (1.0 - obj)

        noobj_mask = (1.0 - obj) * _ignore_gate(best_iou, cfg.ignore_thresh)
        if mt is not None:
            noobj_mask = noobj_mask * (1.0 - mt)
        if nc:
            # activated objectness: 0.5*MSE, whose gradient is darknet's
            # (target - output); the conv's logistic supplies p(1 - p)
            obj_bce = 0.5 * (1.0 - t[..., 4]) ** 2
            noobj_bce = 0.5 * torch.square(t[..., 4])
        else:
            obj_bce = _bce(t[..., 4], 1.0)
            noobj_bce = _bce(t[..., 4], 0.0)
        parts["obj"] = parts["obj"] + on * torch.sum(obj * obj_bce) / nb
        parts["noobj"] = (parts["noobj"]
                          + on * torch.sum(noobj_mask * noobj_bce) / nb)

        if ga:
            mu_x = torch.sigmoid(t_box[..., 0]) * s_xy - off
            mu_y = torch.sigmoid(t_box[..., 1]) * s_xy - off
            nll = (gaussian_nll(tc[..., 0], mu_x, sig[..., 0])
                   + gaussian_nll(tc[..., 1], mu_y, sig[..., 1])
                   + gaussian_nll(tc[..., 2], t_box[..., 2], sig[..., 2])
                   + gaussian_nll(tc[..., 3], t_box[..., 3], sig[..., 3]))
            parts["coord"] = parts["coord"] + torch.sum(
                obj * coord_w * nll) / nb
        elif cfg.iou_loss != "mse":
            iou_k = _diag_iou_variant(pred_boxes, targets[f"tbox_{h}"],
                                      cfg.iou_loss)
            parts["coord"] = parts["coord"] + cfg.iou_normalizer * torch.sum(
                obj * (1.0 - iou_k)) / nb
        else:
            if s_xy == 1.0:
                xy = _bce(t_box[..., 0], tc[..., 0]) \
                    + _bce(t_box[..., 1], tc[..., 1])
            else:
                px = torch.sigmoid(t_box[..., 0]) * s_xy - off
                py = torch.sigmoid(t_box[..., 1]) * s_xy - off
                xy = 0.5 * ((px - tc[..., 0]) ** 2 + (py - tc[..., 1]) ** 2)
            wh = 0.5 * ((t_box[..., 2] - tc[..., 2]) ** 2
                        + (t_box[..., 3] - tc[..., 3]) ** 2)
            parts["coord"] = parts["coord"] + torch.sum(
                obj * coord_w * (xy + wh)) / nb

        def cls_elem(onehot):
            if nc:
                return 0.5 * torch.square(t[..., 5:] - onehot)
            if cfg.focal_loss:
                p = torch.sigmoid(t[..., 5:])
                pt = onehot * p + (1.0 - onehot) * (1.0 - p)
                return 0.5 * (1.0 - pt) ** 2 * _bce(t[..., 5:], onehot)
            return _bce(t[..., 5:], onehot)

        onehot = F.one_hot(targets[f"tcls_{h}"].long(), c).to(torch.float32)
        eps = (smooth_eps[h] if smooth_eps[h] is not None
               else cfg.label_smooth_eps)
        if eps:
            onehot = onehot * (1.0 - eps) + 0.5 * eps
        parts["class"] = parts["class"] + cls_n * torch.sum(
            obj[..., None] * cls_elem(onehot)) / nb

        if mt is not None:
            # positives toward the best truth, at the anchor's own cell
            gtb = torch.gather(targets["gt_boxes"], 1,
                               best_g[..., None].expand(-1, -1, 4)
                               ).reshape(b, sh, sw, a, 4).detach()
            gtc = torch.gather(targets["gt_cls"].long(), 1,
                               best_g).reshape(b, sh, sw, a)
            parts["obj"] = parts["obj"] + on * torch.sum(mt * obj_bce) / nb
            onehot_mt = F.one_hot(gtc, c).to(torch.float32)
            if eps:
                onehot_mt = onehot_mt * (1.0 - eps) + 0.5 * eps
            parts["class"] = parts["class"] + cls_n * torch.sum(
                mt[..., None] * cls_elem(onehot_mt)) / nb
            if cfg.iou_loss != "mse":
                iou_mt = _diag_iou_variant(pred_boxes, gtb, cfg.iou_loss)
                parts["coord"] = (parts["coord"] + cfg.iou_normalizer
                                  * torch.sum(mt * (1.0 - iou_mt)) / nb)
            else:
                cxi = torch.arange(sw, dtype=torch.float32,
                                   device=dev)[None, None, :, None]
                cyj = torch.arange(sh, dtype=torch.float32,
                                   device=dev)[None, :, None, None]
                txm = gtb[..., 0] * sw - cxi
                tym = gtb[..., 1] * sh - cyj
                aw = torch.tensor([anchors_px[m][0] for m in mask],
                                  dtype=torch.float32, device=dev)
                ah = torch.tensor([anchors_px[m][1] for m in mask],
                                  dtype=torch.float32, device=dev)
                twm = torch.log((gtb[..., 2] * net_w / aw).clamp_min(1e-9))
                thm = torch.log((gtb[..., 3] * net_h / ah).clamp_min(1e-9))
                if s_xy == 1.0:
                    xy_mt = _bce(t_box[..., 0], txm) + _bce(t_box[..., 1],
                                                            tym)
                else:
                    pxm = torch.sigmoid(t_box[..., 0]) * s_xy - off
                    pym = torch.sigmoid(t_box[..., 1]) * s_xy - off
                    xy_mt = 0.5 * ((pxm - txm) ** 2 + (pym - tym) ** 2)
                wh_mt = 0.5 * ((t_box[..., 2] - twm) ** 2
                               + (t_box[..., 3] - thm) ** 2)
                w_mt = 2.0 - gtb[..., 2] * gtb[..., 3]
                parts["coord"] = parts["coord"] + torch.sum(
                    mt * w_mt * (xy_mt + wh_mt)) / nb

    total = sum(parts.values())
    return total, parts
