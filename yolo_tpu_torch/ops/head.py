"""Fused detection heads (port of yolo_tpu/ops/head.py: detect_head for
the [region] head, detect_head_yolo for [yolo] heads, detect_head_tree
for YOLO9000's tree [region] head).

score = sigmoid(obj) * softmax(cls) <= sigmoid(obj), so:
  1. objectness sigmoid over all H*W*A boxes
  2. top-KB boxes by objectness
  3. decode + softmax only those KB boxes
  4. global top-K (box, class) candidates
  5. same-class greedy suppression (the CUDA kernel on the card)

Identical to the reference decode + per-class NMS whenever fewer than KB
boxes have objectness >= conf_threshold and fewer than K (box, class)
pairs clear it. The [yolo] head's classes are independent sigmoids, so
score = sigmoid(obj) * sigmoid(cls) <= sigmoid(obj) too.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_tpu_torch.ops.letterbox import as_hw
from yolo_tpu_torch.ops.nms import _geom, _package, _suppress, _top_k


def detect_head(logits: torch.Tensor, anchors, num_classes: int, *,
                conf_threshold: float, iou_threshold: float,
                pre_top_k: int = 256, max_detections: int = 100,
                use_kernel: bool = True, nms_kind: str = "greedy",
                beta_nms: float = 0.6):
    """logits (B, H, W, A*(5+C)) -> fixed-shape detections dict (boxes
    in net-normalized xywh)."""
    b, h, w, _ = logits.shape
    a = len(anchors)
    c = num_classes
    n = h * w * a
    t = logits.to(torch.float32).reshape(b, n, 5 + c)
    anchors_t = torch.as_tensor(anchors, dtype=torch.float32,
                                device=logits.device)

    # 1-2: objectness prefilter
    conf_all = torch.sigmoid(t[..., 4])                       # (B, N)
    kb = min(pre_top_k, n)
    conf_k, nidx = _top_k(conf_all, kb)                       # (B, KB)
    tk = torch.gather(t, 1, nidx[..., None].expand(-1, -1, 5 + c))

    # 3: decode the survivors (flat index n = (cj*W + ci)*A + ai)
    ai = nidx % a
    ci = (nidx // a) % w
    cj = nidx // (a * w)
    bx = (torch.sigmoid(tk[..., 0]) + ci.to(torch.float32)) / w
    by = (torch.sigmoid(tk[..., 1]) + cj.to(torch.float32)) / h
    bw = anchors_t[ai, 0] * torch.exp(tk[..., 2]) / w
    bh = anchors_t[ai, 1] * torch.exp(tk[..., 3]) / h
    boxes_kb = torch.stack([bx, by, bw, bh], dim=-1)          # (B, KB, 4)
    scores_kb = conf_k[..., None] * torch.softmax(tk[..., 5:], dim=-1)

    # 4: global top-K (box, class) candidates
    scores_k, idx = _top_k(scores_kb.reshape(b, kb * c), kb)  # (B, K)
    box_idx = idx // c
    classes_k = (idx % c).to(torch.int32)
    boxes_k = torch.gather(boxes_kb, 1, box_idx[..., None].expand(-1, -1, 4))

    # 5: suppression + packaging (shared with ops/nms.py)
    keep = _suppress(_geom(boxes_k), scores_k, classes_k, conf_threshold,
                     iou_threshold, use_kernel=use_kernel, kind=nms_kind,
                     beta=beta_nms)
    return _package(boxes_k, scores_k, classes_k, keep, max_detections)


def detect_head_yolo(head_logits, anchors_px, masks, num_classes: int,
                     net_size, *, conf_threshold: float,
                     iou_threshold: float, pre_top_k: int = 256,
                     max_detections: int = 100, use_kernel: bool = True,
                     scales=None, nms_kind: str = "greedy",
                     beta_nms: float = 0.6, new_coords=None,
                     gaussian=None):
    """Fused [yolo] multi-head: the objectness top-KB over every head's
    boxes (flat index (j*W + i)*A + a within a head, the heads
    concatenated in order), decode and sigmoid classes for those only,
    then steps 4-5 as detect_head. Boxes net-normalized xywh; net_size
    int or (net_h, net_w); scales per-head scale_x_y.

    new_coords: per-head scaled-yolov4 flags (conf, classes and xy taken
    as they are, wh = (2v)^2 * anchor). gaussian: per-head
    [Gaussian_yolo] flags; such a head is remapped into the shared 5+C
    view, its means in the xywh slots and in slot 4 the activated
    confidence sigmoid(obj) * (1 - mean(sigmoid(u))). Both keep score <=
    conf, so the prefilter's envelope holds (head.py::detect_head_yolo).
    Where heads mix, each value is selected per box with torch.where,
    so a classic head's exp overflow cannot reach a new_coords box
    through inf * 0."""
    net_h, net_w = as_hw(net_size)
    c = num_classes
    b = head_logits[0].shape[0]
    dev = head_logits[0].device
    anchors_np = np.asarray(anchors_px, dtype=np.float32)
    n_heads = len(masks)
    scales = scales or [1.0] * n_heads
    new_coords = new_coords or [False] * n_heads
    gaussian = gaussian or [False] * n_heads
    # per-box decode constants, in the flat order
    ts, meta = [], []
    for logits, mask, s_xy, nc, ga in zip(head_logits, masks, scales,
                                          new_coords, gaussian, strict=True):
        _, h, w, _ = logits.shape
        a = len(mask)
        if ga:
            raw = logits.to(torch.float32).reshape(b, h * w * a, 9 + c)
            uc = torch.sigmoid(raw[..., [1, 3, 5, 7]]).mean(dim=-1)
            conf = torch.sigmoid(raw[..., 8]) * (1.0 - uc)
            ts.append(torch.cat([raw[..., [0, 2, 4, 6]], conf[..., None],
                                 raw[..., 9:]], dim=-1))
        else:
            ts.append(logits.to(torch.float32).reshape(b, h * w * a, 5 + c))
        jj, ii, aa = np.meshgrid(np.arange(h), np.arange(w), np.arange(a),
                                 indexing="ij")
        n = h * w * a
        meta.append(np.stack([
            ii.reshape(-1), jj.reshape(-1), np.full(n, w), np.full(n, h),
            anchors_np[np.asarray(mask), 0][aa.reshape(-1)],
            anchors_np[np.asarray(mask), 1][aa.reshape(-1)],
            np.full(n, s_xy), np.full(n, float(nc)),
            # conf-direct: slot 4 is already an activated confidence
            np.full(n, float(nc or ga))]).astype(np.float32))
    t = torch.cat(ts, dim=1)                                  # (B, N, 5+C)
    cx, cy, gw, gh, pw, ph, sc, ncf, cdf = torch.from_numpy(
        np.concatenate(meta, axis=1)).to(dev)
    n = t.shape[1]
    all_nc, any_nc = all(new_coords), any(new_coords)
    cds = [x or g for x, g in zip(new_coords, gaussian)]

    def mix(nc_val, classic_val, nc_mask):
        """Per-box select; one branch when the heads agree."""
        if all_nc:
            return nc_val
        if not any_nc:
            return classic_val
        return torch.where(nc_mask > 0, nc_val, classic_val)

    if all(cds):
        conf_all = t[..., 4]
    elif not any(cds):
        conf_all = torch.sigmoid(t[..., 4])
    else:
        conf_all = torch.where(cdf[None, :] > 0, t[..., 4],
                               torch.sigmoid(t[..., 4]))
    kb = min(pre_top_k, n)
    conf_k, nidx = _top_k(conf_all, kb)                       # (B, KB)
    tk = torch.gather(t, 1, nidx[..., None].expand(-1, -1, 5 + c))
    s_k = sc[nidx]
    nc_k = ncf[nidx]
    off = (s_k - 1.0) / 2.0
    vx = mix(tk[..., 0], torch.sigmoid(tk[..., 0]), nc_k)
    vy = mix(tk[..., 1], torch.sigmoid(tk[..., 1]), nc_k)
    bx = (vx * s_k - off + cx[nidx]) / gw[nidx]
    by = (vy * s_k - off + cy[nidx]) / gh[nidx]
    bw = mix(4.0 * torch.square(tk[..., 2]), torch.exp(tk[..., 2]),
             nc_k) * pw[nidx] / net_w
    bh = mix(4.0 * torch.square(tk[..., 3]), torch.exp(tk[..., 3]),
             nc_k) * ph[nidx] / net_h
    boxes_kb = torch.stack([bx, by, bw, bh], dim=-1)          # (B, KB, 4)
    probs = mix(tk[..., 5:], torch.sigmoid(tk[..., 5:]), nc_k[..., None])
    scores_kb = conf_k[..., None] * probs

    scores_k, idx = _top_k(scores_kb.reshape(b, kb * c), kb)  # (B, K)
    classes_k = (idx % c).to(torch.int32)
    boxes_k = torch.gather(boxes_kb, 1,
                           (idx // c)[..., None].expand(-1, -1, 4))
    keep = _suppress(_geom(boxes_k), scores_k, classes_k, conf_threshold,
                     iou_threshold, use_kernel=use_kernel, kind=nms_kind,
                     beta=beta_nms)
    return _package(boxes_k, scores_k, classes_k, keep, max_detections)


def detect_head_tree(logits: torch.Tensor, anchors, tree, *,
                     conf_threshold: float, iou_threshold: float,
                     hier_thresh: float = 0.5, tree_map=None,
                     pre_top_k: int = 256, max_detections: int = 100,
                     use_kernel: bool = True, nms_kind: str = "greedy",
                     beta_nms: float = 0.6):
    """Fused YOLO9000 head (head.py::detect_head_tree): the objectness
    top-KB, then the hierarchy math on those boxes only, not on the
    reference path's dense (B, N, n_nodes) scores.

    Traversal mode (tree_map None): a box's score is its objectness and
    its class the traversal's node, so the objectness cut is exact
    whenever fewer than KB boxes clear conf_threshold. Map mode: score_j
    = conf * absolute[map[j]] <= conf, then the global (box, class)
    top-K as detect_head. Suppression: the NMS kernel on the card at K =
    KB."""
    from yolo_tpu_torch.ops.decode import (tree_absolute_probs,
                                           tree_conditional_probs,
                                           tree_top_prediction)

    b, h, w, _ = logits.shape
    a = len(anchors)
    c = tree.n_nodes
    n = h * w * a
    t = logits.to(torch.float32).reshape(b, n, 5 + c)
    anchors_t = torch.as_tensor(anchors, dtype=torch.float32,
                                device=logits.device)

    conf_all = torch.sigmoid(t[..., 4])
    kb = min(pre_top_k, n)
    conf_k, nidx = _top_k(conf_all, kb)
    tk = torch.gather(t, 1, nidx[..., None].expand(-1, -1, 5 + c))

    ai = nidx % a
    ci = (nidx // a) % w
    cj = nidx // (a * w)
    bx = (torch.sigmoid(tk[..., 0]) + ci.to(torch.float32)) / w
    by = (torch.sigmoid(tk[..., 1]) + cj.to(torch.float32)) / h
    bw = anchors_t[ai, 0] * torch.exp(tk[..., 2]) / w
    bh = anchors_t[ai, 1] * torch.exp(tk[..., 3]) / h
    boxes_k = torch.stack([bx, by, bw, bh], dim=-1)           # (B, KB, 4)

    cond = tree_conditional_probs(tk[..., 5:], tree)          # (B, KB, C)
    if tree_map is None:
        classes_k = tree_top_prediction(cond, tree, hier_thresh)
        scores_k = conf_k
    else:
        proj = tree_absolute_probs(cond, tree)[..., list(tree_map)]
        m = len(tree_map)
        scores_k, idx = _top_k((conf_k[..., None] * proj).reshape(
            b, kb * m), kb)
        classes_k = (idx % m).to(torch.int32)
        boxes_k = torch.gather(boxes_k, 1,
                               (idx // m)[..., None].expand(-1, -1, 4))
    keep = _suppress(_geom(boxes_k), scores_k, classes_k, conf_threshold,
                     iou_threshold, use_kernel=use_kernel, kind=nms_kind,
                     beta=beta_nms)
    return _package(boxes_k, scores_k, classes_k, keep, max_detections)
