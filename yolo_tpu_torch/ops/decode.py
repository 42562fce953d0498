"""Region, [yolo] and [detection] decode (port of yolo_tpu/ops/decode.py).

[region] (yolov2), anchors in cell units:
  bx = (sigmoid(tx) + cx) / W,  by = (sigmoid(ty) + cy) / H
  bw = pw * exp(tw) / W,        bh = ph * exp(th) / H
  conf = sigmoid(to), p = softmax(tc), score = conf * p
[yolo] (yolov3/v4), anchors in pixels of the net input, scale_x_y s:
  bx = (sigmoid(tx) * s - (s - 1) / 2 + cx) / W
  bw = pw * exp(tw) / net_w,    bh = ph * exp(th) / net_h
  conf = sigmoid(to), p = sigmoid(tc) per class, score = conf * p
scaled-yolov4 new_coords heads, values already logistic (v):
  bx = (v * s - (s - 1) / 2 + cx) / W, bw = 4 v^2 pw / net_w,
  conf = v_o, p = v_c
[Gaussian_yolo] heads, 9+C channels an anchor [x, ux, y, uy, w, uw, h,
uh, obj, cls...]: the box from x/y/w/h as [yolo], score = sigmoid(obj)
* (1 - mean(sigmoid(u))) * sigmoid(cls).

[detection] (yolov1), the flat layout of specs.DetectionHead:
  bx = (tx + col) / side,  by = (ty + row) / side
  bw = tw^2, bh = th^2 (sqrt=1; tw, th as they are with sqrt=0)
  score = confidence * class probability, no activation

YOLO9000 trees (configs/tree.py): the class logits are soft-maxed per
sibling group (tree_conditional_probs); a node's absolute probability is
the product of the conditionals on its root path (tree_absolute_probs);
prediction descends from the roots taking the most confident child while
that product stays above hier_thresh (tree_top_prediction).

No tw/th clamp, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from yolo_tpu_torch.ops.letterbox import as_hw


def decode(logits: torch.Tensor, anchors, num_classes: int, tree=None,
           tree_map: Optional[Tuple[int, ...]] = None,
           hier_thresh: float = 0.5):
    """logits (B, H, W, A*(5+C)) -> boxes (B, H*W*A, 4) net-normalized
    (cx, cy, w, h) and scores (B, H*W*A, C) = conf * class prob, fp32.

    With a tree (configs.tree.SoftmaxTree) the class math is YOLO9000's:
    with tree_map (a darknet .map) score_j = conf * absolute[map[j]],
    scores (B, N, len(map)); without, the greedy traversal's node scores
    conf, one-hot over the tree's nodes (decode.py::decode)."""
    b, h, w, _ = logits.shape
    a = len(anchors)
    t = logits.to(torch.float32).reshape(b, h, w, a, 5 + num_classes)
    pred_boxes = decode_region_boxes(
        torch.sigmoid(t[..., 0]), torch.sigmoid(t[..., 1]),
        t[..., 2], t[..., 3], anchors, h, w)
    conf = torch.sigmoid(t[..., 4])
    if tree is None:
        scores = conf[..., None] * torch.softmax(t[..., 5:], dim=-1)
        out_c = num_classes
    else:
        cond = tree_conditional_probs(t[..., 5:], tree)
        if tree_map is not None:
            absolute = tree_absolute_probs(cond, tree)
            scores = conf[..., None] * absolute[..., list(tree_map)]
            out_c = len(tree_map)
        else:
            node = tree_top_prediction(cond, tree, hier_thresh)
            scores = (torch.nn.functional.one_hot(
                node.long(), num_classes).to(torch.float32)
                * conf[..., None])
            out_c = num_classes
    return pred_boxes.reshape(b, -1, 4), scores.reshape(b, -1, out_c)


@functools.lru_cache(maxsize=8)
def _tree_np_consts(tree):
    """Constant tables of one SoftmaxTree, as numpy arrays
    (decode.py::_tree_np_consts): node_group, parents, levels (root 0),
    child_group, members (G, max group size, padded with -1), leaf, and
    paths (n_nodes, max_depth) root-first, padded with -1 (the loss's
    gather table). Built once per tree, so no forward walks the tree in
    Python; the depth is paths.shape[1]."""
    from yolo_tpu_torch.configs.tree import (group_members_padded,
                                             tree_paths_padded)

    levels = np.zeros(tree.n_nodes, dtype=np.int64)
    for i, p in enumerate(tree.parents):
        levels[i] = 0 if p < 0 else levels[p] + 1
    return {
        "node_group": np.asarray(tree.node_group, np.int64),
        "parents": np.asarray(tree.parents, np.int64),
        "levels": levels,
        "child_group": np.asarray(tree.child_group, np.int64),
        "members": group_members_padded(tree).astype(np.int64),
        "leaf": np.asarray([tree.leaf(i) for i in range(tree.n_nodes)],
                           bool),
        "paths": tree_paths_padded(tree).astype(np.int64),
    }


@functools.lru_cache(maxsize=16)
def _tree_consts(tree, device: torch.device):
    """_tree_np_consts as tensors on ``device``, cached per device."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in _tree_np_consts(tree).items()}


def _tree_group_shift(logits_c: torch.Tensor, tree):
    """(..., C) class logits -> (z, group sum of exp(z) at each node),
    both (rows, C) fp32: z the logits less their sibling group's max
    (the shift cancels in the softmax: no gradient through it)."""
    g = _tree_consts(tree, logits_c.device)["node_group"]
    t = logits_c.to(torch.float32).reshape(-1, logits_c.shape[-1])
    gi = g[None, :].expand(t.shape[0], -1)
    gmax = torch.full((t.shape[0], tree.n_groups), -torch.inf,
                      device=t.device).scatter_reduce(
                          1, gi, t, "amax", include_self=True)
    z = t - gmax[:, g].detach()
    gsum = torch.zeros((t.shape[0], tree.n_groups),
                       device=t.device).scatter_add(1, gi, torch.exp(z))
    return z, gsum[:, g]


def tree_conditional_probs(logits_c: torch.Tensor, tree) -> torch.Tensor:
    """(..., C) class logits -> the per-sibling-group softmax (YOLO9000's
    conditional probabilities Pr(node | parent)), fp32: each group's max
    subtracted, exp, divided by the group's sum."""
    z, gsum = _tree_group_shift(logits_c, tree)
    return (torch.exp(z) / gsum).reshape(logits_c.shape)


def tree_log_conditional(logits_c: torch.Tensor, tree) -> torch.Tensor:
    """(..., C) class logits -> log of the per-sibling-group softmax, as
    the shifted logit minus the group's log-sum-exp (never the log of a
    formed probability: the classifier CE's stable form)."""
    z, gsum = _tree_group_shift(logits_c, tree)
    return (z - torch.log(gsum)).reshape(logits_c.shape)


def tree_absolute_probs(cond: torch.Tensor, tree) -> torch.Tensor:
    """Conditional -> absolute probabilities: the product of the
    conditionals on each node's root path, one tree level at a time."""
    k = _tree_consts(tree, cond.device)
    parents = k["parents"].clamp_min(0)
    lead = cond.shape[:-1]
    cond = cond.reshape(-1, cond.shape[-1])
    absolute = cond
    for d in range(1, k["paths"].shape[1]):
        absolute = torch.where(k["levels"] == d, cond * absolute[:, parents],
                               absolute)
    return absolute.reshape(*lead, cond.shape[-1])


def tree_top_prediction(cond: torch.Tensor, tree,
                        thresh: float) -> torch.Tensor:
    """The greedy hierarchy prediction on conditionals
    (decode.py::tree_top_prediction): from the root group, take the most
    confident node of the group; descend while the running product of
    conditionals times it exceeds ``thresh``; predict the last accepted
    node (the root group's argmax even below the threshold). Unrolled
    over the tree's depth. Returns int32 node indices of
    cond.shape[:-1]."""
    k = _tree_consts(tree, cond.device)
    members, child_group = k["members"], k["child_group"]
    lead = cond.shape[:-1]
    cond = cond.reshape(-1, cond.shape[-1])
    n = cond.shape[0]
    group = torch.zeros(n, dtype=torch.int64, device=cond.device)
    p = torch.ones(n, dtype=torch.float32, device=cond.device)
    result = torch.full((n,), -1, dtype=torch.int64, device=cond.device)
    done = torch.zeros(n, dtype=torch.bool, device=cond.device)
    for step in range(k["paths"].shape[1]):
        cand = members[group]                                  # (n, K)
        val = torch.where(cand >= 0,
                          torch.gather(cond, 1, cand.clamp_min(0)),
                          torch.full_like(cond[:, :1], -1.0))
        mx, arg = val.max(dim=-1)
        node = torch.gather(cand, 1, arg[:, None])[:, 0]
        active = ~done
        accept = active & (p * mx > thresh)
        result = torch.where(active if step == 0 else accept, node, result)
        p = torch.where(accept, p * mx, p)
        is_leaf = child_group[node] < 0
        group = torch.where(accept & ~is_leaf, child_group[node], group)
        done = done | ~accept | (accept & is_leaf)
    return result.to(torch.int32).reshape(lead)


def decode_region_boxes(sx, sy, tw, th, anchors, h: int, w: int):
    """[region] box decode (region_layer.c get_region_box).

    sx/sy: sigmoided xy offsets (B, H, W, A); tw/th raw wh logits;
    anchors (A, 2) in cell units. Returns (B, H, W, A, 4) normalized
    (cx, cy, w, h)."""
    a = torch.as_tensor(anchors, dtype=torch.float32, device=sx.device)
    cx = torch.arange(w, dtype=torch.float32,
                      device=sx.device)[None, None, :, None]
    cy = torch.arange(h, dtype=torch.float32,
                      device=sx.device)[None, :, None, None]
    bx = (sx + cx) / w
    by = (sy + cy) / h
    bw = a[None, None, None, :, 0] * torch.exp(tw) / w
    bh = a[None, None, None, :, 1] * torch.exp(th) / h
    return torch.stack([bx, by, bw, bh], dim=-1)


def decode_yolo(head_logits, anchors_px, masks, num_classes: int,
                net_size, scales=None, new_coords=None, gaussian=None):
    """[yolo] decode of every head, merged: head_logits a sequence of
    (B, Hs, Ws, As*(5+C)) (As*(9+C) for a Gaussian head); masks per-head
    indices into anchors_px; net_size int or (net_h, net_w); scales
    per-head scale_x_y (default 1); new_coords per-head scaled-yolov4
    flags (the values arrive logistic-activated: xy and wh from them
    directly, conf and classes as they are); gaussian per-head
    [Gaussian_yolo] flags (interleaved [x, ux, y, uy, w, uw, h, uh, obj,
    cls...]; score scaled by 1 - mean(sigmoid(u))). Returns boxes (B, N,
    4) net-normalized xywh and scores (B, N, C), N the heads' Hs*Ws*As in
    head order, fp32 (decode.py::decode_yolo)."""
    n_heads = len(masks)
    scales = scales or [1.0] * n_heads
    new_coords = new_coords or [False] * n_heads
    gaussian = gaussian or [False] * n_heads
    all_boxes, all_scores = [], []
    for logits, mask, s_xy, nc, ga in zip(head_logits, masks, scales,
                                          new_coords, gaussian, strict=True):
        b, h, w, _ = logits.shape
        t = logits.to(torch.float32).reshape(
            b, h, w, len(mask), (9 if ga else 5) + num_classes)
        if ga:
            boxes = decode_head_boxes(t[..., [0, 2, 4, 6]], anchors_px,
                                      mask, s_xy, net_size)
            uc = torch.sigmoid(t[..., [1, 3, 5, 7]]).mean(dim=-1)
            conf = torch.sigmoid(t[..., 8]) * (1.0 - uc)
            probs = torch.sigmoid(t[..., 9:])
        else:
            boxes = decode_head_boxes(t, anchors_px, mask, s_xy, net_size,
                                      new_coords=nc)
            conf = t[..., 4] if nc else torch.sigmoid(t[..., 4])
            probs = t[..., 5:] if nc else torch.sigmoid(t[..., 5:])
        all_boxes.append(boxes.reshape(b, -1, 4))
        all_scores.append((conf[..., None] * probs).reshape(b, -1,
                                                            num_classes))
    return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1)


def decode_head_boxes(t, anchors_px, mask, s_xy: float, net_size,
                      new_coords: bool = False):
    """(B, H, W, A, 5+C) fp32 head activations -> (B, H, W, A, 4)
    normalized xywh: the [yolo] box math, shared by decode_yolo and the
    training loss's ignore gate and iou-family box terms. new_coords:
    the values are logistic-activated already, xy skips the sigmoid and
    wh = (2v)^2 * anchor instead of exp."""
    net_h, net_w = as_hw(net_size)
    _, h, w, _, _ = t.shape
    anch = torch.as_tensor(anchors_px, dtype=torch.float32,
                           device=t.device)[list(mask)]
    cx = torch.arange(w, dtype=torch.float32,
                      device=t.device)[None, None, :, None]
    cy = torch.arange(h, dtype=torch.float32,
                      device=t.device)[None, :, None, None]
    off = (s_xy - 1.0) / 2.0
    vx = t[..., 0] if new_coords else torch.sigmoid(t[..., 0])
    vy = t[..., 1] if new_coords else torch.sigmoid(t[..., 1])
    bx = (vx * s_xy - off + cx) / w
    by = (vy * s_xy - off + cy) / h
    if new_coords:
        bw = 4.0 * torch.square(t[..., 2]) * anch[None, None, None, :, 0] \
            / net_w
        bh = 4.0 * torch.square(t[..., 3]) * anch[None, None, None, :, 1] \
            / net_h
    else:
        bw = anch[None, None, None, :, 0] * torch.exp(t[..., 2]) / net_w
        bh = anch[None, None, None, :, 1] * torch.exp(t[..., 3]) / net_h
    return torch.stack([bx, by, bw, bh], dim=-1)


def decode_detection(flat: torch.Tensor, head) -> tuple:
    """yolov1 [detection] decode (decode.py::decode_detection): flat (B,
    side²·(classes + num·(1+coords))) values (any trailing shape) ->
    boxes (B, side²·num, 4) normalized xywh and scores (B, side²·num,
    classes) = confidence · class probability, fp32."""
    s, n, c = head.side, head.num, head.classes
    b = flat.shape[0]
    t = flat.to(torch.float32).reshape(b, -1)
    probs = t[:, :s * s * c].reshape(b, s * s, 1, c)
    conf = t[:, s * s * c:s * s * (c + n)].reshape(b, s * s, n)
    boxes = t[:, s * s * (c + n):].reshape(b, s * s, n, head.coords)
    cell = torch.arange(s * s, dtype=torch.float32, device=t.device)
    col, row = (cell % s)[None, :, None], (cell // s)[None, :, None]
    bx = (boxes[..., 0] + col) / s
    by = (boxes[..., 1] + row) / s
    if head.sqrt:
        bw, bh = boxes[..., 2].square(), boxes[..., 3].square()
    else:
        bw, bh = boxes[..., 2], boxes[..., 3]
    scores = conf[..., None] * probs
    out_boxes = torch.stack([bx, by, bw, bh], dim=-1)
    return out_boxes.reshape(b, -1, 4), scores.reshape(b, -1, c)
