"""Region and [yolo] decode (port of yolo_tpu/ops/decode.py, flat
classes only).

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

No tw/th clamp, as in the JAX package. YOLO9000 tree decode is ROADMAP
A10.
"""

from __future__ import annotations

import torch

from yolo_tpu_torch.ops.letterbox import as_hw


def decode(logits: torch.Tensor, anchors, num_classes: int):
    """logits (B, H, W, A*(5+C)) -> boxes (B, H*W*A, 4) net-normalized
    (cx, cy, w, h) and scores (B, H*W*A, C) = conf * class prob, fp32."""
    b, h, w, _ = logits.shape
    a = len(anchors)
    t = logits.to(torch.float32).reshape(b, h, w, a, 5 + num_classes)
    pred_boxes = decode_region_boxes(
        torch.sigmoid(t[..., 0]), torch.sigmoid(t[..., 1]),
        t[..., 2], t[..., 3], anchors, h, w)
    conf = torch.sigmoid(t[..., 4])
    scores = conf[..., None] * torch.softmax(t[..., 5:], dim=-1)
    return pred_boxes.reshape(b, -1, 4), scores.reshape(b, -1, num_classes)


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
