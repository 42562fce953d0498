"""Region-layer decode (port of yolo_tpu/ops/decode.py, flat classes only).

  bx = (sigmoid(tx) + cx) / W,  by = (sigmoid(ty) + cy) / H
  bw = pw * exp(tw) / W,        bh = ph * exp(th) / H
  conf = sigmoid(to), p = softmax(tc), score = conf * p

No tw/th clamp, as in the JAX package. YOLO9000 tree decode is ROADMAP
A10.
"""

from __future__ import annotations

import torch


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
