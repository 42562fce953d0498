"""Fused detection heads (port of yolo_tpu/ops/head.py: detect_head for
the [region] head, detect_head_yolo for [yolo] heads).

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
                     beta_nms: float = 0.6):
    """Fused [yolo] multi-head: the objectness top-KB over every head's
    boxes (flat index (j*W + i)*A + a within a head, the heads
    concatenated in order), decode and sigmoid classes for those only,
    then steps 4-5 as detect_head. Boxes net-normalized xywh; net_size
    int or (net_h, net_w); scales per-head scale_x_y."""
    net_h, net_w = as_hw(net_size)
    c = num_classes
    b = head_logits[0].shape[0]
    dev = head_logits[0].device
    anchors_np = np.asarray(anchors_px, dtype=np.float32)
    scales = scales or [1.0] * len(masks)
    # per-box decode constants, in the flat order
    ts, meta = [], []
    for logits, mask, s_xy in zip(head_logits, masks, scales, strict=True):
        _, h, w, _ = logits.shape
        a = len(mask)
        ts.append(logits.to(torch.float32).reshape(b, h * w * a, 5 + c))
        jj, ii, aa = np.meshgrid(np.arange(h), np.arange(w), np.arange(a),
                                 indexing="ij")
        n = h * w * a
        meta.append(np.stack([
            ii.reshape(-1), jj.reshape(-1), np.full(n, w), np.full(n, h),
            anchors_np[np.asarray(mask), 0][aa.reshape(-1)],
            anchors_np[np.asarray(mask), 1][aa.reshape(-1)],
            np.full(n, s_xy)]).astype(np.float32))
    t = torch.cat(ts, dim=1)                                  # (B, N, 5+C)
    cx, cy, gw, gh, pw, ph, sc = torch.from_numpy(
        np.concatenate(meta, axis=1)).to(dev)
    n = t.shape[1]

    conf_all = torch.sigmoid(t[..., 4])
    kb = min(pre_top_k, n)
    conf_k, nidx = _top_k(conf_all, kb)                       # (B, KB)
    tk = torch.gather(t, 1, nidx[..., None].expand(-1, -1, 5 + c))
    s_k = sc[nidx]
    off = (s_k - 1.0) / 2.0
    bx = (torch.sigmoid(tk[..., 0]) * s_k - off + cx[nidx]) / gw[nidx]
    by = (torch.sigmoid(tk[..., 1]) * s_k - off + cy[nidx]) / gh[nidx]
    bw = torch.exp(tk[..., 2]) * pw[nidx] / net_w
    bh = torch.exp(tk[..., 3]) * ph[nidx] / net_h
    boxes_kb = torch.stack([bx, by, bw, bh], dim=-1)          # (B, KB, 4)
    scores_kb = conf_k[..., None] * torch.sigmoid(tk[..., 5:])

    scores_k, idx = _top_k(scores_kb.reshape(b, kb * c), kb)  # (B, K)
    classes_k = (idx % c).to(torch.int32)
    boxes_k = torch.gather(boxes_kb, 1,
                           (idx // c)[..., None].expand(-1, -1, 4))
    keep = _suppress(_geom(boxes_k), scores_k, classes_k, conf_threshold,
                     iou_threshold, use_kernel=use_kernel, kind=nms_kind,
                     beta=beta_nms)
    return _package(boxes_k, scores_k, classes_k, keep, max_detections)
