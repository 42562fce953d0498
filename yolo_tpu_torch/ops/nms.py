"""Fixed-shape, on-device class-wise greedy NMS (port of yolo_tpu/ops/nms.py).

Two candidate strategies, as in the JAX package:
  * "per-class" (exact): per-class top-K of the (B, N, C) score tensor ->
    a (B*C, K) grid. impl "cuda" | "torch".
  * "global" (fast): one top-K over all (box, class) pairs per image -> a
    (B, K) grid with mixed classes and a same-class suppression mask.
    impl "fused" (kernel) | "fused_torch".

Two suppression backends:
  * the CUDA kernel (ops/cuda/nms_kernel.py, csrc/nms_suppress.cu);
  * _suppress_torch, the plain PyTorch version: the CPU path and the
    reference the kernel is held against.

impl "auto" takes "fused" on CUDA tensors and the exact per-class "torch"
path elsewhere.

Memory is bounded by _CHUNK_ELEMS (nms.py's budget): the plain
suppression runs in row chunks whose (rows, K, K) pairwise tensors hold
at most that many fp32 elements, and the per-class path gathers the
candidates' geometry one class chunk at a time when the whole grid's
would exceed it (the exact eval of a 9418-node YOLO9000 tree is B*9418
rows). The kernel holds no pairwise tensor, so it takes the whole grid
in one launch while its (B*C, 5, K) geometry fits the budget. Rows are
independent: the keep masks are the same whatever the chunks. In every mode a box suppresses lower-ranked same-class
overlaps only if it is itself kept and above the confidence threshold;
ties order by (score desc, candidate index asc), as lax.top_k does.
"""

from __future__ import annotations

import torch

from yolo_tpu_torch.ops.cuda import nms_kernel


def _top_k(x: torch.Tensor, k: int):
    """lax.top_k over the last dim: values desc, ties by index asc
    (torch.topk does not promise that order; a stable sort does)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def pairwise_iou_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """boxes (K, 4) xywh -> IoU matrix (K, K) in fp32."""
    g = _geom(boxes.to(torch.float32))
    x1, y1, x2, y2, area = g.unbind(-2)
    iw = (torch.minimum(x2[:, None], x2[None, :])
          - torch.maximum(x1[:, None], x1[None, :])).clamp_min(0.0)
    ih = (torch.minimum(y2[:, None], y2[None, :])
          - torch.maximum(y1[:, None], y1[None, :])).clamp_min(0.0)
    inter = iw * ih
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _geom(boxes_k: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) xywh -> (..., 5, K) rows [x1, y1, x2, y2, area]."""
    x1 = boxes_k[..., 0] - boxes_k[..., 2] / 2
    y1 = boxes_k[..., 1] - boxes_k[..., 3] / 2
    x2 = boxes_k[..., 0] + boxes_k[..., 2] / 2
    y2 = boxes_k[..., 1] + boxes_k[..., 3] / 2
    area = boxes_k[..., 2] * boxes_k[..., 3]
    return torch.stack([x1, y1, x2, y2, area], dim=-2)


def _suppress_torch(geom: torch.Tensor, scores_k: torch.Tensor,
                    classes_k: torch.Tensor, conf_threshold: float,
                    iou_threshold: float, kind: str = "greedy",
                    beta: float = 0.6) -> torch.Tensor:
    """geom (G, 5, K), scores_k (G, K) sorted desc, classes_k (G, K) ->
    keep (G, K) float {0, 1}. Plain PyTorch version of the kernel.

    kind="diou" is AlexeyAB's diounms: the suppression metric becomes
    IoU - (d/c)^beta, d the squared center distance and c the squared
    diagonal of the smallest enclosing box."""
    g, _, k = geom.shape
    x1, y1, x2, y2, area = geom.unbind(1)
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp_min(0.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp_min(0.0)
    inter = iw * ih
    union = area[:, :, None] + area[:, None, :] - inter
    iou = torch.where(union > 0, inter / union, torch.zeros_like(inter))
    if kind == "diou":
        cx = (x1 + x2) / 2
        cy = (y1 + y2) / 2
        d = ((cx[:, :, None] - cx[:, None, :]) ** 2
             + (cy[:, :, None] - cy[:, None, :]) ** 2)
        ew = (torch.maximum(x2[:, :, None], x2[:, None, :])
              - torch.minimum(x1[:, :, None], x1[:, None, :]))
        eh = (torch.maximum(y2[:, :, None], y2[:, None, :])
              - torch.minimum(y1[:, :, None], y1[:, None, :]))
        c = ew ** 2 + eh ** 2
        # darknet box_diounms: c == 0 -> plain IoU
        iou = torch.where(c > 0, iou - (d / c.clamp_min(1e-12)) ** beta, iou)
    elif kind != "greedy":
        raise ValueError(f"unknown NMS kind {kind!r} (greedy | diou)")
    same = classes_k[:, :, None] == classes_k[:, None, :]
    sup_matrix = same & (iou > iou_threshold)
    later = torch.arange(k, device=geom.device)[None, :]
    keep = torch.ones((g, k), dtype=torch.float32, device=geom.device)
    for i in range(k):
        active = (keep[:, i] > 0.5) & (scores_k[:, i] >= conf_threshold)
        suppress = active[:, None] & sup_matrix[:, i, :] & (later > i)
        keep = keep.masked_fill(suppress, 0.0)
    return keep * (scores_k >= conf_threshold).to(torch.float32)


# fp32 elements of one live chunk: a (rows, K, K) pairwise tensor of the
# plain suppression, or a (rows, 5, K) geometry gather for the kernel
# (64 Mi elements = 256 MB)
_CHUNK_ELEMS = 64 * 1024 * 1024


def _suppress_torch_rows(geom, scores_k, classes_k, conf_threshold,
                         iou_threshold, kind: str = "greedy",
                         beta: float = 0.6) -> torch.Tensor:
    """_suppress_torch in row chunks whose pairwise tensors hold at most
    _CHUNK_ELEMS elements (nms.py::_suppress_xla_rows)."""
    g, _, k = geom.shape
    rows = max(1, _CHUNK_ELEMS // (k * k))
    if g <= rows:
        return _suppress_torch(geom, scores_k, classes_k, conf_threshold,
                               iou_threshold, kind=kind, beta=beta)
    return torch.cat([_suppress_torch(
        geom[i:i + rows], scores_k[i:i + rows], classes_k[i:i + rows],
        conf_threshold, iou_threshold, kind=kind, beta=beta)
        for i in range(0, g, rows)])


def _per_class_suppress(geom_n, idx, scores_k, classes_k, conf_threshold,
                        iou_threshold, use_kernel: bool,
                        kind: str = "greedy", beta: float = 0.6):
    """Exact per-class suppression from a shared geometry table
    (nms.py::_per_class_suppress): geom_n (B, 5, N), idx / scores_k /
    classes_k (B, C, K) per-class top-K -> keep (B, C, K). The (rows, 5,
    K) geometry is gathered for as many classes at a time as
    _CHUNK_ELEMS allows: one chunk (one kernel launch) when the whole
    grid fits; the plain path chunks its (rows, K, K) pairwise tensor
    again by rows (_suppress_torch_rows)."""
    b, c, k = idx.shape
    n = geom_n.shape[-1]
    cc = max(1, _CHUNK_ELEMS // (5 * k) // b)
    keeps = []
    for c0 in range(0, c, cc):
        ic = idx[:, c0:c0 + cc]
        m = ic.shape[1]
        geom = torch.gather(geom_n[:, None, :, :].expand(b, m, 5, n), 3,
                            ic[:, :, None, :].expand(b, m, 5, k))
        keeps.append(_suppress(
            geom.reshape(b * m, 5, k),
            scores_k[:, c0:c0 + cc].reshape(b * m, k),
            classes_k[:, c0:c0 + cc].reshape(b * m, k),
            conf_threshold, iou_threshold, use_kernel=use_kernel,
            kind=kind, beta=beta).reshape(b, m, k))
    return keeps[0] if len(keeps) == 1 else torch.cat(keeps, dim=1)


def _suppress(geom, scores_k, classes_k, conf_threshold, iou_threshold,
              use_kernel: bool, kind: str = "greedy", beta: float = 0.6):
    if use_kernel and geom.shape[-1] > nms_kernel.MAX_K:
        use_kernel = False  # beyond the kernel's shared-memory bitmask
    if kind != "greedy":
        use_kernel = False  # the kernel computes plain IoU only
    if use_kernel:
        return nms_kernel.suppress(
            geom.contiguous(), scores_k.contiguous(),
            classes_k.to(torch.float32).contiguous(),
            conf_threshold=float(conf_threshold),
            iou_threshold=float(iou_threshold))
    return _suppress_torch_rows(geom, scores_k, classes_k, conf_threshold,
                                iou_threshold, kind=kind, beta=beta)


def _package(flat_boxes, flat_scores, flat_classes, keep, max_detections,
             box_index=None):
    """Final fixed-size output: global top max_detections by kept score.

    box_index (optional, (B, S) int64): slot -> row of flat_boxes, for
    the per-class path, which gathers boxes for the final D slots only."""
    masked = torch.where(keep > 0.5, flat_scores,
                         torch.full_like(flat_scores, -1.0))
    d = min(max_detections, masked.shape[-1])
    best, sel = _top_k(masked, d)
    bsel = sel if box_index is None else torch.gather(box_index, 1, sel)
    return {
        "boxes": torch.gather(flat_boxes, 1,
                              bsel[..., None].expand(-1, -1, 4)),
        "scores": best.clamp_min(0.0),
        "classes": torch.gather(flat_classes, 1, sel),
        "valid": best >= 0.0,
    }


def nms_batch(boxes: torch.Tensor, scores: torch.Tensor, *,
              conf_threshold: float, iou_threshold: float,
              top_k: int = 128, max_detections: int = 100,
              impl: str = "auto", kind: str = "greedy",
              beta: float = 0.6):
    """Class-wise NMS, batched.

    boxes (B, N, 4) xywh; scores (B, N, C).
    Returns fixed-shape tensors sorted by score desc:
      boxes (B, D, 4), scores (B, D), classes (B, D) int32, valid (B, D).
    """
    b, n, c = scores.shape
    if kind != "greedy" and impl in ("fused", "cuda"):
        impl = {"fused": "fused_torch", "cuda": "torch"}[impl]
    if impl == "auto":
        impl = "fused" if scores.device.type == "cuda" else "torch"

    if impl in ("fused", "fused_torch"):
        k = min(2 * top_k, n * c)
        scores_k, idx = _top_k(scores.reshape(b, n * c), k)
        box_idx = idx // c
        classes_k = (idx % c).to(torch.int32)
        boxes_k = torch.gather(boxes.to(torch.float32), 1,
                               box_idx[..., None].expand(-1, -1, 4))
        keep = _suppress(_geom(boxes_k), scores_k, classes_k,
                         conf_threshold, iou_threshold,
                         use_kernel=(impl == "fused"), kind=kind, beta=beta)
        return _package(boxes_k, scores_k, classes_k, keep, max_detections)

    if impl in ("cuda", "torch"):
        # exact per-class candidates: (B*C, K) grid; the box gather is
        # deferred to the final D slots (see _package's box_index)
        k = min(top_k, n)
        scores_k, idx = _top_k(scores.transpose(1, 2), k)  # (B, C, K)
        bf = boxes.to(torch.float32)
        classes_k = torch.arange(c, dtype=torch.int32,
                                 device=scores.device)[None, :, None] \
            .expand(b, c, k)
        keep = _per_class_suppress(_geom(bf), idx, scores_k, classes_k,
                                   conf_threshold, iou_threshold,
                                   use_kernel=(impl == "cuda"), kind=kind,
                                   beta=beta)
        return _package(bf, scores_k.reshape(b, c * k),
                        classes_k.reshape(b, c * k),
                        keep.reshape(b, c * k), max_detections,
                        box_index=idx.reshape(b, c * k))

    raise ValueError(f"unknown NMS impl {impl!r}")



def nms(boxes: torch.Tensor, scores: torch.Tensor, **kw):
    """nms_batch on one image: boxes (N, 4), scores (N, C)."""
    out = nms_batch(boxes[None], scores[None], **kw)
    return {key: v[0] for key, v in out.items()}
