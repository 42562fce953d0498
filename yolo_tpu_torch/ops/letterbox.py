"""Device-side letterbox (port of yolo_tpu/ops/letterbox.py).

Half-pixel-center bilinear resize without antialiasing (cv2.INTER_LINEAR,
the numpy_ref.letterbox oracle) as two dense interpolation matmuls, H
first, then W: out = R_h @ img @ R_w^T. Each matmul accumulates in fp32
and rounds to the compute dtype, as the JAX op does. Tensors are NHWC at
this boundary, as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


# _lerp_matrix, as_hw and letterbox_geometry are copied from
# yolo_tpu/ops/letterbox.py, whose module imports jax.numpy
@functools.lru_cache(maxsize=64)
def _lerp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix, half-pixel
    centers, clamped borders (cv2.INTER_LINEAR semantics)."""
    scale = in_size / out_size
    coords = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(coords).astype(np.int64)
    frac = (coords - i0).astype(np.float64)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    i0 = np.clip(i0, 0, in_size - 1)
    m = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, i0), (1.0 - frac).astype(np.float32))
    np.add.at(m, (rows, i1), frac.astype(np.float32))
    return m


def as_hw(net) -> tuple:
    """Normalize a net-size argument: int -> (net, net); (h, w) kept."""
    if isinstance(net, (tuple, list)):
        h, w = net
        return int(h), int(w)
    return int(net), int(net)


def letterbox_geometry(src_h: int, src_w: int, net_size):
    """Static geometry: scale, resized (rh, rw), pad offsets (px, py).
    net_size: int (square) or (net_h, net_w)."""
    net_h, net_w = as_hw(net_size)
    scale = min(net_w / src_w, net_h / src_h)
    rw, rh = int(round(src_w * scale)), int(round(src_h * scale))
    px, py = (net_w - rw) // 2, (net_h - rh) // 2
    return scale, rh, rw, px, py


def _resize(x: torch.Tensor, out_h: int, out_w: int, dtype) -> torch.Tensor:
    """NHWC [0, 1] resize by the two interpolation matmuls (H, then W)."""
    _, h, w, _ = x.shape
    if out_h != h:
        mh = torch.as_tensor(_lerp_matrix(h, out_h), device=x.device)
        x = torch.einsum("oh,bhwc->bowc", mh.to(dtype), x)
    if out_w != w:
        mw = torch.as_tensor(_lerp_matrix(w, out_w), device=x.device)
        x = torch.einsum("ow,bhwc->bhoc", mw.to(dtype), x)
    return x


def letterbox(images: torch.Tensor, net_size,
              dtype=torch.float32) -> torch.Tensor:
    """images (B, H, W, C) uint8 raw RGB -> (B, net_h, net_w, C) in
    [0, 1], gray(0.5)-padded. net_size: int or (net_h, net_w)."""
    _, h, w, _ = images.shape
    net_h, net_w = as_hw(net_size)
    _, rh, rw, px, py = letterbox_geometry(h, w, net_size)
    x = images.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype)
    x = _resize(x, rh, rw, dtype)
    return torch.nn.functional.pad(
        x, (0, 0, px, net_w - rw - px, py, net_h - rh - py), value=0.5)


def stretch_resize(images: torch.Tensor, net_size,
                   dtype=torch.float32) -> torch.Tensor:
    """images (B, H, W, C) uint8 raw RGB -> (B, net_h, net_w, C) in
    [0, 1] by plain bilinear resize, aspect ratio not preserved (the
    AlexeyAB-darknet letter_box=0 preprocessing)."""
    net_h, net_w = as_hw(net_size)
    x = images.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype)
    return _resize(x, net_h, net_w, dtype)


def _clip_xyxy(cx, cy, bw, bh, src_h: int, src_w: int) -> torch.Tensor:
    x1 = (cx - bw / 2).clamp(0, src_w)
    y1 = (cy - bh / 2).clamp(0, src_h)
    x2 = (cx + bw / 2).clamp(0, src_w)
    y2 = (cy + bh / 2).clamp(0, src_h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def unstretch_boxes_xyxy(boxes_xywh: torch.Tensor, *, src_h: int,
                         src_w: int) -> torch.Tensor:
    """Inverse of stretch_resize for net-normalized xywh boxes ->
    original-image pixel xyxy, clipped."""
    b = boxes_xywh
    return _clip_xyxy(b[..., 0] * src_w, b[..., 1] * src_h,
                      b[..., 2] * src_w, b[..., 3] * src_h, src_h, src_w)


def unletterbox_boxes_xyxy(boxes_xywh: torch.Tensor, *, src_h: int,
                           src_w: int, net_size) -> torch.Tensor:
    """Map net-normalized xywh boxes to original-image pixel xyxy,
    clipped. net_size: int or (net_h, net_w)."""
    net_h, net_w = as_hw(net_size)
    scale, _, _, px, py = letterbox_geometry(src_h, src_w, net_size)
    b = boxes_xywh
    return _clip_xyxy((b[..., 0] * net_w - px) / scale,
                      (b[..., 1] * net_h - py) / scale,
                      b[..., 2] * net_w / scale,
                      b[..., 3] * net_h / scale, src_h, src_w)
