"""Darknet maxpool (port of yolo_tpu/ops/pool.py).

Darknet pads ``size - 1`` with the window origin shifted by
``-(size - 1) // 2``: lead = (size-1)//2 rows/cols, trail = the rest,
filled with -inf. For the 2x2 pools that is end-padding only (the
tiny-YOLO stride-1 pool keeps its spatial size). F.max_pool2d's own
padding is symmetric, so the padding is an explicit F.pad.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def maxpool_nchw(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    if not x.is_floating_point():
        raise NotImplementedError(
            "integer (int8) pooling is not ported yet (ROADMAP A11)")
    pad = size - 1
    lead = pad // 2
    h, w = x.shape[-2:]
    # the trailing pad is read only where it adds an output row/column
    # (never for 2x2/2 pools on even sizes): skip the copy otherwise
    if lead or any((n + pad - size) // stride != (n - size) // stride
                   for n in (h, w)):
        x = F.pad(x, (lead, pad - lead, lead, pad - lead),
                  value=float("-inf"))
    return F.max_pool2d(x, size, stride)


def maxpool_nhwc(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """The JAX package's NHWC layer API."""
    return maxpool_nchw(x.permute(0, 3, 1, 2), size, stride) \
        .permute(0, 2, 3, 1)
