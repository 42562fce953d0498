"""Darknet maxpool (port of yolo_tpu/ops/pool.py).

Darknet pads ``size - 1`` with the window origin shifted by
``-(size - 1) // 2``: lead = (size-1)//2 rows/cols, trail = the rest,
filled with the identity of max: -inf for floats, the int8 minimum for
the chained int8 activations of models/quantize.py (a -inf fill would
wrap). For the 2x2 pools that is end-padding only (the tiny-YOLO
stride-1 pool keeps its spatial size). F.max_pool2d's own padding is
symmetric, so the padding is an explicit F.pad.

F.max_pool2d has no int8 kernel on either device: int8 codes pool as
the running torch.maximum of the size x size strided views of the
padded tensor, in int8 (no float round trip; one elementwise pass a
window tap: an amax over unfolded windows ran far slower on the card,
PERF.md section 6). Max commutes with the monotone quantization, so
pooling the codes equals quantizing the pooled floats.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def maxpool_nchw(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    if x.dtype == torch.int8:
        fill = torch.iinfo(torch.int8).min
    elif x.is_floating_point():
        fill = float("-inf")
    else:
        raise ValueError(f"maxpool takes float or int8 tensors, got "
                         f"{x.dtype}")
    pad = size - 1
    lead = pad // 2
    h, w = x.shape[-2:]
    # the trailing pad is read only where it adds an output row/column
    # (never for 2x2/2 pools on even sizes): skip the copy otherwise
    if lead or any((n + pad - size) // stride != (n - size) // stride
                   for n in (h, w)):
        x = F.pad(x, (lead, pad - lead, lead, pad - lead), value=fill)
    if x.dtype == torch.int8:
        ho = (x.shape[-2] - size) // stride + 1
        wo = (x.shape[-1] - size) // stride + 1
        out = None
        for dy in range(size):
            for dx in range(size):
                tap = x[..., dy:dy + stride * (ho - 1) + 1:stride,
                        dx:dx + stride * (wo - 1) + 1:stride]
                out = tap if out is None else torch.maximum(out, tap)
        return out.contiguous(memory_format=torch.channels_last)
    return F.max_pool2d(x, size, stride)


def maxpool_nhwc(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """The JAX package's NHWC layer API."""
    return maxpool_nchw(x.permute(0, 3, 1, 2), size, stride) \
        .permute(0, 2, 3, 1)
