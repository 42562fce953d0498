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
pooling the codes equals quantizing the pooled floats. That running
maximum (maxpool_s8_plain) is the plain version of the int8 maxpool
kernel (csrc/maxpool_s8.cu, wrapper ops/cuda/pool_kernel.py), which
every int8 pool on a CUDA tensor launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


# plain int8 pools on a CUDA tensor since the last reset: the served
# int8 path on the card never makes one (chip_smoke.py reads it)
cuda_calls = 0


def out_hw(h: int, w: int, size: int, stride: int) -> tuple:
    """The output size of a darknet maxpool: (n + size - 1 - size) //
    stride + 1 on each side."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def _pad(x: torch.Tensor, size: int, stride: int, fill) -> torch.Tensor:
    pad = size - 1
    lead = pad // 2
    h, w = x.shape[-2:]
    # the trailing pad is read only where it adds an output row/column
    # (never for 2x2/2 pools on even sizes): skip the copy otherwise
    if lead or any((n + pad - size) // stride != (n - size) // stride
                   for n in (h, w)):
        x = F.pad(x, (lead, pad - lead, lead, pad - lead), value=fill)
    return x


def maxpool_s8_plain(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """int8 codes (B, C, H, W) -> their darknet maxpool, channels_last:
    the running torch.maximum of the size x size strided views of the
    tensor padded with the int8 minimum. Any device."""
    global cuda_calls
    if x.device.type == "cuda":
        cuda_calls += 1
    x = _pad(x, size, stride, torch.iinfo(torch.int8).min)
    ho = (x.shape[-2] - size) // stride + 1
    wo = (x.shape[-1] - size) // stride + 1
    out = None
    for dy in range(size):
        for dx in range(size):
            tap = x[..., dy:dy + stride * (ho - 1) + 1:stride,
                    dx:dx + stride * (wo - 1) + 1:stride]
            out = tap if out is None else torch.maximum(out, tap)
    return out.contiguous(memory_format=torch.channels_last)


def maxpool_nchw(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """(B, C, H, W) float or int8 codes -> the darknet maxpool. int8
    codes go through the int8 maxpool kernel's wrapper: the kernel on a
    CUDA tensor, its plain version on the CPU."""
    if x.dtype == torch.int8:
        from yolo_tpu_torch.ops.cuda import pool_kernel

        return pool_kernel.maxpool_s8(x, size, stride)
    if not x.is_floating_point():
        raise ValueError(f"maxpool takes float or int8 tensors, got "
                         f"{x.dtype}")
    return F.max_pool2d(_pad(x, size, stride, float("-inf")), size, stride)


def maxpool_nhwc(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """The JAX package's NHWC layer API."""
    return maxpool_nchw(x.permute(0, 3, 1, 2), size, stride) \
        .permute(0, 2, 3, 1)
