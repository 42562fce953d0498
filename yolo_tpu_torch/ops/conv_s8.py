"""int8 conv block, plain PyTorch: the plain version of the s8 kernel
(``csrc/conv_s8_bias_act.cu``), and the arithmetic of
yolo_tpu/models/quantize.py::conv_block_int8, whose int8 x int8 -> int32
conv is an XLA op in the JAX package (no Pallas kernel).

Layouts are the Darknet executor's: activations (B, C, H, W) in
``torch.channels_last`` memory, int8 kernels OIHW in channels_last
memory (bytes ordered O, ky, kx, I/groups: K-major rows).

The order of operations is the JAX package's, so that outputs agree bit
for bit where the activation is leaky or linear:
  * a float input is quantized as round(x.f32 * x_inv), x_inv = 1 /
    x_scale taken once in fp32 (a reciprocal, then a multiply: not a
    division), clipped to [-127, 127]; an int8 input is taken as it is
    (chained: its producer quantized it at this block's scale);
  * the conv sums int8 products exactly: a float64 conv of the int8
    values (every partial sum is an integer below 2**53, so any order of
    summation is exact), rounded to int32;
  * y = acc.f32 * scale[oc] + bias[oc], scale = x_scale * w_scale formed
    in fp32 by the caller, then the activation in fp32;
  * then either round(y / out_scale) clipped to [-127, 127] as int8 (an
    IEEE division, round half to even), or y cast to ``out_dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from yolo_tpu_torch.configs.specs import ACTIVATIONS
from yolo_tpu_torch.ops import conv as conv_ops

# plain-version calls on a CUDA tensor since the last reset: the served
# int8 path on the card never makes one (chip_smoke.py reads it)
cuda_calls = 0


def out_hw(h: int, w: int, ks: int, stride: int, dilation: int) -> tuple:
    """The output size of a darknet conv: padding (ks // 2) * dilation."""
    pad = (ks // 2) * dilation
    span = dilation * (ks - 1) + 1
    return ((h + 2 * pad - span) // stride + 1,
            (w + 2 * pad - span) // stride + 1)


def quantize_input(x: torch.Tensor, x_inv: float) -> torch.Tensor:
    """A float activation -> int8 codes: round(x.f32 * x_inv) clipped to
    [-127, 127]. x_inv is the fp32 value 1 / x_scale (a Python float
    holding it exactly)."""
    return torch.round(x.float() * x_inv).clamp_(-127, 127).to(torch.int8)


def conv_s8_sums(xq: torch.Tensor, kernel_q: torch.Tensor, *,
                 stride: int = 1, groups: int = 1,
                 dilation: int = 1) -> torch.Tensor:
    """int8 (B, CIN, H, W) x int8 (CO, CIN / groups, ks, ks) -> the exact
    int32 sums (B, CO, H', W'). |sum| <= 127**2 * K stays below 2**31 for
    K < 133,000, every darknet conv."""
    y = F.conv2d(xq.double(), kernel_q.double(), stride=stride,
                 padding=(kernel_q.shape[-1] // 2) * dilation,
                 dilation=dilation, groups=groups)
    return torch.round(y).to(torch.int32)


def epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
             act: str, out_scale: Optional[float],
             out_dtype=torch.float32) -> torch.Tensor:
    """int32 sums (B, CO, H, W) -> dequantized + bias + activation in
    fp32, then requantized to int8 at out_scale, or cast to out_dtype."""
    y = acc.float() * scale[None, :, None, None]
    y = y + bias[None, :, None, None]
    y = conv_ops.activate(y, act)
    if out_scale is not None:
        # a tensor divisor: CUDA divides by a host scalar as a multiply
        # by its reciprocal, which rounds differently
        divisor = torch.tensor(out_scale, dtype=torch.float32,
                               device=y.device)
        return torch.round(y / divisor).clamp_(-127, 127).to(torch.int8)
    return y.to(out_dtype)


def conv_s8_bias_act(x: torch.Tensor, kernel_q: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor, *,
                     x_inv: float, out_scale: Optional[float] = None,
                     act: str = "leaky", stride: int = 1, groups: int = 1,
                     dilation: int = 1,
                     out_dtype=torch.float32) -> torch.Tensor:
    """x (B, CIN, H, W) int8 codes or float; kernel_q (CO, CIN / groups,
    ks, ks) int8; scale, bias (CO,) fp32 -> (B, CO, H', W') channels_last:
    int8 at out_scale when it is given, else out_dtype."""
    global cuda_calls
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cuda":
        cuda_calls += 1
    xq = x if x.dtype == torch.int8 else quantize_input(x, x_inv)
    acc = conv_s8_sums(xq, kernel_q, stride=stride, groups=groups,
                       dilation=dilation)
    return epilogue(acc, scale, bias, act=act, out_scale=out_scale,
                    out_dtype=out_dtype).contiguous(
                        memory_format=torch.channels_last)
