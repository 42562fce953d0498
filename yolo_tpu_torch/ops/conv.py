"""Conv + folded-BN bias + activation block, plain PyTorch (port of the
math of yolo_tpu/ops/pallas/conv_kernel.py::fused_conv_bias_act, and of
the XLA conv block yolo_tpu/models/graph.py::conv_block runs for mish).

Layouts are the Darknet executor's: activations (B, C, H, W) in
``torch.channels_last`` memory (NHWC bytes), kernels OIHW in
channels_last memory (bytes ordered O, ky, kx, I), biases (CO,) fp32.

Numerics, as in the JAX package: the conv sums the operands' values in
fp32 (a bf16 input is upcast, and products of bf16 values are exact in
fp32 and in TF32; an fp32 input runs with TF32 off), the fp32 bias and
the activation (leaky 0.1, linear, or mish x * tanh(softplus(x))) apply
to the unrounded sum, and only then is the result cast to the input's
dtype. The CUDA kernel (``ops/cuda/conv_kernel.py``,
``csrc/conv_bias_act.cu``) is held against this function; it takes
leaky and linear only, as the JAX package's kernel route does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_tpu_torch.ops.precision import exact_for


def eligible(kernel_hwio, stride: int) -> bool:
    """The shapes the fused kernel takes (conv_kernel.py::eligible):
    stride 1, 3x3 or 1x1, CIN and CO multiples of 128. ``kernel_hwio``
    is anything with an HWIO ``.shape``."""
    ks, _, cin, co = kernel_hwio.shape
    return (stride == 1 and ks in (1, 3) and cin % 128 == 0
            and co % 128 == 0)


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)), in the JAX package's order of operations
    (graph.py::_activate)."""
    return x * torch.tanh(F.softplus(x))


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    """The port's activations (graph.py::_activate): leaky (0.1),
    linear, mish."""
    if act == "leaky":
        return F.leaky_relu(x, 0.1)
    if act == "mish":
        return mish(x)
    if act == "linear":
        return x
    raise ValueError(f"unknown activation {act!r}")


def fused_conv_bias_act(x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor, *, act: str = "leaky",
                        stride: int = 1) -> torch.Tensor:
    """x (B, CIN, H, W), kernel (CO, CIN, ks, ks), bias (CO,) fp32 ->
    (B, CO, H', W') in x.dtype. Darknet padding ks // 2 (SAME at
    stride 1)."""
    if act not in ("leaky", "linear", "mish"):
        raise ValueError(f"act must be 'leaky', 'linear' or 'mish', got "
                         f"{act!r}")
    with exact_for(x.dtype):
        y = F.conv2d(x.float(), kernel.float(), stride=stride,
                     padding=kernel.shape[-1] // 2)
    # fp32 epilogue, in place on the conv's fresh output
    y.add_(bias[None, :, None, None])
    if act == "leaky":
        F.leaky_relu(y, 0.1, inplace=True)
    elif act == "mish":
        y = mish(y)
    return y.to(x.dtype)
