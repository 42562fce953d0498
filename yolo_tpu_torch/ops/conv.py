"""Conv + folded-BN bias + activation block, plain PyTorch (port of the
math of yolo_tpu/ops/pallas/conv_kernel.py::fused_conv_bias_act, and of
the XLA conv block yolo_tpu/models/graph.py::conv_block runs for the
other activations and for grouped and dilated convs).

Layouts are the Darknet executor's: activations (B, C, H, W) in
``torch.channels_last`` memory (NHWC bytes), kernels OIHW in
channels_last memory (bytes ordered O, ky, kx, I), biases (CO,) fp32.

Numerics, as in the JAX package: the conv sums the operands' values in
fp32 (a bf16 input is upcast, and products of bf16 values are exact in
fp32 and in TF32; an fp32 input runs with TF32 off), the fp32 bias and
the activation (leaky 0.1, linear, mish, logistic, swish, relu or
ramp) apply to the unrounded sum, and only then is the result cast to
the input's dtype. The CUDA kernel (``ops/cuda/conv_kernel.py``,
``csrc/conv_bias_act.cu``) is held against this function; it takes
leaky and linear only, as the JAX package's kernel route does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_tpu_torch.configs.specs import ACTIVATIONS
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
    """The darknet activations of graph.py::_activate: leaky (0.1),
    linear, mish, logistic, swish (x * sigmoid(x)), relu and ramp
    (max(x, 0) + 0.1 * x). Below fp32 (a bf16 sam, scale_channels or
    shortcut output) each operation rounds to x's dtype in the JAX
    package's order: 0.1 a bf16 constant, sigmoid as 1 / (1 + exp(-x))."""
    if x.element_size() < 4 and act in ("leaky", "logistic", "swish",
                                        "ramp"):
        return _activate_rounded(x, act)
    if act == "leaky":
        return F.leaky_relu(x, 0.1)
    if act == "linear":
        return x
    if act == "mish":
        return mish(x)
    if act == "logistic":
        return torch.sigmoid(x)
    if act == "swish":
        return x * torch.sigmoid(x)
    if act == "relu":
        return torch.clamp_min(x, 0.0)
    if act == "ramp":
        return torch.clamp_min(x, 0.0) + 0.1 * x
    raise ValueError(f"unknown activation {act!r}")


def _activate_rounded(x: torch.Tensor, act: str) -> torch.Tensor:
    tenth = torch.tensor(0.1, dtype=x.dtype, device=x.device)
    if act == "leaky":
        return torch.where(x > 0, x, x * tenth)
    if act == "ramp":
        return torch.clamp_min(x, 0.0) + x * tenth
    sig = 1 / (1 + torch.exp(-x))
    return sig if act == "logistic" else x * sig


def fused_conv_bias_act(x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor, *, act: str = "leaky",
                        stride: int = 1, groups: int = 1,
                        dilation: int = 1) -> torch.Tensor:
    """x (B, CIN, H, W), kernel (CO, CIN / groups, ks, ks), bias (CO,)
    fp32 -> (B, CO, H', W') in x.dtype. Darknet padding (ks // 2) *
    dilation (SAME at stride 1, dilated or not)."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    with exact_for(x.dtype):
        y = F.conv2d(x.float(), kernel.float(), stride=stride,
                     padding=(kernel.shape[-1] // 2) * dilation,
                     dilation=dilation, groups=groups)
    # fp32 epilogue, in place on the conv's fresh output
    y.add_(bias[None, :, None, None])
    if act == "leaky":
        F.leaky_relu(y, 0.1, inplace=True)
    else:
        y = activate(y, act)
    return y.to(x.dtype)
