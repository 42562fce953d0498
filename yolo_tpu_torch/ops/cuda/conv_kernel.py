"""Fused conv + bias + leaky/linear block: wrapper of
``csrc/conv_bias_act.cu``.

The CUDA kernel replaces the Pallas TPU kernel
``yolo_tpu/ops/pallas/conv_kernel.py::fused_conv_bias_act``. Its plain
PyTorch version is ``yolo_tpu_torch.ops.conv.fused_conv_bias_act``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, which is what the CPU tests run.
"""

from __future__ import annotations

import torch

from yolo_tpu_torch.ops import conv
from yolo_tpu_torch.ops.cuda import build

# kernel launches since the last reset (chip_smoke.py reads it to show
# that a route ran the kernel)
launches = 0


def fused_conv_bias_act(x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor, *,
                        act: str = "leaky") -> torch.Tensor:
    """x (B, CIN, H, W) bf16 or fp32 in channels_last memory, kernel
    (CO, CIN, ks, ks) in x's dtype and channels_last memory, bias (CO,)
    fp32 -> (B, CO, H, W) in x.dtype, channels_last. Stride 1, SAME
    padding; only shapes that ``ops.conv.eligible`` takes."""
    global launches
    if x.device.type == "cpu":
        return conv.fused_conv_bias_act(x, kernel, bias, act=act)
    if act not in ("leaky", "linear"):
        raise ValueError(f"act must be 'leaky' or 'linear', got {act!r}")
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA or CPU tensor, got {x.device}")
    if x.dim() != 4 or kernel.dim() != 4:
        raise ValueError(f"x and kernel must be 4-D, got {tuple(x.shape)} "
                         f"and {tuple(kernel.shape)}")
    b, cin, h, w = x.shape
    co, kcin, ks, ks2 = kernel.shape
    if kcin != cin or ks != ks2 or tuple(bias.shape) != (co,):
        raise ValueError(f"kernel {tuple(kernel.shape)} and bias "
                         f"{tuple(bias.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if not conv.eligible(kernel.permute(2, 3, 1, 0), 1):
        raise ValueError(f"the conv kernel takes 1x1 or 3x3 kernels with "
                         f"CIN and CO multiples of 128, got "
                         f"{tuple(kernel.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    build.check_tensor("x", x, x.device, x.dtype, True)
    build.check_tensor("kernel", kernel, x.device, x.dtype, True)
    build.check_tensor("bias", bias, x.device, torch.float32, False)
    out = torch.empty((b, co, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.yolo_conv_bias_act(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, w, cin, co, ks, int(act == "leaky"),
            int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"conv_bias_act launch failed: CUDA error {err}")
    launches += 1
    return out
