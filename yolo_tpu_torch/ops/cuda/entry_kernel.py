"""Fused entry layer (conv1 3x3 + bias + leaky + maxpool 2x2/2): wrapper
of ``csrc/entry_conv_pool.cu``.

The CUDA kernel replaces the Pallas TPU kernel
``yolo_tpu/ops/pallas/entry_kernel.py::fused_entry_from_planes``. Its
plain PyTorch version is ``yolo_tpu_torch.ops.entry.fused_entry``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, which is what the CPU tests run.
"""

from __future__ import annotations

import torch

from yolo_tpu_torch.ops import entry
from yolo_tpu_torch.ops.cuda import build

GROUP = 16  # output channels per thread (entry_conv_pool.cu kGroup)

# kernel launches since the last reset (chip_smoke.py reads it to show
# that the fused entry route ran the kernel)
launches = 0


def fused_entry(xpad: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor, *, out_dtype=torch.bfloat16
                ) -> torch.Tensor:
    """xpad (B, H + 2, W + 2, 3) fp32 contiguous, H and W even; kernel
    (cout, 3, 3, 3) fp32 OIHW contiguous, cout a multiple of 16; bias
    (cout,) fp32 -> (B, cout, H/2, W/2) in out_dtype (bf16 or fp32),
    channels_last."""
    global launches
    if xpad.device.type == "cpu":
        return entry.fused_entry(xpad, kernel, bias, out_dtype=out_dtype)
    if xpad.device.type != "cuda":
        raise ValueError(f"xpad must be a CUDA or CPU tensor, got "
                         f"{xpad.device}")
    if xpad.dim() != 4 or xpad.shape[3] != 3:
        raise ValueError(f"xpad must be (B, H + 2, W + 2, 3), got "
                         f"{tuple(xpad.shape)}")
    b, hp, wp, _ = xpad.shape
    h, w = hp - 2, wp - 2
    if h < 2 or w < 2 or h % 2 or w % 2:
        raise ValueError(f"the entry kernel pools 2x2/2: H and W must be "
                         f"even and >= 2, got {h}x{w}")
    cout = kernel.shape[0]
    if tuple(kernel.shape) != (cout, 3, 3, 3) or cout % GROUP \
            or tuple(bias.shape) != (cout,):
        raise ValueError(f"kernel must be (cout, 3, 3, 3) with cout a "
                         f"multiple of {GROUP} and bias (cout,), got "
                         f"{tuple(kernel.shape)} and {tuple(bias.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got "
                         f"{out_dtype}")
    for name, t in (("xpad", xpad), ("kernel", kernel), ("bias", bias)):
        build.check_tensor(name, t, xpad.device, torch.float32, False)
    out = torch.empty((b, cout, h // 2, w // 2), dtype=out_dtype,
                      device=xpad.device, memory_format=torch.channels_last)
    if b == 0:
        return out
    lib = build.library()
    with torch.cuda.device(xpad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.yolo_entry_conv_pool(
            xpad.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, w, cout, int(out_dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"entry_conv_pool launch failed: CUDA error {err}")
    launches += 1
    return out
