"""Darknet maxpool of int8 codes: wrapper of ``csrc/maxpool_s8.cu``.

No Pallas original: the JAX package pools in XLA (yolo_tpu/ops/pool.py,
lax.reduce_window), int8 codes included. The plain version is
``yolo_tpu_torch.ops.pool.maxpool_s8_plain`` (a running torch.maximum
of strided views). ``ops/pool.py::maxpool_nchw`` sends every int8 pool
on a CUDA tensor here. A CUDA tensor launches the kernel or raises; a
CPU tensor takes the plain version, which is what the CPU tests run.
"""

from __future__ import annotations

import torch

from yolo_tpu_torch.ops import pool
from yolo_tpu_torch.ops.cuda import build

# kernel launches since the last reset (chip_smoke.py reads it to show
# that the int8 path ran the kernel); one per call
launches = 0


def check_pool(size, stride) -> tuple:
    """(size, stride) as positive ints, or ValueError."""
    if (isinstance(size, bool) or isinstance(stride, bool)
            or not isinstance(size, int) or not isinstance(stride, int)
            or size < 1 or stride < 1):
        raise ValueError(f"pool size and stride must be positive ints, "
                         f"got {size!r} and {stride!r}")
    return size, stride


def maxpool_s8(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """int8 codes (B, C, H, W), channels_last -> their darknet maxpool
    (B, C, H', W'), channels_last, H' = (H - 1) // stride + 1: any size,
    stride and channel count."""
    global launches
    check_pool(size, stride)
    if x.dim() != 4:
        raise ValueError(f"x must be 4-D (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype != torch.int8:
        raise ValueError(f"the int8 maxpool takes int8 codes, got {x.dtype}")
    if x.device.type == "cpu":
        return pool.maxpool_s8_plain(x, size, stride)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA or CPU tensor, got {x.device}")
    build.check_tensor("x", x, x.device, torch.int8, True)
    b, c, h, w = x.shape
    ho, wo = pool.out_hw(h, w, size, stride)
    out = torch.empty((b, c, ho, wo), dtype=torch.int8, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    vec = 16 if c % 16 == 0 else 4 if c % 4 == 0 else 1
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.yolo_maxpool_s8(
            x.data_ptr(), out.data_ptr(), b, h, w, c, size, stride, ho, wo,
            vec, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"maxpool_s8 launch failed: "
                           f"{'bad arguments' if err < 0 else f'CUDA error {err}'}")
    launches += 1
    return out
