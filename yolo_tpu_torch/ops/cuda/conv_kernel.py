"""Fused conv + bias + leaky/linear block: wrapper of
``csrc/conv_bias_act.cu``, and the launch plan of its bf16 kernel.

The CUDA kernel replaces the Pallas TPU kernel
``yolo_tpu/ops/pallas/conv_kernel.py::fused_conv_bias_act``. Its plain
PyTorch version is ``yolo_tpu_torch.ops.conv.fused_conv_bias_act``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, which is what the CPU tests run.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from yolo_tpu_torch.ops import conv
from yolo_tpu_torch.ops.cuda import build

# kernel launches since the last reset (chip_smoke.py reads it to show
# that a route ran the kernel); one per call, whatever the split
launches = 0

SMS = 132          # streaming multiprocessors of an H100 SXM
BK = 64            # K chunk of the bf16 kernel: one 128-byte swizzle row
# (BM, BN) tiles the bf16 kernel is built for, and how many of its blocks
# fit on one SM (the rings' shared memory: 225, 193, 193 and 97 KB)
TILES = {(192, 256): 1, (128, 256): 1, (128, 128): 1, (64, 128): 2}
F32_TILE = (64, 64)

# A cost model in microseconds that only ranks the candidate plans, fitted
# to the kernel's times at YOLOv2-COCO's shapes on an H100 80GB HBM3
# (700 W; tools/port_perf.py tiles times every tile there): the SM time
# of one K chunk of a block with the SM full (13x13 1280 -> 1024 at batch
# 32), a block's fixed cost (the ring's fill and the epilogue: ~2 us +
# 0.06 us per KB of bf16 output tile), and a split's reduction (a launch
# and its fp32 traffic at 3.35 TB/s).
_CHUNK_US = {(192, 256): 0.95, (128, 256): 0.65, (128, 128): 0.51,
             (64, 128): 0.284}
_REDUCE_LAUNCH_US = 3.0


def _block_us(bm: int, bn: int) -> float:
    return 2.0 + 0.06 * bm * bn * 2 / 1024


class Plan(NamedTuple):
    """How the conv kernel covers one call: BM x BN output tiles, K cut
    into ``splits`` runs of whole BK chunks, and the fp32 workspace the
    partial sums need (0 without a split)."""
    bm: int
    bn: int
    splits: int
    workspace_bytes: int


def split_steps(steps: int, splits: int) -> list:
    """The K chunks [begin, end) of each split, as the kernel cuts them:
    split s takes [s * steps // splits, (s + 1) * steps // splits)."""
    return [(s * steps // splits, (s + 1) * steps // splits)
            for s in range(splits)]


def _tiles(m: int, co: int, bm: int, bn: int) -> int:
    return math.ceil(m / bm) * (co // bn)


def _cost(m: int, co: int, steps: int, bm: int, bn: int, splits: int):
    blocks = _tiles(m, co, bm, bn) * splits
    resident = TILES[(bm, bn)]
    waves = math.ceil(blocks / (SMS * resident))
    cost = waves * resident * (math.ceil(steps / splits)
                               * _CHUNK_US[(bm, bn)] + _block_us(bm, bn))
    if splits > 1:
        cost += _REDUCE_LAUNCH_US + (2 * splits + 1) * m * co * 4 / 3.35e6
    return cost


@functools.lru_cache(maxsize=1024)
def plan(batch: int, h: int, w: int, cin: int, co: int, ks: int,
         bf16: bool = True) -> Plan:
    """The launch plan of one conv (shapes as ``ops.conv.eligible`` takes
    them). fp32 runs its one 64x64 tile shape, unsplit. bf16: where some
    tile shape fills the card (>= SMS tiles) there is no split; else each
    tile shape splits K until tiles x splits fill it. The cost model
    picks among the tile shapes, and among the splits that fill the card
    where there are some. Cached: a forward asks for the same few shapes
    on every call."""
    m = batch * h * w
    steps = ks * ks * cin // BK
    if not bf16:
        return Plan(*F32_TILE, 1, 0)
    shapes = [t for t in TILES if co % t[1] == 0]
    if any(_tiles(m, co, bm, bn) >= SMS for bm, bn in shapes):
        cands = [(bm, bn, 1) for bm, bn in shapes]
    else:
        cands = [(bm, bn, min(steps, math.ceil(SMS / _tiles(m, co, bm, bn))))
                 for bm, bn in shapes]
        filling = [c for c in cands if _tiles(m, co, *c[:2]) * c[2] >= SMS]
        cands = filling or cands
    bm, bn, splits = min(cands, key=lambda c: _cost(m, co, steps, *c))
    return Plan(bm, bn, splits, workspace_bytes(m, co, splits))


def workspace_bytes(m: int, co: int, splits: int) -> int:
    """fp32 partial sums of every split: splits x M x CO, none unsplit."""
    return splits * m * co * 4 if splits > 1 else 0


_ERRORS = {-1: "the kernel was not built for this plan",
           -2: "the driver has no tensor-map encoder",
           -3: "the driver refused a tensor map"}


def fused_conv_bias_act(x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor, *,
                        act: str = "leaky") -> torch.Tensor:
    """x (B, CIN, H, W) bf16 or fp32 in channels_last memory, kernel
    (CO, CIN, ks, ks) in x's dtype and channels_last memory, bias (CO,)
    fp32 -> (B, CO, H, W) in x.dtype, channels_last. Stride 1, SAME
    padding; only shapes that ``ops.conv.eligible`` takes. The launch
    follows ``plan(...)``."""
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
    bf16 = x.dtype == torch.bfloat16
    p = plan(b, h, w, cin, co, ks, bf16=bf16)
    # the workspace is allocated from this size: it must hold every split
    if p.workspace_bytes != workspace_bytes(b * h * w, co, p.splits):
        raise ValueError(f"{p} does not hold the workspace of its splits")
    ws = (torch.empty(p.workspace_bytes // 4, dtype=torch.float32,
                      device=x.device) if p.workspace_bytes else None)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.yolo_conv_bias_act(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), b, h, w, cin, co, ks,
            int(act == "leaky"), int(bf16), p.bm, p.bn, p.splits, stream)
    if err != 0:
        raise RuntimeError(f"conv_bias_act launch failed ({p}): "
                           f"{_ERRORS.get(err, f'CUDA error {err}')}")
    launches += 1
    return out
