"""int8 conv + dequantize + bias + activation, then requantize or cast:
wrapper of ``csrc/conv_s8_bias_act.cu``, and the plan of its four
bodies.

The CUDA kernel replaces the int8 conv of the JAX package's int8
post-training quantization (yolo_tpu/models/quantize.py:234, an XLA conv
with int32 accumulation; it has no Pallas kernel). Its plain PyTorch
version is ``yolo_tpu_torch.ops.conv_s8.conv_s8_bias_act``.

A float input is quantized as round(x.f32 * x_inv) (the arithmetic of
ops/conv_s8.py::quantize_input): by the stem body while it loads its
input tile, for the other bodies by one pass of the library's
quantization kernel first; an int8 input is read as it is. ``pool=(size, stride)`` fuses the darknet maxpool that follows
the conv into the stem body (fuses_pool says where); the plain version
is the conv followed by ops/pool.py::maxpool_nchw. A CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain version,
which is what the CPU tests run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from yolo_tpu_torch.configs.specs import ACTIVATIONS
from yolo_tpu_torch.ops import conv_s8
from yolo_tpu_torch.ops import pool as pool_ops
from yolo_tpu_torch.ops.cuda import build
from yolo_tpu_torch.ops.cuda.pool_kernel import check_pool

# kernel launches since the last reset (chip_smoke.py reads it to show
# that the int8 path ran the kernel); one per call
launches = 0

SMS = 132          # streaming multiprocessors of an H100 SXM
CHUNK = 32         # the mma body's K chunk: one tap's 32 input channels
STEM_K = 32        # the stem body's K row: one mma.sync m16n8k32 step
STEM_ROWS = 16     # the stem body's patch rows: the largest pool it fuses
STAGE_K = 128      # the wgmma body's K bytes a ring stage
ACT_CODES = {"linear": 0, "leaky": 1, "mish": 2, "logistic": 3, "swish": 4,
             "relu": 5, "ramp": 6}
OUT_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
IN_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
# activations the unrolled tensor-core epilogues take in registers; the
# others (mish, logistic, swish) run in the reduction's epilogue
SIMPLE_ACTS = ("linear", "leaky", "relu", "ramp")


# K from which the wgmma body's 128-wide tiles lead the 64-wide ones (a
# short K loop leaves the block's fill and epilogue exposed)
WGMMA_WIDE_K = 4096
BODIES = {"mma": 0, "dp4a": 1, "wgmma": 2, "stem": 3}


class Plan(NamedTuple):
    """Which body covers a conv: "stem" (ks*ks*CIN <= 32, mma.sync on a
    shared input tile), "wgmma" on 128 x BN tiles with activation boxes
    of ``chunk`` bytes, in ``splits`` K splits (the TMA ring and wgmma
    tensor cores), "mma" on BM x BN tiles (mma.sync tensor cores,
    per-group CIN a multiple of CHUNK) or "dp4a" with ``npt`` output
    channels a thread (any shape)."""
    body: str
    bm: int = 0
    bn: int = 0
    npt: int = 0
    chunk: int = 0
    splits: int = 1


def stem_takes(cin_g: int, co_g: int, groups: int, *, stride: int = 1,
               dilation: int = 1, ks: int = 3) -> bool:
    """Whether the stem body takes the conv: groups 1, dilation 1,
    stride 1 or 2, a window of at most STEM_K bytes and CO % 8 == 0."""
    return (groups == 1 and dilation == 1 and stride in (1, 2)
            and ks * ks * cin_g <= STEM_K and co_g % 8 == 0)


def fuses_pool(kernel_shape, groups: int, stride: int, dilation: int,
               pool) -> bool:
    """Whether a conv of OIHW ``kernel_shape`` takes the maxpool ``pool``
    = (size, stride) that follows it into its launch: on the stem body,
    pools up to STEM_ROWS wide."""
    co, cin_g, ks, _ = kernel_shape
    return (stem_takes(cin_g, co // groups, groups, stride=stride,
                       dilation=dilation, ks=ks)
            and 1 <= pool[0] <= STEM_ROWS and pool[1] >= 1)


def wgmma_splits(m: int, k: int, tiles: int) -> int:
    """K splits of a wgmma plan: where its tiles do not fill the card,
    as many as fill it, each split two ring stages at least."""
    if tiles >= SMS:
        return 1
    return max(1, min(SMS // tiles, -(-k // STAGE_K) // 2))


def plan(m: int, cin_g: int, co_g: int, groups: int, *, stride: int = 1,
         dilation: int = 1, ks: int = 3) -> Plan:
    """The body and tile of one conv: M output pixels, CIN and CO per
    group. The stem body takes the narrow first convs (stem_takes). The
    wgmma body takes stride-1, undilated, ungrouped convs of odd size
    with CIN a multiple of 32 and CO of 64, in activation boxes of 128,
    64 or 32 bytes (the widest that divides CIN; four taps of CIN 32 or
    two of CIN 64 a 128-byte stage): 128 x 128 tiles where the chunk is
    128 and K spans WGMMA_WIDE_K or more, else 128 x 64, as
    tools/port_perf.py tiles_s8 ranks them at YOLOv2-COCO's shapes;
    split K where the tiles do not fill the card (wgmma_splits). The mma body takes every other per-group CIN that is
    a multiple of 32, with 128 x 64 tiles, or 64 x 64 where those would
    not give each SM two blocks; the rest (narrow groups) run on
    dp4a."""
    if stem_takes(cin_g, co_g, groups, stride=stride, dilation=dilation,
                  ks=ks):
        return Plan("stem")
    if (groups == 1 and stride == 1 and dilation == 1 and ks % 2 == 1
            and cin_g % CHUNK == 0 and co_g % 64 == 0):
        chunk = next(c for c in (128, 64, 32) if cin_g % c == 0)
        k = ks * ks * cin_g
        bn = (128 if chunk == 128 and co_g % 128 == 0
              and k >= WGMMA_WIDE_K else 64)
        return Plan("wgmma", 128, bn, chunk=chunk,
                    splits=wgmma_splits(m, k, -(-m // 128) * (co_g // bn)))
    if cin_g % CHUNK == 0:
        blocks = -(-m // 128) * -(-co_g // 64) * groups
        return Plan("mma", 128 if blocks >= 2 * SMS else 64, 64)
    npt = 32 if co_g >= 32 else 8 if co_g >= 8 else 1
    return Plan("dp4a", npt=npt)


_ERRORS = {-1: "the kernel was not built for this plan",
           -2: "the driver has no tensor-map encoder",
           -3: "the driver refused a tensor map"}


def conv_s8_bias_act(x: torch.Tensor, kernel_q: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor, *,
                     x_inv: float, out_scale: Optional[float] = None,
                     act: str = "leaky", stride: int = 1, groups: int = 1,
                     dilation: int = 1, out_dtype=torch.float32,
                     pool: Optional[tuple] = None) -> torch.Tensor:
    """x (B, CIN, H, W) int8 codes or float, channels_last; kernel_q (CO,
    CIN / groups, ks, ks) int8 channels_last; scale = x_scale * w_scale
    and bias (CO,) fp32 -> (B, CO, H', W') channels_last: int8 codes at
    out_scale when it is given, else out_dtype (bf16 or fp32). Darknet
    padding (ks // 2) * dilation; any stride, dilation and groups. pool
    = (size, stride): the darknet maxpool of that output instead (where
    fuses_pool allows it on a CUDA tensor)."""
    global launches
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if pool is not None:
        pool = check_pool(*pool)
    if x.device.type == "cpu":
        y = conv_s8.conv_s8_bias_act(
            x, kernel_q, scale, bias, x_inv=x_inv, out_scale=out_scale,
            act=act, stride=stride, groups=groups, dilation=dilation,
            out_dtype=out_dtype)
        return y if pool is None else pool_ops.maxpool_nchw(y, *pool)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA or CPU tensor, got {x.device}")
    if x.dim() != 4 or kernel_q.dim() != 4:
        raise ValueError(f"x and kernel_q must be 4-D, got "
                         f"{tuple(x.shape)} and {tuple(kernel_q.shape)}")
    b, cin, h, w = x.shape
    co, cin_g, ks, ks2 = kernel_q.shape
    if (groups < 1 or cin % groups or co % groups or cin_g * groups != cin
            or ks != ks2 or stride < 1 or dilation < 1
            or tuple(scale.shape) != (co,) or tuple(bias.shape) != (co,)):
        raise ValueError(f"kernel {tuple(kernel_q.shape)}, scale "
                         f"{tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} do not match x "
                         f"{tuple(x.shape)} at groups={groups}, "
                         f"stride={stride}, dilation={dilation}")
    if out_scale is None and out_dtype not in (torch.bfloat16,
                                               torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got "
                         f"{out_dtype}")
    if x.dtype not in IN_KINDS:
        raise ValueError(f"x must be int8, bfloat16 or float32, got "
                         f"{x.dtype}")
    if pool is not None and not fuses_pool(kernel_q.shape, groups, stride,
                                           dilation, pool):
        raise ValueError(f"pool {pool} fuses only into the stem body "
                         f"(stem_takes, pools up to {STEM_ROWS}); kernel "
                         f"{tuple(kernel_q.shape)} at stride={stride}, "
                         f"groups={groups}, dilation={dilation} does not "
                         f"take it")
    ho, wo = conv_s8.out_hw(h, w, ks, stride, dilation)
    p = plan(b * ho * wo, cin_g, co // groups, groups, stride=stride,
             dilation=dilation, ks=ks)
    build.check_tensor("x", x, x.device, x.dtype, True)
    lib = build.library()
    if p.body != "stem" and x.dtype != torch.int8:
        # the other bodies read int8 codes: one quantization pass
        # (quantize_input's arithmetic) into a buffer
        xq = torch.empty_like(x, dtype=torch.int8,
                              memory_format=torch.channels_last)
        with torch.cuda.device(x.device):
            err = lib.yolo_quantize_s8(
                x.data_ptr(), IN_KINDS[x.dtype], float(x_inv),
                xq.data_ptr(), x.numel(),
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"quantize_s8 launch failed: "
                               f"{_ERRORS.get(err, f'CUDA error {err}')}")
        x = xq
    build.check_tensor("kernel_q", kernel_q, x.device, torch.int8, True)
    build.check_tensor("scale", scale, x.device, torch.float32, False)
    build.check_tensor("bias", bias, x.device, torch.float32, False)
    psize, pstride = pool or (1, 1)
    ph, pw = pool_ops.out_hw(ho, wo, psize, pstride) if pool else (ho, wo)
    kind = torch.int8 if out_scale is not None else out_dtype
    out = torch.empty((b, co, ph, pw), dtype=kind, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    # the int32 sums go through a workspace (the reduction runs the
    # epilogue) where K is split, where a tensor-core body's activation
    # is transcendental, and for the mma body's int8 codes
    raw = (p.splits > 1
           or (p.body in ("wgmma", "mma") and act not in SIMPLE_ACTS)
           or (p.body == "mma" and kind == torch.int8))
    ws = (torch.empty((p.splits, b * ho * wo, co), dtype=torch.int32,
                      device=x.device) if raw else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.yolo_conv_s8_bias_act(
            x.data_ptr(), IN_KINDS[x.dtype], float(x_inv),
            kernel_q.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(),
            1.0 if out_scale is None else float(out_scale), b, h, w, cin, co,
            ks, stride, dilation, groups, (ks // 2) * dilation, ho, wo,
            ACT_CODES[act], OUT_KINDS[kind], BODIES[p.body], p.bm, p.bn,
            p.npt or p.chunk, p.splits,
            None if ws is None else ws.data_ptr(), psize, pstride, ph, pw,
            stream)
    if err != 0:
        raise RuntimeError(f"conv_s8_bias_act launch failed ({p}): "
                           f"{_ERRORS.get(err, f'CUDA error {err}')}")
    launches += 1
    return out
