"""Post-training int8 quantization for the inference path (port of
yolo_tpu/models/quantize.py).

  * weights: symmetric per-output-channel int8
    (w_scale[oc] = max|w[..., oc]| / 127)
  * activations: symmetric per-tensor int8, scales calibrated on a
    representative batch (each conv input's abs-max, or a percentile of
    |x|, in the fp32 forward)
  * each conv block: quantize the input -> int8 conv (int32 sums) ->
    dequantize * (x_scale * w_scale) + bias -> activation, then either
    requantize at the consumer's scale (chained) or cast to the compute
    dtype. Non-conv layers run in the compute dtype, or on int8 codes
    where a maxpool sits inside a chain.

The int8 params keep the folded params' list shape, each conv block
becoming {"kernel_q", "w_scale", "x_scale", "bias"} (+ "out_scale"),
numpy in the JAX package's layout (HWIO kernels); ``Darknet`` takes them
as it takes folded params and runs each int8 block through the s8 kernel
(ops/cuda/conv_s8_kernel.py) on the card, or its plain version on the
CPU. Serving computes in bf16 around the int8 convs (the CLI's
--precision int8).

This mode trades exactness for speed: it does not satisfy the fp32
box/score parity of fp32 and bf16; its accuracy is bounded by the score
deviation and top-50 overlap gates of tests/test_torch_quantize.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from yolo_tpu_torch.configs.specs import (Connected, Conv, Crop,
                                          DetectionHead, LayerSpec, Local,
                                          MaxPool, Route, Sam, ScaleChannels,
                                          Shortcut, layer_strides,
                                          resolve_route, weighted_specs)
from yolo_tpu_torch.device import resolve as resolve_device
from yolo_tpu_torch.models.graph import Darknet, fold_params
from yolo_tpu_torch.ops import conv_s8


def _percentile(ax: torch.Tensor, percentile: float) -> float:
    """jnp.percentile(ax, percentile) (linear interpolation) on a flat
    tensor, in its fp32 arithmetic: q = percentile / 100, position q * (n
    - 1) with n in fp32, the two neighbours of the sorted order weighted
    by the position's fraction. The neighbours come from a top-k of the
    nearer tail: torch.quantile refuses inputs above 2**24 elements."""
    n = ax.numel()
    q = np.float32(percentile) / np.float32(100.0)
    pos = q * (np.float32(n) - np.float32(1.0))
    low, high = np.floor(pos), np.ceil(pos)
    w_high = pos - low
    w_low = np.float32(1.0) - w_high
    lo = int(min(max(low, 0), n - 1))
    hi = int(min(max(high, 0), n - 1))
    if n - lo <= hi + 1:
        top = torch.topk(ax, n - lo, largest=True, sorted=True).values
        v_lo, v_hi = top[n - lo - 1], top[n - hi - 1]
    else:
        bottom = torch.topk(ax, hi + 1, largest=False, sorted=True).values
        v_lo, v_hi = bottom[lo], bottom[hi]
    return float(np.float32(v_lo.item()) * w_low
                 + np.float32(v_hi.item()) * w_high)


def calibrate(layers: Sequence[LayerSpec], folded_params, x,
              eps: float = 1e-5, method: str = "absmax",
              percentile: float = 99.9, return_out_maxes: bool = False,
              device="cuda"):
    """Run a representative batch through the fp32 forward (TF32 off) on
    ``device`` and record each conv's input range statistic. x: (B, H,
    W, C) in [0, 1]. Returns one scale per conv (and, with
    return_out_maxes, each conv output's abs-max).

    method="absmax" (the default) maps the observed abs-max to 127;
    method="percentile" clips to the given percentile of |x|. The
    forward walk is Darknet.run(return_all=True), every layer's output,
    with conv i's input read as outputs[i - 1]. eps is the folded
    params' BN epsilon, already applied (kept for the JAX signature)."""
    if method not in ("absmax", "percentile"):
        raise ValueError(f"unknown calibration method '{method}' "
                         "(absmax | percentile)")
    net = Darknet(layers, folded_params, device=resolve_device(device),
                  dtype=torch.float32)
    x = torch.as_tensor(np.asarray(x, np.float32), device=net.device)
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    outs = net.run(x, return_all=True)
    maxes, out_maxes = [], []
    for i, layer in enumerate(layers):
        if not isinstance(layer, Conv):
            continue
        ax = (x if i == 0 else outs[i - 1]).abs()
        maxes.append(float(ax.max()) if method == "absmax"
                     else _percentile(ax.reshape(-1), percentile))
        out_maxes.append(float(outs[i].abs().max()))
    scales = [v / 127.0 for v in maxes]
    if return_out_maxes:
        return scales, out_maxes
    return scales


def _chain_out_scales(layers: Sequence[LayerSpec],
                      act_scales: List[float],
                      out_maxes: Optional[List[float]] = None):
    """Returns (out_scales, x_scales): per conv, the int8 scale its
    output is emitted at (None = fp output), and each conv's possibly
    WIDENED input scale.

    Chained-int8 serving: when a conv's output feeds EXACTLY ONE conv
    (directly or through maxpools: max commutes with the monotone
    quantization, so pooling int8 is exact), the block emits int8
    already quantized at the consumer's scale, one byte an element
    between the blocks. Convs consumed by route/reorg/shortcut/upsample
    or by several layers (yolov2's passthrough source) emit the compute
    dtype: the rule is consumer-derived, not 'the next conv in order'.

    A pool-mediated chain's consumer was calibrated on the POOLED
    tensor, whose abs-max can be smaller than the pre-pool tensor's
    (pooling drops deep leaky negatives); the shared scale is widened to
    max(consumer_scale, producer_out_absmax / 127), for the producer's
    out_scale and the consumer's x_scale alike. Without out_maxes such
    chains stay fp boundaries."""
    n = len(layers)
    consumers: Dict[int, List[int]] = {i: [] for i in range(-1, n)}
    for idx, l in enumerate(layers):
        if isinstance(l, Route):
            for r in l.layers:
                consumers[resolve_route(idx, r)].append(idx)
        elif isinstance(l, (Shortcut, Sam, ScaleChannels)):
            consumers[resolve_route(idx, l.frm)].append(idx)
            consumers[idx - 1].append(idx)
        elif idx > 0:
            consumers[idx - 1].append(idx)
    conv_ordinal = {}
    ci = 0
    for idx, l in enumerate(layers):
        if isinstance(l, Conv):
            conv_ordinal[idx] = ci
            ci += 1
    x_scales = list(act_scales)
    chains = []  # (producer_conv_ordinal, consumer_conv_ordinal, pooled?)
    for idx, l in enumerate(layers):
        if not isinstance(l, Conv):
            continue
        cur, pooled = idx, False
        while True:
            cons = consumers[cur]
            if len(cons) != 1:
                break
            nxt = cons[0]
            if isinstance(layers[nxt], Conv):
                chains.append((conv_ordinal[idx], conv_ordinal[nxt],
                               pooled))
                break
            if isinstance(layers[nxt], MaxPool):
                cur, pooled = nxt, True
                continue
            break  # reorg/route/shortcut/upsample/head need fp input
    if out_maxes is None:
        chains = [c for c in chains if not c[2]]
    # widen pool-mediated consumers first, so that every reader of
    # x_scales below (direct producers of a widened conv too) agrees
    for prod, cons, pooled in chains:
        if pooled:
            x_scales[cons] = max(x_scales[cons], out_maxes[prod] / 127.0)
    out_scales: List[Optional[float]] = [None] * len(conv_ordinal)
    for prod, cons, _pooled in chains:
        out_scales[prod] = x_scales[cons]
    return out_scales, x_scales


def quantize(layers: Sequence[LayerSpec], folded_params,
             act_scales: List[float], chain: bool = True,
             out_maxes: Optional[List[float]] = None):
    """Folded (kernel + bias) numpy params + calibrated activation scales
    -> the int8 params (numpy). chain=True emits int8 activations
    between sole-consumer conv pairs (_chain_out_scales; pool-mediated
    chains need out_maxes from calibrate(..., return_out_maxes=True));
    chain=False keeps every block's output in the compute dtype."""
    n_convs = sum(1 for l in layers if isinstance(l, Conv))
    if chain:
        out_scales, act_scales = _chain_out_scales(layers, act_scales,
                                                   out_maxes)
    else:
        out_scales = [None] * n_convs
    out = []
    ci = 0
    for spec, p in zip(weighted_specs(tuple(layers)), folded_params):
        if not isinstance(spec, Conv):
            # a classifier's [connected] tail and blend weights stay fp
            out.append({k: np.asarray(v) for k, v in p.items()})
            continue
        x_scale, o_scale = act_scales[ci], out_scales[ci]
        ci += 1
        kernel = np.asarray(p["kernel"], np.float32)
        w_scale = np.maximum(np.abs(kernel).max(axis=(0, 1, 2)), 1e-8) / 127.0
        kq = np.clip(np.round(kernel / w_scale), -127, 127).astype(np.int8)
        q = {
            "kernel_q": kq,
            "w_scale": w_scale.astype(np.float32),
            "x_scale": np.float32(max(x_scale, 1e-8)),
            "bias": np.asarray(p["bias"], np.float32),
        }
        if o_scale is not None:
            q["out_scale"] = np.float32(max(o_scale, 1e-8))
        out.append(q)
    return out


def conv_block_int8(x: torch.Tensor, p: Dict[str, torch.Tensor],
                    spec: Conv, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Quantize -> int8 conv -> dequantize + bias -> activation, in plain
    PyTorch (ops/conv_s8.py): the plain version of the s8 kernel. x (B,
    C, H, W) channels_last, float or int8 (chained: taken as quantized at
    this block's x_scale); p: one block of graph.params_from_numpy
    (kernel_q OIHW int8, w_scale, x_scale, bias, optional out_scale). A
    block with out_scale emits int8 codes at it, else compute_dtype."""
    x_scale = p["x_scale"].float()
    scale = x_scale * p["w_scale"].float()
    x_inv = float(torch.tensor(1.0, dtype=torch.float32) / x_scale.cpu())
    out_scale = float(p["out_scale"]) if "out_scale" in p else None
    return conv_s8.conv_s8_bias_act(
        x, p["kernel_q"], scale, p["bias"], x_inv=x_inv,
        out_scale=out_scale, act=spec.act, stride=spec.stride,
        groups=spec.groups, dilation=spec.dilation, out_dtype=compute_dtype)


def conv_shapes(cfg) -> Dict[tuple, int]:
    """{(h, w, cin, co, ks, stride, groups, dilation, act): count} of
    every conv of a config at its (net_h, net_w): what the s8 kernel
    takes at batch 1 once the config is quantized."""
    from yolo_tpu_torch.io.darknet_weights import _conv_in_channels

    strides = layer_strides(cfg.layers)
    cins = iter(_conv_in_channels(cfg.layers, cfg.in_channels))
    shapes: Dict[tuple, int] = {}
    for idx, layer in enumerate(cfg.layers):
        if isinstance(layer, (Connected, Local)) or (
                isinstance(layer, Shortcut) and layer.weights_type != "none"):
            next(cins)
        if not isinstance(layer, Conv):
            continue
        s = strides[idx - 1] if idx else 1
        key = (cfg.input_h // s, cfg.input_w // s, next(cins),
               layer.filters, layer.size, layer.stride, layer.groups,
               layer.dilation, layer.act)
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def prepare_int8(cfg, params, calibration_images, method: str = "absmax",
                 chain: bool = True, device="cuda") -> list:
    """darknet/raw (or folded) numpy params -> calibrated int8 params
    (numpy, what Darknet takes). calibration_images: (B, H, W, C)
    preprocessed [0, 1] fp32 batch; method: see calibrate; chain: int8
    activations between sole-consumer conv pairs (see quantize); device:
    where the calibration forward runs ("cuda" by default, which raises
    without a card)."""
    if any(isinstance(l, (Crop, Local, DetectionHead)) for l in cfg.layers):
        raise NotImplementedError(
            "int8 PTQ does not support the yolov1 family "
            "([crop]/[local]/[detection] layers) — use fp32/bf16")
    folded = fold_params(cfg.layers, params, cfg.bn_eps)
    scales, out_maxes = calibrate(cfg.layers, folded, calibration_images,
                                  cfg.bn_eps, method=method,
                                  return_out_maxes=True, device=device)
    return quantize(cfg.layers, folded, scales, chain=chain,
                    out_maxes=out_maxes)
