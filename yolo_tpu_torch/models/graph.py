"""Executor for the port's layer set (port of yolo_tpu/models/graph.py).

``Darknet`` interprets a ``ModelConfig.layers`` tuple of Conv / MaxPool /
Route / Reorg / Shortcut / Sam / ScaleChannels / Upsample / AvgPool /
YoloHead / Connected / Dropout / SoftmaxHead / Crop / Local /
DetectionHead specs with BN folded into
each conv, so every conv block is conv (grouped, dilated or plain) +
bias + activation (leaky, linear, mish, logistic, swish, relu or ramp).
The JAX package's NHWC layout is kept at the boundary: input (B, H, W,
C); the output is the region head's logits (B, H/32, W/32, A*(5+C))
fp32, or, for a net with [yolo] heads, the tuple of the heads' inputs
(B, H/s, W/s, A*(5+C)) fp32 in layer order (A*(9+C) for a Gaussian
head), or, for a classifier, its [softmax] output (B, C) fp32: the
probabilities, with a YOLO9000 tree the per-group conditionals, or with
``softmax_logits`` the logits before the softmax (what training's
classifier_loss takes), or, for yolov1, the [detection] head's input
(B, 1, 1, side²·(classes + num·(1+coords))) fp32. A [connected] layer is
a dense layer over the input flattened in CHW order with an fp32 sum (on
bf16-rounded values in bf16 mode); a [local] layer (_local) is fp32
with true fp32 products in both modes, then cast; [crop] center-crops
outside training and maps x to x*2-1; [dropout] is the identity except
in training. Inside,
activations are NCHW tensors in ``torch.channels_last`` memory and
routes concatenate on
dim 1. A weighted shortcut blends its inputs in fp32 with its blend
weights (graph.py::apply_layers' Shortcut branch) and casts the result
to the compute dtype.

Precision, as in the JAX package:
  * float32: full fp32 convs. cuDNN runs fp32 convs in TF32 by default,
    so the forward turns that off (JAX fp32 is Precision.HIGHEST).
  * bfloat16: activations and kernels are rounded to bf16; each conv
    accumulates in fp32 and hands its fp32 sum to the fp32 bias and
    leaky, and only then is the result cast to bf16 (the JAX conv's
    preferred_element_type=f32). A bf16 F.conv2d would round its output
    to bf16 before the bias, so the conv runs in fp32 on the bf16
    values instead: products of bf16 values are exact in fp32, and in
    TF32 too (10 mantissa bits hold bf16's 7), so TF32 may stay on.

Conv routes (``conv_impl``, the JAX package's "xla" | "pallas"): "torch"
runs every conv as above (ops/conv.py); "cuda" sends the convs that the
fused conv kernel takes (leaky or linear, groups 1, dilation 1, stride
1, 1x1 or 3x3, CIN and CO multiples of 128: graph.py::conv_block's gate)
through it (ops/cuda/conv_kernel.py), which reads bf16 kernels in bf16
mode, and the others (mish, swish, logistic, relu, ramp, grouped and
dilated convs among them) as above.

int8 params (models/quantize.py: a conv block holding ``kernel_q``)
dispatch before conv_impl, as graph.py::conv_block does: on a CUDA
tensor such a block always runs the s8 kernel
(ops/cuda/conv_s8_kernel.py), on a CPU tensor its plain version
(ops/conv_s8.py); it emits int8 codes where it is chained to its
consumer, else the compute dtype, and int8 codes pass through the
maxpools between chained convs.

``DarknetTrain`` is the train-mode executor (apply_layers(train=True)):
unfolded BN with batch statistics, trainable kernels, gamma, beta,
biases and shortcut blend weights, and the new rolling statistics
returned, not written. Its
numerics are the JAX package's training numerics, which differ from
inference in two places:
  * BN normalizes with the Bessel-corrected batch variance var*n/(n-1)
    and puts that value into the rolling variance, with momentum 0.99 on
    the OLD value; it is written by hand (F.batch_norm normalizes with
    the biased variance).
  * in bf16 the conv emits bf16 (the JAX train conv's
    preferred_element_type is the compute dtype), so the training conv
    is a bf16 F.conv2d: fp32 accumulation, one rounding before BN.
Training convs run no kernel of csrc/: in JAX they are XLA convs. The
[dropout] masks and the [crop] jitter are jax.random's draws from the
step's key (utils/prng.py), on the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from yolo_tpu_torch.configs.specs import (AvgPool, Connected, Conv, Crop,
                                          DetectionHead, Dropout, LayerSpec,
                                          Local, MaxPool, Reorg, Route, Sam,
                                          ScaleChannels, Shortcut,
                                          SoftmaxHead, Upsample, YoloHead,
                                          resolve_route, weighted_specs)
from yolo_tpu_torch.device import resolve as resolve_device
from yolo_tpu_torch.ops import conv as conv_ops
from yolo_tpu_torch.ops import entry as entry_ops
from yolo_tpu_torch.ops.cuda import conv_kernel, conv_s8_kernel
from yolo_tpu_torch.ops.pool import maxpool_nchw
from yolo_tpu_torch.ops.precision import exact_for, no_tf32
from yolo_tpu_torch.ops.reorg import reorg_nchw
from yolo_tpu_torch.utils import prng

NumpyParams = List[Dict[str, np.ndarray]]

BN_MOMENTUM = 0.99


_LAYERS = (Conv, MaxPool, Route, Reorg, Shortcut, Sam, ScaleChannels,
           Upsample, AvgPool, YoloHead, Connected, Dropout, SoftmaxHead,
           Crop, Local, DetectionHead)


def _check_layer(idx: int, layer: LayerSpec) -> None:
    """The port's own specs are its layers; any other object (a JAX spec
    among them) is not a spec of this package."""
    if not isinstance(layer, _LAYERS):
        raise TypeError(f"layer {idx}: {layer!r} is not a spec of "
                        f"yolo_tpu_torch.configs.specs")


def _routed_layers(layers: Sequence[LayerSpec]) -> set:
    """Outputs a later Route, Shortcut, Sam or ScaleChannels reads; the
    rest are dropped as the executors go."""
    out = set()
    for idx, l in enumerate(layers):
        if isinstance(l, Route):
            out.update(resolve_route(idx, r) for r in l.layers)
        elif isinstance(l, (Shortcut, Sam, ScaleChannels)):
            out.add(resolve_route(idx, l.frm))
    return out


def _blend_weights(weights: torch.Tensor, norm: str) -> torch.Tensor:
    """A weighted shortcut's (2, 1) or (2, C) fp32 blend weights after
    its normalization along the input axis."""
    if norm == "relu":
        lw = weights.clamp_min(0.001)
        return lw / (1e-4 + lw.sum(dim=0, keepdim=True))
    if norm == "softmax":
        e = torch.exp(weights - weights.amax(dim=0, keepdim=True))
        return e / (1e-4 + e.sum(dim=0, keepdim=True))
    return weights


def _weighted_shortcut(layer: Shortcut, x: torch.Tensor, src: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """graph.py::apply_layers' weighted Shortcut: in fp32, out = x * W0 +
    src * W1 over the min-channel overlap and x * W0 alone on x's other
    channels, then the activation, cast to x's dtype. x, src (B, C, H,
    W); weights (2, 1) per_feature or (2, C) per_channel."""
    wts = _blend_weights(weights.float(), layer.weights_norm)
    m = min(src.shape[1], x.shape[1])
    if layer.weights_type == "per_channel":
        w0 = wts[0][None, :, None, None]
        w1 = wts[1][:m][None, :, None, None]
    else:
        w0, w1 = wts[0, 0], wts[1, 0]
    y = x.float() * w0
    mixed = y[:, :m] + src[:, :m].float() * w1
    y = torch.cat([mixed, y[:, m:]], dim=1) if m < x.shape[1] else mixed
    return conv_ops.activate(y, layer.act).to(x.dtype)


def _weightless_layer(idx: int, layer: LayerSpec, x: torch.Tensor,
                      outputs: Dict[int, torch.Tensor],
                      heads: List[torch.Tensor]) -> torch.Tensor:
    """Every layer but Conv and a weighted Shortcut, alike in both
    executors and both precisions (apply_layers' branches): x (B, C, H,
    W) channels_last in the compute dtype. A [yolo] head appends its
    input to ``heads`` as fp32 NHWC and passes it on."""
    if isinstance(layer, MaxPool):
        return maxpool_nchw(x, layer.size, layer.stride)
    if isinstance(layer, Reorg):
        return reorg_nchw(x, layer.stride).contiguous(
            memory_format=torch.channels_last)
    if isinstance(layer, Route):
        srcs = [outputs[resolve_route(idx, r)] for r in layer.layers]
        if layer.groups > 1:
            # darknet route_layer slices each source before the concat
            srcs = [s[:, layer.group_id * (s.shape[1] // layer.groups):
                      (layer.group_id + 1) * (s.shape[1] // layer.groups)]
                    for s in srcs]
        return srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
    if isinstance(layer, Shortcut):
        src = outputs[resolve_route(idx, layer.frm)]
        if src.shape[1] == x.shape[1]:
            y = x + src
        else:
            # darknet shortcut_cpu: add over min(c1, c2) channels, the
            # rest of the input passes through
            m = min(src.shape[1], x.shape[1])
            y = torch.cat([x[:, :m] + src[:, :m], x[:, m:]], dim=1)
        return conv_ops.activate(y, layer.act)
    if isinstance(layer, Sam):
        # darknet sam_layer: elementwise product (spatial attention)
        return conv_ops.activate(x * outputs[resolve_route(idx, layer.frm)],
                                 layer.act)
    if isinstance(layer, ScaleChannels):
        # the SE multiply: x is (B, C, 1, 1) or (B, 1, H, W), broadcast
        # over the frm layer's output, whose shape the result takes
        return conv_ops.activate(outputs[resolve_route(idx, layer.frm)] * x,
                                 layer.act).contiguous(
                                     memory_format=torch.channels_last)
    if isinstance(layer, AvgPool):
        # darknet avgpool_layer: the global mean in fp32, kept 4-D
        return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype) \
            .contiguous(memory_format=torch.channels_last)
    if isinstance(layer, Upsample):
        y = F.interpolate(x, scale_factor=layer.stride, mode="nearest")
        if layer.scale != 1.0:
            # the scale rounded to the compute dtype first, as jnp does
            y = y * torch.tensor(layer.scale, dtype=y.dtype)
        return y
    if isinstance(layer, YoloHead):
        heads.append(x.permute(0, 2, 3, 1).to(torch.float32))
        return x
    if isinstance(layer, Dropout):
        return x    # darknet's test-mode forward; training: _dropout
    if isinstance(layer, Crop):
        return _crop(idx, layer, x, None)
    if isinstance(layer, DetectionHead):
        return x    # its input is the detection tensor (decode_detection)
    raise TypeError(f"layer {idx}: unknown layer spec {layer!r}")


def _connected(layer: Connected, x: torch.Tensor, kernel: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """graph.py::apply_layers' Connected: x (B, C, H, W) flattened in
    CHW order, times the (in, out) kernel with an fp32 sum (on the
    bf16-rounded values below fp32, which multiply exactly in fp32),
    bias and activation in fp32, cast to x's dtype; (B, out, 1, 1)."""
    xf = x.reshape(x.shape[0], -1)
    if x.dtype != torch.float32:
        xf, kernel = xf.float(), kernel.to(x.dtype).float()
    y = conv_ops.activate(torch.matmul(xf, kernel) + bias, layer.act)
    return y.to(x.dtype)[:, :, None, None].contiguous(
        memory_format=torch.channels_last)


def _local(layer: Local, x: torch.Tensor, kernel: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """graph.py::_local_layer, darknet's local_layer: a conv whose
    filters differ at every output position. x (B, C, H, W); kernel
    (H', W', F, C, k, k) fp32, bias (H', W', F) fp32. The patches are
    unfolded in darknet's (c, ky, kx) order, which the weights file's
    per-position (F, C, k, k) blocks follow; one fp32 product a position
    with true fp32 products (no TF32) in both modes, bias and activation
    in fp32, cast to x's dtype. Returns (B, F, H', W')."""
    hh, ww, f = layer.out_h, layer.out_w, layer.filters
    pad = layer.size // 2 if layer.pad else 0
    cols = F.unfold(x.float(), layer.size, padding=pad,
                    stride=layer.stride)                   # (B, P, H'W')
    with no_tf32():
        y = torch.bmm(cols.permute(2, 0, 1),
                      kernel.reshape(hh * ww, f, -1).transpose(1, 2))
    y = conv_ops.activate(y + bias.reshape(hh * ww, 1, f), layer.act)
    return y.permute(1, 2, 0).reshape(x.shape[0], f, hh, ww).to(
        x.dtype).contiguous(memory_format=torch.channels_last)


def _crop(idx: int, layer: Crop, x: torch.Tensor,
          key: Optional[np.ndarray]) -> torch.Tensor:
    """graph.py::apply_layers' Crop (darknet crop_layer): with a train
    key, one (dy, dx, flip) for the batch from jax.random's draws of
    fold_in(key, idx) split three ways, where the input exceeds the crop
    or flip is on; else the center crop. Then x*2-1 unless noadjust.
    x (B, C, H, W)."""
    _, _, ih, iw = x.shape
    ch, cw = layer.crop_h, layer.crop_w
    if key is not None and (ih > ch or iw > cw or layer.flip):
        kdy, kdx, kf = prng.split(prng.fold_in(key, idx), 3)
        dy = int(prng.randint(kdy, (), 0, ih - ch + 1))
        dx = int(prng.randint(kdx, (), 0, iw - cw + 1))
        x = x[:, :, dy:dy + ch, dx:dx + cw]
        if layer.flip and bool(prng.bernoulli(kf)):
            x = x.flip(3)
    else:
        dy, dx = (ih - ch) // 2, (iw - cw) // 2
        x = x[:, :, dy:dy + ch, dx:dx + cw]
    if not layer.noadjust:
        x = x * 2.0 - 1.0
    return x.contiguous(memory_format=torch.channels_last)


def _softmax_head(layer: SoftmaxHead, x: torch.Tensor,
                  softmax_logits: bool) -> torch.Tensor:
    """graph.py::apply_layers' SoftmaxHead: the input flattened in NHWC
    order in fp32 -> (B, C) probabilities (one softmax per sibling group
    with a tree), the logits divided by the temperature first;
    softmax_logits returns the flat logits undivided (classifier_loss
    applies the temperature)."""
    flat = x.float().permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    if softmax_logits:
        return flat
    if layer.temperature != 1.0:
        flat = flat / layer.temperature
    if layer.tree is not None:
        from yolo_tpu_torch.ops.decode import tree_conditional_probs

        return tree_conditional_probs(flat, layer.tree)
    return torch.softmax(flat, dim=-1)


def _dropout(idx: int, layer: Dropout, x: torch.Tensor,
             key: Optional[np.ndarray], shard=None) -> torch.Tensor:
    """darknet's inverted dropout in training: zero with probability p,
    survivors scaled by 1 / (1 - p). The mask is the JAX package's,
    bernoulli(fold_in(key, idx), 1 - p) over the NHWC shape, drawn on
    the host (utils/prng.py) and permuted to x's (B, C, H, W); no key (or
    p = 0) is the identity. With a shard (DarknetTrain.forward), the mask
    is drawn over the whole batch and this shard's rows taken."""
    if key is None or layer.prob <= 0:
        return x
    b, c, h, w = x.shape
    rows = slice(0, b) if shard is None else slice(shard.start,
                                                   shard.start + b)
    total = b if shard is None else shard.total
    keep = torch.from_numpy(np.ascontiguousarray(prng.bernoulli(
        prng.fold_in(key, idx), 1.0 - layer.prob, (total, h, w, c))[rows])
    ).permute(0, 3, 1, 2).to(x.device)
    return torch.where(keep, x / (1.0 - layer.prob), torch.zeros_like(x))


def _result(x: torch.Tensor, heads: List[torch.Tensor]):
    """The [yolo] heads' logits as a tuple, a classifier's (B, C) output,
    else the last layer's output as fp32 NHWC (apply_layers' return)."""
    if heads:
        return tuple(heads)
    if x.dim() == 2:
        return x
    return x.permute(0, 2, 3, 1).to(torch.float32)


def fold_params(layers: Sequence[LayerSpec], params: NumpyParams,
                eps: float = 1e-5) -> NumpyParams:
    """Fold inference BN into conv weight+bias, in numpy, bit for bit as
    yolo_tpu.models.graph.fold_params:
    w' = w * g/sqrt(v+eps), b' = beta - mean * g/sqrt(v+eps)."""
    n_weighted = len(weighted_specs(layers))
    if len(params) != n_weighted:
        raise ValueError(f"fold_params: {len(params)} param blocks for "
                         f"{n_weighted} weighted layers")
    folded = []
    for p in params:
        if "weights" in p:  # weighted shortcut: nothing to fold
            folded.append({"weights": np.asarray(p["weights"])})
            continue
        if "gamma" in p:
            scale = np.asarray(p["gamma"]) / np.sqrt(np.asarray(p["var"]) + eps)
            k = np.asarray(p["kernel"])
            folded.append({
                "kernel": k * scale.reshape((1,) * (k.ndim - 1) + (-1,)),
                "bias": np.asarray(p["beta"]) - np.asarray(p["mean"]) * scale,
            })
        else:
            folded.append({"kernel": np.asarray(p["kernel"]),
                           "bias": np.asarray(p["bias"])})
    return folded


def _blend_tensor(spec: Shortcut, p, i: int, device) -> torch.Tensor:
    """A weighted shortcut's blend weights as a (2, n) fp32 tensor."""
    if set(p) != {"weights"}:
        raise ValueError(f"weighted layer {i}: expected {{weights}} for "
                         f"{spec}, got {sorted(p)}")
    w = np.asarray(p["weights"], np.float32)
    if w.ndim != 2 or w.shape[0] != 2 or (
            spec.weights_type == "per_feature" and w.shape[1] != 1):
        raise ValueError(f"weighted layer {i}: blend weights {w.shape} do "
                         f"not match {spec}")
    return torch.from_numpy(w.copy()).to(device)


def _local_tensors(spec: Local, p, i: int, device):
    """A local layer's (H', W', F, C, k, k) kernel and (H', W', F) bias
    as fp32 tensors."""
    if set(p) != {"kernel", "bias"}:
        raise ValueError(f"local {i}: expected {{kernel, bias}}, got "
                         f"{sorted(p)}")
    k = np.asarray(p["kernel"], np.float32)
    want = (spec.out_h, spec.out_w, spec.filters, spec.in_c, spec.size,
            spec.size)
    if k.shape != want:
        raise ValueError(f"local {i}: kernel {k.shape} does not match "
                         f"{spec}")
    return (torch.from_numpy(k.copy()).to(device),
            torch.from_numpy(np.asarray(p["bias"], np.float32).copy())
            .to(device))


def _connected_tensors(spec: Connected, p, i: int, device):
    """A connected layer's (in, out) kernel and bias as fp32 tensors."""
    if set(p) != {"kernel", "bias"}:
        raise ValueError(f"connected {i}: expected {{kernel, bias}}, got "
                         f"{sorted(p)}")
    k = np.asarray(p["kernel"], np.float32)
    if k.ndim != 2 or k.shape[1] != spec.out:
        raise ValueError(f"connected {i}: kernel {k.shape} does not match "
                         f"{spec}")
    return (torch.from_numpy(k.copy()).to(device),
            torch.from_numpy(np.asarray(p["bias"], np.float32).copy())
            .to(device))


_QUANT_KEYS = {"kernel_q", "w_scale", "x_scale", "bias"}


def _quant_tensors(spec: Conv, p, i: int, device) -> Dict[str, Any]:
    """An int8 block of models/quantize.py::quantize (the JAX package's
    layout: HWIO int8 kernel_q, (CO,) w_scale, scalar x_scale, (CO,)
    bias, optional scalar out_scale) -> kernel_q OIHW int8 in
    channels_last memory, (O, ky, kx, I) bytes (K-major rows), w_scale
    and bias (CO,) fp32, x_scale and out_scale 0-dim fp32 tensors."""
    if not _QUANT_KEYS <= set(p) <= _QUANT_KEYS | {"out_scale"}:
        raise ValueError(f"conv {i}: expected int8 params "
                         f"{sorted(_QUANT_KEYS)} (+ out_scale), got "
                         f"{sorted(p)}")
    k = np.asarray(p["kernel_q"])
    if k.dtype != np.int8 or k.ndim != 4 or k.shape[0] != spec.size \
            or k.shape[3] != spec.filters:
        raise ValueError(f"conv {i}: int8 kernel {k.dtype} {k.shape} does "
                         f"not match {spec}")
    out = {"kernel_q": torch.from_numpy(np.ascontiguousarray(
        k.transpose(3, 2, 0, 1))).to(device).contiguous(
            memory_format=torch.channels_last)}
    for key in ("w_scale", "x_scale", "bias", "out_scale"):
        if key in p:
            out[key] = torch.from_numpy(np.array(p[key], np.float32)).to(
                device)
    return out


def params_from_numpy(layers: Sequence[LayerSpec], params: NumpyParams,
                      device, dtype=torch.float32) -> List[Dict[str, Any]]:
    """Folded JAX-package params (HWIO numpy kernels) -> the port's
    tensors: OIHW kernels in ``dtype`` and channels_last memory, (in,
    out) connected kernels in ``dtype``, fp32 local kernels (JAX's
    layout), fp32 biases and shortcut blend weights, all on
    ``device``. An int8 block (``kernel_q``: models/quantize.py) comes
    across as _quant_tensors gives it."""
    convs = weighted_specs(layers)
    if len(params) != len(convs):
        raise ValueError(f"params_from_numpy: {len(params)} param blocks "
                         f"for {len(convs)} weighted layers")
    out = []
    for i, (spec, p) in enumerate(zip(convs, params)):
        if isinstance(spec, Shortcut):
            out.append({"weights": _blend_tensor(spec, p, i, device)})
            continue
        if isinstance(spec, Connected):
            kernel, bias = _connected_tensors(spec, p, i, device)
            out.append({"kernel": kernel.to(dtype), "bias": bias})
            continue
        if isinstance(spec, Local):
            kernel, bias = _local_tensors(spec, p, i, device)
            out.append({"kernel": kernel, "bias": bias})
            continue
        if "kernel_q" in p:
            out.append(_quant_tensors(spec, p, i, device))
            continue
        if set(p) != {"kernel", "bias"}:
            raise ValueError(f"conv {i}: expected folded params "
                             f"{{kernel, bias}}, got {sorted(p)} "
                             f"(run fold_params first)")
        k = np.asarray(p["kernel"], dtype=np.float32)
        if k.ndim != 4 or k.shape[0] != spec.size or k.shape[3] != spec.filters:
            raise ValueError(f"conv {i}: kernel {k.shape} does not match "
                             f"{spec}")
        kernel = torch.from_numpy(np.ascontiguousarray(
            k.transpose(3, 2, 0, 1)))
        out.append({
            "kernel": kernel.to(device=device, dtype=dtype).contiguous(
                memory_format=torch.channels_last),
            "bias": torch.from_numpy(np.asarray(p["bias"], np.float32))
            .to(device),
        })
    return out


class Darknet(torch.nn.Module):
    """The port's layer set with folded weights held as buffers on
    ``device``; forward computes in ``dtype`` (float32 or bfloat16).
    Kernels are held in fp32 either way, in bf16 mode rounded to bf16
    values (see the module docstring). Two more sets serve the kernel
    routes: in bf16 mode a bf16 copy of each kernel the fused conv kernel
    takes, and, when the net starts with a fusable entry, conv1's
    unrounded fp32 kernel (OIHW contiguous), which the entry kernel reads
    in both modes as the JAX package's does."""

    def __init__(self, layers: Sequence[LayerSpec], params: NumpyParams, *,
                 device, dtype=torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        for idx, layer in enumerate(layers):
            _check_layer(idx, layer)
        self.layers = tuple(layers)
        self.compute_dtype = dtype
        self.device = torch.device(device)
        weighted = weighted_specs(layers)
        # int8 blocks (models/quantize.py), by weighted-layer index: on a
        # CUDA tensor they always run the s8 kernel (graph.py::conv_block
        # dispatches on kernel_q before conv_impl)
        self.quantized = tuple(isinstance(spec, Conv) and "kernel_q" in p
                               for spec, p in zip(weighted, params))
        # the convs the fused kernel takes (graph.py::conv_block's route:
        # folded bias, leaky or linear, groups 1, dilation 1, and
        # conv_kernel.eligible), by weighted-layer index
        self.kernel_eligible = tuple(
            isinstance(spec, Conv) and not q
            and spec.act in ("leaky", "linear")
            and spec.groups == 1 and spec.dilation == 1
            and conv_ops.eligible(np.asarray(p["kernel"]), spec.stride)
            for spec, p, q in zip(weighted, params, self.quantized))
        # per int8 block: (1 / x_scale, out_scale or None), fp32 values
        # held as Python floats (the kernel takes them by value)
        self.int8_scales: Dict[int, tuple] = {}
        for i, p in enumerate(params_from_numpy(layers, params, self.device,
                                                dtype)):
            if "weights" in p:
                self.register_buffer(f"weights{i}", p["weights"])
                continue
            if "kernel_q" in p:
                self._register_int8(i, params[i], p)
                continue
            self.register_buffer(f"kernel{i}", p["kernel"].float())
            self.register_buffer(f"bias{i}", p["bias"])
            if dtype == torch.bfloat16 and self.kernel_eligible[i]:
                self.register_buffer(f"kernel{i}_bf16", p["kernel"])
        if entry_ops.eligible(self.layers) and not self.quantized[0]:
            self.register_buffer("entry_kernel", torch.from_numpy(
                np.ascontiguousarray(np.asarray(
                    params[0]["kernel"], np.float32).transpose(3, 2, 0, 1)))
                .to(self.device))
        self._routed = _routed_layers(self.layers)
        # int8 convs whose maxpool runs in their own launch (the s8
        # kernel's stem body): conv layer index -> (size, stride), where
        # the next layer is a maxpool and nothing else reads the conv's
        # output; run() fuses them unless it returns every layer
        self.fused_pools: Dict[int, tuple] = {}
        conv_i = 0
        for idx, layer in enumerate(self.layers[:-1]):
            nxt = self.layers[idx + 1]
            if (isinstance(layer, Conv) and self.quantized[conv_i]
                    and isinstance(nxt, MaxPool) and idx not in self._routed
                    and conv_s8_kernel.fuses_pool(
                        tuple(getattr(self, f"kernel{conv_i}_q").shape),
                        layer.groups, layer.stride, layer.dilation,
                        (nxt.size, nxt.stride))):
                self.fused_pools[idx] = (nxt.size, nxt.stride)
            if isinstance(layer, (Conv, Connected, Local)) or (
                    isinstance(layer, Shortcut)
                    and layer.weights_type != "none"):
                conv_i += 1

    def _register_int8(self, i: int, p_np, p) -> None:
        """Buffers of int8 block i: kernel{i}_q, scale{i} = x_scale *
        w_scale and bias{i}; the scale product and 1 / x_scale are taken
        once in fp32, as conv_block_int8 takes them."""
        x_scale = np.float32(np.asarray(p_np["x_scale"]))
        self.register_buffer(f"kernel{i}_q", p["kernel_q"])
        self.register_buffer(f"scale{i}", torch.from_numpy(
            x_scale * np.asarray(p_np["w_scale"], np.float32)).to(
                self.device))
        self.register_buffer(f"bias{i}", p["bias"])
        out_scale = p_np.get("out_scale")
        self.int8_scales[i] = (
            float(np.float32(1.0) / x_scale),
            None if out_scale is None else float(np.float32(out_scale)))

    def forward(self, x: torch.Tensor, *, conv_impl: str = "torch",
                softmax_logits: bool = False):
        """x (B, H, W, C) in [0, 1] -> logits (B, H/32, W/32, A*(5+C))
        fp32, the tuple of [yolo] head logits, or a classifier's (B, C)
        output (softmax_logits: its logits). conv_impl="cuda" runs
        the convs that the fused conv kernel
        takes through it (on a CPU tensor: through its plain version),
        the rest through F.conv2d, as the JAX package's
        conv_impl="pallas"; "torch" runs every conv through F.conv2d."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return self.run(x, conv_impl=conv_impl,
                        softmax_logits=softmax_logits)

    @torch.no_grad()
    def run(self, x: torch.Tensor, *, start: int = 0,
            conv_impl: str = "torch", softmax_logits: bool = False,
            return_all: bool = False):
        """Layers ``start``.. on x, the (B, C, H, W) channels_last output
        of layer ``start - 1`` in the compute dtype (the input image for
        start=0) -> logits (B, H', W', A*(5+C)) fp32, the tuple of
        [yolo] head logits, or a classifier's (B, C) output. Routes must
        not reach back before ``start``. return_all returns every
        layer's output instead, as the executor holds it ((B, C, H, W),
        a classifier's (B, C); apply_layers(return_all=True))."""
        if conv_impl not in ("torch", "cuda"):
            raise ValueError(f"unknown conv_impl {conv_impl!r} "
                             f"(torch | cuda)")
        outputs: Dict[int, torch.Tensor] = {}
        heads: List[torch.Tensor] = []
        every: List[torch.Tensor] = []
        conv_i = len(weighted_specs(self.layers[:start]))
        pooled = False  # the last conv's launch ran this maxpool
        for idx in range(start, len(self.layers)):
            layer = self.layers[idx]
            if pooled:
                pooled = False
                if idx in self._routed:
                    outputs[idx] = x
                continue
            if isinstance(layer, Conv):
                bias = getattr(self, f"bias{conv_i}")
                if self.quantized[conv_i]:
                    x_inv, out_scale = self.int8_scales[conv_i]
                    pool = (None if return_all
                            else self.fused_pools.get(idx))
                    x = conv_s8_kernel.conv_s8_bias_act(
                        x.contiguous(memory_format=torch.channels_last),
                        getattr(self, f"kernel{conv_i}_q"),
                        getattr(self, f"scale{conv_i}"), bias, x_inv=x_inv,
                        out_scale=out_scale, act=layer.act,
                        stride=layer.stride, groups=layer.groups,
                        dilation=layer.dilation,
                        out_dtype=self.compute_dtype, pool=pool)
                    pooled = pool is not None
                elif conv_impl == "cuda" and self.kernel_eligible[conv_i]:
                    kernel = getattr(self, f"kernel{conv_i}_bf16"
                                     if x.dtype == torch.bfloat16
                                     else f"kernel{conv_i}")
                    x = conv_kernel.fused_conv_bias_act(
                        x.contiguous(memory_format=torch.channels_last),
                        kernel, bias, act=layer.act)
                else:
                    x = conv_ops.fused_conv_bias_act(
                        x, getattr(self, f"kernel{conv_i}"), bias,
                        act=layer.act, stride=layer.stride,
                        groups=layer.groups, dilation=layer.dilation)
                conv_i += 1
            elif isinstance(layer, Shortcut) and \
                    layer.weights_type != "none":
                x = _weighted_shortcut(
                    layer, x, outputs[resolve_route(idx, layer.frm)],
                    getattr(self, f"weights{conv_i}"))
                conv_i += 1
            elif isinstance(layer, (Connected, Local)):
                fn = _connected if isinstance(layer, Connected) else _local
                x = fn(layer, x, getattr(self, f"kernel{conv_i}"),
                       getattr(self, f"bias{conv_i}"))
                conv_i += 1
            elif isinstance(layer, SoftmaxHead):
                x = _softmax_head(layer, x, softmax_logits)
            else:
                x = _weightless_layer(idx, layer, x, outputs, heads)
            if idx in self._routed:
                outputs[idx] = x
            if return_all:
                every.append(x)
        return every if return_all else _result(x, heads)


def train_params_from_numpy(layers: Sequence[LayerSpec], params: NumpyParams,
                            device) -> List[Dict[str, torch.Tensor]]:
    """Unfolded JAX-package params (HWIO numpy kernels; gamma, beta,
    mean, var or bias) -> fp32 tensors on ``device``: OIHW kernels in
    channels_last memory, connected kernels (in, out), local kernels in
    JAX's (H', W', F, C, k, k), the rest as they are.
    DarknetTrain.to_numpy is the inverse, exactly."""
    convs = weighted_specs(layers)
    if len(params) != len(convs):
        raise ValueError(f"train_params_from_numpy: {len(params)} param "
                         f"blocks for {len(convs)} weighted layers")
    out = []
    for i, (spec, p) in enumerate(zip(convs, params)):
        if isinstance(spec, Shortcut):
            out.append({"weights": _blend_tensor(spec, p, i, device)})
            continue
        if isinstance(spec, (Connected, Local)):
            fn = (_connected_tensors if isinstance(spec, Connected)
                  else _local_tensors)
            kernel, bias = fn(spec, p, i, device)
            out.append({"kernel": kernel, "bias": bias})
            continue
        want = ({"kernel", "gamma", "beta", "mean", "var"} if spec.bn
                else {"kernel", "bias"})
        if set(p) != want:
            raise ValueError(f"conv {i}: expected unfolded params "
                             f"{sorted(want)}, got {sorted(p)}")
        k = np.asarray(p["kernel"], dtype=np.float32)
        if k.ndim != 4 or k.shape[0] != spec.size or k.shape[3] != spec.filters:
            raise ValueError(f"conv {i}: kernel {k.shape} does not match "
                             f"{spec}")
        t = {key: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
             for key, v in p.items() if key != "kernel"}
        t["kernel"] = torch.from_numpy(np.ascontiguousarray(
            k.transpose(3, 2, 0, 1))).to(device).contiguous(
                memory_format=torch.channels_last)
        out.append(t)
    return out


def _train_conv_block(x, kernel, gamma, beta, mean, var, bias, *,
                      spec: Conv, eps: float, compute_dtype,
                      bn_stats_fp32: bool, shard=None):
    """graph.py::conv_block(train=True): conv, BN on batch statistics
    (or bias), the activation, cast to the compute dtype. Returns (y,
    new_mean, new_var); the statistics are None without BN. With a shard
    (DarknetTrain.forward), the statistics are the whole batch's: the
    sums of y and of (y - m)^2 over every shard, through shard.all_sum,
    divided by the whole batch's count, as jnp.mean over a sharded axis
    gives them."""
    conv = dict(stride=spec.stride, padding=(spec.size // 2) * spec.dilation,
                dilation=spec.dilation, groups=spec.groups)
    if compute_dtype == torch.float32:
        y = F.conv2d(x, kernel, **conv)
    else:
        y = F.conv2d(x.to(compute_dtype), kernel.to(compute_dtype), **conv)
    new_mean = new_var = None
    if gamma is not None and shard is not None:
        n = shard.total * y.shape[2] * y.shape[3]
        yf = y.float()
        mf = shard.all_sum(yf.sum(dim=(0, 2, 3))) / n
        v = shard.all_sum((yf - mf[None, :, None, None]).square().sum(
            dim=(0, 2, 3))) / n
        if bn_stats_fp32 or compute_dtype == torch.float32:
            y, m = yf, mf
        else:
            m, v = mf.to(y.dtype), v.to(y.dtype)
    elif gamma is not None:
        n = y.shape[0] * y.shape[2] * y.shape[3]
        if bn_stats_fp32 or compute_dtype == torch.float32:
            y = y.float()
            m = y.mean(dim=(0, 2, 3))
            v = (y - m[None, :, None, None]).square().mean(dim=(0, 2, 3))
        else:
            # statistics in the compute dtype: reduced in fp32, rounded
            # once, as jnp.mean / jnp.var do on bf16
            yf = y.float()
            mf = yf.mean(dim=(0, 2, 3))
            m = mf.to(y.dtype)
            v = (yf - mf[None, :, None, None]).square().mean(
                dim=(0, 2, 3)).to(y.dtype)
    if gamma is not None:
        # darknet variance_cpu: 1/(n - 1) (Bessel), in the step and in
        # the rolling variance alike
        v = v * (n / max(n - 1, 1))
        new_mean = (BN_MOMENTUM * mean
                    + (1 - BN_MOMENTUM) * m.detach().float())
        new_var = BN_MOMENTUM * var + (1 - BN_MOMENTUM) * v.detach().float()
        scale = gamma * torch.rsqrt(v + eps)
        y = ((y - m[None, :, None, None]) * scale[None, :, None, None]
             + beta[None, :, None, None])
    else:
        y = y + bias[None, :, None, None]
    y = conv_ops.activate(y, spec.act)
    if compute_dtype != torch.float32:
        y = y.to(compute_dtype)
    return y, new_mean, new_var


class DarknetTrain(torch.nn.Module):
    """The port's layer set in train mode on unfolded params: kernels,
    gamma, beta, biases and shortcut blend weights are ``nn.Parameter``s,
    rolling mean and var buffers, all fp32 on ``device`` (``blocks[i]``
    holds weighted layer i's).

    forward returns (logits, bn_updates) and writes nothing (logits: the
    tuple of head logits for a [yolo] net, as Darknet's): bn_updates
    maps conv index -> {"mean", "var"}, the rolling statistics after
    this batch, which apply_bn_updates writes into the buffers. Kept
    functional so that remat (torch.utils.checkpoint re-running a block
    in the backward) and chained sub-batches each update the statistics
    exactly once."""

    def __init__(self, layers: Sequence[LayerSpec], params: NumpyParams, *,
                 device, eps: float = 1e-5):
        super().__init__()
        for idx, layer in enumerate(layers):
            _check_layer(idx, layer)
        self.layers = tuple(layers)
        self.eps = eps
        self.device = resolve_device(device)
        self.blocks = torch.nn.ModuleList()
        for p in train_params_from_numpy(layers, params, self.device):
            block = torch.nn.Module()
            for key, t in p.items():
                if key in ("mean", "var"):
                    block.register_buffer(key, t)
                else:
                    setattr(block, key, torch.nn.Parameter(t))
            self.blocks.append(block)
        self._routed = _routed_layers(self.layers)

    def forward(self, x: torch.Tensor, *, compute_dtype=torch.float32,
                bn_stats_fp32: bool = True, remat: bool = False,
                softmax_logits: bool = False,
                dropout_key: Optional[np.ndarray] = None, shard=None):
        """x (B, H, W, C) in [0, 1] -> (logits (B, H/32, W/32,
        A*(5+C)) fp32, bn_updates). remat re-runs each conv block in the
        backward instead of keeping its intermediates. A classifier
        returns its (B, C) output, its logits with softmax_logits (the
        training forward). dropout_key, the step's (and sub-batch's)
        jax.random key (utils/prng.py), draws the [dropout] masks and the
        [crop] jitter as the JAX package does; None keeps dropout the
        identity and crops the center. shard: x is rows [shard.start,
        shard.start + B) of a batch of shard.total rows that other
        shards forward at the same time (parallel/sharding.py): BN takes
        the whole batch's statistics through shard.all_sum (a
        differentiable sum over every shard) and dropout its rows of the
        whole batch's masks."""
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {compute_dtype}")
        if remat and shard is not None:
            raise ValueError("remat with a sharded batch: the recomputed "
                             "blocks would sum the statistics over the "
                             "shards a second time")
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        if not isinstance(self.layers[0], Crop):
            # a [crop] input layer maps the images in their own dtype
            # first, as the JAX train step's does
            x = x.to(compute_dtype)
        outputs: Dict[int, torch.Tensor] = {}
        heads: List[torch.Tensor] = []
        bn_updates: Dict[int, Dict[str, torch.Tensor]] = {}
        conv_i = 0
        with exact_for(compute_dtype):
            for idx, layer in enumerate(self.layers):
                if isinstance(layer, Conv):
                    b = self.blocks[conv_i]
                    args = (x, b.kernel, getattr(b, "gamma", None),
                            getattr(b, "beta", None), getattr(b, "mean", None),
                            getattr(b, "var", None), getattr(b, "bias", None))
                    kw = dict(spec=layer, eps=self.eps,
                              compute_dtype=compute_dtype,
                              bn_stats_fp32=bn_stats_fp32, shard=shard)
                    if remat:
                        x, mean, var = torch.utils.checkpoint.checkpoint(
                            _train_conv_block, *args, use_reentrant=False,
                            **kw)
                    else:
                        x, mean, var = _train_conv_block(*args, **kw)
                    if mean is not None:
                        bn_updates[conv_i] = {"mean": mean, "var": var}
                    conv_i += 1
                elif isinstance(layer, Shortcut) and \
                        layer.weights_type != "none":
                    x = _weighted_shortcut(
                        layer, x, outputs[resolve_route(idx, layer.frm)],
                        self.blocks[conv_i].weights)
                    conv_i += 1
                elif isinstance(layer, (Connected, Local)):
                    fn = (_connected if isinstance(layer, Connected)
                          else _local)
                    b = self.blocks[conv_i]
                    x = fn(layer, x, b.kernel, b.bias)
                    conv_i += 1
                elif isinstance(layer, Dropout):
                    x = _dropout(idx, layer, x, dropout_key, shard)
                elif isinstance(layer, Crop):
                    x = _crop(idx, layer, x, dropout_key).to(compute_dtype)
                elif isinstance(layer, SoftmaxHead):
                    x = _softmax_head(layer, x, softmax_logits)
                else:
                    x = _weightless_layer(idx, layer, x, outputs, heads)
                if idx in self._routed:
                    outputs[idx] = x
        return _result(x, heads), bn_updates

    def to_numpy(self, overrides: Optional[List[Dict[str, torch.Tensor]]]
                 = None) -> NumpyParams:
        """The params in the JAX package's unfolded numpy layout (HWIO
        kernels), exactly; fold_params + Darknet serve them. overrides
        (per conv, name -> tensor) replace the live values, e.g. an EMA
        track."""
        out = []
        for i, b in enumerate(self.blocks):
            src = dict(b.named_parameters(recurse=False))
            src.update(b.named_buffers(recurse=False))
            if overrides is not None:
                src.update(overrides[i])
            p = {k: v.detach().float().cpu().numpy().copy()
                 for k, v in src.items() if k != "kernel"}
            if "kernel" not in src:   # shortcut blend weights
                out.append(p)
                continue
            k = src["kernel"].detach().float().cpu()
            p["kernel"] = np.ascontiguousarray(
                (k.permute(2, 3, 1, 0) if k.dim() == 4 else k).numpy())
            out.append(p)
        return out


@torch.no_grad()
def apply_bn_updates(net: DarknetTrain,
                     bn_updates: Dict[int, Dict[str, torch.Tensor]]) -> None:
    """Write the rolling statistics of a train-mode forward into the
    module's buffers (graph.py::apply_bn_updates, in place)."""
    for i, stats in bn_updates.items():
        for key, t in stats.items():
            getattr(net.blocks[i], key).copy_(t)
