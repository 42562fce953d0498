"""Executor for the yolov2 layer set (port of yolo_tpu/models/graph.py).

``Darknet`` interprets a ``ModelConfig.layers`` tuple of Conv / MaxPool /
Route / Reorg specs with BN folded into each conv, so every conv block is
conv + bias + leaky (or linear). The JAX package's NHWC layout is kept at
the boundary: input (B, S, S, C), logits (B, S/32, S/32, A*(5+C)) fp32.
Inside, activations are NCHW tensors in ``torch.channels_last`` memory
and routes concatenate on dim 1.

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
fused conv kernel takes (stride 1, 1x1 or 3x3, CIN and CO multiples of
128) through it (ops/cuda/conv_kernel.py), which reads bf16 kernels in
bf16 mode, and the others as above.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from yolo_tpu_torch.configs.specs import (Conv, LayerSpec, MaxPool, Reorg,
                                          Route, resolve_route,
                                          weighted_specs)
from yolo_tpu_torch.ops import conv as conv_ops
from yolo_tpu_torch.ops import entry as entry_ops
from yolo_tpu_torch.ops.cuda import conv_kernel
from yolo_tpu_torch.ops.pool import maxpool_nchw
from yolo_tpu_torch.ops.reorg import reorg_nchw

NumpyParams = List[Dict[str, np.ndarray]]


def _check_layer(idx: int, layer: LayerSpec) -> None:
    if isinstance(layer, Conv):
        if layer.act not in ("leaky", "linear"):
            raise NotImplementedError(
                f"layer {idx}: activation {layer.act!r} is not ported yet "
                f"(ROADMAP A8)")
    elif not isinstance(layer, (MaxPool, Route, Reorg)):
        raise NotImplementedError(
            f"layer {idx}: {type(layer).__name__} is not a layer of the "
            f"yolov2 set (ROADMAP A8)")


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


def params_from_numpy(layers: Sequence[LayerSpec], params: NumpyParams,
                      device, dtype=torch.float32) -> List[Dict[str, Any]]:
    """Folded JAX-package params (HWIO numpy kernels) -> the port's
    tensors: OIHW kernels in ``dtype`` and channels_last memory, fp32
    biases, all on ``device``."""
    convs = weighted_specs(layers)
    if len(params) != len(convs):
        raise ValueError(f"params_from_numpy: {len(params)} param blocks "
                         f"for {len(convs)} conv layers")
    out = []
    for i, (spec, p) in enumerate(zip(convs, params)):
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
    """The yolov2 layer set with folded weights held as buffers on
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
        convs = weighted_specs(layers)
        # the convs the fused kernel takes (graph.py::conv_block's route:
        # folded bias, leaky or linear, and conv_kernel.eligible)
        self.kernel_eligible = tuple(
            conv_ops.eligible(np.asarray(p["kernel"]), spec.stride)
            for spec, p in zip(convs, params))
        for i, p in enumerate(params_from_numpy(layers, params, self.device,
                                                dtype)):
            self.register_buffer(f"kernel{i}", p["kernel"].float())
            self.register_buffer(f"bias{i}", p["bias"])
            if dtype == torch.bfloat16 and self.kernel_eligible[i]:
                self.register_buffer(f"kernel{i}_bf16", p["kernel"])
        if entry_ops.eligible(self.layers):
            self.register_buffer("entry_kernel", torch.from_numpy(
                np.ascontiguousarray(np.asarray(
                    params[0]["kernel"], np.float32).transpose(3, 2, 0, 1)))
                .to(self.device))
        # outputs a later Route reads; the rest are dropped as they go
        self._routed = {resolve_route(idx, r)
                        for idx, l in enumerate(layers)
                        if isinstance(l, Route) for r in l.layers}

    def forward(self, x: torch.Tensor, *,
                conv_impl: str = "torch") -> torch.Tensor:
        """x (B, H, W, C) in [0, 1] -> logits (B, H/32, W/32, A*(5+C))
        fp32. conv_impl="cuda" runs the convs that the fused conv kernel
        takes through it (on a CPU tensor: through its plain version),
        the rest through F.conv2d, as the JAX package's
        conv_impl="pallas"; "torch" runs every conv through F.conv2d."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return self.run(x, conv_impl=conv_impl)

    @torch.no_grad()
    def run(self, x: torch.Tensor, *, start: int = 0,
            conv_impl: str = "torch") -> torch.Tensor:
        """Layers ``start``.. on x, the (B, C, H, W) channels_last output
        of layer ``start - 1`` in the compute dtype (the input image for
        start=0) -> logits (B, H', W', A*(5+C)) fp32. Routes must not
        reach back before ``start``."""
        if conv_impl not in ("torch", "cuda"):
            raise ValueError(f"unknown conv_impl {conv_impl!r} "
                             f"(torch | cuda)")
        outputs: Dict[int, torch.Tensor] = {}
        conv_i = sum(isinstance(l, Conv) for l in self.layers[:start])
        for idx in range(start, len(self.layers)):
            layer = self.layers[idx]
            if isinstance(layer, Conv):
                bias = getattr(self, f"bias{conv_i}")
                if conv_impl == "cuda" and self.kernel_eligible[conv_i]:
                    kernel = getattr(self, f"kernel{conv_i}_bf16"
                                     if x.dtype == torch.bfloat16
                                     else f"kernel{conv_i}")
                    x = conv_kernel.fused_conv_bias_act(
                        x.contiguous(memory_format=torch.channels_last),
                        kernel, bias, act=layer.act)
                else:
                    x = conv_ops.fused_conv_bias_act(
                        x, getattr(self, f"kernel{conv_i}"), bias,
                        act=layer.act, stride=layer.stride)
                conv_i += 1
            elif isinstance(layer, MaxPool):
                x = maxpool_nchw(x, layer.size, layer.stride)
            elif isinstance(layer, Reorg):
                x = reorg_nchw(x, layer.stride).contiguous(
                    memory_format=torch.channels_last)
            else:  # Route
                srcs = [outputs[resolve_route(idx, r)]
                        for r in layer.layers]
                x = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
            if idx in self._routed:
                outputs[idx] = x
        return x.permute(0, 2, 3, 1).to(torch.float32)
