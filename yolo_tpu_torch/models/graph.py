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
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from yolo_tpu_torch.configs.specs import (Conv, LayerSpec, MaxPool, Reorg,
                                          Route, resolve_route,
                                          weighted_specs)
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


class _NoTF32:
    """Keeps cuDNN's TF32 off while any fp32 forward runs. The flag is
    process-wide, so overlapping forwards (the server's worker thread and
    a caller's) share one save/restore, counted under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = True

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    torch.backends.cudnn.allow_tf32 = self._saved


_no_tf32 = _NoTF32()


class Darknet(torch.nn.Module):
    """The yolov2 layer set with folded weights held as buffers on
    ``device``; forward computes in ``dtype`` (float32 or bfloat16).
    Kernels are held in fp32 either way, in bf16 mode rounded to bf16
    values (see the module docstring)."""

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
        for i, p in enumerate(params_from_numpy(layers, params, self.device,
                                                dtype)):
            self.register_buffer(f"kernel{i}", p["kernel"].float())
            self.register_buffer(f"bias{i}", p["bias"])
        # outputs a later Route reads; the rest are dropped as they go
        self._routed = {resolve_route(idx, r)
                        for idx, l in enumerate(layers)
                        if isinstance(l, Route) for r in l.layers}

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) in [0, 1] -> logits (B, H/32, W/32, A*(5+C))
        fp32."""
        dt = self.compute_dtype
        x = x.to(dt).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        outputs: Dict[int, torch.Tensor] = {}
        conv_i = 0
        precision = _no_tf32() if dt == torch.float32 \
            else contextlib.nullcontext()
        with precision:
            for idx, layer in enumerate(self.layers):
                if isinstance(layer, Conv):
                    # fp32 conv of the bf16 values (a no-op cast in fp32)
                    y = F.conv2d(x.float(), getattr(self, f"kernel{conv_i}"),
                                 stride=layer.stride, padding=layer.size // 2)
                    # fp32 epilogue, in place on the conv's fresh output
                    y.add_(getattr(self, f"bias{conv_i}")[None, :, None,
                                                          None])
                    if layer.act == "leaky":
                        F.leaky_relu(y, 0.1, inplace=True)
                    x = y.to(dt)
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
