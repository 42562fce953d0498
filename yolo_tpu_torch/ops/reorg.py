"""Darknet reorg (port of yolo_tpu/ops/reorg.py).

yolov2.cfg's ``[reorg] stride=2`` (forward=0 path of reorg_cpu) is NOT
pixel_unshuffle / space-to-depth: it reinterprets the flat buffer, which
scrambles channels in a way the pretrained weights of the next conv bake
in. As a reshape/permute chain (NCHW, s = stride, oc = C/s^2):
  x(B,C,H,W) -> reshape (B, oc, H*s, W*s) -> reshape (B, oc, H, s, W, s)
             -> permute (B, s_h, s_w, oc, H, W) -> reshape (B, C*s^2, H/s, W/s)
"""

from __future__ import annotations

import torch


def reorg_nchw(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    b, c, h, w = x.shape
    s = stride
    oc = c // (s * s)
    v = x.reshape(b, oc, h * s, w * s)
    v = v.reshape(b, oc, h, s, w, s)
    v = v.permute(0, 3, 5, 1, 2, 4)
    return v.reshape(b, c * s * s, h // s, w // s)


def reorg_nhwc(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """The JAX package's NHWC layer API."""
    return reorg_nchw(x.permute(0, 3, 1, 2), stride).permute(0, 2, 3, 1)
