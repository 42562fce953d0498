"""The fused entry route's host side and plain version (port of the math
of yolo_tpu/ops/pallas/entry_kernel.py).

The route replaces letterbox + conv1 (3x3, 3 -> cout, leaky) + maxpool
2x2/2 with one kernel that writes only the pooled activation
(``ops/cuda/entry_kernel.py``, ``csrc/entry_conv_pool.cu``). The JAX
package feeds its kernel six column-parity planes, a layout that exists
only for Mosaic's lane rules; the port keeps the planes' numbers and
emits them as one NHWC image with the conv's zero border in place:

  * the row interpolation accumulates in fp32 and is rounded to
    ``interp_dtype``;
  * the column interpolation accumulates in fp32 and stays fp32;
  * the letterbox bands are gray 0.5, the conv border is 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from yolo_tpu_torch.configs.specs import Conv, MaxPool
from yolo_tpu_torch.ops.letterbox import _lerp_matrix, letterbox_geometry
from yolo_tpu_torch.ops.precision import no_tf32


def eligible(layers) -> bool:
    """The fusion applies when the graph starts conv(3x3, stride 1,
    ungrouped, undilated, leaky) -> maxpool(2, 2)
    (entry_kernel.py::eligible)."""
    return (len(layers) >= 2 and isinstance(layers[0], Conv)
            and layers[0].size == 3 and layers[0].act == "leaky"
            and layers[0].stride == 1 and layers[0].groups == 1
            and layers[0].dilation == 1
            and isinstance(layers[1], MaxPool)
            and layers[1].size == 2 and layers[1].stride == 2)


@functools.lru_cache(maxsize=64)
def _column_matrix(src_w: int, src_h: int, net: int):
    """(net + 2, src_w) column interpolation over the padded width, and
    the (net + 2,) gray term: column v + 1 of the padded image is
    sum_w M[v + 1, w] * x[w] + g[v + 1]. Rows of the conv border and of
    the gray bands are zero; g is 0.5 in the bands
    (entry_kernel.py::_wplane_matrices, before its parity split)."""
    _, _, rw, px, _ = letterbox_geometry(src_h, src_w, net)
    mw = _lerp_matrix(src_w, rw)
    m = np.zeros((net + 2, src_w), np.float32)
    g = np.zeros((net + 2,), np.float32)
    g[1:net + 1] = 0.5
    m[1 + px:1 + px + rw] = mw
    g[1 + px:1 + px + rw] = 0.0
    return m, g


def letterbox_padded(images_u8: torch.Tensor, net: int,
                     interp_dtype=torch.bfloat16) -> torch.Tensor:
    """Raw RGB (B, H, W, 3) uint8 -> (B, net + 2, net + 2, 3) fp32: the
    letterboxed image with a zero border of one pixel, the entry
    kernel's input. ``build_planes`` of its interior is
    ``entry_kernel.letterbox_planes``."""
    b, h, w, c = images_u8.shape
    _, rh, _, _, py = letterbox_geometry(h, w, net)
    dev = images_u8.device
    x = images_u8.to(interp_dtype) * torch.tensor(1.0 / 255.0,
                                                  dtype=interp_dtype)
    if rh != h:
        mh = torch.as_tensor(_lerp_matrix(h, rh), device=dev)
        # fp32 sums of the interp-dtype values, rounded once
        x = torch.einsum("oh,bhwc->bowc", mh.to(interp_dtype).float(),
                         x.float()).to(interp_dtype)
    m, g = _column_matrix(w, h, net)
    m = torch.as_tensor(m, device=dev).to(interp_dtype).float()
    cols = torch.einsum("qw,bhwc->bhqc", m, x.float())
    cols += torch.as_tensor(g, device=dev)[None, None, :, None]
    out = torch.zeros((b, net + 2, net + 2, c), dtype=torch.float32,
                      device=dev)
    out[:, 1:net + 1, 1:net + 1] = 0.5
    out[:, 1 + py:1 + py + rh] = cols
    return out


def fused_entry(xpad: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor, *, out_dtype=torch.bfloat16
                ) -> torch.Tensor:
    """xpad (B, H + 2, W + 2, 3) fp32, kernel (cout, 3, 3, 3) fp32 OIHW,
    bias (cout,) fp32 -> (B, cout, H/2, W/2) in out_dtype, channels_last:
    an fp32 conv (TF32 off) + bias + leaky(0.1) + maxpool 2x2/2."""
    x = xpad.permute(0, 3, 1, 2)
    with no_tf32():
        y = F.conv2d(x.float(), kernel.float())
    y = F.leaky_relu(y + bias[None, :, None, None], 0.1)
    return F.max_pool2d(y, 2, 2).to(out_dtype).contiguous(
        memory_format=torch.channels_last)
