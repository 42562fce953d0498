"""Greedy same-class NMS suppression: wrapper of ``csrc/nms_suppress.cu``.

The CUDA kernel replaces the Pallas TPU kernel
``yolo_tpu/ops/pallas/nms_kernel.py::suppress`` and keeps its signature
and semantics. Its plain PyTorch version is
``yolo_tpu_torch.ops.nms._suppress_torch`` (the port of ``_suppress_xla``),
run in row chunks (``_suppress_torch_rows``) to bound its memory.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, which is what the CPU tests run.
"""

from __future__ import annotations

import torch

from yolo_tpu_torch.ops.cuda import build

MAX_K = 256  # the kernel's shared-memory bitmask holds K <= 256 columns

# kernel launches since the last reset (chip_smoke.py reads it to show
# that the served path ran the kernel)
launches = 0


def suppress(geom: torch.Tensor, scores: torch.Tensor,
             classes: torch.Tensor, *, conf_threshold: float,
             iou_threshold: float) -> torch.Tensor:
    """geom (G, 5, K) f32 rows [x1, y1, x2, y2, area], scores (G, K) f32
    sorted desc, classes (G, K) f32 class ids -> keep (G, K) f32 in
    {0, 1}."""
    global launches
    if geom.device.type == "cpu":
        from yolo_tpu_torch.ops.nms import _suppress_torch_rows

        return _suppress_torch_rows(geom, scores, classes, conf_threshold,
                                    iou_threshold)
    if geom.dim() != 3 or geom.shape[1] != 5:
        raise ValueError(f"geom must be (G, 5, K), got {tuple(geom.shape)}")
    g, _, k = geom.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"CUDA NMS supports 1 <= K <= {MAX_K}, got K={k}")
    for name, t, shape in (("geom", geom, (g, 5, k)),
                           ("scores", scores, (g, k)),
                           ("classes", classes, (g, k))):
        if t.device.type != "cuda" or t.device != geom.device:
            raise ValueError(f"{name} must be on {geom.device}, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    keep = torch.empty((g, k), dtype=torch.float32, device=geom.device)
    if g == 0:
        return keep
    lib = build.library()
    with torch.cuda.device(geom.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.yolo_nms_suppress(
            geom.data_ptr(), scores.data_ptr(), classes.data_ptr(),
            keep.data_ptr(), g, k, float(conf_threshold),
            float(iou_threshold), stream)
    if err != 0:
        raise RuntimeError(f"nms_suppress launch failed: CUDA error {err}")
    launches += 1
    return keep
