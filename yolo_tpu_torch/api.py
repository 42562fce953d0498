"""High-level public API (port of yolo_tpu/api.py) — weights to boxes:

    import yolo_tpu_torch

    model = yolo_tpu_torch.load("yolov2.weights", "coco")   # device="cuda"
    detections = model(images_u8)            # (B, H, W, 3) raw RGB
    # {'boxes' (B,D,4) pixel xyxy, 'scores', 'classes', 'valid'} tensors

Darknet ``.weights`` files of the yolov2 family only; orbax checkpoints,
``zoo://`` entries and custom darknet ``.cfg`` topologies are ROADMAP
A12.
"""

from __future__ import annotations

from typing import Optional

import torch


class Model:
    """A loaded detector: callable on raw uint8 RGB batches."""

    def __init__(self, cfg, params, detector):
        self.cfg = cfg
        self.params = params  # the Darknet module
        self._detector = detector

    def __call__(self, images_u8):
        images = torch.as_tensor(images_u8, device=self.params.device)
        return self._detector(self.params, images)


_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _infer_variant(weights_path: str) -> Optional[str]:
    """The ported variant whose topology gives the file's byte size (16-
    and 20-byte headers both accepted), else None."""
    import os

    from yolo_tpu_torch.configs import VARIANTS
    from yolo_tpu_torch.io.darknet_weights import expected_bytes

    actual = os.path.getsize(weights_path)
    for name, cfg in VARIANTS.items():
        want = expected_bytes(cfg.layers, cfg.in_channels)
        if actual in (want, want - 4):
            return name
    return None


def load(weights_path: str, variant: Optional[str] = None, *,
         device: str = "cuda", precision: str = "bf16",
         input_size: Optional[int] = None,
         conf_threshold: Optional[float] = None,
         nms_threshold: Optional[float] = None) -> Model:
    """Load a darknet ``.weights`` file into a ready-to-call detector.

    variant: a yolov2-family name (yolo_tpu_torch.configs.VARIANTS);
    None matches the file's byte size against them. device: "cuda" (the
    default, which raises when CUDA is absent) or "cpu", only when asked
    for. precision: "fp32" | "bf16"."""
    import os

    from yolo_tpu_torch.configs import get_variant
    from yolo_tpu_torch.device import resolve as resolve_device
    from yolo_tpu_torch.io import darknet_weights as dw
    from yolo_tpu_torch.models.graph import Darknet, fold_params
    from yolo_tpu_torch.models.predict import make_detector

    if precision not in _DTYPES:
        raise ValueError(f"precision={precision!r}: the API supports "
                         f"'fp32' | 'bf16'")
    dev = resolve_device(device)
    if weights_path.startswith("zoo://") or os.path.isdir(weights_path):
        raise NotImplementedError(
            f"{weights_path}: zoo entries and checkpoint dirs are not "
            f"ported yet (ROADMAP A12); pass a darknet .weights file")
    if variant is None:
        variant = _infer_variant(weights_path)
        if variant is None:
            raise ValueError(
                f"cannot infer the model variant from {weights_path}'s "
                f"size; pass variant= explicitly")
    model_cfg = get_variant(variant, input_size=input_size)
    params, _ = dw.load(weights_path, model_cfg.layers,
                        input_channels=model_cfg.in_channels)
    net = Darknet(model_cfg.layers,
                  fold_params(model_cfg.layers, params, model_cfg.bn_eps),
                  device=dev, dtype=_DTYPES[precision])
    detector = make_detector(model_cfg, conf_threshold=conf_threshold,
                             nms_threshold=nms_threshold)
    return Model(model_cfg, net, detector)
