"""High-level public API (port of yolo_tpu/api.py) — weights to boxes:

    import yolo_tpu_torch

    model = yolo_tpu_torch.load("yolov2.weights", "coco")   # device="cuda"
    model = yolo_tpu_torch.load("my.weights", cfg="my.cfg",
                                names="my.names")            # custom .cfg
    model = yolo_tpu_torch.load("zoo://yolov3")   # $YOLO_TPU_WEIGHTS_DIR
    detections = model(images_u8)            # (B, H, W, 3) raw RGB
    # {'boxes' (B,D,4) pixel xyxy, 'scores', 'classes', 'valid'} tensors

Darknet ``.weights`` files of the built-in variants (matched by size),
of any detector a darknet ``.cfg`` describes, or of a ``zoo://`` entry
(a local file only: nothing is fetched); or a training checkpoint
directory of the port (io/checkpoint.py; its EMA track when it keeps
one, the built-in variant matched by the params' shapes). JAX orbax
checkpoints convert with tools/ckpt_to_torch.py; the classifiers are
ROADMAP A10.
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
    """The built-in variant whose topology gives the file's byte size
    (io/zoo.py::infer_variant), else None."""
    from yolo_tpu_torch.io import zoo

    return zoo.infer_variant(weights_path)


def _variant_of_params(params) -> Optional[str]:
    """The built-in variant a .weights file of ``params`` (unfolded
    numpy) would be matched to by its size (io/zoo.py::infer_variant),
    else None."""
    import numpy as np

    from yolo_tpu_torch.configs.variants import VARIANTS
    from yolo_tpu_torch.io.darknet_weights import expected_bytes

    size = 20 + 4 * sum(int(np.size(v)) for p in params for v in p.values())
    for name, cfg in VARIANTS.items():
        if expected_bytes(cfg.layers, cfg.in_channels) == size:
            return name
    return None


def load(weights_path: str, variant: Optional[str] = None, *,
         cfg: Optional[str] = None, names: Optional[str] = None,
         device: str = "cuda", precision: str = "bf16",
         input_size: Optional[int] = None,
         conf_threshold: Optional[float] = None,
         nms_threshold: Optional[float] = None) -> Model:
    """Load a darknet ``.weights`` file, a ``zoo://<name>`` entry or a
    checkpoint directory of the port into a ready-to-call detector.

    variant: a built-in variant (yolo_tpu_torch.configs.VARIANTS); None
    takes a zoo entry's variant, or matches a plain file's byte size
    against the built-in topologies. cfg / names: a darknet .cfg (and
    .names) that describes the topology instead
    (configs/darknet_cfg.py). device: "cuda" (the default, which raises
    when CUDA is absent) or "cpu", only when asked for. precision:
    "fp32" | "bf16"."""
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
    if weights_path.startswith("zoo://"):
        from yolo_tpu_torch.io import zoo

        entry = zoo.load_manifest().get(weights_path[len("zoo://"):])
        if entry and entry.get("cutoff_layers"):
            raise ValueError(
                f"{weights_path} is a partial backbone file for "
                f"training init (io.darknet_weights.load_partial); it "
                f"cannot drive a detector")
        if variant is None and cfg is None:
            variant = entry["variant"] if entry else None
        weights_path = zoo.resolve(weights_path)
    params = None
    if os.path.isdir(weights_path):
        from yolo_tpu_torch.io import checkpoint

        state = checkpoint.restore(weights_path)
        params = [{k: v.numpy() for k, v in b.items()}
                  for b in state.get("ema_params", state["params"])]
        if variant is None and cfg is None:
            variant = _variant_of_params(params)
            if variant is None:
                raise ValueError(
                    f"no built-in variant has the shapes of "
                    f"{weights_path}'s params; pass variant= or cfg=")
    if cfg is not None:
        from yolo_tpu_torch.configs.darknet_cfg import config_from_cfg

        model_cfg = config_from_cfg(cfg, names_path=names)
        if input_size is not None:
            model_cfg = model_cfg.with_input_size(input_size)
    else:
        if variant is None:
            variant = _infer_variant(weights_path)
            if variant is None:
                raise ValueError(
                    f"cannot infer the model variant from {weights_path}'s "
                    f"size; pass variant= or cfg= explicitly")
        model_cfg = get_variant(variant, input_size=input_size)
    if params is None:
        params, _ = dw.load(weights_path, model_cfg.layers,
                            input_channels=model_cfg.in_channels)
    net = Darknet(model_cfg.layers,
                  fold_params(model_cfg.layers, params, model_cfg.bn_eps),
                  device=dev, dtype=_DTYPES[precision])
    detector = make_detector(model_cfg, conf_threshold=conf_threshold,
                             nms_threshold=nms_threshold)
    return Model(model_cfg, net, detector)
