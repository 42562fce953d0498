"""High-level public API (port of yolo_tpu/api.py) — weights to boxes:

    import yolo_tpu_torch

    model = yolo_tpu_torch.load("yolov2.weights", "coco")   # device="cuda"
    model = yolo_tpu_torch.load("my.weights", cfg="my.cfg",
                                names="my.names")            # custom .cfg
    model = yolo_tpu_torch.load("zoo://yolov3")   # $YOLO_TPU_WEIGHTS_DIR
    detections = model(images_u8)            # (B, H, W, 3) raw RGB
    # {'boxes' (B,D,4) pixel xyxy, 'scores', 'classes', 'valid'} tensors
    clf = yolo_tpu_torch.load("darknet53.weights", "darknet53")
    labels = clf(images_u8)          # per image [(name, prob)] top-5

Darknet ``.weights`` files of the built-in variants (matched by size),
of any detector a darknet ``.cfg`` describes, or of a ``zoo://`` entry
(a local file only: nothing is fetched); or a training checkpoint
directory of the port (io/checkpoint.py; its EMA track when it keeps
one, the built-in variant matched by the params' shapes). JAX orbax
checkpoints convert with tools/ckpt_to_torch.py. A classifier (a
darknet19/darknet53 variant or a [softmax] .cfg, YOLO9000 tree
classifiers too) loads as a ``Classifier``; a YOLO9000 tree detector's
``.cfg`` names its tree= and map= files beside it.
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


class Classifier:
    """A loaded classifier: callable on raw uint8 RGB images (a batch or
    a list of different sizes), returns per image the top-k [(name,
    prob), ...] after darknet's preprocess (resize_min + centre crop);
    a tree classifier ranks leaf-masked absolute probabilities."""

    def __init__(self, cfg, params, k: int = 5):
        self.cfg = cfg
        self.params = params  # the Darknet module
        self.k = k

    def __call__(self, images_u8):
        import numpy as np

        from yolo_tpu_torch.models.classify import (classifier_preprocess,
                                                    hierarchy_leaf_probs,
                                                    make_classifier, top_k)

        xs = np.stack([classifier_preprocess(np.asarray(im),
                                             self.cfg.input_hw)
                       for im in images_u8])
        with torch.no_grad():
            probs = make_classifier(self.cfg)(self.params, xs).cpu().numpy()
        tree = self.cfg.softmax_tree
        if tree is not None:
            probs = hierarchy_leaf_probs(probs, tree)
        return [top_k(p, self.cfg.class_names, k=self.k) for p in probs]


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
         nms_threshold: Optional[float] = None, k: int = 5):
    """Load a darknet ``.weights`` file, a ``zoo://<name>`` entry or a
    checkpoint directory of the port into a ready-to-call detector.

    variant: a built-in variant (yolo_tpu_torch.configs.VARIANTS); None
    takes a zoo entry's variant, or matches a plain file's byte size
    against the built-in topologies. cfg / names: a darknet .cfg (and
    .names) that describes the topology instead
    (configs/darknet_cfg.py). device: "cuda" (the default, which raises
    when CUDA is absent) or "cpu", only when asked for. precision:
    "fp32" | "bf16". A detector comes back as a Model; a classifier as a
    Classifier, whose top-``k`` labels it returns."""
    import os

    from yolo_tpu_torch.configs import get_variant
    from yolo_tpu_torch.device import resolve as resolve_device
    from yolo_tpu_torch.io import darknet_weights as dw
    from yolo_tpu_torch.models.graph import Darknet, fold_params
    from yolo_tpu_torch.models.predict import make_detector

    if precision not in _DTYPES:
        # 'int8' (a CLI-only serving mode) or a typo must not run bf16
        raise ValueError(f"precision={precision!r}: the API supports "
                         f"'fp32' | 'bf16' (int8 PTQ is the CLI/"
                         f"models.quantize surface)")
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
    if model_cfg.head_kind == "softmax":
        return Classifier(model_cfg, net, k=k)
    detector = make_detector(model_cfg, conf_threshold=conf_threshold,
                             nms_threshold=nms_threshold)
    return Model(model_cfg, net, detector)


def load_classifier(weights_path: str, variant: Optional[str] = None, *,
                    cfg: Optional[str] = None, names: Optional[str] = None,
                    device: str = "cuda", precision: str = "bf16",
                    k: int = 5) -> Classifier:
    """A darknet classifier (.weights file, checkpoint directory or
    zoo:// entry) as a callable top-k model (api.py::load_classifier):
    load() restricted to classifiers."""
    if cfg is None and variant is None:
        raise ValueError("load_classifier needs a variant name "
                         "(e.g. 'darknet19') or cfg=")
    out = load(weights_path, variant, cfg=cfg, names=names, device=device,
               precision=precision, k=k)
    if not isinstance(out, Classifier):
        raise ValueError(f"{out.cfg.name} is a detector — use "
                         f"yolo_tpu_torch.load")
    return out
