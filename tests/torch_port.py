"""Helpers shared by tests/test_torch_*.py, which hold the PyTorch port
(yolo_tpu_torch) against the JAX package."""

import dataclasses

from yolo_tpu.configs import specs as jspecs
from yolo_tpu_torch.io import darknet_weights as dw


def to_jax_config(cfg):
    """The JAX package's ModelConfig for a port ModelConfig: every spec
    and field carried over by name; fields the port lacks keep the JAX
    defaults, which are the yolov2 family's."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["layers"] = tuple(
        getattr(jspecs, type(l).__name__)(**dataclasses.asdict(l))
        for l in cfg.layers)
    return jspecs.ModelConfig(**fields)


def he_weights(cfg, path, seed=0, box_scale=1.0, objectness_shift=0.0):
    """Seeded He-scaled weights (io.darknet_weights.synthetic_detector_params,
    plain He by default) written as a darknet .weights file."""
    dw.save(path, cfg.layers, dw.synthetic_detector_params(
        cfg, seed, box_scale=box_scale, objectness_shift=objectness_shift))
