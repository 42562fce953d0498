"""Layer specs and the model config of the yolov2 family (port of
yolo_tpu/configs/specs.py, the layer kinds the port executes).

Semantics pinned by the darknet cfg format, as in the JAX package:
  * ``Conv``: conv2d (darknet pad = size // 2), optional batch-norm,
    activation (leaky 0.1 or linear).
  * ``MaxPool``: darknet maxpool; ``size=2, stride=1`` pads one row/col
    at the end with -inf.
  * ``Route``: channel concat of earlier layer outputs, in listed order,
    indices relative to the route layer (negative) as darknet.
  * ``Reorg``: darknet ``reorg_cpu`` with forward=0 (yolov2.cfg's
    ``[reorg] stride=2``), not space_to_depth.

Field names and defaults are the JAX package's, so a config here and its
counterpart there describe the same network (tests/test_torch_graph.py
holds every variant to that).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union


@dataclasses.dataclass(frozen=True)
class Conv:
    filters: int
    size: int = 3
    stride: int = 1
    bn: bool = True
    act: str = "leaky"  # "leaky" (slope 0.1) | "linear"


@dataclasses.dataclass(frozen=True)
class MaxPool:
    size: int = 2
    stride: int = 2


@dataclasses.dataclass(frozen=True)
class Route:
    # relative indices into the layer list (negative, darknet-style)
    layers: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Reorg:
    stride: int = 2


LayerSpec = Union[Conv, MaxPool, Route, Reorg]


def weighted_specs(layers: Tuple[LayerSpec, ...]) -> Tuple[Conv, ...]:
    """Weight-carrying layers in darknet file order (the .weights walk
    order and the params-list order): the convs."""
    return tuple(l for l in layers if isinstance(l, Conv))


def resolve_route(idx: int, rel: int) -> int:
    """Resolve a darknet route index relative to layer position ``idx``."""
    return idx + rel if rel < 0 else rel


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One yolov2-family detector: topology, [region] anchors (cell
    units), class names and postprocess defaults."""

    name: str
    layers: Tuple[LayerSpec, ...]
    anchors: Tuple[Tuple[float, float], ...]
    class_names: Tuple[str, ...]
    input_size: int = 416   # square [net] height = width
    in_channels: int = 3
    conf_threshold: float = 0.5
    nms_threshold: float = 0.45
    bn_eps: float = 1e-5
    # "greedy" | "diou" (suppression metric IoU - (d/c)^beta_nms)
    nms_kind: str = "greedy"
    beta_nms: float = 0.6
    # [region] training keys (region_layer.c deltas), the official
    # yolov2 cfgs' values: thresh is the noobj IoU gate; they reach the
    # loss through train.loss.region_loss_config
    region_thresh: float = 0.6
    region_object_scale: float = 5.0
    region_noobject_scale: float = 1.0
    region_class_scale: float = 1.0
    region_coord_scale: float = 1.0
    region_rescore: bool = True

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    @property
    def num_anchors(self) -> int:
        return len(self.anchors)

    @property
    def input_hw(self) -> Tuple[int, int]:
        """(net_h, net_w) — the shape-order geometry every op takes."""
        return (self.input_size, self.input_size)

    def detection_names(self) -> Tuple[str, ...]:
        """Display names for detection class indices."""
        return self.class_names

    def with_input_size(self, size: int) -> "ModelConfig":
        if size % 32 != 0:
            raise ValueError(
                f"input size must be a multiple of 32, got {size}")
        return dataclasses.replace(self, input_size=size)
