"""Layer specs and the model config of the yolov2 and yolov3/v4
families (port of yolo_tpu/configs/specs.py, the layer kinds the port
executes).

Semantics pinned by the darknet cfg format, as in the JAX package:
  * ``Conv``: conv2d (darknet pad = size // 2, any stride), optional
    batch-norm, activation (leaky 0.1, linear, or mish for yolov4).
  * ``MaxPool``: darknet maxpool; ``size=2, stride=1`` pads one row/col
    at the end with -inf; the stride-1 5/9/13 SPP pools pad both sides.
  * ``Route``: channel concat of earlier layer outputs, in listed order,
    indices relative to the route layer (negative) as darknet, or
    absolute; ``groups``/``group_id`` slice each source (yolov4 CSP).
  * ``Reorg``: darknet ``reorg_cpu`` with forward=0 (yolov2.cfg's
    ``[reorg] stride=2``), not space_to_depth.
  * ``Shortcut``: residual add of an earlier layer's output; where the
    channel counts differ the add covers the smaller count and the rest
    passes through.
  * ``Upsample``: nearest-neighbour x stride, values times ``scale``.
  * ``YoloHead``: marks its input as one [yolo] head's logits; its
    routed output is its input.

Options that only a custom darknet ``.cfg`` sets (a weighted shortcut,
``new_coords``, Gaussian heads, the swish/logistic/relu/ramp
activations) raise NotImplementedError when a spec is built: they are
ROADMAP A8b.

Field names and defaults are the JAX package's, so a config here and its
counterpart there describe the same network (tests/test_torch_graph.py
holds every variant to that).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

ACTIVATIONS = ("leaky", "linear", "mish")
# activations of the JAX package that only a custom .cfg reaches
_A8B_ACTIVATIONS = ("logistic", "swish", "relu", "ramp")


def _a8b(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP A8b: "
                               f"options only a custom .cfg sets)")


def _check_act(act: str) -> None:
    if act in _A8B_ACTIVATIONS:
        raise _a8b(f"activation {act!r}")
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")


@dataclasses.dataclass(frozen=True)
class Conv:
    filters: int
    size: int = 3
    stride: int = 1
    bn: bool = True
    act: str = "leaky"  # "leaky" (slope 0.1) | "linear" | "mish"

    def __post_init__(self):
        _check_act(self.act)


@dataclasses.dataclass(frozen=True)
class MaxPool:
    size: int = 2
    stride: int = 2


@dataclasses.dataclass(frozen=True)
class Route:
    # indices into the layer list, relative (negative, darknet-style)
    # or absolute
    layers: Tuple[int, ...]
    # darknet [route] groups/group_id (yolov4 CSP): each source keeps
    # its channel slice group_id of groups equal parts
    groups: int = 1
    group_id: int = 0


@dataclasses.dataclass(frozen=True)
class Reorg:
    stride: int = 2


@dataclasses.dataclass(frozen=True)
class Shortcut:
    """darknet [shortcut] ``from`` index (negative = relative, else
    absolute), then the activation (linear in every official cfg)."""
    frm: int
    act: str = "linear"
    # weighted shortcuts (AlexeyAB per_feature / per_channel, with relu
    # or softmax normalization) are ROADMAP A8b
    weights_type: str = "none"
    weights_norm: str = "none"

    def __post_init__(self):
        _check_act(self.act)
        if self.weights_type != "none" or self.weights_norm != "none":
            raise _a8b(f"a weighted shortcut ({self.weights_type}, "
                       f"{self.weights_norm})")


@dataclasses.dataclass(frozen=True)
class Upsample:
    # darknet [upsample]: nearest-neighbour x stride; scale multiplies
    # the values (default 1, which the official cfgs keep)
    stride: int = 2
    scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class YoloHead:
    # indices into ModelConfig.anchors (pixel units of the net input)
    mask: Tuple[int, ...]
    # darknet [yolo] scale_x_y: bx = (sigmoid(tx)*s - (s-1)/2 + cx) / W
    scale_xy: float = 1.0
    # per-head training overrides (None = the YoloLossConfig value; an
    # explicit 0.0 disables): box-gradient clamp, class label smoothing
    max_delta: Optional[float] = None
    label_smooth_eps: Optional[float] = None
    # scaled-yolov4 new_coords and [Gaussian_yolo] heads: ROADMAP A8b
    new_coords: bool = False
    gaussian: bool = False

    def __post_init__(self):
        if self.new_coords:
            raise _a8b("[yolo] new_coords=1")
        if self.gaussian:
            raise _a8b("[Gaussian_yolo]")


LayerSpec = Union[Conv, MaxPool, Route, Reorg, Shortcut, Upsample, YoloHead]


def weighted_specs(layers: Tuple[LayerSpec, ...]) -> Tuple[Conv, ...]:
    """Weight-carrying layers in darknet file order (the .weights walk
    order and the params-list order): the convs."""
    return tuple(l for l in layers if isinstance(l, Conv))


def resolve_route(idx: int, rel: int) -> int:
    """Resolve a darknet route index relative to layer position ``idx``."""
    return idx + rel if rel < 0 else rel


def layer_strides(layers: Tuple[LayerSpec, ...]) -> Tuple[int, ...]:
    """Feature stride (net pixels per cell) after each layer
    (darknet_cfg.py::layer_strides): conv, maxpool and reorg strides
    multiply, upsample divides, a route takes its sources' stride,
    shortcut and [yolo] pass through."""
    strides = []
    cur = 1
    for idx, l in enumerate(layers):
        if isinstance(l, (Conv, MaxPool, Reorg)):
            cur *= l.stride
        elif isinstance(l, Upsample):
            if cur % l.stride:
                raise ValueError(f"layer {idx}: upsample stride {l.stride} "
                                 f"does not divide feature stride {cur}")
            cur //= l.stride
        elif isinstance(l, Route):
            srcs = {strides[resolve_route(idx, r)] for r in l.layers}
            if len(srcs) != 1:
                raise ValueError(f"layer {idx}: route sources have "
                                 f"feature strides {sorted(srcs)}")
            cur = srcs.pop()
        elif isinstance(l, Shortcut):
            if strides[resolve_route(idx, l.frm)] != cur:
                raise ValueError(f"layer {idx}: shortcut across feature "
                                 f"strides")
        strides.append(cur)
    return tuple(strides)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One detector: topology, anchors, class names and postprocess
    defaults. Anchors are in cell units for the [region] head (yolov2
    family) and in pixels of the net input for [yolo] heads (yolov3/v4
    family)."""

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
    # [yolo] training keys (yolo_layer.c), read by
    # train.loss.yolo_loss_config: the objectness ignore band, the box
    # loss (mse | iou | giou | diou | ciou) and its normalizers;
    # obj_normalizer None keeps the classic roles (cls_normalizer scales
    # objectness), a float splits them
    ignore_thresh: float = 0.7
    iou_loss: str = "mse"
    iou_normalizer: float = 1.0
    cls_normalizer: float = 1.0
    obj_normalizer: Optional[float] = None
    # AlexeyAB iou_thresh: anchors above this wh-IoU with a truth are
    # assigned too (1.0 = the best anchor only)
    assign_iou_thresh: float = 1.0
    # objectness_smooth=1: training raises, as the JAX package's does
    objectness_smooth: bool = False
    # focal class loss (gamma 2, alpha 0.5)
    focal_loss: bool = False
    # anchors whose predicted box beats this IoU with a truth train as
    # positives too; 1.0 disables
    truth_thresh: float = 1.0

    @property
    def head_kind(self) -> str:
        """"yolo" ([yolo] heads: sigmoid classes, pixel anchors) or
        "region" (the yolov2 [region] head), from the layer list."""
        if any(isinstance(l, YoloHead) for l in self.layers):
            return "yolo"
        return "region"

    @property
    def yolo_heads(self) -> Tuple[YoloHead, ...]:
        """[yolo] layers in graph order (empty for the region family)."""
        return tuple(l for l in self.layers if isinstance(l, YoloHead))

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
