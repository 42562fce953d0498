"""Layer specs and the model config of the yolov1, yolov2 and yolov3/v4
families, YOLO9000, the darknet classifiers and the detectors a custom
darknet ``.cfg`` describes (port of yolo_tpu/configs/specs.py).

Semantics pinned by the darknet cfg format, as in the JAX package:
  * ``Conv``: conv2d (darknet pad = size // 2, times the dilation), any
    stride, optional groups (depthwise when groups == in_channels),
    optional batch-norm, activation (leaky 0.1, linear, mish, logistic,
    swish, relu or ramp).
  * ``MaxPool``: darknet maxpool; ``size=2, stride=1`` pads one row/col
    at the end with -inf; the stride-1 5/9/13 SPP pools pad both sides.
  * ``Route``: channel concat of earlier layer outputs, in listed order,
    indices relative to the route layer (negative) as darknet, or
    absolute; ``groups``/``group_id`` slice each source (yolov4 CSP).
  * ``Reorg``: darknet ``reorg_cpu`` with forward=0 (yolov2.cfg's
    ``[reorg] stride=2``), not space_to_depth.
  * ``Shortcut``: residual add of an earlier layer's output; where the
    channel counts differ the add covers the smaller count and the rest
    passes through. A weighted shortcut blends the two inputs with
    learned weights held in the .weights file.
  * ``Sam``: elementwise product with an earlier layer's output.
  * ``ScaleChannels``: an earlier layer's output scaled by this layer's
    (B, 1, 1, C) or (B, H, W, 1) input (the SE multiply).
  * ``Upsample``: nearest-neighbour x stride, values times ``scale``.
  * ``AvgPool``: global average pool to (B, 1, 1, C) (the squeeze of an
    SE block).
  * ``YoloHead``: marks its input as one [yolo] head's logits; its
    routed output is its input.
  * ``Connected``: darknet [connected], a dense layer over the input
    flattened in CHW order (darknet53's 1000-way output).
  * ``Dropout``: identity at inference; darknet's inverted dropout in
    training.
  * ``SoftmaxHead``: darknet [softmax], the classifier output: softmax
    over the flattened input, or with a YOLO9000 tree one softmax per
    sibling group.
  * ``Crop``, ``Local``, ``DetectionHead``: the yolov1 input layer, its
    locally-connected conv and its [detection] head.

Field names and defaults are the JAX package's, so a config here and its
counterpart there describe the same network (tests/test_torch_graph.py
and tests/test_torch_cfg.py hold every variant and parsed cfg to that).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

ACTIVATIONS = ("leaky", "linear", "mish", "logistic", "swish", "relu",
               "ramp")


def _check_act(act: str) -> None:
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")


@dataclasses.dataclass(frozen=True)
class Conv:
    filters: int
    size: int = 3
    stride: int = 1
    bn: bool = True
    # "leaky" (slope 0.1) | "linear" | "mish" | "logistic" | "swish" |
    # "relu" | "ramp" (x * (x > 0) + 0.1 * x)
    act: str = "leaky"
    # darknet [convolutional] groups: the kernel is (oc, ic/groups, k, k)
    # in the .weights file
    groups: int = 1
    # darknet [convolutional] dilation: padding (size // 2) * dilation
    # keeps the undilated conv's output geometry
    dilation: int = 1

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
    absolute), then the activation (linear in every official cfg).

    A weighted shortcut (AlexeyAB weights_type=per_feature |
    per_channel) carries learned blend weights in the .weights file: 2
    (one a merged input) for per_feature, 2*C for per_channel, group
    major [w_in..., w_from...]. out = in * W0 + from * W1 over the
    min-channel overlap, in * W0 alone on the passthrough channels,
    then the activation. weights_norm rescales the weights along the
    input axis first: relu -> max(w, 0.001) / (1e-4 + sum), softmax ->
    exp(w - max) / (1e-4 + sum) (yolo_tpu/configs/specs.py::Shortcut
    states the sources)."""
    frm: int
    act: str = "linear"
    # "none" | "per_feature" | "per_channel"
    weights_type: str = "none"
    # "none" | "relu" | "softmax"
    weights_norm: str = "none"

    def __post_init__(self):
        _check_act(self.act)


@dataclasses.dataclass(frozen=True)
class Sam:
    # darknet [sam] (spatial attention): this layer's input times an
    # earlier layer's same-shape output, then the activation
    frm: int
    act: str = "linear"


@dataclasses.dataclass(frozen=True)
class ScaleChannels:
    # darknet [scale_channels] (the SE multiply): the ``frm`` layer's
    # output times this layer's input, (B, 1, 1, C) when scale_wh=0 or
    # (B, H, W, 1) when scale_wh=1, broadcast; the output takes the frm
    # layer's shape
    frm: int
    scale_wh: int = 0
    act: str = "linear"


@dataclasses.dataclass(frozen=True)
class Upsample:
    # darknet [upsample]: nearest-neighbour x stride; scale multiplies
    # the values (default 1, which the official cfgs keep)
    stride: int = 2
    scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class AvgPool:
    """darknet [avgpool]: global average pool, kept 4-D (B, 1, 1, C) so
    that 1x1 convs and [scale_channels] read it unchanged."""


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
    # scaled-yolov4 [yolo] new_coords=1: the head conv is logistic, so
    # xy, conf and classes arrive activated; bx = (v*s - (s-1)/2 + cx)/W,
    # bw = 4*v^2*anchor/net_w
    new_coords: bool = False
    # [Gaussian_yolo]: 9+C channels an anchor, means and sigmas
    # interleaved [x, ux, y, uy, w, uw, h, uh, obj, classes...]; score =
    # sigmoid(obj) * sigmoid(cls) * (1 - mean(sigmoid(u)))
    gaussian: bool = False


@dataclasses.dataclass(frozen=True)
class Connected:
    """darknet [connected]: a dense layer over the input flattened in
    CHW order. Weights-file block (parser.c save_connected_weights):
    biases[out], then weights[out * in] row-major (out, in); the params
    hold the kernel as (in, out). in_features pins the flattened feature
    count of a spatial input (the parser sets it; such a model cannot
    be resized); None means a 1x1 input whose features are its channels
    (the classifiers)."""
    out: int
    act: str = "linear"
    in_features: Optional[int] = None

    def __post_init__(self):
        _check_act(self.act)


@dataclasses.dataclass(frozen=True)
class Dropout:
    """darknet [dropout]: identity at inference; in training darknet's
    inverted dropout (zero with probability ``prob``, survivors scaled
    by 1 / (1 - prob))."""
    prob: float = 0.5


@dataclasses.dataclass(frozen=True)
class Crop:
    """darknet [crop] (the yolov1 input layer, crop_layer.c): the output
    is ``input*2 - 1`` unless noadjust, in both modes. Test mode
    center-crops to (crop_h, crop_w); train mode draws one (dy, dx) and
    one flip a batch (darknet's rand() once a forward). darknet's CPU
    forward ignores the angle/saturation/exposure keys, and so does
    this."""
    crop_h: int
    crop_w: int
    flip: bool = False
    noadjust: bool = False


@dataclasses.dataclass(frozen=True)
class Local:
    """darknet [local] (the yolov1 locally-connected conv): a filter bank
    of its own at every output position, out (out_h, out_w, filters),
    pad=1 meaning size // 2, always biased, no BN. Weights-file block:
    biases[out_h*out_w*filters] in CHW order, then one (filters, in_c,
    k, k) block a position, positions row-major. The parser pins
    out_h/out_w/in_c, which size the weights, so such a model cannot be
    resized."""
    filters: int
    size: int = 3
    stride: int = 1
    pad: bool = True
    act: str = "leaky"
    out_h: int = 0
    out_w: int = 0
    in_c: int = 0

    def __post_init__(self):
        _check_act(self.act)


@dataclasses.dataclass(frozen=True)
class DetectionHead:
    """darknet [detection] (the yolov1 head): marks its input, the last
    [connected] layer's side*side*(classes + num*(1+coords)) values, as
    the detection tensor. Flat layout: side²·classes class
    probabilities, side²·num confidences, side²·num·coords boxes; a box
    is x=(tx+col)/side, y=(ty+row)/side, w=tw², h=th² (sqrt=1; tw, th
    as they are with sqrt=0), its score confidence · class probability.
    Training is detection_loss (arXiv:1506.02640 eq. 3) with the
    [detection] scale keys."""
    side: int
    num: int
    classes: int
    sqrt: bool = True
    coords: int = 4
    rescore: bool = False
    object_scale: float = 1.0
    noobject_scale: float = 0.5
    class_scale: float = 1.0
    coord_scale: float = 5.0


@dataclasses.dataclass(frozen=True)
class SoftmaxHead:
    """darknet [softmax] (groups=1): marks the model as a classifier;
    the output is (B, C) probabilities over the flattened input. With a
    tree ([softmax] tree=, the darknet9000 classifier) the output is the
    YOLO9000 conditional probabilities, one softmax per sibling group
    (ops/decode.tree_conditional_probs). temperature T divides the
    logits before the (tree-)softmax."""
    tree: Optional[object] = None   # configs.tree.SoftmaxTree
    temperature: float = 1.0


LayerSpec = Union[Conv, MaxPool, Route, Reorg, Shortcut, Sam,
                  ScaleChannels, Upsample, AvgPool, YoloHead, Connected,
                  Dropout, Crop, Local, DetectionHead, SoftmaxHead]


def conv_specs(layers: Tuple[LayerSpec, ...]) -> Tuple[Conv, ...]:
    """Conv layers in darknet file order."""
    return tuple(l for l in layers if isinstance(l, Conv))


def weighted_specs(layers: Tuple[LayerSpec, ...]
                   ) -> Tuple[Union[Conv, Connected, Local, Shortcut], ...]:
    """Weight-carrying layers in darknet file order (the .weights walk
    order and the params-list order): the convs, the connected and
    local layers and the weighted shortcuts."""
    return tuple(l for l in layers
                 if isinstance(l, (Conv, Connected, Local))
                 or (isinstance(l, Shortcut) and l.weights_type != "none"))


def resolve_route(idx: int, rel: int) -> int:
    """Resolve a darknet route index relative to layer position ``idx``."""
    return idx + rel if rel < 0 else rel


def layer_strides(layers: Tuple[LayerSpec, ...]) -> Tuple[int, ...]:
    """Feature stride (net pixels per cell) after each layer
    (darknet_cfg.py::layer_strides): conv, maxpool and reorg strides
    multiply, upsample divides, a route takes its sources' (agreeing)
    stride, shortcut, sam and [yolo] pass through, scale_channels takes
    its ``frm`` layer's."""
    strides = []
    cur = 1
    for idx, l in enumerate(layers):
        if isinstance(l, (Conv, MaxPool, Reorg)):
            cur *= l.stride
        elif isinstance(l, Upsample):
            if cur % l.stride:
                raise ValueError(
                    f"layer {idx}: upsample stride {l.stride} does not "
                    f"divide feature stride {cur}")
            cur //= l.stride
        elif isinstance(l, Route):
            srcs = {strides[resolve_route(idx, r)] for r in l.layers}
            if len(srcs) != 1:
                raise ValueError(
                    f"layer {idx}: route sources have mismatched feature "
                    f"strides {sorted(srcs)} — cannot concatenate")
            cur = srcs.pop()
        elif isinstance(l, (Shortcut, Sam)):
            src = strides[resolve_route(idx, l.frm)]
            if src != cur:
                raise ValueError(
                    f"layer {idx}: {type(l).__name__.lower()} across "
                    f"feature strides {src} vs {cur}")
        elif isinstance(l, ScaleChannels):
            cur = strides[resolve_route(idx, l.frm)]
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
    # [net] height, and width too when input_width is None (square);
    # a rectangular net sets input_width, and geometry reads
    # input_h / input_w / input_hw
    input_size: int = 416
    input_width: Optional[int] = None
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
    # YOLO9000 ([region] tree=<file>): class logits are soft-maxed per
    # sibling group; decode projects through tree_map ([region]
    # map=<file>, opt-in with use_tree_map at the predict layer) or
    # descends the tree while the path product stays above hier_thresh
    # (darknet's -hier, default 0.5). tree_file / map_file keep the
    # cfg's path strings, so that cfg_to_string round-trips.
    tree: Optional[object] = None          # configs.tree.SoftmaxTree
    tree_map: Optional[Tuple[int, ...]] = None
    tree_file: Optional[str] = None
    map_file: Optional[str] = None
    hier_thresh: float = 0.5

    @property
    def head_kind(self) -> str:
        """"yolo" ([yolo] heads: sigmoid classes, pixel anchors),
        "softmax" (a darknet classifier: [softmax] over a pooled trunk,
        no anchors), "detection" (the yolov1 [detection] head over a
        connected layer, no anchors) or "region" (the yolov2 [region]
        head), from the layer list."""
        if any(isinstance(l, YoloHead) for l in self.layers):
            return "yolo"
        if any(isinstance(l, SoftmaxHead) for l in self.layers):
            return "softmax"
        if any(isinstance(l, DetectionHead) for l in self.layers):
            return "detection"
        return "region"

    @property
    def detection_head(self) -> Optional[DetectionHead]:
        """The yolov1 [detection] spec (None for other families)."""
        for l in self.layers:
            if isinstance(l, DetectionHead):
                return l
        return None

    @property
    def softmax_tree(self):
        """The classifier's hierarchy: its SoftmaxHead layer's tree,
        which training reads too (None for detectors and flat
        classifiers)."""
        for l in self.layers:
            if isinstance(l, SoftmaxHead):
                return l.tree
        return None

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
    def input_h(self) -> int:
        """Net input height ([net] height)."""
        return self.input_size

    @property
    def input_w(self) -> int:
        """Net input width ([net] width; == height for square nets)."""
        return self.input_width if self.input_width is not None \
            else self.input_size

    @property
    def input_hw(self) -> Tuple[int, int]:
        """(net_h, net_w) — the shape-order geometry every op takes."""
        return (self.input_h, self.input_w)

    @property
    def grid_hw(self) -> Tuple[int, int]:
        """Region-head grid (gh, gw) = input_hw // 32."""
        return (self.input_h // 32, self.input_w // 32)

    def num_detection_classes(self, use_tree_map: bool = False) -> int:
        """len(detection_names(use_tree_map))."""
        return len(self.detection_names(use_tree_map))

    def detection_names(self, use_tree_map: bool = False
                        ) -> Tuple[str, ...]:
        """Display names for detection class indices: under the tree
        map projection, the mapped tree nodes' names."""
        if use_tree_map and self.tree_map is not None:
            return tuple(self.class_names[m] for m in self.tree_map)
        return self.class_names

    def with_input_size(self, size: int) -> "ModelConfig":
        """Square resize. A rectangular config raises: squaring it would
        change its aspect (use with_input_hw)."""
        if self.input_width is not None and \
                self.input_width != self.input_size:
            raise ValueError(
                f"{self.name} is rectangular ({self.input_w}x"
                f"{self.input_h}): with_input_size would square it — "
                f"use with_input_hw(h, w)")
        return self.with_input_hw(size, size)

    def with_input_hw(self, h: int, w: int) -> "ModelConfig":
        if h % 32 != 0 or w % 32 != 0:
            raise ValueError(
                f"input size must be a multiple of 32, got {w}x{h}")
        if any(isinstance(l, (Local, Crop)) for l in self.layers) or \
                any(isinstance(l, Connected) and l.in_features is not None
                    for l in self.layers):
            # [local], [crop] and spatial dense weights are sized by the
            # cfg input
            raise ValueError(
                f"{self.name} has a fixed input size "
                f"({self.input_size}): [local]/[crop]/spatial "
                f"[connected] weights are sized by it")
        return dataclasses.replace(
            self, input_size=h, input_width=None if w == h else w)
