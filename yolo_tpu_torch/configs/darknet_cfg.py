"""Darknet ``.cfg`` file parser -> ModelConfig (port of
yolo_tpu/configs/darknet_cfg.py, the detection surface): any darknet
detector cfg + .weights pair runs unmodified (SURVEY.md §2.1 'Config'):

    model = yolo_tpu_torch.load("my.weights", cfg="my.cfg",
                                names="my.names")

Sections: [net] (width/height — rectangular nets — and channels),
[convolutional] (batch_normalize, filters, size, stride, groups,
dilation, activation leaky|linear|mish|logistic|swish|relu|ramp),
[maxpool], [route] (layers, groups/group_id), [reorg], [shortcut] (from,
activation, weights_type, weights_normalization), [sam],
[scale_channels] (from, scale_wh), [upsample] (stride, scale),
[avgpool] (global), [cost] (ignored), [region] (the yolov2 head and its
training keys; tree=/map= for YOLO9000), [yolo] (mask, anchors, the
training keys, scale_x_y, the scaled-yolov4 new_coords=1 head,
nms_kind/beta_nms), [Gaussian_yolo] (9+C channels an anchor), and the
classifier sections [connected] (output, activation; no BN), [dropout]
(probability) and [softmax] (groups=1, tree=, temperature), the last
layer of a darknet19/darknet53-style classifier, and the yolov1
sections [crop] (first layer), [local] (its geometry pinned at parse,
as the weights' size depends on it), a spatial [connected] and
[detection] (last layer, the connected output's width checked).

Each section raises where the JAX package's parser raises, with the same
exception type and message, and the same stderr warnings for keys
nothing reads.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

from yolo_tpu_torch.configs.specs import (AvgPool, Connected, Conv, Crop,
                                          DetectionHead, Dropout, Local,
                                          MaxPool, ModelConfig, Reorg, Route,
                                          Sam, ScaleChannels, Shortcut,
                                          SoftmaxHead, Upsample, YoloHead,
                                          layer_strides, resolve_route)

_SUPPORTED = {"net", "convolutional", "maxpool", "route", "reorg",
              "region", "shortcut", "sam", "scale_channels", "upsample",
              "yolo", "gaussian_yolo", "avgpool", "connected", "dropout",
              "softmax", "cost", "crop", "local", "detection"}

# Per-section key audit (darknet's cfg is the FULL training config, so
# a silently-dropped key can mean silently-different training): keys in
# the "consumed" set are read somewhere (builder, net_training_params,
# augmentation config) or are deliberate no-ops documented elsewhere;
# "noop" keys are recognized-but-unimplemented darknet keys that only
# matter away from the listed no-op value (warn when they would change
# behavior, stay silent at the default); anything else warns once as
# unrecognized. parser.c is the authority for darknet's key set.
_YOLO_KEYS = frozenset((
    "anchors", "num", "classes", "mask", "jitter", "random",
    "ignore_thresh", "truth_thresh", "iou_loss", "iou_normalizer",
    "cls_normalizer", "obj_normalizer", "iou_thresh",
    "objectness_smooth", "focal_loss", "label_smooth_eps", "max_delta",
    "scale_x_y", "new_coords", "nms_kind", "beta_nms"))
_CONSUMED_KEYS = {
    "net": frozenset((
        "width", "height", "channels", "batch", "subdivisions",
        "momentum", "decay", "learning_rate", "burn_in", "max_batches",
        "policy", "steps", "scales", "step", "scale", "gamma",
        "sgdr_cycle", "sgdr_mult", "learning_rate_min", "power",
        "letter_box", "adam", "B1", "B2", "eps", "saturation",
        "exposure", "hue", "flip", "mosaic", "mixup", "ema_alpha",
        # darknet's validation top-k display — `classify --top` here
        "top",
        # classifier scale/rotation augmentation (data.c
        # random_augment_image — detector training ignores them, as
        # darknet's load_data_detection does)
        "angle", "aspect", "min_crop", "max_crop",
        # [net] blur / gaussian_noise augmentations (round 5 —
        # cv2-formula-pinned, data/augment.py)
        "blur", "gaussian_noise")),
    "convolutional": frozenset((
        "batch_normalize", "filters", "size", "stride", "stride_x",
        "stride_y", "pad", "padding", "groups", "dilation",
        "activation")),
    "maxpool": frozenset(("size", "stride", "stride_x", "stride_y",
                          "padding")),
    "route": frozenset(("layers", "groups", "group_id")),
    "reorg": frozenset(("stride",)),
    "shortcut": frozenset(("from", "activation", "weights_type",
                           "weights_normalization")),
    "sam": frozenset(("from", "activation")),
    "scale_channels": frozenset(("from", "activation", "scale_wh")),
    "upsample": frozenset(("stride", "scale")),
    "avgpool": frozenset(),
    "connected": frozenset(("output", "activation", "batch_normalize")),
    "dropout": frozenset(("probability",)),
    "softmax": frozenset(("groups", "temperature", "tree")),
    # [crop] flip/noadjust are real crop_layer.c CPU semantics
    # (specs.Crop); angle/saturation/exposure/shift are GPU-kernel
    # jitter darknet's CPU forward ignores — consumed-silent to match.
    # [detection] jitter is --augment's job (documented deviation).
    "crop": frozenset(("crop_height", "crop_width", "flip", "angle",
                       "saturation", "exposure", "shift", "noadjust")),
    "local": frozenset(("filters", "size", "stride", "pad",
                        "activation")),
    "detection": frozenset((
        "classes", "side", "num", "sqrt", "coords", "rescore",
        "object_scale", "noobject_scale", "class_scale", "coord_scale",
        "jitter", "softmax")),
    "cost": frozenset(("type", "scale")),
    "yolo": _YOLO_KEYS,
    "gaussian_yolo": _YOLO_KEYS,
    "region": frozenset((
        "anchors", "num", "classes", "thresh", "tree", "map", "jitter",
        "random", "rescore", "object_scale", "noobject_scale",
        "class_scale", "coord_scale", "softmax", "bias_match",
        "focal_loss",
        # parsed-but-unused in darknet's region_layer forward/backward
        "absolute", "log")),
}
_NOOP_KEYS = {
    # value at which the unimplemented key is behavior-neutral in
    # darknet (its parse default)
    "net": {"cutmix": 0.0, "adversarial_lr": 0.0,
            "attention": 0.0, "contrastive": 0.0, "track": 0.0,
            "mosaic_bound": 0.0, "resize_step": 32.0},
    "convolutional": {"assisted_excitation": 0.0},
    "yolo": {"resize": 1.0, "counters_per_class": None,
             "show_details": None},
    "gaussian_yolo": {"resize": 1.0, "uc_normalizer": 1.0},
    # parsed by darknet's parse_detection but warn when set — their
    # forward effects are unimplemented here
    "detection": {"forced": 0.0, "reorg": 0.0},
}


def _audit_cfg_keys(cfg_path: str, sections) -> None:
    """Warn once per (section, key) for cfg keys nothing consumes —
    darknet trains from the cfg alone, so a dropped key is a silently
    different run. No-op-valued unimplemented keys stay silent."""
    seen = set()
    for kind, kv in sections:
        consumed = _CONSUMED_KEYS.get(kind, frozenset())
        noop = _NOOP_KEYS.get(kind, {})
        for key, val in kv.items():
            if key in consumed or (kind, key) in seen:
                continue
            seen.add((kind, key))
            if key in noop:
                want = noop[key]
                if callable(want):
                    want = want(kv)
                try:
                    if want is not None and float(val) == want:
                        continue
                except ValueError:
                    pass
                print(f"{cfg_path}: [{kind}] {key}={val} is not "
                      f"implemented — proceeding as if "
                      f"{key}={'unset' if want is None else f'{want:g}'}"
                      f" (darknet would behave differently)",
                      file=sys.stderr)
            else:
                print(f"{cfg_path}: [{kind}] {key}={val} is not a "
                      f"recognized key here — ignored (check the "
                      f"spelling against darknet's parser.c)",
                      file=sys.stderr)


def parse_cfg(path: str) -> List[Tuple[str, Dict[str, str]]]:
    """INI-like darknet cfg -> [(section_name, {key: value}), ...] in
    file order. '#' and ';' start comments; repeated sections are kept
    as separate entries (unlike configparser)."""
    sections: List[Tuple[str, Dict[str, str]]] = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#")[0].split(";")[0].strip()
            if not line:
                continue
            if line.startswith("["):
                sections.append((line.strip("[] ").lower(), {}))
            else:
                if "=" not in line or not sections:
                    raise ValueError(f"malformed cfg line: {raw.rstrip()}")
                k, v = line.split("=", 1)
                sections[-1][1][k.strip()] = v.strip()
    return sections


def _parse_anchors(kv: Dict[str, str], section: str
                   ) -> Tuple[Tuple[float, float], ...]:
    """anchors=/num= pair -> ((pw, ph), ...), validated."""
    vals = [float(v) for v in kv["anchors"].split(",")]
    n = int(kv.get("num", len(vals) // 2))
    if n < 1 or 2 * n > len(vals):
        raise ValueError(
            f"{section} num={n} needs {2 * n} anchor values, got "
            f"{len(vals)}")
    return tuple((vals[2 * i], vals[2 * i + 1]) for i in range(n))


def load_names(path: str) -> Tuple[str, ...]:
    """darknet .names file: one class name per line."""
    with open(path) as f:
        return tuple(line.strip() for line in f if line.strip())


def _resolve_spatial(layers: List, input_hw: Tuple[int, int],
                     in_channels: int = 3) -> List:
    """Shape-resolution pass (darknet_cfg.py::_resolve_spatial): walk
    (h, w, c) through the layer list, raising where a route
    concatenates sources of different spatial extents, and pin the
    flattened feature count of a spatial dense input in
    Connected.in_features (darknet flattens h*w*c; a 1x1 input keeps
    None, the classifier case) and Local.out_h/out_w/in_c, which size
    its weights. Returns the rewritten layer list.
    input_hw: (net_h, net_w)."""
    import dataclasses as _dc

    shapes: List[Tuple[int, int, int]] = []   # (h, w, c) per layer
    out = []
    h, w = input_hw
    c = in_channels
    for idx, l in enumerate(layers):
        if isinstance(l, Conv):
            # darknet applies padding = pad * dilation with effective
            # kernel extent dilation*(size-1)+1
            d = l.dilation
            pad = (l.size // 2) * d
            eff = d * (l.size - 1) + 1
            h = (h + 2 * pad - eff) // l.stride + 1
            w = (w + 2 * pad - eff) // l.stride + 1
            c = l.filters
        elif isinstance(l, MaxPool):
            # darknet maxpool: pad = size-1 -> out = (dim-1)//stride + 1
            h = (h - 1) // l.stride + 1
            w = (w - 1) // l.stride + 1
        elif isinstance(l, AvgPool):
            h = w = 1
        elif isinstance(l, Reorg):
            h //= l.stride
            w //= l.stride
            c *= l.stride * l.stride
        elif isinstance(l, Upsample):
            h *= l.stride
            w *= l.stride
        elif isinstance(l, Route):
            srcs = [shapes[resolve_route(idx, r)] for r in l.layers]
            if len({(s[0], s[1]) for s in srcs}) != 1:
                raise ValueError(
                    f"layer {idx}: route concatenates sources with "
                    f"mismatched spatial extents "
                    f"{[(s[0], s[1]) for s in srcs]}")
            h, w = srcs[0][0], srcs[0][1]
            c = sum(s[2] // l.groups for s in srcs)
        elif isinstance(l, ScaleChannels):
            h, w, c = shapes[resolve_route(idx, l.frm)]
        elif isinstance(l, Local):
            pad = l.size // 2 if l.pad else 0
            oh = (h + 2 * pad - l.size) // l.stride + 1
            ow = (w + 2 * pad - l.size) // l.stride + 1
            l = _dc.replace(l, out_h=oh, out_w=ow, in_c=c)
            h, w, c = oh, ow, l.filters
        elif isinstance(l, Crop):
            if l.crop_h > h or l.crop_w > w:
                raise ValueError(
                    f"[crop] {l.crop_h}x{l.crop_w} exceeds the "
                    f"{h}x{w} input")
            h, w = l.crop_h, l.crop_w
        elif isinstance(l, Connected):
            if h * w > 1:
                l = _dc.replace(l, in_features=h * w * c)
            h = w = 1
            c = l.out
        # Shortcut/Sam/Dropout/SoftmaxHead/YoloHead/DetectionHead keep
        # the running shape
        shapes.append((h, w, c))
        out.append(l)
    return out


def config_from_cfg(cfg_path: str, names_path: Optional[str] = None,
                    name: Optional[str] = None) -> ModelConfig:
    """Build a ModelConfig from a darknet cfg (+ optional .names)."""
    sections = parse_cfg(cfg_path)
    layers: List = []
    net_h = net_w = 416
    net_c = 3
    anchors: Tuple[Tuple[float, float], ...] = ()
    num_classes: Optional[int] = None
    ignore_thresh: Optional[float] = None
    loss_spec: Optional[Tuple] = None  # [yolo] training-key set
    nms_spec: Optional[Tuple] = None   # [yolo] (nms_kind, beta_nms)
    region_thresh: Optional[float] = None
    region_spec: Optional[Tuple] = None  # [region] loss scales+rescore
    saw_region = False
    saw_detection = False
    detection_spec: Optional[DetectionHead] = None
    tree_file: Optional[str] = None   # [region]/[softmax] tree= (YOLO9000)
    map_file: Optional[str] = None    # [region] map=

    for kind, kv in sections:
        if kind not in _SUPPORTED:
            raise ValueError(
                f"[{kind}] is not a supported darknet section "
                f"(supported: {sorted(_SUPPORTED)})")
        if kind == "net":
            # darknet [net] width/height are independent keys —
            # rectangular nets (a normal AlexeyAB video workflow) are
            # fully supported; every geometry consumer reads
            # ModelConfig.input_hw = (height, width)
            w = int(kv.get("width", 416))
            h = int(kv.get("height", w))
            if w < 1 or h < 1:
                raise ValueError(f"[net] width={w} height={h} must "
                                 f"both be >= 1")
            net_c = int(kv.get("channels", 3))
            if net_c not in (1, 3):
                # darknet's own OpenCV image loader supports exactly
                # c=1 (cv2.IMREAD_GRAYSCALE) and c=3 (IMREAD_COLOR) —
                # any other count errors there too ("OpenCV can't
                # load image with N channels"), so reject at parse
                raise ValueError(
                    f"[net] channels={kv['channels']} is not supported "
                    f"— darknet's image loader handles channels=1 "
                    f"(grayscale, cv2.IMREAD_GRAYSCALE) or channels=3 "
                    f"(RGB) only, and so does this pipeline")
            net_w, net_h = w, h
        elif kind == "convolutional":
            act = kv.get("activation", "logistic")
            if act not in ("leaky", "linear", "mish", "logistic",
                           "swish", "relu", "ramp"):
                raise ValueError(f"unsupported activation '{act}'")
            stride = int(kv.get("stride", 1))
            if stride < 1:
                raise ValueError(f"conv stride must be >= 1, got {stride}")
            if int(kv.get("size", 1)) < 1 or int(kv["filters"]) < 1:
                raise ValueError(
                    f"conv size={kv.get('size', 1)} "
                    f"filters={kv['filters']}: both must be >= 1")
            for sk in ("stride_x", "stride_y"):
                # AlexeyAB per-axis strides: accept only when they
                # agree with `stride` — anisotropic strides would
                # silently mis-build the geometry
                if int(kv.get(sk, stride)) != stride:
                    raise ValueError(
                        f"conv {sk}={kv[sk]} != stride={stride} "
                        f"(anisotropic strides are unsupported)")
            size = int(kv.get("size", 1))
            # darknet: padding = size//2 if pad else explicit `padding`
            # (default 0); the executor supports SAME (size//2) only —
            # reject rather than silently mis-build (a 3x3 conv without
            # pad=1 shifts every activation vs the matching weights)
            padding = (size // 2 if int(kv.get("pad", 0))
                       else int(kv.get("padding", 0)))
            if padding != size // 2:
                raise ValueError(
                    f"conv size={size} with padding={padding} is "
                    f"unsupported (only darknet pad=size//2; add pad=1)")
            cgroups = int(kv.get("groups", 1))
            filters = int(kv["filters"])
            if cgroups < 1 or filters % cgroups:
                raise ValueError(
                    f"conv groups={cgroups} must divide "
                    f"filters={filters}")
            dilation = int(kv.get("dilation", 1))
            if dilation < 1:
                raise ValueError(f"conv dilation={dilation} must be "
                                 f">= 1")
            if size == 1:
                # darknet parse_convolutional: if (size == 1)
                # dilation = 1 — a 1x1 kernel has nothing to dilate
                dilation = 1
            layers.append(Conv(
                filters=filters,
                size=size,
                stride=stride,
                bn=bool(int(kv.get("batch_normalize", 0))),
                act=act,
                groups=cgroups,
                dilation=dilation))
        elif kind == "maxpool":
            # darknet parse_maxpool defaults: stride=1, size=stride —
            # NOT size=2/stride=size (a bare [maxpool] is a stride-1
            # near-identity pool in darknet; the old defaults silently
            # halved the feature map — code-review finding)
            mp_stride = int(kv.get("stride", 1))
            size = int(kv.get("size", mp_stride))
            if size < 1 or mp_stride < 1:
                raise ValueError(
                    f"[maxpool] size={size} stride={mp_stride}: both "
                    f"must be >= 1")
            # darknet's default maxpool padding is size-1 (with the
            # -(pad//2) origin shift) — the convention all three
            # implementations pin. An EXPLICIT different padding would
            # silently mis-build, so reject it loudly.
            if "padding" in kv and int(kv["padding"]) != size - 1:
                raise ValueError(
                    f"[maxpool] padding={kv['padding']} is unsupported "
                    f"(only darknet's default padding=size-1={size - 1} "
                    f"is implemented — see ops/pool.py)")
            for sk in ("stride_x", "stride_y"):
                if int(kv.get(sk, mp_stride)) != mp_stride:
                    raise ValueError(
                        f"[maxpool] {sk}={kv[sk]} != stride="
                        f"{mp_stride} (anisotropic strides are "
                        f"unsupported)")
            layers.append(MaxPool(size=size, stride=mp_stride))
        elif kind == "route":
            rels = tuple(int(v) for v in kv["layers"].split(","))
            groups = int(kv.get("groups", 1))
            group_id = int(kv.get("group_id", 0))
            if groups < 1 or not 0 <= group_id < groups:
                raise ValueError(
                    f"[route] group_id={group_id} out of range for "
                    f"groups={groups}")
            layers.append(Route(rels, groups=groups, group_id=group_id))
        elif kind == "reorg":
            # darknet parse_reorg default stride=1 (every official
            # yolov2 cfg sets stride=2 explicitly)
            if int(kv.get("stride", 1)) < 1:
                raise ValueError(f"[reorg] stride={kv['stride']} must "
                                 f"be >= 1")
            layers.append(Reorg(int(kv.get("stride", 1))))
        elif kind == "shortcut":
            act = kv.get("activation", "linear")
            if act not in ("leaky", "linear"):
                raise ValueError(f"unsupported shortcut activation '{act}'")
            # AlexeyAB weighted shortcuts (scaled-yolov4 csp-x family):
            # weights_type adds learned blend weights to the .weights
            # layout (specs.Shortcut pins layout + forward); per_layer
            # is parser.c's alias for per_feature
            wt = kv.get("weights_type", "none")
            if wt == "per_layer":
                wt = "per_feature"
            if wt not in ("none", "per_feature", "per_channel"):
                raise ValueError(
                    f"[shortcut] weights_type='{wt}' is not a darknet "
                    f"value (none | per_feature | per_layer | "
                    f"per_channel)")
            wn = kv.get("weights_normalization", "none")
            if wn not in ("none", "relu", "softmax"):
                raise ValueError(
                    f"[shortcut] weights_normalization='{wn}' is not a "
                    f"darknet value (none | relu | softmax)")
            if wt == "none" and wn != "none":
                raise ValueError(
                    "[shortcut] weights_normalization without "
                    "weights_type has no weights to normalize")
            layers.append(Shortcut(int(kv["from"]), act=act,
                                   weights_type=wt, weights_norm=wn))
        elif kind == "sam":
            act = kv.get("activation", "linear")
            if act not in ("leaky", "linear"):
                raise ValueError(f"unsupported sam activation '{act}'")
            layers.append(Sam(int(kv["from"]), act=act))
        elif kind == "scale_channels":
            act = kv.get("activation", "linear")
            if act not in ("leaky", "linear", "logistic"):
                raise ValueError(
                    f"unsupported scale_channels activation '{act}'")
            swh = int(kv.get("scale_wh", 0))
            if swh not in (0, 1):
                raise ValueError(
                    f"[scale_channels] scale_wh={swh} (0 = channel SE "
                    f"scaling, 1 = spatial scaling)")
            layers.append(ScaleChannels(int(kv["from"]), scale_wh=swh,
                                        act=act))
        elif kind == "upsample":
            if int(kv.get("stride", 2)) < 1:
                raise ValueError(f"[upsample] stride={kv['stride']} "
                                 f"must be >= 1")
            layers.append(Upsample(int(kv.get("stride", 2)),
                                   scale=float(kv.get("scale", 1.0))))
        elif kind == "avgpool":
            layers.append(AvgPool())
        elif kind == "connected":
            if int(kv.get("batch_normalize", 0)):
                raise ValueError(
                    "[connected] batch_normalize=1 is not supported (no "
                    "official classifier cfg uses it; its weights-file "
                    "order also differs from conv)")
            act = kv.get("activation", "logistic")
            if act not in ("leaky", "linear", "logistic", "relu",
                           "ramp"):
                raise ValueError(
                    f"unsupported connected activation '{act}'")
            if not layers:
                raise ValueError("[connected] cannot be the first layer")
            # spatial inputs (the yolov1 head) get their flattened
            # feature count pinned by _resolve_spatial below
            layers.append(Connected(int(kv["output"]), act=act))
        elif kind == "dropout":
            prob = float(kv.get("probability", 0.5))
            if not 0.0 <= prob < 1.0:
                # p=1 would zero everything and the inverted-dropout
                # 1/(1-p) rescale divides by zero
                raise ValueError(f"[dropout] probability={prob:g} must "
                                 f"be in [0, 1)")
            layers.append(Dropout(prob))
        elif kind == "softmax":
            if int(kv.get("groups", 1)) != 1:
                raise ValueError("[softmax] groups != 1 (grouped "
                                 "softmax) is not supported")
            # darknet9000 classifier hierarchy: [softmax] tree=<file>
            # (the tree is parsed below, once num_classes is known)
            if "tree" in kv:
                tree_file = kv["tree"]
            temp = float(kv.get("temperature", 1.0))
            if temp <= 0:
                raise ValueError(f"[softmax] temperature={temp:g} must "
                                 f"be > 0")
            layers.append(SoftmaxHead(temperature=temp))
        elif kind == "crop":
            ch = int(kv.get("crop_height", 0))
            cw = int(kv.get("crop_width", 0))
            if ch <= 0 or cw <= 0:
                raise ValueError("[crop] needs crop_height and "
                                 "crop_width")
            if layers:
                raise ValueError("[crop] must be the first layer "
                                 "(the yolov1 input layer)")
            # angle/saturation/exposure are GPU-kernel jitter keys
            # darknet's CPU forward ignores — matched by ignoring them;
            # flip and noadjust ARE crop_layer.c CPU semantics
            layers.append(Crop(ch, cw,
                               flip=bool(int(kv.get("flip", 0))),
                               noadjust=bool(int(kv.get("noadjust",
                                                        0)))))
        elif kind == "local":
            act = kv.get("activation", "logistic")
            if act not in ("leaky", "linear", "relu", "ramp",
                           "logistic"):
                raise ValueError(f"unsupported local activation '{act}'")
            if (int(kv.get("filters", 1)) < 1
                    or int(kv.get("size", 1)) < 1
                    or int(kv.get("stride", 1)) < 1):
                raise ValueError("[local] filters/size/stride must all "
                                 "be >= 1")
            layers.append(Local(
                filters=int(kv.get("filters", 1)),
                size=int(kv.get("size", 1)),
                stride=int(kv.get("stride", 1)),
                pad=bool(int(kv.get("pad", 0))),
                act=act))
        elif kind == "detection":
            if saw_detection:
                raise ValueError("multiple [detection] sections")
            saw_detection = True
            num_classes = int(kv.get("classes", 1))
            if int(kv.get("softmax", 0)):
                # darknet's forward would softmax each cell's class
                # block — unimplemented here, so reject rather than
                # silently predict differently (the original
                # yolov1.cfg uses softmax=0; code-review finding)
                raise ValueError("[detection] softmax=1 is not "
                                 "supported (the v1 family is pinned "
                                 "to the softmax=0 forward)")
            # absent keys get darknet's PARSE defaults (parse_detection:
            # every scale 1, coords 1) — the paper lambdas (5/0.5) are
            # what the official cfgs SET, not the parser's fallback
            # (code-review finding; same rule as the [region] block)
            detection_spec = DetectionHead(
                side=int(kv.get("side", 7)),
                num=int(kv.get("num", 1)),
                classes=num_classes,
                sqrt=bool(int(kv.get("sqrt", 0))),
                coords=int(kv.get("coords", 1)),
                rescore=bool(int(kv.get("rescore", 0))),
                object_scale=float(kv.get("object_scale", 1.0)),
                noobject_scale=float(kv.get("noobject_scale", 1.0)),
                class_scale=float(kv.get("class_scale", 1.0)),
                coord_scale=float(kv.get("coord_scale", 1.0)))
            layers.append(detection_spec)
        elif kind == "cost":
            # training-loss marker (classifier cfgs end with it);
            # no forward effect — parsed and dropped
            pass
        elif kind in ("yolo", "gaussian_yolo"):
            gaussian = kind == "gaussian_yolo"
            if gaussian and int(kv.get("new_coords", 0)):
                raise ValueError(
                    "[Gaussian_yolo] with new_coords=1 does not exist "
                    "in darknet — drop one of them")
            # darknet make_yolo_layer: a maskless [yolo] uses ALL
            # num anchors (mask = 0..num-1); kv["mask"] raised a bare
            # KeyError on valid darknet cfgs (code-review finding)
            if "mask" in kv:
                mask = tuple(int(v) for v in kv["mask"].split(","))
            else:
                mask = tuple(range(int(kv.get("num", 1))))
            layers.append(YoloHead(
                mask, scale_xy=float(kv.get("scale_x_y", 1.0)),
                # scaled-yolov4 decode; the preceding conv must carry
                # activation=logistic (validated after the walk)
                new_coords=bool(int(kv.get("new_coords", 0))),
                gaussian=gaussian,
                # per-layer training options (AlexeyAB parses these
                # per [yolo] section); absent keys stay None (unset)
                max_delta=(float(kv["max_delta"])
                           if "max_delta" in kv else None),
                label_smooth_eps=(float(kv["label_smooth_eps"])
                                  if "label_smooth_eps" in kv else None)))
            head_anchors = _parse_anchors(kv, "[yolo]")
            n = len(head_anchors)
            head_classes = int(kv.get("classes", 20))
            if anchors and (head_anchors != anchors
                            or head_classes != num_classes):
                raise ValueError(
                    "[yolo] sections must share one anchors/classes set")
            anchors, num_classes = head_anchors, head_classes
            if any(m < 0 or m >= n for m in mask):
                raise ValueError(f"[yolo] mask {mask} out of range for "
                                 f"num={n} anchors")
            # absent -> darknet's PARSE default 0.5 (parser.c; the
            # official cfgs SET .7 explicitly — falling back to the
            # ModelConfig default 0.7 silently widened the ignore
            # band for parse-default-reliant cfgs; code-review
            # finding)
            it = float(kv.get("ignore_thresh", 0.5))
            if ignore_thresh is not None and it != ignore_thresh:
                raise ValueError(
                    "[yolo] sections must share one ignore_thresh")
            ignore_thresh = it
            il = kv.get("iou_loss", "mse")
            if il not in ("mse", "iou", "giou", "diou", "ciou"):
                raise ValueError(f"unsupported iou_loss '{il}'")
            # iou_normalizer parse default is 0.75 in AlexeyAB's
            # parser.c (official cfgs set 0.07 explicitly); it only
            # bites with the iou-family losses (code-review finding)
            new_loss = (il, float(kv.get("iou_normalizer", 0.75)),
                        float(kv.get("cls_normalizer", 1.0)),
                        float(kv.get("iou_thresh", 1.0)),
                        (float(kv["obj_normalizer"])
                         if "obj_normalizer" in kv else None),
                        bool(int(kv.get("objectness_smooth", 0))),
                        bool(float(kv.get("focal_loss", 0))),
                        float(kv.get("truth_thresh", 1.0)))
            if loss_spec is not None and new_loss != loss_spec:
                raise ValueError("[yolo] sections must share one "
                                 "iou_loss/normalizer/iou_thresh set")
            loss_spec = new_loss
            # AlexeyAB nms_kind: default/greedynms -> greedy IoU NMS;
            # diounms -> DIoU-NMS with beta_nms (box.c box_diounms)
            nk_raw = kv.get("nms_kind", "default")
            if nk_raw not in ("default", "greedynms", "diounms"):
                raise ValueError(f"unsupported nms_kind '{nk_raw}' "
                                 "(default | greedynms | diounms)")
            nk = "diou" if nk_raw == "diounms" else "greedy"
            # beta_nms only means anything under diounms — greedy
            # sections with differing beta values behave identically
            # in darknet and must not be rejected
            new_nms = (nk, float(kv.get("beta_nms", 0.6))
                       if nk == "diou" else 0.6)
            if nms_spec is not None and new_nms != nms_spec:
                raise ValueError("[yolo] sections must share one "
                                 "nms_kind/beta_nms set")
            nms_spec = new_nms
        elif kind == "region":
            if saw_region:
                # last-wins would silently overwrite anchors/thresh/
                # scales and reset tree/map (code-review finding;
                # [detection] already rejects duplicates)
                raise ValueError("multiple [region] sections")
            saw_region = True
            if float(kv.get("focal_loss", 0)):
                raise ValueError(
                    "[region] focal_loss=1 is not supported — the "
                    "region family's class term is pinned to darknet's "
                    "squared-error-on-softmax convention; AlexeyAB's "
                    "focal variant on softmax probabilities has no "
                    "reference source to pin ([yolo] heads DO support "
                    "focal_loss)")
            anchors = _parse_anchors(kv, "[region]")
            num_classes = int(kv.get("classes", 20))
            # [region] thresh is darknet's TRAINING noobj-suppression
            # threshold (NOT the detection confidence — use --conf);
            # it flows to LossConfig.iou_thresh via region_thresh
            # parse_region's default is 0.5 — 0.6 is what the
            # official cfgs SET (code-review finding)
            region_thresh = float(kv.get("thresh", 0.5))
            # training-loss scales + rescore, with darknet's PARSE
            # defaults for absent keys (parser.c parse_region:
            # 1/1/1/1/0 — the official cfgs set 5/…/rescore=1
            # explicitly), so a custom cfg trains exactly as darknet
            # would run it
            region_spec = (float(kv.get("object_scale", 1.0)),
                           float(kv.get("noobject_scale", 1.0)),
                           float(kv.get("class_scale", 1.0)),
                           float(kv.get("coord_scale", 1.0)),
                           bool(int(kv.get("rescore", 0))))
            if not int(kv.get("softmax", 1)):
                # region class probabilities without the softmax
                # (linear class outputs) have no pinned decode/loss
                # semantics here — every published cfg sets softmax=1
                raise ValueError(
                    "[region] softmax=0 is not supported (class "
                    "scores are pinned to darknet's softmax "
                    "convention; delete the key or set softmax=1)")
            if "bias_match" in kv and not int(kv["bias_match"]):
                # darknet bias_match=0 assigns truths to anchors by
                # the LIVE predicted box shape; our GT encoder is
                # static (anchor-shape wh-IoU = bias_match=1). The
                # official yolov2 cfgs all set bias_match=1.
                print("[region] bias_match=0: truth→anchor assignment "
                      "still uses anchor-shape wh-IoU (bias_match=1 "
                      "semantics) — prediction-dependent assignment "
                      "is not supported", file=sys.stderr)
            # YOLO9000: tree=<.tree file> switches the class softmax to
            # one per sibling group; map=<.map file> records the
            # COCO-eval projection (opted into at the predict layer).
            # Paths resolve against the cfg's directory first, then as
            # given (darknet's cwd-relative habit).
            tree_file = kv.get("tree")
            map_file = kv.get("map")

    if not layers:
        raise ValueError(f"{cfg_path}: no layers found")
    softmax_heads = [i for i, l in enumerate(layers)
                     if isinstance(l, SoftmaxHead)]
    if softmax_heads and (saw_region or num_classes is not None):
        raise ValueError(f"{cfg_path}: [softmax] (classifier) cannot be "
                         f"mixed with [region]/[yolo] detection heads")
    if softmax_heads:
        if len(softmax_heads) > 1 or softmax_heads[0] != len(layers) - 1:
            raise ValueError(f"{cfg_path}: exactly one [softmax] as the "
                             f"final layer is supported")
        # classifier num_classes = features into the softmax: walk back
        # over the channel-preserving tail to the last weighted layer
        for l in reversed(layers[:-1]):
            if isinstance(l, Conv):
                num_classes = l.filters
                break
            if isinstance(l, Connected):
                num_classes = l.out
                break
            if not isinstance(l, (AvgPool, Dropout)):
                raise ValueError(
                    f"{cfg_path}: [softmax] must follow a conv/connected "
                    f"output (optionally through avgpool/dropout), "
                    f"found {type(l).__name__}")
        else:
            raise ValueError(f"{cfg_path}: no weighted layer before "
                             f"[softmax]")
    if num_classes is None:
        raise ValueError(f"{cfg_path}: no [region], [yolo], or "
                         f"[softmax] section")

    _validate_refs(layers)   # clear ref errors BEFORE the shape walk
    layers = _resolve_spatial(layers, (net_h, net_w), in_channels=net_c)
    yolo_heads = [(i, l) for i, l in enumerate(layers)
                  if isinstance(l, YoloHead)]
    heads_present = [n for n, flag in (
        ("[region]", saw_region), ("[yolo]", bool(yolo_heads)),
        ("[softmax]", bool(softmax_heads)),
        ("[detection]", saw_detection)) if flag]
    if len(heads_present) > 1:
        raise ValueError(f"{cfg_path}: {' and '.join(heads_present)} "
                         f"sections cannot be mixed")
    if saw_detection:
        if not isinstance(layers[-1], DetectionHead):
            raise ValueError(f"{cfg_path}: [detection] must be the "
                             f"final layer (yolov1 cfgs)")
        d = detection_spec
        need = d.side * d.side * (d.classes + d.num * (1 + d.coords))
        prev = layers[-2] if len(layers) > 1 else None
        if isinstance(prev, Connected) and prev.out != need:
            raise ValueError(
                f"{cfg_path}: the layer before [detection] outputs "
                f"{prev.out} features but side²*(classes+num*(1+coords)) "
                f"= {need}")

    tree = tree_map = None
    if map_file and not tree_file:
        raise ValueError(f"{cfg_path}: [region] map= requires tree= "
                         f"(the map projects onto tree nodes)")
    if tree_file:
        import os as _os

        from yolo_tpu_torch.configs.tree import parse_map, parse_tree

        def _resolve(p: str) -> str:
            local = _os.path.join(_os.path.dirname(cfg_path), p)
            return local if _os.path.exists(local) else p

        tree = parse_tree(_resolve(tree_file))
        if tree.n_nodes != num_classes:
            section = "[softmax]" if softmax_heads else "[region]"
            raise ValueError(
                f"{cfg_path}: {section} head has {num_classes} classes "
                f"but the tree has {tree.n_nodes} nodes — they must "
                f"match (every tree node is a class)")
        if map_file:
            tree_map = parse_map(_resolve(map_file), tree)
        if softmax_heads:
            # the executor applies the per-group softmax, so the head
            # layer itself carries the tree
            layers[-1] = SoftmaxHead(
                tree=tree, temperature=layers[-1].temperature)

    class_names = (load_names(names_path) if names_path
                   else tree.names if tree is not None
                   else tuple(f"class{i}" for i in range(num_classes)))
    if len(class_names) != num_classes:
        raise ValueError(
            f"classes={num_classes} but names file has "
            f"{len(class_names)} entries")

    if yolo_heads:
        # yolov3 family: each [yolo] layer's input conv must emit
        # len(mask)*(5+classes) channels
        for i, head in yolo_heads:
            prev = layers[i - 1] if i else None
            # [Gaussian_yolo] carries 4 extra sigma channels per anchor
            per = (9 if head.gaussian else 5) + num_classes
            expected_out = len(head.mask) * per
            if not isinstance(prev, Conv) or prev.filters != expected_out:
                kindname = "Gaussian_yolo" if head.gaussian else "yolo"
                raise ValueError(
                    f"layer {i - 1}: conv before [{kindname}] "
                    f"mask={head.mask} must output "
                    f"len(mask)*({per - num_classes}+classes)="
                    f"{expected_out} channels, "
                    f"got {getattr(prev, 'filters', prev)}")
            # scaled-yolov4 contract: new_coords heads read values the
            # head conv already passed through logistic; a mismatch
            # either double-sigmoids or decodes raw logits as [0,1]
            if head.new_coords and prev.act != "logistic":
                raise ValueError(
                    f"layer {i}: [yolo] new_coords=1 requires the head "
                    f"conv to use activation=logistic (scaled-yolov4 "
                    f"cfgs), got activation={prev.act}")
            if not head.new_coords and prev.act == "logistic":
                raise ValueError(
                    f"layer {i}: head conv activation=logistic without "
                    f"[yolo] new_coords=1 would double-sigmoid the "
                    f"decode — set new_coords=1 or activation=linear")
        _validate_strides(layers, (net_h, net_w))
    elif softmax_heads or saw_detection:
        pass  # classifier / yolov1: validated above, no region contract
    else:
        expected_out = len(anchors) * (5 + num_classes)
        last = layers[-1]
        if not isinstance(last, Conv) or last.filters != expected_out:
            raise ValueError(
                f"final conv must output num*(5+classes)={expected_out} "
                f"channels, got {getattr(last, 'filters', last)}")

        downsample = 1
        for l in layers:
            if isinstance(l, MaxPool):
                downsample *= l.stride
            elif isinstance(l, Conv):
                downsample *= l.stride
        if downsample != 32:
            # inference derives the grid from the feature shape, but the
            # GT encoder pins grid = input/32 (data/targets.py) — reject
            # rather than silently mis-train
            raise ValueError(
                f"trunk downsample must be 32 for the yolov2 region head, "
                f"got {downsample} (pool/conv strides)")

    import os

    cfg = ModelConfig(
        name=name or os.path.splitext(os.path.basename(cfg_path))[0],
        layers=tuple(layers), anchors=anchors, class_names=class_names,
        input_size=net_h, input_width=None if net_w == net_h else net_w,
        in_channels=net_c)
    import dataclasses

    if ignore_thresh is not None:
        cfg = dataclasses.replace(cfg, ignore_thresh=ignore_thresh)
    if loss_spec is not None:
        cfg = dataclasses.replace(cfg, iou_loss=loss_spec[0],
                                  iou_normalizer=loss_spec[1],
                                  cls_normalizer=loss_spec[2],
                                  assign_iou_thresh=loss_spec[3],
                                  obj_normalizer=loss_spec[4],
                                  objectness_smooth=loss_spec[5],
                                  focal_loss=loss_spec[6],
                                  truth_thresh=loss_spec[7])
    if region_thresh is not None:
        cfg = dataclasses.replace(cfg, region_thresh=region_thresh)
    if region_spec is not None:
        cfg = dataclasses.replace(cfg,
                                  region_object_scale=region_spec[0],
                                  region_noobject_scale=region_spec[1],
                                  region_class_scale=region_spec[2],
                                  region_coord_scale=region_spec[3],
                                  region_rescore=region_spec[4])
    if nms_spec is not None:
        cfg = dataclasses.replace(cfg, nms_kind=nms_spec[0],
                                  beta_nms=nms_spec[1])
    if tree is not None:
        cfg = dataclasses.replace(cfg, tree=tree, tree_map=tree_map,
                                  tree_file=tree_file,
                                  map_file=map_file)
    _audit_cfg_keys(cfg_path, sections)
    return cfg


def _validate_refs(layers: Sequence) -> None:
    """Route/Shortcut indices must resolve to an EARLIER layer: a
    negative resolved index would silently wrap around the outputs list
    (python indexing) and mis-build the graph."""
    for idx, l in enumerate(layers):
        refs = (l.layers if isinstance(l, Route)
                else (l.frm,)
                if isinstance(l, (Shortcut, Sam, ScaleChannels)) else ())
        for r in refs:
            resolved = resolve_route(idx, r)
            if not 0 <= resolved < idx:
                raise ValueError(
                    f"layer {idx}: reference {r} resolves to layer "
                    f"{resolved}, which is not an earlier layer")


def net_training_params(cfg_path: str) -> Dict[str, object]:
    """Training hyperparameters from the cfg (darknet uses the cfg as
    the full training config): [net] learning_rate, momentum, decay,
    burn_in, steps, scales, plus the augmentation keys — [net]
    saturation/exposure/hue/flip/mosaic and the head sections' jitter —
    returned only for keys present, so the CLI can fall back per key
    (explicit flags win)."""
    out: Dict[str, object] = {}
    for kind, kv in parse_cfg(cfg_path):
        if kind == "net":
            for key, cast in (("learning_rate", float),
                              ("momentum", float),
                              ("decay", float), ("burn_in", int),
                              ("ema_alpha", float),
                              ("max_batches", int),
                              # darknet's images-per-iteration and its
                              # gradient-accumulation split; the CLI
                              # uses them as --batch/--grad-accum
                              # defaults
                              ("batch", int),
                              ("subdivisions", int),
                              ("power", float),
                              # policy=step/exp/sigmoid/sgdr keys
                              # (parser.c parse_net_options)
                              ("step", int), ("scale", float),
                              ("gamma", float),
                              ("sgdr_cycle", int), ("sgdr_mult", int),
                              ("learning_rate_min", float),
                              ("letter_box", int),
                              # darknet [net] adam=1 switches the
                              # optimizer; B1/B2/eps are its moments
                              ("adam", int), ("B1", float),
                              ("B2", float), ("eps", float),
                              ("saturation", float), ("exposure", float),
                              ("hue", float), ("flip", int),
                              ("mosaic", int), ("mixup", int),
                              # classifier scale/rotation augmentation
                              # (data.c random_augment_image)
                              ("angle", float), ("aspect", float),
                              ("min_crop", int), ("max_crop", int),
                              # blur/gaussian_noise augmentations
                              ("blur", int),
                              ("gaussian_noise", float)):
                if key in kv:
                    out[key] = cast(kv[key])
            # raw schedule keys + policy; the CLI gates their use
            # (darknet's default policy is CONSTANT, and steps/scales
            # apply only under policy=steps) so explicit flags can
            # still override a broken cfg schedule
            out["policy"] = kv.get("policy", "constant")
            if "steps" in kv:
                out["steps"] = tuple(int(v)
                                     for v in kv["steps"].split(","))
            if "scales" in kv:
                out["scales"] = tuple(float(v)
                                      for v in kv["scales"].split(","))
        elif kind in ("region", "yolo", "gaussian_yolo"):
            # per-head keys: darknet reads them from the LAST layer
            # (detector.c: l = net.layers[net.n-1]; l.random, l.jitter)
            # so later sections OVERWRITE earlier ones
            if "jitter" in kv:
                out["jitter"] = float(kv["jitter"])
            # random enables darknet's multi-scale training (resize
            # net every 10 batches; AlexeyAB also accepts fractional
            # values as a resize-range factor — any value > 0 turns
            # multi-scale on)
            if "random" in kv:
                out["random"] = float(kv["random"])
    return out


def _validate_strides(layers: Sequence, input_hw: Tuple[int, int]) -> None:
    net_h, net_w = input_hw
    strides = layer_strides(layers)
    for idx, l in enumerate(layers):
        if isinstance(l, YoloHead) and (net_h % strides[idx]
                                        or net_w % strides[idx]):
            raise ValueError(
                f"layer {idx}: [yolo] feature stride {strides[idx]} does "
                f"not divide net size {net_w}x{net_h}")


def cfg_to_string(cfg: ModelConfig) -> str:
    """ModelConfig -> darknet .cfg text (inverse of config_from_cfg; the
    companion of io/darknet_weights.save for full darknet round-trip)."""
    out = [f"[net]\nwidth={cfg.input_w}\nheight={cfg.input_h}\n"
           f"channels={cfg.in_channels}\n"]
    anchors = ", ".join(f"{w:g},{h:g}" for w, h in cfg.anchors)
    for l in cfg.layers:
        if isinstance(l, Conv):
            out.append("[convolutional]\n"
                       + ("batch_normalize=1\n" if l.bn else "")
                       + f"filters={l.filters}\nsize={l.size}\n"
                       + (f"groups={l.groups}\n" if l.groups > 1 else "")
                       + (f"dilation={l.dilation}\n"
                          if l.dilation > 1 else "")
                       + f"stride={l.stride}\n"
                       + f"pad={1 if l.size > 1 else 0}\n"
                       + f"activation={l.act}\n")
        elif isinstance(l, MaxPool):
            out.append(f"[maxpool]\nsize={l.size}\nstride={l.stride}\n")
        elif isinstance(l, Route):
            out.append("[route]\nlayers="
                       + ",".join(str(r) for r in l.layers) + "\n"
                       + (f"groups={l.groups}\ngroup_id={l.group_id}\n"
                          if l.groups > 1 else ""))
        elif isinstance(l, Reorg):
            out.append(f"[reorg]\nstride={l.stride}\n")
        elif isinstance(l, Shortcut):
            out.append(f"[shortcut]\nfrom={l.frm}\n"
                       + (f"weights_type={l.weights_type}\n"
                          if l.weights_type != "none" else "")
                       + (f"weights_normalization={l.weights_norm}\n"
                          if l.weights_norm != "none" else "")
                       + f"activation={l.act}\n")
        elif isinstance(l, Sam):
            out.append(f"[sam]\nfrom={l.frm}\nactivation={l.act}\n")
        elif isinstance(l, ScaleChannels):
            out.append(f"[scale_channels]\nfrom={l.frm}\n"
                       + (f"scale_wh=1\n" if l.scale_wh else "")
                       + f"activation={l.act}\n")
        elif isinstance(l, Upsample):
            out.append(f"[upsample]\nstride={l.stride}\n"
                       + (f"scale={l.scale:g}\n"
                          if l.scale != 1.0 else ""))
        elif isinstance(l, AvgPool):
            out.append("[avgpool]\n")
        elif isinstance(l, Connected):
            out.append(f"[connected]\noutput={l.out}\n"
                       f"activation={l.act}\n")
        elif isinstance(l, Dropout):
            out.append(f"[dropout]\nprobability={l.prob:g}\n")
        elif isinstance(l, Crop):
            out.append(f"[crop]\ncrop_height={l.crop_h}\n"
                       f"crop_width={l.crop_w}\n"
                       + (f"flip={int(l.flip)}\n" if l.flip else "")
                       + ("noadjust=1\n" if l.noadjust else ""))
        elif isinstance(l, Local):
            out.append(f"[local]\nfilters={l.filters}\nsize={l.size}\n"
                       f"stride={l.stride}\npad={1 if l.pad else 0}\n"
                       f"activation={l.act}\n")
        elif isinstance(l, DetectionHead):
            out.append(f"[detection]\nclasses={l.classes}\n"
                       f"coords={l.coords}\nside={l.side}\nnum={l.num}\n"
                       f"sqrt={1 if l.sqrt else 0}\n"
                       f"rescore={1 if l.rescore else 0}\n"
                       f"object_scale={l.object_scale:g}\n"
                       f"noobject_scale={l.noobject_scale:g}\n"
                       f"class_scale={l.class_scale:g}\n"
                       f"coord_scale={l.coord_scale:g}\n")
        elif isinstance(l, SoftmaxHead):
            out.append("[softmax]\ngroups=1\n"
                       + (f"temperature={l.temperature:g}\n"
                          if l.temperature != 1.0 else "")
                       + (f"tree={cfg.tree_file}\n"
                          if cfg.tree_file else ""))
        elif isinstance(l, YoloHead):
            out.append(("[Gaussian_yolo]" if l.gaussian else "[yolo]")
                       + "\nmask = "
                       + ",".join(str(m) for m in l.mask) + "\n"
                       + f"anchors = {anchors}\n"
                       + f"classes={cfg.num_classes}\n"
                       + f"num={cfg.num_anchors}\n"
                       + f"ignore_thresh = {cfg.ignore_thresh:g}\n"
                       + (f"scale_x_y = {l.scale_xy:g}\n"
                          if l.scale_xy != 1.0 else "")
                       + ("new_coords=1\n" if l.new_coords else "")
                       + (f"iou_loss={cfg.iou_loss}\n"
                          if cfg.iou_loss != "mse" else "")
                       + (f"iou_normalizer={cfg.iou_normalizer:g}\n"
                          if cfg.iou_normalizer != 1.0 else "")
                       + (f"cls_normalizer={cfg.cls_normalizer:g}\n"
                          if cfg.cls_normalizer != 1.0 else "")
                       + (f"obj_normalizer={cfg.obj_normalizer:g}\n"
                          if cfg.obj_normalizer is not None else "")
                       + (f"iou_thresh={cfg.assign_iou_thresh:g}\n"
                          if cfg.assign_iou_thresh != 1.0 else "")
                       + ("objectness_smooth=1\n"
                          if cfg.objectness_smooth else "")
                       + ("focal_loss=1\n" if cfg.focal_loss else "")
                       + (f"truth_thresh = {cfg.truth_thresh:g}\n"
                          if cfg.truth_thresh != 1.0 else "")
                       + ("nms_kind=diounms\n"
                          if cfg.nms_kind == "diou" else "")
                       + (f"beta_nms={cfg.beta_nms:g}\n"
                          if cfg.nms_kind == "diou"
                          and cfg.beta_nms != 0.6 else "")
                       + (f"max_delta={l.max_delta:g}\n"
                          if l.max_delta is not None else "")
                       + (f"label_smooth_eps={l.label_smooth_eps:g}\n"
                          if l.label_smooth_eps is not None else ""))
    if cfg.head_kind == "region":
        out.append(f"[region]\nanchors = {anchors}\n"
                   f"classes={cfg.num_classes}\nnum={cfg.num_anchors}\n"
                   f"thresh = {cfg.region_thresh:g}\n"
                   # always explicit (darknet's parse defaults differ
                   # from the official-cfg values, so omitting them
                   # would change the parsed training config)
                   f"object_scale={cfg.region_object_scale:g}\n"
                   f"noobject_scale={cfg.region_noobject_scale:g}\n"
                   f"class_scale={cfg.region_class_scale:g}\n"
                   f"coord_scale={cfg.region_coord_scale:g}\n"
                   f"rescore={int(cfg.region_rescore)}\n"
                   f"bias_match=1\nsoftmax=1\n"
                   + (f"tree={cfg.tree_file}\n"
                      if cfg.tree_file else "")
                   + (f"map={cfg.map_file}\n"
                      if cfg.map_file else ""))
    return "\n".join(out)
