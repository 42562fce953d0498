"""The built-in detector variants (port of yolo_tpu/configs/variants.py).
Topologies and anchors are pinned by the darknet cfg files the weights
come from: yolov2-tiny-voc.cfg, yolov2-voc.cfg, yolov2.cfg (COCO) and
yolov2-tiny.cfg (COCO) for the [region] head; yolov3.cfg,
yolov3-spp.cfg, yolov3-tiny.cfg, yolov4.cfg and yolov4-tiny.cfg for the
[yolo] heads, whose layer lists give the official .weights byte counts
exactly; darknet19.cfg, darknet19_448.cfg and darknet53.cfg for the
darknet classifiers."""

from __future__ import annotations

from typing import Optional

from yolo_tpu_torch.configs.names import COCO_NAMES, VOC_NAMES
from yolo_tpu_torch.configs.specs import (AvgPool, Connected, Conv,
                                          MaxPool, ModelConfig, Reorg,
                                          Route, Shortcut, SoftmaxHead,
                                          Upsample, YoloHead)

# anchors in 13x13-cell units
TINY_VOC_ANCHORS = (
    (1.08, 1.19), (3.42, 4.41), (6.63, 11.38), (9.42, 5.11), (16.62, 10.52),
)
VOC_ANCHORS = (
    (1.3221, 1.73145), (3.19275, 4.00944), (5.05587, 8.09892),
    (9.47112, 4.84053), (11.2364, 10.0071),
)
COCO_ANCHORS = (
    (0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
    (7.88282, 3.52778), (9.77052, 9.16828),
)


def _tiny_yolov2_layers(num_out: int, head_filters: int):
    """yolov2-tiny-voc.cfg / yolov2-tiny.cfg: 6x (conv3x3 + maxpool),
    pool #6 stride 1, conv 1024, conv ``head_filters`` (1024 for VOC, 512
    for COCO), final 1x1 linear conv."""
    return (
        Conv(16), MaxPool(2, 2),
        Conv(32), MaxPool(2, 2),
        Conv(64), MaxPool(2, 2),
        Conv(128), MaxPool(2, 2),
        Conv(256), MaxPool(2, 2),
        Conv(512), MaxPool(2, 1),   # stride-1 pool, padded at the end
        Conv(1024),
        Conv(head_filters),
        Conv(num_out, size=1, bn=False, act="linear"),
    )


def _yolov2_layers(num_out: int):
    """yolov2.cfg: Darknet-19 backbone (18 convs) + passthrough head.
    Each entry is one darknet layer, so the route offsets are the cfg's:
    route -9 -> the 26x26x512 conv output; route (-1, -4) ->
    concat(reorg, conv1024) in listed order."""
    return (
        Conv(32), MaxPool(),                                   # 0-1
        Conv(64), MaxPool(),                                   # 2-3
        Conv(128), Conv(64, 1), Conv(128), MaxPool(),          # 4-7
        Conv(256), Conv(128, 1), Conv(256), MaxPool(),         # 8-11
        Conv(512), Conv(256, 1), Conv(512), Conv(256, 1),      # 12-15
        Conv(512),                                             # 16 (26x26x512)
        MaxPool(),                                             # 17
        Conv(1024), Conv(512, 1), Conv(1024), Conv(512, 1),    # 18-21
        Conv(1024),                                            # 22
        Conv(1024), Conv(1024),                                # 23-24 head
        Route((-9,)),                                          # 25 -> 16
        Conv(64, 1),                                           # 26
        Reorg(2),                                              # 27
        Route((-1, -4)),                                       # 28 -> (27, 24)
        Conv(1024),                                            # 29
        Conv(num_out, size=1, bn=False, act="linear"),         # 30
    )


# ---------------------------------------------------------------------------
# yolov3 family (multi-scale [yolo] heads; anchors in net-input pixels)
# ---------------------------------------------------------------------------

YOLOV3_ANCHORS = (
    (10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
    (116, 90), (156, 198), (373, 326),
)
YOLOV3_TINY_ANCHORS = (
    (10, 14), (23, 27), (37, 58), (81, 82), (135, 169), (344, 319),
)


def _res_block(ch: int):
    """Darknet-53 residual block: 1x1 half-width, 3x3, shortcut -3."""
    return (Conv(ch // 2, 1), Conv(ch), Shortcut(-3))


def _yolov3_layers(num_out: int):
    """yolov3.cfg: Darknet-53 (stride-2 convs, residual stages of
    1/2/8/8/4 blocks) + 3-scale FPN head. Layer indices are darknet's;
    route -1,61 and -1,36 reach the 512- and 256-stage tails."""
    layers = [
        Conv(32),                       # 0
        Conv(64, stride=2),             # 1
        *_res_block(64),                # 2-4
        Conv(128, stride=2),            # 5
        *_res_block(128), *_res_block(128),          # 6-11
        Conv(256, stride=2),            # 12
    ]
    for _ in range(8):
        layers += _res_block(256)       # 13-36 (tail: 36)
    layers.append(Conv(512, stride=2))  # 37
    for _ in range(8):
        layers += _res_block(512)       # 38-61 (tail: 61)
    layers.append(Conv(1024, stride=2))  # 62
    for _ in range(4):
        layers += _res_block(1024)      # 63-74
    layers += [
        Conv(512, 1), Conv(1024), Conv(512, 1),      # 75-77
        Conv(1024), Conv(512, 1), Conv(1024),        # 78-80
        Conv(num_out, size=1, bn=False, act="linear"),  # 81
        YoloHead((6, 7, 8)),            # 82 (stride 32)
        Route((-4,)),                   # 83 -> 79
        Conv(256, 1),                   # 84
        Upsample(2),                    # 85
        Route((-1, 61)),                # 86 -> concat(85, 61) = 768ch
        Conv(256, 1), Conv(512), Conv(256, 1),       # 87-89
        Conv(512), Conv(256, 1), Conv(512),          # 90-92
        Conv(num_out, size=1, bn=False, act="linear"),  # 93
        YoloHead((3, 4, 5)),            # 94 (stride 16)
        Route((-4,)),                   # 95 -> 91
        Conv(128, 1),                   # 96
        Upsample(2),                    # 97
        Route((-1, 36)),                # 98 -> concat(97, 36) = 384ch
        Conv(128, 1), Conv(256), Conv(128, 1),       # 99-101
        Conv(256), Conv(128, 1), Conv(256),          # 102-104
        Conv(num_out, size=1, bn=False, act="linear"),  # 105
        YoloHead((0, 1, 2)),            # 106 (stride 8)
    ]
    return tuple(layers)


def _yolov3_tiny_layers(num_out: int):
    """yolov3-tiny.cfg: the tiny conv/pool trunk (stride-1 pool #6) +
    2-scale head. The second [yolo] mask is (1, 2, 3), the official
    cfg's (anchor 0 unused)."""
    return (
        Conv(16), MaxPool(2, 2),        # 0-1
        Conv(32), MaxPool(2, 2),        # 2-3
        Conv(64), MaxPool(2, 2),        # 4-5
        Conv(128), MaxPool(2, 2),       # 6-7
        Conv(256), MaxPool(2, 2),       # 8-9
        Conv(512), MaxPool(2, 1),       # 10-11 (stride-1 pool)
        Conv(1024),                     # 12
        Conv(256, 1),                   # 13
        Conv(512),                      # 14
        Conv(num_out, size=1, bn=False, act="linear"),  # 15
        YoloHead((3, 4, 5)),            # 16 (stride 32)
        Route((-4,)),                   # 17 -> 13
        Conv(128, 1),                   # 18
        Upsample(2),                    # 19
        Route((-1, 8)),                 # 20 -> concat(19, 8) = 384ch
        Conv(256),                      # 21
        Conv(num_out, size=1, bn=False, act="linear"),  # 22
        YoloHead((1, 2, 3)),            # 23 (stride 16)
    )


def _yolov3_spp_layers(num_out: int):
    """yolov3-spp.cfg: yolov3 with an SPP block after convs 75-77: the
    stride-1 5/9/13 maxpools concatenated with their input by route
    -1,-3,-5,-6 (pool13, pool9, pool5, conv77: 2048 channels), then one
    extra 512 1x1 conv. The absolute routes 61 and 36 are unchanged."""
    base = list(_yolov3_layers(num_out))
    head = base[:78]                    # 0-74 backbone + convs 75-77
    head += [
        MaxPool(5, 1),                  # 78
        Route((-2,)),                   # 79 -> 77
        MaxPool(9, 1),                  # 80
        Route((-4,)),                   # 81 -> 77
        MaxPool(13, 1),                 # 82
        Route((-1, -3, -5, -6)),        # 83 -> concat(82, 80, 78, 77)
        Conv(512, 1),                   # 84
    ]
    head += base[78:]
    return tuple(head)


def _csp_block(ch: int):
    """yolov4-tiny CSP block: conv ch; grouped half; two ch/2 convs;
    partial concat; 1x1 transition; full concat."""
    return (
        Conv(ch),                                  # +0
        Route((-1,), groups=2, group_id=1),        # +1 (ch/2)
        Conv(ch // 2),                             # +2
        Conv(ch // 2),                             # +3
        Route((-1, -2)),                           # +4 (ch)
        Conv(ch, 1),                               # +5
        Route((-6, -1)),                           # +6 (2*ch)
    )


def _yolov4_tiny_layers(num_out: int):
    """yolov4-tiny.cfg: CSPOSANet backbone + 2-scale head, scale_x_y
    1.05; the second [yolo] mask is (1, 2, 3) as in yolov3-tiny."""
    return (
        Conv(32, stride=2), Conv(64, stride=2),    # 0-1
        *_csp_block(64),                           # 2-8
        MaxPool(2, 2),                             # 9
        *_csp_block(128),                          # 10-16
        MaxPool(2, 2),                             # 17
        *_csp_block(256),                          # 18-24
        MaxPool(2, 2),                             # 25
        Conv(512),                                 # 26
        Conv(256, 1),                              # 27
        Conv(512),                                 # 28
        Conv(num_out, size=1, bn=False, act="linear"),  # 29
        YoloHead((3, 4, 5), scale_xy=1.05),        # 30 (stride 32)
        Route((-4,)),                              # 31 -> 27
        Conv(128, 1),                              # 32
        Upsample(2),                               # 33
        Route((-1, 23)),                           # 34 -> concat(33, 23)
        Conv(256),                                 # 35
        Conv(num_out, size=1, bn=False, act="linear"),  # 36
        YoloHead((1, 2, 3), scale_xy=1.05),        # 37 (stride 16)
    )


YOLOV4_ANCHORS = (
    (12, 16), (19, 36), (40, 28), (36, 75), (76, 55), (72, 146),
    (142, 110), (192, 243), (459, 401),
)


def _csp_stage(c: int, n: int, first: bool = False):
    """CSPDarknet53 stage: stride-2 downsample, 1x1 split pair (via
    route -2), n residual blocks on one branch, 1x1 post, cross-stage
    concat, 1x1 transition. Stage 1 keeps full-width splits with a
    32-channel bottleneck."""
    split = c if first else c // 2
    block_in = 32 if first else c // 2
    layers = [
        Conv(c, stride=2, act="mish"),
        Conv(split, 1, act="mish"),          # split a
        Route((-2,)),
        Conv(split, 1, act="mish"),          # split b
    ]
    for _ in range(n):
        layers += [Conv(block_in, 1, act="mish"),
                   Conv(split, 3, act="mish"),
                   Shortcut(-3)]
    layers += [Conv(split, 1, act="mish"),
               Route((-1, -(3 * n + 4))),
               Conv(c, 1, act="mish")]
    return layers


def _yolov4_layers(num_out: int):
    """yolov4.cfg: CSPDarknet53 (mish) + SPP + PANet (leaky), 3-scale
    head with scale_x_y 1.2/1.1/1.05 and masks in small-to-large order.
    The backbone taps (54, 85) are the cfg's absolute routes."""
    L = [Conv(32, act="mish")]
    L += _csp_stage(64, 1, first=True)
    L += _csp_stage(128, 2)
    L += _csp_stage(256, 8)
    p3 = len(L) - 1                          # 54: stride-8 x 256 tap
    L += _csp_stage(512, 8)
    p4 = len(L) - 1                          # 85: stride-16 x 512 tap
    L += _csp_stage(1024, 4)

    L += [Conv(512, 1), Conv(1024), Conv(512, 1)]
    L += [MaxPool(5, 1), Route((-2,)), MaxPool(9, 1), Route((-4,)),
          MaxPool(13, 1), Route((-1, -3, -5, -6))]       # SPP
    L += [Conv(512, 1), Conv(1024), Conv(512, 1)]
    o5 = len(L) - 1                          # stride-32 x 512
    L += [Conv(256, 1), Upsample(2), Route((p4,)), Conv(256, 1),
          Route((-1, -3))]
    L += [Conv(256, 1), Conv(512), Conv(256, 1), Conv(512), Conv(256, 1)]
    o4p = len(L) - 1                         # stride-16 x 256
    L += [Conv(128, 1), Upsample(2), Route((p3,)), Conv(128, 1),
          Route((-1, -3))]
    L += [Conv(128, 1), Conv(256), Conv(128, 1), Conv(256), Conv(128, 1)]
    L += [Conv(256), Conv(num_out, size=1, bn=False, act="linear"),
          YoloHead((0, 1, 2), scale_xy=1.2)]             # stride 8
    L += [Route((-4,)), Conv(256, stride=2), Route((-1, o4p))]
    L += [Conv(256, 1), Conv(512), Conv(256, 1), Conv(512), Conv(256, 1)]
    L += [Conv(512), Conv(num_out, size=1, bn=False, act="linear"),
          YoloHead((3, 4, 5), scale_xy=1.1)]             # stride 16
    L += [Route((-4,)), Conv(512, stride=2), Route((-1, o5))]
    L += [Conv(512, 1), Conv(1024), Conv(512, 1), Conv(1024),
          Conv(512, 1)]
    L += [Conv(1024), Conv(num_out, size=1, bn=False, act="linear"),
          YoloHead((6, 7, 8), scale_xy=1.05)]            # stride 32
    return tuple(L)


VARIANTS = {
    "tiny-voc": ModelConfig(
        name="tiny-yolov2-voc", layers=_tiny_yolov2_layers(5 * 25, 1024),
        anchors=TINY_VOC_ANCHORS, class_names=VOC_NAMES),
    "voc": ModelConfig(
        name="yolov2-voc", layers=_yolov2_layers(5 * 25),
        anchors=VOC_ANCHORS, class_names=VOC_NAMES),
    "coco": ModelConfig(
        name="yolov2-coco", layers=_yolov2_layers(5 * 85),
        anchors=COCO_ANCHORS, class_names=COCO_NAMES),
    "tiny-coco": ModelConfig(
        name="tiny-yolov2-coco", layers=_tiny_yolov2_layers(5 * 85, 512),
        anchors=COCO_ANCHORS, class_names=COCO_NAMES),
    "yolov3": ModelConfig(
        name="yolov3-coco", layers=_yolov3_layers(3 * 85),
        anchors=YOLOV3_ANCHORS, class_names=COCO_NAMES, input_size=416),
    "yolov3-spp": ModelConfig(
        name="yolov3-spp-coco", layers=_yolov3_spp_layers(3 * 85),
        anchors=YOLOV3_ANCHORS, class_names=COCO_NAMES, input_size=608),
    "yolov3-tiny": ModelConfig(
        name="yolov3-tiny-coco", layers=_yolov3_tiny_layers(3 * 85),
        anchors=YOLOV3_TINY_ANCHORS, class_names=COCO_NAMES,
        input_size=416),
    "yolov4": ModelConfig(
        name="yolov4-coco", layers=_yolov4_layers(3 * 85),
        anchors=YOLOV4_ANCHORS, class_names=COCO_NAMES, input_size=608,
        # yolov4.cfg [yolo] training keys
        iou_loss="ciou", iou_normalizer=0.07, assign_iou_thresh=0.213),
    "yolov4-tiny": ModelConfig(
        name="yolov4-tiny-coco", layers=_yolov4_tiny_layers(3 * 85),
        anchors=YOLOV3_TINY_ANCHORS, class_names=COCO_NAMES,
        input_size=416, iou_loss="ciou", iou_normalizer=0.07),
}


# darknet classifiers, the pretrained-backbone sources (darknet19 is
# yolov2's trunk, darknet53 yolov3's; `partial` cuts the .conv.NN
# initialization files from them). ImageNet-1k placeholder labels:
# --names gives the real list (darknet's imagenet.shortnames.list).
IMAGENET_PLACEHOLDER_NAMES = tuple(f"imagenet_{i:04d}" for i in range(1000))


def _darknet19_layers():
    """darknet19.cfg: yolov2's trunk (its first 18 convs, which is what
    lets darknet19_448.conv.23 start a yolov2 fine-tune) + a 1x1
    conv-1000 head, global avgpool, softmax."""
    return (
        Conv(32), MaxPool(),
        Conv(64), MaxPool(),
        Conv(128), Conv(64, 1), Conv(128), MaxPool(),
        Conv(256), Conv(128, 1), Conv(256), MaxPool(),
        Conv(512), Conv(256, 1), Conv(512), Conv(256, 1), Conv(512),
        MaxPool(),
        Conv(1024), Conv(512, 1), Conv(1024), Conv(512, 1), Conv(1024),
        Conv(1000, size=1, bn=False, act="linear"),
        AvgPool(),
        SoftmaxHead(),
    )


def _darknet53_layers():
    """darknet53.cfg: yolov3's backbone (52 convs, residual stages of
    1/2/8/8/4, the layers darknet53.conv.74 holds) + global avgpool, a
    1000-way [connected], softmax."""
    return tuple(_yolov3_layers(255)[:75]) + (
        AvgPool(), Connected(1000, act="linear"), SoftmaxHead())


VARIANTS.update({
    # the net sizes of darknet19.cfg, darknet19_448.cfg (the
    # 448-finetuned classifier) and darknet53.cfg
    "darknet19": ModelConfig(
        name="darknet19", layers=_darknet19_layers(), anchors=(),
        class_names=IMAGENET_PLACEHOLDER_NAMES, input_size=256),
    "darknet19-448": ModelConfig(
        name="darknet19-448", layers=_darknet19_layers(), anchors=(),
        class_names=IMAGENET_PLACEHOLDER_NAMES, input_size=448),
    "darknet53": ModelConfig(
        name="darknet53", layers=_darknet53_layers(), anchors=(),
        class_names=IMAGENET_PLACEHOLDER_NAMES, input_size=256),
})

# the variants under the JAX package's names
TINY_YOLOV2_VOC = VARIANTS["tiny-voc"]
YOLOV2_VOC = VARIANTS["voc"]
YOLOV2_COCO = VARIANTS["coco"]
TINY_YOLOV2_COCO = VARIANTS["tiny-coco"]
YOLOV3_COCO = VARIANTS["yolov3"]
YOLOV3_SPP_COCO = VARIANTS["yolov3-spp"]
YOLOV3_TINY_COCO = VARIANTS["yolov3-tiny"]
YOLOV4_COCO = VARIANTS["yolov4"]
YOLOV4_TINY_COCO = VARIANTS["yolov4-tiny"]
DARKNET19 = VARIANTS["darknet19"]
DARKNET19_448 = VARIANTS["darknet19-448"]
DARKNET53 = VARIANTS["darknet53"]

# the layer builders by family, for configs that keep a variant's
# topology with another class count (a VOC fine-tune of a COCO model)
LAYER_BUILDERS = {
    "yolov3": _yolov3_layers, "yolov3-spp": _yolov3_spp_layers,
    "yolov3-tiny": _yolov3_tiny_layers, "yolov4": _yolov4_layers,
    "yolov4-tiny": _yolov4_tiny_layers,
}


def get_variant(name: str, input_size: Optional[int] = None) -> ModelConfig:
    if name not in VARIANTS:
        raise KeyError(f"unknown variant {name!r} (ported: "
                       f"{', '.join(VARIANTS)})")
    cfg = VARIANTS[name]
    if input_size is not None:
        cfg = cfg.with_input_size(input_size)
    return cfg
