"""The yolov2-family variants (port of yolo_tpu/configs/variants.py,
region-head detectors). Topologies and anchors are pinned by the darknet
cfg files the weights come from: yolov2-tiny-voc.cfg, yolov2-voc.cfg,
yolov2.cfg (COCO) and yolov2-tiny.cfg (COCO)."""

from __future__ import annotations

from typing import Optional

from yolo_tpu_torch.configs.names import COCO_NAMES, VOC_NAMES
from yolo_tpu_torch.configs.specs import (Conv, MaxPool, ModelConfig, Reorg,
                                          Route)

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
}


def get_variant(name: str, input_size: Optional[int] = None) -> ModelConfig:
    if name not in VARIANTS:
        raise NotImplementedError(
            f"variant {name!r} is not ported yet (ported: "
            f"{', '.join(VARIANTS)}; the yolov3/v4 family is ROADMAP A8, "
            f"classifiers A10)")
    cfg = VARIANTS[name]
    if input_size is not None:
        cfg = cfg.with_input_size(input_size)
    return cfg
