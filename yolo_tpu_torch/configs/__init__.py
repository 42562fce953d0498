from yolo_tpu_torch.configs.names import COCO_NAMES, VOC_NAMES
from yolo_tpu_torch.configs.specs import (AvgPool, Connected, Conv, Dropout,
                                          LayerSpec, MaxPool, ModelConfig,
                                          Reorg, Route, Sam, ScaleChannels,
                                          Shortcut, SoftmaxHead, Upsample,
                                          YoloHead, conv_specs,
                                          layer_strides, resolve_route,
                                          weighted_specs)
from yolo_tpu_torch.configs.variants import (TINY_YOLOV2_VOC, VARIANTS,
                                             YOLOV2_COCO, YOLOV2_VOC,
                                             get_variant)

__all__ = [
    "COCO_NAMES", "VOC_NAMES", "AvgPool", "Connected", "Conv", "Dropout",
    "LayerSpec", "MaxPool", "ModelConfig", "Reorg", "Route", "Sam",
    "ScaleChannels", "Shortcut", "SoftmaxHead", "Upsample", "YoloHead",
    "conv_specs", "layer_strides", "resolve_route", "weighted_specs",
    "TINY_YOLOV2_VOC", "VARIANTS", "YOLOV2_COCO", "YOLOV2_VOC",
    "get_variant",
]
