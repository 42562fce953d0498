from yolo_tpu_torch.configs.names import COCO_NAMES, VOC_NAMES
from yolo_tpu_torch.configs.specs import (Conv, LayerSpec, MaxPool,
                                          ModelConfig, Reorg, Route,
                                          Shortcut, Upsample, YoloHead,
                                          layer_strides, resolve_route,
                                          weighted_specs)
from yolo_tpu_torch.configs.variants import VARIANTS, get_variant

__all__ = [
    "COCO_NAMES", "VOC_NAMES", "Conv", "LayerSpec", "MaxPool", "ModelConfig",
    "Reorg", "Route", "Shortcut", "Upsample", "YoloHead", "layer_strides",
    "resolve_route", "weighted_specs", "VARIANTS", "get_variant",
]
