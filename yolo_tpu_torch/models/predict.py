"""Frame-in/boxes-out inference (port of yolo_tpu/models/predict.py).

  raw u8 (B, H, W, 3) -> letterbox -> Darknet -> fused head (decode + NMS)
  -> {boxes (B, D, 4) [original-image pixel xyxy], scores, classes, valid}

PyTorch runs eagerly, so there is no jit cache: make_detector returns a
plain function. The compute dtype is the Darknet module's (``net``), and
the letterbox runs in it too.
"""

from __future__ import annotations

from typing import Optional

import torch

from yolo_tpu_torch.configs.specs import ModelConfig
from yolo_tpu_torch.models.graph import Darknet
from yolo_tpu_torch.ops.decode import decode
from yolo_tpu_torch.ops.letterbox import (letterbox, stretch_resize,
                                          unletterbox_boxes_xyxy,
                                          unstretch_boxes_xyxy)
from yolo_tpu_torch.ops.nms import nms_batch


def forward(cfg: ModelConfig, net: Darknet,
            images_01: torch.Tensor) -> torch.Tensor:
    """Preprocessed (B, S, S, 3) [0, 1] -> raw head logits (fp32). The
    convs run through F.conv2d; the fused conv kernel is ROADMAP B2."""
    return net(images_01)


def detect(cfg: ModelConfig, net: Darknet, images_01: torch.Tensor, *,
           conf_threshold: Optional[float] = None,
           nms_threshold: Optional[float] = None,
           top_k: int = 128, max_detections: int = 100,
           nms_impl: str = "auto", head: str = "auto"):
    """Preprocessed images -> fixed-shape detections (net-space xywh).

    head="fused" runs the objectness-prefiltered decode + NMS
    (ops/head.py, exact at production thresholds, the CUDA default);
    head="reference" runs full decode + per-class NMS."""
    logits = forward(cfg, net, images_01)
    return _postprocess(cfg, logits, conf_threshold=conf_threshold,
                        nms_threshold=nms_threshold, top_k=top_k,
                        max_detections=max_detections, nms_impl=nms_impl,
                        head=head)


def _postprocess(cfg: ModelConfig, logits: torch.Tensor, *,
                 conf_threshold: Optional[float] = None,
                 nms_threshold: Optional[float] = None,
                 top_k: int = 128, max_detections: int = 100,
                 nms_impl: str = "auto", head: str = "auto"):
    conf_t = cfg.conf_threshold if conf_threshold is None else conf_threshold
    iou_t = cfg.nms_threshold if nms_threshold is None else nms_threshold
    on_cuda = logits.device.type == "cuda"
    if head == "auto":
        # fused heads are exact only while few boxes clear the
        # threshold; at PR-curve thresholds take the reference path
        head = "fused" if on_cuda and conf_t >= 0.1 else "reference"
    if head == "fused":
        from yolo_tpu_torch.ops.head import detect_head

        # prefilter budget: top_k suffices at high thresholds; near the
        # exactness boundary spend 2x so the objectness cut can't drop
        # passing boxes
        pre = top_k if conf_t >= 0.3 else 2 * top_k
        return detect_head(
            logits, cfg.anchors, cfg.num_classes,
            conf_threshold=conf_t, iou_threshold=iou_t,
            pre_top_k=pre, max_detections=max_detections,
            use_kernel=on_cuda, nms_kind=cfg.nms_kind,
            beta_nms=cfg.beta_nms)
    if head != "reference":
        raise ValueError(f"unknown head {head!r} (auto | fused | reference)")
    boxes, scores = decode(logits, cfg.anchors, cfg.num_classes)
    return nms_batch(
        boxes, scores, conf_threshold=conf_t, iou_threshold=iou_t,
        top_k=top_k, max_detections=max_detections, impl=nms_impl,
        kind=cfg.nms_kind, beta=cfg.beta_nms)


def detect_raw(cfg: ModelConfig, net: Darknet, images_u8: torch.Tensor, *,
               entry: str = "auto", resize: str = "letterbox", **kw):
    """Raw RGB (B, H, W, 3) uint8 -> detections with boxes mapped back to
    original-image pixel xyxy.

    resize="stretch" is the aspect-ignoring bilinear resize (AlexeyAB
    letter_box=0); "letterbox" (default) matches pjreddie darknet."""
    if entry == "fused":
        raise NotImplementedError(
            "entry='fused' needs the fused entry kernel, which is not "
            "ported yet (ROADMAP B3)")
    if entry != "auto":
        raise ValueError(f"unknown entry {entry!r} (auto | fused)")
    _, h, w, _ = images_u8.shape
    if resize == "stretch":
        x = stretch_resize(images_u8, cfg.input_hw, dtype=net.compute_dtype)
        dets = detect(cfg, net, x, **kw)
        dets["boxes"] = unstretch_boxes_xyxy(dets["boxes"], src_h=h, src_w=w)
        return dets
    if resize != "letterbox":
        raise ValueError(f"unknown resize {resize!r} (letterbox | stretch)")
    x = letterbox(images_u8, cfg.input_hw, dtype=net.compute_dtype)
    dets = detect(cfg, net, x, **kw)
    dets["boxes"] = unletterbox_boxes_xyxy(
        dets["boxes"], src_h=h, src_w=w, net_size=cfg.input_hw)
    return dets


def make_detector(cfg: ModelConfig, *,
                  conf_threshold: Optional[float] = None,
                  nms_threshold: Optional[float] = None,
                  top_k: int = 128, max_detections: int = 100,
                  nms_impl: str = "auto", head: str = "auto",
                  entry: str = "auto", resize: str = "letterbox"):
    """Raw-RGB detector: ``fn(net, images_u8) -> detections``."""
    def fn(net: Darknet, images_u8: torch.Tensor):
        return detect_raw(cfg, net, images_u8,
                          conf_threshold=conf_threshold,
                          nms_threshold=nms_threshold, top_k=top_k,
                          max_detections=max_detections, nms_impl=nms_impl,
                          head=head, entry=entry, resize=resize)
    return fn
