"""Frame-in/boxes-out inference (port of yolo_tpu/models/predict.py).

  raw u8 (B, H, W, 3) -> letterbox -> Darknet -> fused head (decode + NMS)
  -> {boxes (B, D, 4) [original-image pixel xyxy], scores, classes, valid}

PyTorch runs eagerly, so there is no jit cache: make_detector returns a
plain function. The compute dtype is the Darknet module's (``net``), and
the letterbox runs in it too.

yolov1 models ([detection]) decode their flat head (decode_detection)
on the reference route only: head="fused" raises, as in the JAX package.

YOLO9000 tree models ([region] tree=) decode through the hierarchy:
the greedy traversal (hier_thresh) or, with use_tree_map, the [region]
map= projection; the fused route runs ops/head.py::detect_head_tree.

Two routes reach the fused kernels, as in the JAX package:
``detect_raw(..., conv_impl="cuda")`` sends the eligible convs through
the fused conv kernel, and ``entry="fused"`` replaces letterbox + conv1
+ pool1 with the fused entry kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from yolo_tpu_torch.configs.specs import (ModelConfig, Route, Sam,
                                          ScaleChannels, Shortcut)
from yolo_tpu_torch.models.graph import Darknet
from yolo_tpu_torch.ops import entry as entry_ops
from yolo_tpu_torch.ops.cuda import entry_kernel
from yolo_tpu_torch.ops.decode import decode, decode_detection, decode_yolo
from yolo_tpu_torch.ops.letterbox import (letterbox, stretch_resize,
                                          unletterbox_boxes_xyxy,
                                          unstretch_boxes_xyxy)
from yolo_tpu_torch.ops.nms import nms_batch


def forward(cfg: ModelConfig, net: Darknet, images_01: torch.Tensor, *,
            conv_impl: str = "torch"):
    """Preprocessed (B, S, S, 3) [0, 1] -> raw head logits (fp32; a
    tuple, one per head, for [yolo] heads).
    conv_impl="torch" runs every conv through F.conv2d; "cuda" runs the
    eligible ones through the fused conv kernel (Darknet.forward)."""
    return net(images_01, conv_impl=conv_impl)


def detect(cfg: ModelConfig, net: Darknet, images_01: torch.Tensor, *,
           conf_threshold: Optional[float] = None,
           nms_threshold: Optional[float] = None,
           top_k: int = 128, max_detections: int = 100,
           nms_impl: str = "auto", head: str = "auto",
           conv_impl: str = "torch", use_tree_map: bool = False,
           hier_thresh: Optional[float] = None):
    """Preprocessed images -> fixed-shape detections (net-space xywh).

    head="fused" runs the objectness-prefiltered decode + NMS
    (ops/head.py, exact at production thresholds, the CUDA default);
    head="reference" runs full decode + per-class NMS. conv_impl: see
    forward. use_tree_map / hier_thresh: YOLO9000 tree models only (the
    map projection, or the traversal's threshold; None is the
    config's)."""
    logits = forward(cfg, net, images_01, conv_impl=conv_impl)
    return _postprocess(cfg, logits, conf_threshold=conf_threshold,
                        nms_threshold=nms_threshold, top_k=top_k,
                        max_detections=max_detections, nms_impl=nms_impl,
                        head=head, use_tree_map=use_tree_map,
                        hier_thresh=hier_thresh)


def _postprocess(cfg: ModelConfig, logits, *,
                 conf_threshold: Optional[float] = None,
                 nms_threshold: Optional[float] = None,
                 top_k: int = 128, max_detections: int = 100,
                 nms_impl: str = "auto", head: str = "auto",
                 use_tree_map: bool = False,
                 hier_thresh: Optional[float] = None):
    conf_t = cfg.conf_threshold if conf_threshold is None else conf_threshold
    iou_t = cfg.nms_threshold if nms_threshold is None else nms_threshold
    if use_tree_map and cfg.tree_map is None:
        raise ValueError("use_tree_map=True but the model has no "
                         "[region] map= projection")
    hier = cfg.hier_thresh if hier_thresh is None else hier_thresh
    tree_map = cfg.tree_map if use_tree_map else None
    yolo = cfg.head_kind == "yolo"
    on_cuda = (logits[0] if yolo else logits).device.type == "cuda"
    if head == "auto":
        # fused heads are exact only while few boxes clear the
        # threshold; at PR-curve thresholds take the reference path
        head = ("fused" if on_cuda and conf_t >= 0.1
                and cfg.head_kind != "detection" else "reference")
    if head not in ("fused", "reference"):
        raise ValueError(f"unknown head {head!r} (auto | fused | reference)")
    if cfg.head_kind == "detection":
        # a 7x7*num candidate set: a fused prefilter has nothing to save
        if head == "fused":
            raise ValueError("head='fused' does not support yolov1 "
                             "[detection] models")
        boxes, scores = decode_detection(logits, cfg.detection_head)
        return nms_batch(
            boxes, scores, conf_threshold=conf_t, iou_threshold=iou_t,
            top_k=top_k, max_detections=max_detections, impl=nms_impl,
            kind=cfg.nms_kind, beta=cfg.beta_nms)
    # prefilter budget of the fused heads: top_k suffices at high
    # thresholds; near the exactness boundary spend 2x so the objectness
    # cut can't drop passing boxes
    pre = top_k if conf_t >= 0.3 else 2 * top_k
    if yolo:
        masks = [h.mask for h in cfg.yolo_heads]
        flags = dict(scales=[h.scale_xy for h in cfg.yolo_heads],
                     new_coords=[h.new_coords for h in cfg.yolo_heads],
                     gaussian=[h.gaussian for h in cfg.yolo_heads])
        if head == "fused":
            from yolo_tpu_torch.ops.head import detect_head_yolo

            return detect_head_yolo(
                logits, cfg.anchors, masks, cfg.num_classes, cfg.input_hw,
                conf_threshold=conf_t, iou_threshold=iou_t,
                pre_top_k=pre, max_detections=max_detections,
                use_kernel=on_cuda, nms_kind=cfg.nms_kind,
                beta_nms=cfg.beta_nms, **flags)
        boxes, scores = decode_yolo(logits, cfg.anchors, masks,
                                    cfg.num_classes, cfg.input_hw, **flags)
        return nms_batch(
            boxes, scores, conf_threshold=conf_t, iou_threshold=iou_t,
            top_k=top_k, max_detections=max_detections, impl=nms_impl,
            kind=cfg.nms_kind, beta=cfg.beta_nms)
    if head == "fused" and cfg.tree is not None:
        from yolo_tpu_torch.ops.head import detect_head_tree

        return detect_head_tree(
            logits, cfg.anchors, cfg.tree, conf_threshold=conf_t,
            iou_threshold=iou_t, hier_thresh=hier, tree_map=tree_map,
            pre_top_k=pre, max_detections=max_detections,
            use_kernel=on_cuda, nms_kind=cfg.nms_kind,
            beta_nms=cfg.beta_nms)
    if head == "fused":
        from yolo_tpu_torch.ops.head import detect_head

        return detect_head(
            logits, cfg.anchors, cfg.num_classes,
            conf_threshold=conf_t, iou_threshold=iou_t,
            pre_top_k=pre, max_detections=max_detections,
            use_kernel=on_cuda, nms_kind=cfg.nms_kind,
            beta_nms=cfg.beta_nms)
    boxes, scores = decode(logits, cfg.anchors, cfg.num_classes,
                           tree=cfg.tree, tree_map=tree_map,
                           hier_thresh=hier)
    return nms_batch(
        boxes, scores, conf_threshold=conf_t, iou_threshold=iou_t,
        top_k=top_k, max_detections=max_detections, impl=nms_impl,
        kind=cfg.nms_kind, beta=cfg.beta_nms)


def _entry_fusable(cfg: ModelConfig) -> bool:
    """The entry fusion applies (predict.py::_entry_fusable): a conv3x3 +
    pool2x2 entry, 3 input channels, and routes, shortcuts, sam and
    scale_channels layers that resolve without layers 0-1 (relative,
    never reaching back before layer 2). The params' side of the JAX
    gate (folded, not int8) is detect_raw's check of the net."""
    def refs(layer):
        return layer.layers if isinstance(layer, Route) else (layer.frm,)

    return (entry_ops.eligible(cfg.layers) and cfg.in_channels == 3
            and all(r < 0 and idx + r >= 2
                    for idx, l in enumerate(cfg.layers)
                    if isinstance(l, (Route, Shortcut, Sam, ScaleChannels))
                    for r in refs(l)))


def detect_raw(cfg: ModelConfig, net: Darknet, images_u8: torch.Tensor, *,
               entry: str = "auto", resize: str = "letterbox",
               conv_impl: str = "torch", **kw):
    """Raw RGB (B, H, W, 3) uint8 -> detections with boxes mapped back to
    original-image pixel xyxy.

    resize="stretch" is the aspect-ignoring bilinear resize (AlexeyAB
    letter_box=0); "letterbox" (default) matches pjreddie darknet.

    entry="fused" replaces letterbox + conv1 + pool1 with the letterbox
    of ops/entry.py and the fused entry kernel, then runs layers 2..
    with conv_impl="torch", as the JAX package's fused branch does;
    "auto" is the plain letterbox + Darknet. conv_impl: see forward; the
    fused entry does not take "cuda" (the JAX package's fused branch has
    no conv_impl either)."""
    if entry not in ("auto", "fused"):
        raise ValueError(f"unknown entry {entry!r} (auto | fused)")
    _, h, w, _ = images_u8.shape
    if resize == "stretch":
        if entry == "fused":
            raise ValueError("entry='fused' implements letterbox only")
        x = stretch_resize(images_u8, cfg.input_hw, dtype=net.compute_dtype)
        dets = detect(cfg, net, x, conv_impl=conv_impl, **kw)
        dets["boxes"] = unstretch_boxes_xyxy(dets["boxes"], src_h=h, src_w=w)
        return dets
    if resize != "letterbox":
        raise ValueError(f"unknown resize {resize!r} (letterbox | stretch)")
    if entry == "fused":
        if conv_impl != "torch":
            raise ValueError(
                f"entry='fused' runs layers 2.. with conv_impl='torch', "
                f"got conv_impl={conv_impl!r}: the reference's fused "
                f"entry route has no conv kernel route")
        if not _entry_fusable(cfg) or net.quantized[0]:
            # an int8 conv 0 (models/quantize.py) has no entry kernel,
            # as the JAX package's gate refuses kernel_q params
            raise ValueError("entry='fused' needs a conv3x3+pool2x2 "
                             "entry and folded-BN params")
        net_h, net_w = cfg.input_hw
        if net_h != net_w:
            # kept for parity: the TPU kernel's plane packing is
            # square-only
            raise ValueError(
                f"entry='fused' supports square nets only ({net_w}x{net_h} "
                f"is rectangular); use the default entry='auto'")
        if net_h > 416:
            # kept for parity: the TPU kernel holds a whole image in VMEM
            raise ValueError(
                f"entry='fused' supports net sizes <= 416 ({net_h} exceeds "
                f"it); use the default entry='auto'")
        dt = net.compute_dtype
        xpad = entry_ops.letterbox_padded(images_u8, net_h, interp_dtype=dt)
        x = entry_kernel.fused_entry(xpad, net.entry_kernel, net.bias0,
                                     out_dtype=dt)
        logits = net.run(x, start=2)
        dets = _postprocess(cfg, logits, **kw)
    else:
        x = letterbox(images_u8, cfg.input_hw, dtype=net.compute_dtype)
        dets = detect(cfg, net, x, conv_impl=conv_impl, **kw)
    dets["boxes"] = unletterbox_boxes_xyxy(
        dets["boxes"], src_h=h, src_w=w, net_size=cfg.input_hw)
    return dets


def make_detector(cfg: ModelConfig, *,
                  conf_threshold: Optional[float] = None,
                  nms_threshold: Optional[float] = None,
                  top_k: int = 128, max_detections: int = 100,
                  nms_impl: str = "auto", head: str = "auto",
                  entry: str = "auto", resize: str = "letterbox",
                  use_tree_map: bool = False,
                  hier_thresh: Optional[float] = None):
    """Raw-RGB detector: ``fn(net, images_u8) -> detections``."""
    def fn(net: Darknet, images_u8: torch.Tensor):
        return detect_raw(cfg, net, images_u8,
                          conf_threshold=conf_threshold,
                          nms_threshold=nms_threshold, top_k=top_k,
                          max_detections=max_detections, nms_impl=nms_impl,
                          head=head, entry=entry, resize=resize,
                          use_tree_map=use_tree_map,
                          hier_thresh=hier_thresh)
    return fn


def make_detector_preprocessed(cfg: ModelConfig, *,
                               conf_threshold: Optional[float] = None,
                               nms_threshold: Optional[float] = None,
                               top_k: int = 128, max_detections: int = 100,
                               nms_impl: str = "auto", head: str = "auto",
                               conv_impl: str = "torch",
                               use_tree_map: bool = False,
                               hier_thresh: Optional[float] = None):
    """Detector for host-preprocessed (B, net_h, net_w, 3) [0, 1] input,
    one shape whatever the source sizes (data/pipeline.py
    inference_batches): ``fn(net, images_01) -> detections`` with
    net-space xywh boxes, un-letterboxed per image by the caller.
    conv_impl: see forward; use_tree_map / hier_thresh: see detect."""
    def fn(net: Darknet, images_01: torch.Tensor):
        return detect(cfg, net, images_01.to(net.compute_dtype),
                      conf_threshold=conf_threshold,
                      nms_threshold=nms_threshold, top_k=top_k,
                      max_detections=max_detections, nms_impl=nms_impl,
                      head=head, conv_impl=conv_impl,
                      use_tree_map=use_tree_map, hier_thresh=hier_thresh)
    return fn
