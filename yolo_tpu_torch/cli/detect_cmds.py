"""`predict` / `detect` / `classify` (port of yolo_tpu/cli/detect_cmds.py):
single-image and batched directory detection, classifier top-k and
imagefolder accuracy, each at --precision fp32, bf16 or int8 (calibrated
on the command's first inputs, as the JAX commands calibrate). Video
input (ROADMAP A12a) is not ported yet and raises, int8 with it."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from yolo_tpu_torch.cli._common import (_device, _get_cfg, _load_net,
                                        _load_params, _quantize_classifier,
                                        _refuse_yolov1, _require_detection,
                                        _to_numpy, _tree_kw)


def cmd_classify(args) -> None:
    """darknet classifier predict (classifier.c predict_classifier):
    min-side resize + centre crop, forward, top-k labels as JSON lines;
    ``--images DIR`` scores an imagefolder tree (darknet `classifier
    valid`) and prints top-1/top-k accuracy."""
    from yolo_tpu_torch.data.pipeline import load_image
    from yolo_tpu_torch.models.classify import (classifier_preprocess,
                                                hierarchy_leaf_probs,
                                                hierarchy_path,
                                                make_classifier, top_k)

    cfg = _get_cfg(args)
    if cfg.head_kind != "softmax":
        raise SystemExit(f"{cfg.name} is not a classifier "
                         f"(head_kind={cfg.head_kind}) — use `predict`")
    if bool(args.image) == bool(args.images):
        raise SystemExit("give exactly one of --image / --images")
    if args.use_tree_map or args.hier_thresh is not None:
        raise SystemExit("--use-tree-map/--hier-thresh shape the "
                         "DETECTION decode — classify uses leaf-masked "
                         "absolute probs (--hierarchy prints the path)")
    if args.hierarchy and cfg.softmax_tree is None:
        raise SystemExit("--hierarchy applies only to tree classifiers "
                         f"([softmax] tree=<file>); {cfg.name} has none")
    if args.hierarchy and args.images:
        raise SystemExit("--hierarchy prints one image's tree path — "
                         "use it with --image")
    quantize_on = net = None
    if args.precision == "int8":
        # calibrated on the image, or on the imagefolder's first chunk
        _refuse_yolov1(cfg)
        _device(args)
        params = _load_params(args, cfg)

        def quantize_on(calib_01):
            return _quantize_classifier(args, cfg, params, calib_01)
    else:
        net = _load_net(args, cfg)
    if args.image:
        x = classifier_preprocess(load_image(args.image, cfg.in_channels),
                                  cfg.input_hw)
        if quantize_on is not None:
            net = quantize_on(x[None])
        with torch.no_grad():
            probs = make_classifier(cfg)(net, x[None]).cpu().numpy()[0]
        if cfg.softmax_tree is not None:
            # per-group conditionals -> leaf-masked absolute probs
            if args.hierarchy:
                for name, c, p in hierarchy_path(probs, cfg.softmax_tree):
                    print(json.dumps({"node": name,
                                      "conditional": round(c, 6),
                                      "prob": round(p, 6)}))
                return
            probs = hierarchy_leaf_probs(probs[None], cfg.softmax_tree)[0]
        for name, p in top_k(probs, cfg.class_names, k=args.top):
            print(json.dumps({"class": name, "prob": round(p, 6)}))
        return

    from yolo_tpu_torch.data.imagefolder import list_imagefolder
    from yolo_tpu_torch.models.classify import imagefolder_accuracy

    try:
        samples = list_imagefolder(args.images, cfg.class_names)
    except ValueError as e:
        raise SystemExit(str(e))
    try:
        with torch.no_grad():
            out = imagefolder_accuracy(cfg, net, samples, batch=args.batch,
                                       k=args.top,
                                       quantize_first_batch=quantize_on)
    except ValueError as e:
        raise SystemExit(f"--batch: {e}" if "batch" in str(e) else str(e))
    print(json.dumps(out))


def _write_label_file(image_path: str, dets_xyxy, src_w: int,
                      src_h: int) -> str:
    """darknet `-save_labels`: the image's detections as a YOLO-format
    label file at label_path_for(image_path), one '%d %2.4f %2.4f %2.4f
    %2.4f' line (class, relative cx cy w h) per detection; written even
    with no detection. dets_xyxy: [(class_id, score, x1, y1, x2, y2)
    pixel]."""
    from yolo_tpu_torch.data.darknet_list import label_path_for

    out = label_path_for(image_path)
    d = os.path.dirname(out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out, "w") as f:
        for (c, _s, x1, y1, x2, y2) in dets_xyxy:
            cx = (x1 + x2) / 2.0 / src_w
            cy = (y1 + y2) / 2.0 / src_h
            bw = (x2 - x1) / src_w
            bh = (y2 - y1) / src_h
            f.write(f"{int(c)} {cx:2.4f} {cy:2.4f} "
                    f"{bw:2.4f} {bh:2.4f}\n")
    return out


def _det_json(names, classes, scores, xyxy, order) -> list:
    return [{"class": names[int(classes[i])],
             "score": round(float(scores[i]), 4),
             "box_xyxy": [round(float(v), 1) for v in xyxy[j]]}
            for j, i in enumerate(order)]


def cmd_predict(args) -> None:
    """Single-image detection."""
    from yolo_tpu_torch.data.pipeline import load_image
    from yolo_tpu_torch.models.predict import make_detector
    from yolo_tpu_torch.utils.profiling import maybe_trace
    from yolo_tpu_torch.utils.viz import draw_detections, save_image

    cfg = _get_cfg(args)
    _require_detection(cfg, "predict")
    tree_kw = _tree_kw(args, cfg)
    names = cfg.detection_names(tree_kw["use_tree_map"])
    img = load_image(args.image, cfg.in_channels)
    net = _load_net(args, cfg, lambda: [img])   # int8: calibrated on it
    det = make_detector(cfg, resize=args.resize, **tree_kw)
    with maybe_trace(args.profile_dir), torch.no_grad():
        out = _to_numpy(det(net, torch.from_numpy(img[None]).to(net.device)))
    boxes, scores = out["boxes"][0], out["scores"][0]
    classes, valid = out["classes"][0], out["valid"][0]
    keep = np.nonzero(valid)[0]
    for d in _det_json(names, classes, scores, boxes[keep], keep):
        print(json.dumps(d))
    if args.save_labels:
        src_h, src_w = img.shape[:2]
        out_txt = _write_label_file(
            args.image, [(int(classes[i]), float(scores[i]), *boxes[i])
                         for i in keep], src_w, src_h)
        print(f"wrote {out_txt}", file=sys.stderr)
    if args.output:
        save_image(args.output, draw_detections(img, boxes, scores, classes,
                                                names, valid))
        print(f"wrote {args.output}", file=sys.stderr)


def _image_paths(args) -> list:
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    if args.recursive:
        paths = sorted(
            os.path.join(root, f)
            for root, _dirs, files in os.walk(args.images)
            for f in files if f.lower().endswith(exts))
    else:
        paths = sorted(
            os.path.join(args.images, f) for f in os.listdir(args.images)
            if f.lower().endswith(exts))
    if not paths:
        raise SystemExit(f"no images found in {args.images}")
    return paths


def cmd_detect(args) -> None:
    """Batched detection over a directory: the host decodes (and with
    --host-preprocess letterboxes) on threads, DevicePrefetcher stages
    the batches on the device."""
    from yolo_tpu_torch.data.pipeline import (DevicePrefetcher,
                                              inference_batches, load_image)
    from yolo_tpu_torch.models.predict import (make_detector,
                                               make_detector_preprocessed)
    from yolo_tpu_torch.ops.letterbox import (unletterbox_boxes_xyxy,
                                              unstretch_boxes_xyxy)
    from yolo_tpu_torch.utils.viz import draw_detections, save_image

    if args.video:
        # int8 video calibrates on the stream's first frames: A12a too
        raise SystemExit("detect --video needs a video decoder, which is "
                         "not ported yet (ROADMAP A12, data/video.py)")
    cfg = _get_cfg(args)
    _require_detection(cfg, "detect")
    tree_kw = _tree_kw(args, cfg)
    names = cfg.detection_names(tree_kw["use_tree_map"])
    paths = _image_paths(args)
    # int8: calibrated on the first 8 images
    net = _load_net(args, cfg, lambda: [load_image(p, cfg.in_channels)
                                        for p in paths[:8]])
    if args.host_preprocess:
        det = make_detector_preprocessed(cfg, **tree_kw)
        host_iter = inference_batches(paths, args.batch,
                                      net_size=cfg.input_hw,
                                      resize=args.resize,
                                      channels=cfg.in_channels)
    else:
        det = make_detector(cfg, resize=args.resize, **tree_kw)
        host_iter = inference_batches(paths, args.batch,
                                      channels=cfg.in_channels)
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
    with DevicePrefetcher(host_iter, depth=2, device=net.device) as staged, \
            torch.no_grad():
        for batch in staged:
            out = _to_numpy(det(net, batch["images"]))
            boxes_all = out["boxes"].astype(np.float64)
            for bi, path in enumerate(batch["paths"]):
                valid = np.nonzero(out["valid"][bi])[0]
                if args.host_preprocess:
                    src_h, src_w = batch["shapes"][bi]
                    b = torch.from_numpy(boxes_all[bi][valid])
                    xyxy = (unstretch_boxes_xyxy(b, src_h=src_h, src_w=src_w)
                            if args.resize == "stretch" else
                            unletterbox_boxes_xyxy(b, src_h=src_h,
                                                   src_w=src_w,
                                                   net_size=cfg.input_hw)
                            ).numpy()
                else:
                    src_h, src_w = batch["images"].shape[1:3]
                    xyxy = boxes_all[bi][valid]
                scores, classes = out["scores"][bi], out["classes"][bi]
                print(json.dumps({"image": path, "detections": _det_json(
                    names, classes, scores, xyxy, valid)}))
                if args.save_labels:
                    _write_label_file(
                        path, [(int(classes[i]), float(scores[i]), *xyxy[j])
                               for j, i in enumerate(valid)], src_w, src_h)
                if args.output_dir:
                    src = (load_image(path, cfg.in_channels)
                           if args.host_preprocess
                           else batch["images"][bi].cpu().numpy())
                    # mirror the source tree: --recursive makes basename
                    # collisions routine (a/img.jpg vs b/img.jpg)
                    dst = os.path.join(args.output_dir,
                                       os.path.relpath(path, args.images))
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    save_image(dst, draw_detections(
                        src, xyxy, scores[valid], classes[valid], names))
