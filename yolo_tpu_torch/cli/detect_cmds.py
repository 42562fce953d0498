"""`predict` / `detect` / `classify` (port of yolo_tpu/cli/detect_cmds.py):
single-image and batched directory detection, classifier top-k and
imagefolder accuracy, each at --precision fp32, bf16 or int8 (calibrated
on the command's first inputs, as the JAX commands calibrate), and
`detect --video` over a video's frames (data/video.py)."""

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

    cfg = _get_cfg(args)
    _require_detection(cfg, "detect")
    tree_kw = _tree_kw(args, cfg)
    names = cfg.detection_names(tree_kw["use_tree_map"])
    if args.video:
        _detect_video(args, cfg, names, tree_kw)
        return
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


def _first_video_frames(args, cfg) -> list:
    """int8 calibration frames: the stream's first batch of 8 sampled
    frames (padded as video_batches pads), the generator closed before
    the stream is opened again (a webcam refuses a second open)."""
    from yolo_tpu_torch.data.video import video_batches

    gen = video_batches(args.video, 8, stride=args.stride, max_frames=8,
                        channels=cfg.in_channels)
    try:
        first = next(gen)
    finally:
        gen.close()
    return list(first["images"])


def _detect_video(args, cfg, names, tree_kw) -> None:
    """Video detection: every frame has one shape, so the whole stream
    runs the raw-frame detector (device letterbox) at one shape. One JSON
    line a sampled frame; --save-video writes an annotated MJPG copy at
    fps / stride."""
    from yolo_tpu_torch.data.pipeline import DevicePrefetcher
    from yolo_tpu_torch.data.video import (VideoAnnotator, check_source,
                                           video_batches, video_info)
    from yolo_tpu_torch.models.predict import make_detector

    if args.save_labels:
        raise SystemExit("--save-labels derives per-IMAGE label "
                         "paths — it applies to --images mode only")
    try:
        check_source(args.video)
    except ValueError as e:
        raise SystemExit(str(e))
    net = _load_net(args, cfg, lambda: _first_video_frames(args, cfg))
    det = make_detector(cfg, resize=args.resize, **tree_kw)
    writer = None
    if args.save_video:
        info = video_info(args.video)
        writer = VideoAnnotator(args.save_video,
                                fps=info["fps"] / max(args.stride, 1),
                                width=info["width"], height=info["height"])
    host_iter = video_batches(args.video, args.batch, stride=args.stride,
                              max_frames=args.max_frames or None,
                              channels=cfg.in_channels)
    try:
        with DevicePrefetcher(host_iter, depth=2, device=net.device) \
                as staged, torch.no_grad():
            for batch in staged:
                out = _to_numpy(det(net, batch["images"]))
                boxes = out["boxes"].astype(np.float64)
                frames = (batch["images"].cpu().numpy()
                          if writer is not None else None)
                for bi, frame_idx in enumerate(batch["frames"]):
                    valid = np.nonzero(out["valid"][bi])[0]
                    print(json.dumps({"frame": int(frame_idx),
                                      "detections": _det_json(
                                          names, out["classes"][bi],
                                          out["scores"][bi],
                                          boxes[bi][valid], valid)}))
                    if writer is not None:
                        writer.write(frames[bi], boxes[bi],
                                     out["scores"][bi], out["classes"][bi],
                                     names, out["valid"][bi])
    finally:
        if writer is not None:
            writer.close()
            print(f"wrote {args.save_video}", file=sys.stderr)
