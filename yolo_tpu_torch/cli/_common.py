"""Shared CLI plumbing (port of yolo_tpu/cli/_common.py): the common
flags, config and weights resolution, the dataset sources."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="tiny-voc",
                   choices=["tiny-voc", "voc", "coco", "tiny-coco",
                            "yolov3", "yolov3-spp", "yolov3-tiny",
                            "yolov4", "yolov4-tiny", "darknet19",
                            "darknet19-448", "darknet53"])
    p.add_argument("--cfg", default=None,
                   help="darknet .cfg file (overrides --model; any "
                        "yolov1/v2/v3/v4-family or classifier topology)")
    p.add_argument("--names", default=None,
                   help="darknet .names file (class names for --cfg)")
    p.add_argument("--input-size", type=int, default=None,
                   help="net input size (multiple of 32; default per model)")
    p.add_argument("--precision", default="bf16",
                   choices=["fp32", "bf16", "int8"],
                   help="fp32 = parity mode, bf16 = throughput (fp32 "
                        "accum), int8 = PTQ serving mode (calibrated on "
                        "the first inputs; not parity-exact)")
    p.add_argument("--conf", type=float, default=None, help="score threshold")
    p.add_argument("--nms", type=float, default=None, help="NMS IoU threshold")
    p.add_argument("--resize", default="letterbox",
                   choices=["letterbox", "stretch"],
                   help="preprocess geometry: letterbox (pjreddie "
                        "darknet) or stretch = plain resize (AlexeyAB "
                        "darknet letter_box=0 default) — applies to "
                        "predict/detect/eval/serve AND train")
    p.add_argument("--decoder", default="native",
                   choices=["cv2", "native"],
                   help="host image decoder: native = the port's own "
                        "JPEG/PNG/BMP/PNM/TIFF/WebP decoder "
                        "(yolo_tpu_torch/native/, the bytes cv2.imread "
                        "gives); cv2 where OpenCV is installed")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace here")
    p.add_argument("--hier-thresh", type=float, default=None,
                   help="YOLO9000 tree models: hierarchy traversal "
                        "threshold (descend while the path probability "
                        "product exceeds this; darknet -hier, default "
                        "0.5)")
    p.add_argument("--use-tree-map", action="store_true",
                   help="YOLO9000 tree models: decode through the "
                        "[region] map= projection (score = conf * "
                        "absolute tree prob of each mapped node — the "
                        "darknet COCO-eval path) instead of the "
                        "hierarchy traversal")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the command computes: cuda (the default; "
                        "raises without a card) or cpu")


def _compute_dtype(precision: str):
    # int8 quantizes the convs only; the surrounding math runs in bf16
    return torch.float32 if precision == "fp32" else torch.bfloat16


def _refuse_yolov1(cfg) -> None:
    """--precision int8 on a yolov1-family net raises before anything is
    read, with the JAX package's message (quantize.py::prepare_int8);
    every int8 command calls it before it quantizes."""
    from yolo_tpu_torch.configs.specs import Crop, DetectionHead, Local

    if any(isinstance(l, (Crop, Local, DetectionHead)) for l in cfg.layers):
        raise SystemExit("int8 PTQ does not support the yolov1 family "
                         "([crop]/[local]/[detection] layers) — use "
                         "fp32/bf16")


def _quantize_classifier(args, cfg, params, calib_01):
    """int8 PTQ of a classifier calibrated on classifier-preprocessed [0,
    1] images (resize_min + centre crop: the `classify` and /classify
    input path) -> the int8 net on --device. One implementation for
    `classify` and `serve`; _maybe_quantize is the detector-geometry
    sibling."""
    from yolo_tpu_torch.models import quantize

    q = quantize.prepare_int8(cfg, params, np.asarray(calib_01),
                              device=_device(args))
    print(f"int8 PTQ: calibrated on {len(calib_01)} images",
          file=sys.stderr)
    return _net(args, cfg, q)


def _maybe_quantize(args, cfg, params, sample_images_u8):
    """--precision int8's params: calibrated on the given raw images,
    preprocessed with the geometry inference uses (--resize letterbox or
    stretch, the host resize of data/pipeline.py), quantized by
    models/quantize.py."""
    from yolo_tpu_torch.data.pipeline import _host_resize
    from yolo_tpu_torch.models import quantize

    calib = np.stack([_host_resize(im, cfg.input_hw, args.resize)
                      for im in sample_images_u8])
    qparams = quantize.prepare_int8(cfg, params, calib, device=_device(args))
    print(f"int8 PTQ: calibrated on {len(sample_images_u8)} images",
          file=sys.stderr)
    return qparams


def _device(args) -> torch.device:
    """--device resolved as every entry point resolves it: cuda raises
    without a card."""
    from yolo_tpu_torch.device import resolve

    try:
        return resolve(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}") from None


def _load_params(args, cfg, folded: bool = True):
    """Numpy params from a darknet .weights file or a checkpoint
    directory of the port (its EMA track when it keeps one), folded for
    inference unless folded=False."""
    from yolo_tpu_torch.io import darknet_weights as dw
    from yolo_tpu_torch.models.graph import fold_params

    weights = _resolve_weights(args.weights)
    if os.path.isdir(weights):  # a train checkpoint
        from yolo_tpu_torch.io import checkpoint as ckpt

        try:
            state = ckpt.restore(weights)
        except (FileNotFoundError, ValueError) as e:
            raise SystemExit(str(e)) from None
        source = state.get("ema_params", state["params"])
        if "ema_params" in state:
            print("using the checkpoint's EMA weight track (darknet "
                  "ema_apply semantics)", file=sys.stderr)
        params = [{k: v.numpy() for k, v in p.items()} for p in source]
    else:
        params, header = dw.load(weights, cfg.layers,
                                 input_channels=cfg.in_channels)
        print(f"loaded darknet weights: version "
              f"{header['major']}.{header['minor']}.{header['revision']}, "
              f"seen {header['seen']}", file=sys.stderr)
    if folded:
        params = fold_params(cfg.layers, params, cfg.bn_eps)
    return params


def _net(args, cfg, params):
    """The inference module (models.graph.Darknet) of folded or int8
    params on --device, computing at --precision (int8: bf16 around the
    int8 convs)."""
    from yolo_tpu_torch.models.graph import Darknet

    return Darknet(cfg.layers, params, device=_device(args),
                   dtype=_compute_dtype(args.precision))


def _load_net(args, cfg, calibration=None):
    """The inference module of --weights on --device at --precision.
    int8 calibrates on ``calibration()``, the raw images the command
    names (called after the weights are read, as the JAX commands read
    them)."""
    if args.precision == "int8":
        _refuse_yolov1(cfg)
    _device(args)
    params = _load_params(args, cfg)
    if args.precision == "int8":
        params = _maybe_quantize(args, cfg, params, calibration())
    return _net(args, cfg, params)


def _resolve_weights(spec: str) -> str:
    """zoo://<name> -> verified local path (pass-through otherwise),
    library errors as CLI errors."""
    if not spec.startswith("zoo://"):
        return spec
    from yolo_tpu_torch.io import zoo

    try:
        return zoo.resolve(spec)
    except (KeyError, FileNotFoundError, ValueError) as e:
        raise SystemExit(str(e).strip("'\""))


def _apply_data_file(args) -> None:
    """A darknet `.data` file as the flags it stands for, before the
    command runs: the command's list (train= for training/anchors,
    valid= for eval) becomes --image-list, names= fills --names when
    absent (relative paths against the CWD first, then the .data file's
    directory); classes= is checked later against the model."""
    from yolo_tpu_torch.data.darknet_list import parse_data_file

    if getattr(args, "image_list", None):
        raise SystemExit("give --data or --image-list, not both (the "
                         ".data file's train=/valid= entry IS the "
                         "image list)")
    try:
        kv = parse_data_file(args.data)
    except OSError as e:
        raise SystemExit(f"--data: {e}")
    key = getattr(args, "_data_list_key", "train")
    if key not in kv:
        raise SystemExit(f"{args.data}: no '{key} = <list file>' entry "
                         f"(this command reads the {key}= list)")
    base = os.path.dirname(os.path.abspath(args.data))

    def _resolve(p):
        if os.path.isabs(p) or os.path.exists(p):
            return p
        alt = os.path.join(base, p)
        return alt if os.path.exists(alt) else p

    args.image_list = _resolve(kv[key])
    if "names" in kv and not getattr(args, "names", None):
        args.names = _resolve(kv["names"])
    args._data_classes = int(kv["classes"]) if "classes" in kv else None
    if (key == "train" and "valid" in kv
            and hasattr(args, "eval_image_list")
            and not args.eval_image_list):
        # darknet -map scores the .data valid= list during training
        args.eval_image_list = _resolve(kv["valid"])


def _dataset_samples(args, cfg, names=None):
    """(image_path, annotation) samples from --voc-root, --coco-json or
    --image-list/--data (darknet list + YOLO .txt labels); the
    annotation is a VOC XML path or a parsed dict. ``names``: the class
    vocabulary (default cfg.class_names)."""
    n_sources = sum(bool(s) for s in (
        args.voc_root, args.coco_json, getattr(args, "image_list", None)))
    if n_sources != 1:
        raise SystemExit("give exactly one of --voc-root / --coco-json "
                         "/ --image-list (or --data)")
    if getattr(args, "image_list", None):
        from yolo_tpu_torch.data.darknet_list import list_images

        want = names or cfg.class_names
        data_ncls = getattr(args, "_data_classes", None)
        if data_ncls is not None and data_ncls != len(want):
            raise SystemExit(
                f"--data classes={data_ncls} but the model has "
                f"{len(want)} classes — wrong .data file or wrong "
                f"cfg/--names")
        return list_images(args.image_list, want)
    if args.coco_json:
        from yolo_tpu_torch.data.coco import load_coco

        root = args.image_root or os.path.dirname(args.coco_json)
        return load_coco(args.coco_json, names or cfg.class_names,
                         image_root=root)
    from yolo_tpu_torch.data.voc import list_split

    return list_split(args.voc_root, args.split)


def _get_cfg(args):
    import dataclasses

    if getattr(args, "cfg", None):
        from yolo_tpu_torch.configs.darknet_cfg import config_from_cfg

        cfg = config_from_cfg(args.cfg, names_path=args.names)
        if args.input_size is not None:
            cfg = cfg.with_input_size(args.input_size)
    else:
        from yolo_tpu_torch.configs import get_variant

        cfg = get_variant(args.model, input_size=args.input_size)
    if args.conf is not None:
        cfg = dataclasses.replace(cfg, conf_threshold=args.conf)
    if args.nms is not None:
        cfg = dataclasses.replace(cfg, nms_threshold=args.nms)
    return cfg


def _require_detection(cfg, cmd: str) -> None:
    if cfg.head_kind == "softmax":
        raise SystemExit(
            f"{cfg.name} is a classifier (softmax head) — `{cmd}` needs "
            f"a detection model; use `classify` for top-k labels or "
            f"`partial` to extract its backbone for detector training")


def _tree_kw(args, cfg) -> dict:
    """The YOLO9000 hierarchy flags of predict/detect/eval/recall/serve,
    checked (they mean nothing without a [region] tree=) and returned as
    the make_detector* / collect_detections keywords."""
    use_map = getattr(args, "use_tree_map", False)
    hier = getattr(args, "hier_thresh", None)
    if (use_map or hier is not None) and cfg.tree is None:
        raise SystemExit("--use-tree-map/--hier-thresh apply only to "
                         "YOLO9000 tree models ([region] tree=<file>); "
                         f"{cfg.name} has no tree")
    if use_map and cfg.tree_map is None:
        raise SystemExit("--use-tree-map needs a [region] map=<file> "
                         f"projection in the cfg; {cfg.name} has none")
    return {"use_tree_map": use_map, "hier_thresh": hier}


def _to_numpy(out) -> dict:
    """Detector output tensors -> numpy, one copy each."""
    return {k: v.cpu().numpy() for k, v in out.items()}

