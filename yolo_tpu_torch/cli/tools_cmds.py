"""Tooling commands (port of yolo_tpu/cli/tools_cmds.py): `zoo`,
`partial`, `anchors`, `export`, `serve`, `doctor`; `bench` is the JAX
package's and raises."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from yolo_tpu_torch.cli._common import (_dataset_samples, _device,
                                        _get_cfg, _load_net, _load_params,
                                        _quantize_classifier,
                                        _refuse_yolov1, _resolve_weights,
                                        _tree_kw)


def cmd_zoo(args) -> None:
    """Weights-zoo manifest: list entries, verify a file, pin a SHA
    (io/zoo.py)."""
    from yolo_tpu_torch.io import zoo

    manifest = zoo.load_manifest()
    if args.action == "list":
        out = {}
        for name, e in sorted(manifest.items()):
            path = os.path.join(zoo.weights_dir(), e["filename"])
            out[name] = {**e, "local_path": path,
                         "present": os.path.exists(path)}
        print(json.dumps(out, indent=2))
        return

    entry = manifest.get(args.name)
    if not entry:
        raise SystemExit(f"unknown zoo entry '{args.name}'")
    path = args.file or os.path.join(zoo.weights_dir(), entry["filename"])
    if args.action == "verify":
        problems = zoo.verify_file(path, entry)
        print(json.dumps({"path": path, "ok": not problems,
                          "problems": problems}))
        if problems:
            raise SystemExit(1)
    elif args.action == "pin-sha":
        try:
            sha = zoo.record_sha(args.name, path)
        except ValueError as e:
            raise SystemExit(str(e))
        print(json.dumps({"name": args.name, "sha256": sha}))


def cmd_partial(args) -> None:
    """darknet `partial`: the first N layers' weights (a backbone file
    such as darknet19_448.conv.23)."""
    from yolo_tpu_torch.configs.specs import weighted_specs
    from yolo_tpu_torch.io import darknet_weights as dw

    cfg = _get_cfg(args)
    params, header, n_loaded = dw.load_partial(
        _resolve_weights(args.weights), cfg.layers,
        input_channels=cfg.in_channels)
    n_convs = len(weighted_specs(tuple(cfg.layers[:args.layers])))
    if n_convs > n_loaded:
        raise SystemExit(f"cutoff needs {n_convs} weighted layers; the "
                         f"file has {n_loaded}")
    # darknet's partial resets net->seen to 0 before saving
    dw.save(args.output, cfg.layers, params, seen=0, cutoff_convs=n_convs)
    print(f"wrote {args.output}: first {args.layers} layers "
          f"({n_convs} convs)", file=sys.stderr)


def cmd_anchors(args) -> None:
    """YOLO9000 dimension-cluster k-means over a dataset's GT boxes
    (darknet `calc_anchors`; data/anchors.py)."""
    from yolo_tpu_torch.data.anchors import collect_wh, kmeans_anchors

    cfg = _get_cfg(args)
    wh = collect_wh(_dataset_samples(args, cfg), cfg.class_names)
    # [region] anchors are in grid cells, [yolo] anchors in input pixels
    # (per axis on rectangular nets)
    units = ((cfg.input_w, cfg.input_h) if cfg.head_kind == "yolo"
             else (cfg.input_w // 32, cfg.input_h // 32))
    res = kmeans_anchors(wh, args.num_anchors, units_wh=units,
                         seed=args.seed)
    flat = ", ".join(f"{w:.4f},{h:.4f}" for w, h in res["anchors"])
    print(json.dumps({"anchors": [[round(float(w), 4), round(float(h), 4)]
                                  for w, h in res["anchors"]],
                      "avg_iou": round(res["avg_iou"], 4),
                      "darknet_line": flat,
                      "units": "pixels" if cfg.head_kind == "yolo"
                               else "cells",
                      "num_boxes": int(len(wh))}))


def cmd_export(args) -> None:
    """A checkpoint of the port -> darknet .weights (and --save-cfg the
    .cfg and .names beside it). A JAX orbax checkpoint converts first
    with tools/ckpt_to_torch.py."""
    from yolo_tpu_torch.io import checkpoint as ckpt
    from yolo_tpu_torch.io import darknet_weights as dw

    cfg = _get_cfg(args)
    try:
        state = ckpt.restore(args.checkpoint)
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(str(e)) from None
    source = state["params"]
    if "ema_params" in state and not args.live_weights:
        source = state["ema_params"]
        print("exporting the EMA weight track (darknet ema_apply "
              "semantics; --live-weights exports the raw track)",
              file=sys.stderr)
    params = [{k: v.numpy() for k, v in p.items()} for p in source]
    dw.save(args.output, cfg.layers, params, seen=int(state.get("seen", 0)))
    print(f"wrote {args.output}", file=sys.stderr)
    if args.save_cfg:
        from yolo_tpu_torch.configs.darknet_cfg import cfg_to_string

        with open(args.save_cfg, "w") as f:
            f.write(cfg_to_string(cfg))
        names_path = os.path.splitext(args.save_cfg)[0] + ".names"
        with open(names_path, "w") as f:
            f.write("\n".join(cfg.class_names) + "\n")
        print(f"wrote {args.save_cfg} + {names_path}", file=sys.stderr)


def _serve_net(args, cfg, classifier: bool):
    """serve's net; at --precision int8 calibrated on
    --calibration-image with the geometry of the endpoint (a classifier's
    resize_min + centre crop, a detector's --resize)."""
    from yolo_tpu_torch.data.pipeline import load_image

    if args.precision != "int8":
        return _load_net(args, cfg)
    _refuse_yolov1(cfg)
    if not args.calibration_image:
        raise SystemExit("--precision int8 needs --calibration-image")
    if not classifier:
        return _load_net(args, cfg, lambda: [
            load_image(args.calibration_image, cfg.in_channels)])
    from yolo_tpu_torch.models.classify import classifier_preprocess

    _device(args)
    params = _load_params(args, cfg)
    calib = classifier_preprocess(
        load_image(args.calibration_image, cfg.in_channels), cfg.input_hw)
    return _quantize_classifier(args, cfg, params, calib[None])


def cmd_serve(args) -> None:
    """HTTP detection (or, for a classifier, classification) endpoint
    with micro-batching (serve.py) on --device."""
    import numpy as np
    import torch

    from yolo_tpu_torch.models.predict import make_detector
    from yolo_tpu_torch.serve import DetectionServer

    cfg = _get_cfg(args)
    classifier = cfg.head_kind == "softmax"
    if classifier and (args.use_tree_map or args.hier_thresh is not None):
        raise SystemExit("--use-tree-map/--hier-thresh shape the "
                         "DETECTION decode; /classify scores leaf-"
                         "masked absolute probs with no threshold")
    tree_kw = {} if classifier else _tree_kw(args, cfg)
    net = _serve_net(args, cfg, classifier)
    mesh = None
    if args.dp:
        from yolo_tpu_torch.parallel import sharding as shd

        # every card of this process; --device cpu: a mesh of the CPU
        mesh = (shd.make_mesh() if net.device.type == "cuda"
                else shd.make_mesh(devices=[net.device]))
        print(f"DP serving over {len(mesh)} devices", file=sys.stderr)
    server = DetectionServer(
        cfg, net, host=args.host, port=args.port, max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms,
        adaptive_window=not args.no_adaptive_window,
        conf_threshold=args.conf, resize=args.resize, mesh=mesh, **tree_kw)
    if args.prewarm_shape and not classifier:
        # eager PyTorch compiles nothing; one call at batch 1 and at
        # --max-batch settles cuDNN's algorithm choice for the shape
        h, w = (int(v) for v in args.prewarm_shape.split("x"))
        print(f"prewarming batch sizes 1 and {args.max_batch} for "
              f"{h}x{w}...", file=sys.stderr)
        det = make_detector(cfg, conf_threshold=args.conf,
                            resize=args.resize, **tree_kw)
        with torch.no_grad():
            for b in sorted({1, args.max_batch}):
                det(net, torch.from_numpy(np.zeros(
                    (b, h, w, cfg.in_channels), np.uint8)).to(net.device))
    server.start()
    endpoint = "/classify" if classifier else "/detect"
    print(f"serving {cfg.name} on http://{args.host}:{server.port} "
          f"(POST {endpoint}, GET /healthz)", file=sys.stderr, flush=True)
    try:
        server.wait()
    finally:
        server.stop()


def cmd_bench(args) -> None:
    raise SystemExit("`bench` runs bench.py, the JAX package's benchmark; "
                     "the port's benchmark is not written yet (ROADMAP "
                     "A13)")


def _run(cmd) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"failed: {e}"
    return (proc.stdout.strip() if proc.returncode == 0
            else f"failed: {proc.stderr.strip()[-200:]}")


def cmd_doctor(args) -> None:
    """One JSON report of what the port depends on: torch and CUDA
    versions, the card's name and power limit, nvcc, a build and load of
    the CUDA kernels and of the host C library (the image decoders
    and the JPEG encoder), optional packages and the zoo's local files.
    Each failure is reported, not raised."""
    import importlib.util

    import torch

    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "cuda_available": torch.cuda.is_available(),
              "device_count": torch.cuda.device_count()}
    if torch.cuda.is_available():
        report["device"] = torch.cuda.get_device_name(0)
    smi = shutil.which("nvidia-smi")
    report["nvidia_smi"] = (_run([smi, "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"])
                            if smi else None)
    from yolo_tpu_torch.ops.cuda import build as cuda_build

    try:
        nvcc = cuda_build.nvcc_path()
        report["nvcc"] = nvcc
        report["nvcc_version"] = _run([nvcc, "--version"]).splitlines()[-1]
    except RuntimeError as e:
        report["nvcc"] = None
        report["nvcc_version"] = f"failed: {e}"
    try:
        path, seconds = cuda_build.build()
        cuda_build.library()
        report["cuda_kernels"] = {"library": path, "build_seconds": seconds,
                                  "sources": sorted(
                                      os.path.basename(s) for s in
                                      cuda_build._sources())}
    except Exception as e:  # reported: doctor diagnoses, it does not stop
        report["cuda_kernels"] = f"failed: {e}"
    from yolo_tpu_torch.native import build as native_build

    try:
        path, seconds = native_build.build()
        native_build.library()
        report["native_library"] = {"library": path,
                                    "build_seconds": seconds}
    except Exception as e:
        report["native_library"] = f"failed: {e}"
    for mod in ("triton", "cv2", "jax"):
        report[mod] = importlib.util.find_spec(mod) is not None
    from yolo_tpu_torch.io import zoo

    wdir = zoo.weights_dir()
    present = []
    if os.path.isdir(wdir):
        present = [n for n, e in zoo.load_manifest().items()
                   if os.path.exists(os.path.join(wdir, e["filename"]))]
    report["weights_dir"] = wdir
    report["zoo_present"] = present
    print(json.dumps(report, indent=2))
