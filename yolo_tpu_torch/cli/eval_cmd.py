"""`eval`/`test` (VOC and COCO mAP) and `recall` (darknet `detector
recall`): port of yolo_tpu/cli/eval_cmd.py."""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from yolo_tpu_torch.cli._common import (_compute_dtype, _dataset_samples,
                                        _device, _get_cfg, _load_params,
                                        _maybe_quantize, _refuse_yolov1,
                                        _require_detection, _tree_kw)


def _served_params(args, cfg, pairs):
    """--weights folded, or at --precision int8 calibrated on the first
    8 samples' images (the JAX commands' calibration set)."""
    from yolo_tpu_torch.data.pipeline import load_image

    if args.precision != "int8":
        return _load_params(args, cfg)
    _refuse_yolov1(cfg)
    params = _load_params(args, cfg)
    return _maybe_quantize(args, cfg, params, [
        load_image(p, cfg.in_channels) for p, _ in pairs[:8]])


def _write_voc_detections(out_dir: str, detections, samples, names,
                          gt) -> None:
    """darknet `detector valid` comp4 files: one
    comp4_det_test_<class>.txt per class (every one created, even
    empty), lines '<image_id> <score> <xmin> <ymin> <xmax> <ymax>' in the
    VOC devkit's 1-based pixels (+1 on each corner, clamped to [1, w] x
    [1, h]), '%f' formatting; the image id is the file's basename without
    its extension."""
    os.makedirs(out_dir, exist_ok=True)
    lines = {c: [] for c in range(len(names))}
    for img_id, (path, _ann) in enumerate(samples):
        w, h = gt[img_id]["width"], gt[img_id]["height"]
        stem = os.path.splitext(os.path.basename(path))[0]
        for (c, s, x1, y1, x2, y2) in detections.get(img_id, ()):
            xmin = max(1.0, x1 + 1.0)
            ymin = max(1.0, y1 + 1.0)
            xmax = min(float(w), x2 + 1.0)
            ymax = min(float(h), y2 + 1.0)
            lines[c].append(f"{stem} {s:f} {xmin:f} {ymin:f} "
                            f"{xmax:f} {ymax:f}\n")
    for c, name in enumerate(names):
        with open(os.path.join(out_dir, f"comp4_det_test_{name}.txt"),
                  "w") as f:
            f.writelines(lines[c])
    n = sum(len(v) for v in lines.values())
    print(f"wrote {n} detections to {out_dir}/comp4_det_test_*.txt "
          f"({len(names)} class files)", file=sys.stderr)


def cmd_recall(args) -> None:
    """darknet `detector recall`: cumulative class-agnostic proposal
    recall / avg IoU / proposals per image, per-image lines on stderr,
    one summary JSON line on stdout (eval/recall.py)."""
    from yolo_tpu_torch.eval.recall import recall_detector

    cfg = _get_cfg(args)
    _require_detection(cfg, "recall")
    # recall is class-agnostic, but name-mapped annotations drop boxes
    # whose names do not resolve: the same names as `eval`
    names = cfg.detection_names(_tree_kw(args, cfg)["use_tree_map"])
    dtype = _compute_dtype(args.precision)
    device = _device(args)
    pairs = _dataset_samples(args, cfg, names=names)
    stats = recall_detector(
        cfg, _served_params(args, cfg, pairs), pairs, batch=args.batch,
        thresh=args.thresh, nms=args.nms_thresh, iou_thresh=args.iou_thresh,
        compute_dtype=dtype, resize=args.resize, names=names, device=device)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in stats.items()}))


def cmd_eval(args) -> None:
    """VOC (or COCO) mAP over a dataset; --resize stretch scores with
    AlexeyAB's plain-resize geometry."""
    from yolo_tpu_torch.eval.runner import (build_ground_truth,
                                            collect_detections)
    from yolo_tpu_torch.eval.voc_map import evaluate

    cfg = _get_cfg(args)
    _require_detection(cfg, "eval")
    tree_kw = _tree_kw(args, cfg)
    # tree-map eval scores the projected class list
    names = cfg.detection_names(tree_kw["use_tree_map"])
    ncls = len(names)
    if not args.from_detections and not args.weights:
        raise SystemExit("--weights is required (or score a saved "
                         "results file with --from-detections)")
    metric = args.metric or ("voc10" if args.use_2010_metric
                             else "voc07")
    if args.save_pr and metric == "coco":
        # checked before the model runs, not after the sweep
        raise SystemExit("--save-pr exports VOC-protocol PR curves; "
                         "use --metric voc07/voc10 with it")
    dtype = None if args.from_detections else _compute_dtype(args.precision)
    device = None if args.from_detections else _device(args)
    pairs = _dataset_samples(args, cfg, names=names)
    gt, orig_ids = build_ground_truth(pairs, names)

    if args.from_detections:
        # a saved results file (pycocotools loadRes schema), no model run
        if args.coco_json:
            from yolo_tpu_torch.data.coco import category_ids

            cls_of = {v: k for k, v in category_ids(
                args.coco_json, names).items()}
        else:
            cls_of = {c: c for c in range(ncls)}
        inv = {orig: i for i, orig in orig_ids.items()}
        detections = {i: [] for i in orig_ids}
        with open(args.from_detections) as f:
            for r in json.load(f):
                i = inv.get(r["image_id"])
                c = cls_of.get(r["category_id"])
                if i is None or c is None:
                    continue
                x, y, bw, bh = r["bbox"]
                detections[i].append((c, float(r["score"]),
                                      x, y, x + bw, y + bh))
    else:
        detections = collect_detections(
            cfg, _served_params(args, cfg, pairs), pairs, batch=args.batch,
            eval_conf=args.eval_conf, compute_dtype=dtype,
            resize=args.resize, device=device, **tree_kw)

    if args.save_detections:
        # pycocotools loadRes format: original image/category ids,
        # top-left xywh pixel boxes; a COCO results file holds only the
        # dataset's own categories
        if args.coco_json:
            from yolo_tpu_torch.data.coco import category_ids

            cat_of = category_ids(args.coco_json, names)
        else:
            cat_of = {c: c for c in range(ncls)}
        results = [
            {"image_id": orig_ids[img_id], "category_id": cat_of[c],
             "bbox": [round(x1, 2), round(y1, 2),
                      round(x2 - x1, 2), round(y2 - y1, 2)],
             "score": round(s, 5)}
            for img_id, dets in detections.items()
            for (c, s, x1, y1, x2, y2) in dets if c in cat_of]
        with open(args.save_detections, "w") as f:
            json.dump(results, f)
        print(f"wrote {len(results)} detections to "
              f"{args.save_detections}", file=sys.stderr)

    if args.save_voc_dir:
        _write_voc_detections(args.save_voc_dir, detections, pairs,
                              names, gt)

    stats = None
    if args.stats:
        # darknet -map's conf-threshold block: two lines on stderr, the
        # numbers merged into the stdout JSON
        from yolo_tpu_torch.eval.voc_map import (detection_stats,
                                                 print_detection_stats)

        if args.eval_conf > args.stats_thresh:
            print(f"note: --eval-conf {args.eval_conf} > --stats-thresh "
                  f"{args.stats_thresh}: detections below --eval-conf "
                  f"were never collected", file=sys.stderr)
        stats = detection_stats(detections, gt, ncls,
                                conf_thresh=args.stats_thresh)
        print_detection_stats(stats, args.stats_thresh)
        stats = {"tp": stats["tp"], "fp": stats["fp"],
                 "fn": stats["fn"],
                 "precision": round(stats["precision"], 4),
                 "recall": round(stats["recall"], 4),
                 "f1": round(stats["f1"], 4),
                 "avg_iou": round(stats["avg_iou"], 4)}

    if metric == "coco":
        from yolo_tpu_torch.eval.coco_map import evaluate_coco

        result = evaluate_coco(detections, gt, ncls)
        out = {k: round(result[k], 4) for k in (
            "map", "map50", "map75", "map_small", "map_medium",
            "map_large", "ar1", "ar10", "ar", "ar_small", "ar_medium",
            "ar_large") if k in result}
        out["ap"] = {names[c]: round(a, 4) for c, a in result["ap"].items()}
        if stats is not None:
            out["stats"] = stats
        print(json.dumps(out))
        return
    result = evaluate(detections, gt, ncls,
                      use_07_metric=metric == "voc07",
                      return_curves=bool(args.save_pr))
    if args.save_pr:
        with open(args.save_pr, "w") as f:
            json.dump({names[c]: v
                       for c, v in result["curves"].items()}, f)
        print(f"wrote PR curves to {args.save_pr}", file=sys.stderr)
    per_class = {names[c]: round(a, 4)
                 for c, a in result["ap"].items() if not np.isnan(a)}
    out = {"map": round(result["map"], 4), "ap": per_class}
    if stats is not None:
        out["stats"] = stats
    print(json.dumps(out))
