"""Argument parser + command dispatch (the `main()` behind
`yolo-tpu-torch` / `python -m yolo_tpu_torch[.cli]`), port of
yolo_tpu/cli/_main.py: the same subcommands, flags and defaults, plus
--device on each command that computes."""

from __future__ import annotations

import argparse
from typing import Optional

import yolo_tpu_torch.cli as _pkg
from yolo_tpu_torch.cli._common import _add_common, _add_device
from yolo_tpu_torch.cli.detect_cmds import cmd_classify, cmd_detect, cmd_predict
from yolo_tpu_torch.cli.eval_cmd import cmd_eval, cmd_recall
from yolo_tpu_torch.cli.tools_cmds import (cmd_anchors, cmd_bench, cmd_doctor,
                                           cmd_export, cmd_partial, cmd_serve,
                                           cmd_zoo)
from yolo_tpu_torch.cli.train_cmd import cmd_train


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(prog="yolo_tpu_torch",
                                 description=_pkg.__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("predict", help="single-image detection")
    _add_common(p)
    _add_device(p)
    p.add_argument("--weights", required=True)
    p.add_argument("--image", required=True)
    p.add_argument("--output", default=None, help="write annotated image")
    p.add_argument("--save-labels", action="store_true",
                   help="write the detections as a YOLO-format .txt "
                        "label (darknet -save_labels pseudo-labeling: "
                        "the /images/->/labels/ path chain, else a "
                        "sibling .txt; trains directly via "
                        "--image-list)")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("classify",
                       help="classifier top-k prediction (darknet19/53)")
    _add_common(p)
    _add_device(p)
    p.add_argument("--weights", required=True)
    p.add_argument("--image", default=None)
    p.add_argument("--images", default=None,
                   help="imagefolder tree (<dir>/<class>/<image>): "
                        "report top-1/top-5 accuracy (darknet "
                        "`classifier valid` equivalent)")
    p.add_argument("--batch", type=int, default=32,
                   help="--images batch size (one jit bucket)")
    p.add_argument("--top", type=int, default=5,
                   help="print the top-k classes (default 5)")
    p.add_argument("--hierarchy", action="store_true",
                   help="tree classifiers ([softmax] tree=): print the "
                        "greedy root-to-leaf path with conditional and "
                        "absolute probabilities instead of flat top-k")
    p.set_defaults(fn=cmd_classify)

    p = sub.add_parser("detect",
                       help="batched detection over a directory or video")
    _add_common(p)
    _add_device(p)
    p.add_argument("--weights", required=True)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--images", default=None, help="image directory")
    src.add_argument("--video", default=None,
                     help="video file (Motion JPEG AVI under the native "
                          "decoder; any format and webcam indices under "
                          "--decoder cv2)")
    p.add_argument("--stride", type=int, default=1,
                   help="video: sample every Nth frame")
    p.add_argument("--max-frames", type=int, default=0,
                   help="video: stop after N sampled frames (0 = all)")
    p.add_argument("--save-video", default=None,
                   help="video: write an annotated MJPG copy here")
    p.add_argument("--output-dir", default=None,
                   help="images: write annotated copies here")
    p.add_argument("--recursive", action="store_true",
                   help="images: walk subdirectories too")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--host-preprocess", action="store_true",
                   help="letterbox on host: one compiled program for "
                        "mixed image sizes (device letterbox otherwise)")
    p.add_argument("--save-labels", action="store_true",
                   help="images: write each image's detections as a "
                        "YOLO-format .txt label (darknet -save_labels "
                        "pseudo-labeling; the /images/->/labels/ path "
                        "chain, else sibling .txt)")
    p.set_defaults(fn=cmd_detect)

    def _add_dataset(p, default_split):
        p.add_argument("--voc-root", default=None,
                       help="VOC dataset root (Annotations/, JPEGImages/, "
                            "ImageSets/)")
        p.add_argument("--split", default=default_split,
                       help="VOC ImageSets/Main split (VOC only)")
        p.add_argument("--coco-json", default=None,
                       help="COCO instances JSON (alternative to "
                            "--voc-root)")
        p.add_argument("--image-root", default=None,
                       help="image dir for --coco-json file_names "
                            "(default: the JSON's directory)")
        p.add_argument("--image-list", default=None,
                       help="darknet-native list file: one image path "
                            "per line, YOLO-format .txt label per "
                            "image (the .data train=/valid= format)")
        p.add_argument("--data", default=None,
                       help="darknet .data file: resolves the image "
                            "list (train= here, valid= for eval) and "
                            "names= when --names is absent")
        # which .data key this command trains/scores from
        p.set_defaults(_data_list_key="train" if default_split == "train"
                       else "valid")

    p = sub.add_parser("train", help="fine-tune on VOC or COCO data")
    _add_common(p)
    _add_device(p)
    p.add_argument("--weights", default=None,
                   help=".weights init (full file or darknet partial; "
                        "required for detectors, optional for "
                        "classifiers — scratch init without it)")
    p.add_argument("--imagefolder", default=None,
                   help="classifier training data: <dir>/<class>/"
                        "<image> imagefolder (softmax-head models)")
    p.add_argument("--eval-imagefolder", default=None,
                   help="held-out imagefolder scored every --eval-every "
                        "steps during classifier training (top-1; best "
                        "checkpoint saved as 'best')")
    _add_dataset(p, "train")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch", type=int, default=None,
                   help="images per optimizer step (default: the "
                        "cfg's [net] batch, else 32)")
    p.add_argument("--grad-accum", type=int, default=None,
                   help="sequential sub-batches per optimizer step "
                        "(darknet [net] subdivisions: gradient "
                        "accumulation with per-sub-batch BN stats; "
                        "default: the cfg's subdivisions, else 1 — "
                        "pass 1 to force one whole-batch pass)")
    p.add_argument("--lr", type=float, default=None,
                   help="learning rate (default: the cfg's [net] "
                        "learning_rate, else 1e-4)")
    p.add_argument("--optimizer", default=None,
                   choices=["sgd", "adam"],
                   help="default: the cfg's [net] adam=1 key, else sgd "
                        "(darknet); cfg B1/B2/eps flow into Adam")
    p.add_argument("--ema-alpha", type=float, default=None,
                   help="per-step weight EMA (darknet [net] ema_alpha, "
                        "scaled-yolov4 cfgs use 0.9998); checkpoints "
                        "keep both tracks and consumers prefer the EMA; "
                        "default from the cfg, else off")
    p.add_argument("--ema-start-step", type=int, default=None,
                   help="step the EMA starts blending at (darknet: "
                        "max_batches/2 — derived from the cfg when "
                        "present; before it the track mirrors the live "
                        "weights)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize conv activations in backward "
                        "(less HBM, more FLOPs; for large batch/608)")
    p.add_argument("--burn-in", type=int, default=None,
                   help="darknet burn-in steps (quartic lr ramp; "
                        "default: the cfg's [net] burn_in, else 0)")
    p.add_argument("--lr-steps", default=None,
                   help="comma-separated steps for lr decay (darknet "
                        "policy=steps)")
    p.add_argument("--lr-scales", default=None,
                   help="comma-separated decay factors matching --lr-steps")
    p.add_argument("--augment", action="store_true",
                   help="darknet-style jitter/flip/HSV augmentation")
    p.add_argument("--no-augment", action="store_true",
                   help="disable ALL augmentation, including "
                        "cfg-driven keys")
    p.add_argument("--mosaic", action="store_true",
                   help="yolov4 mosaic: 4-image composites (implies "
                        "--augment)")
    p.add_argument("--mixup", action="store_true",
                   help="AlexeyAB mixup: 0.5/0.5 two-image blends with "
                        "concatenated truths (implies --augment)")
    p.add_argument("--multi-scale", action="store_true")
    p.add_argument("--multi-scale-every", type=int, default=None,
                   help="resize interval in batches (darknet resizes "
                        "every 10)")
    p.add_argument("--multi-scale-sizes", default=None,
                   help="comma-separated sizes: square ints (default "
                        "darknet 320..608) or WIDTHxHEIGHT rect "
                        "buckets (rect nets default to an "
                        "aspect-preserving x1.4 ladder)")
    p.add_argument("--allow-deviations", action="store_true",
                   help="train official cfgs whose keys have no "
                        "pinnable semantics here by falling back to "
                        "documented nearby semantics instead of "
                        "rejecting (currently: [yolo] "
                        "objectness_smooth=1 trains with SHARP "
                        "objectness targets, i.e. "
                        "objectness_smooth=0) — each fallback prints "
                        "one warning")
    p.add_argument("--prewarm", action="store_true",
                   help="compile all multi-scale buckets before training "
                        "(nothing to compile in eager PyTorch)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--eval-every", type=int, default=0,
                   help="validation mAP every N steps (logged as "
                        "val_map)")
    p.add_argument("--eval-split", default=None,
                   help="VOC split for --eval-every (default: the "
                        "training samples)")
    p.add_argument("--eval-coco-json", default=None,
                   help="held-out COCO instances file for --eval-every")
    p.add_argument("--eval-image-list", default=None,
                   help="held-out darknet list file for --eval-every "
                        "(auto-filled from --data valid=, darknet's "
                        "-map behavior)")
    p.add_argument("--eval-max-images", type=int, default=0,
                   help="cap validation set size (0 = all)")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory to resume from (the "
                        "model, optimizer, step and data position)")
    p.add_argument("--keep-seen", action="store_true",
                   help="keep darknet 'seen' counter (affects loss warmup)")
    p.add_argument("--loader", default="threads",
                   choices=["threads", "grain"],
                   help="grain = deterministic multiprocess pipeline "
                        "whose data position resumes with --resume")
    p.add_argument("--loader-workers", type=int, default=0,
                   help="grain worker processes (0 = in-process)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-file", default=None)
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--fail-after-step", type=int, default=0,
                   help="debug: abort after N steps to exercise resume")
    p.set_defaults(fn=cmd_train)

    # "test" is the reference's name for the evaluation mode (SURVEY.md
    # §1 L7: train/predict/test); both names map to the same command.
    p = sub.add_parser("eval", aliases=["test"], help="mAP evaluation")
    _add_common(p)
    _add_device(p)
    p.add_argument("--weights", default=None,
                   help="required unless --from-detections")
    _add_dataset(p, "test")
    p.add_argument("--from-detections", default=None,
                   help="score a saved results JSON (--save-detections "
                        "format) instead of running the model")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--eval-conf", type=float, default=0.005,
                   help="low threshold for PR-curve coverage")
    p.add_argument("--metric", default=None,
                   choices=["voc07", "voc10", "coco"],
                   help="voc07 = 11-point (default), voc10 = AUC, "
                        "coco = mAP@[.5:.95] 101-point")
    p.add_argument("--use-2010-metric", action="store_true",
                   help="alias for --metric voc10")
    p.add_argument("--save-detections", default=None,
                   help="write raw detections as a pycocotools-style "
                        "results JSON (original image/category ids)")
    p.add_argument("--save-pr", default=None,
                   help="write per-class PR curves (scores/recall/"
                        "precision) as JSON — VOC metrics only")
    p.add_argument("--save-voc-dir", default=None,
                   help="write per-class VOC-devkit submission files "
                        "(comp4_det_test_<class>.txt, darknet "
                        "`detector valid` format)")
    p.add_argument("--stats", action="store_true",
                   help="print darknet -map's conf-threshold console "
                        "block (precision/recall/F1, TP/FP/FN, average "
                        "IoU) and merge the numbers into the JSON")
    p.add_argument("--stats-thresh", type=float, default=0.25,
                   help="--stats confidence threshold (darknet's "
                        "thresh_calc_avg_iou, default .25)")
    p.set_defaults(fn=cmd_eval)

    # darknet `detector recall`: class-agnostic proposal recall
    p = sub.add_parser("recall",
                       help="proposal recall / avg IoU (darknet "
                            "`detector recall`)")
    _add_common(p)
    _add_device(p)
    p.add_argument("--weights", required=True)
    _add_dataset(p, "test")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--thresh", type=float, default=0.001,
                   help="objectness proposal threshold (darknet's "
                        "hardcoded .001)")
    p.add_argument("--nms-thresh", type=float, default=0.4,
                   help="objectness-NMS IoU threshold (darknet's .4)")
    p.add_argument("--iou-thresh", type=float, default=0.5,
                   help="GT-match IoU threshold (darknet's .5)")
    p.set_defaults(fn=cmd_recall)

    p = sub.add_parser("partial",
                       help="extract the first N layers' weights "
                            "(darknet `partial`)")
    _add_common(p)
    p.add_argument("--weights", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--layers", type=int, required=True,
                   help="darknet layer-index cutoff (e.g. 23 -> "
                        ".conv.23)")
    p.set_defaults(fn=cmd_partial)

    p = sub.add_parser("zoo", help="pretrained-weights manifest tools")
    p.add_argument("action", choices=["list", "verify", "pin-sha"])
    p.add_argument("--name", default=None, help="zoo entry name")
    p.add_argument("--file", default=None,
                   help="file to check (default: the entry's path under "
                        "$YOLO_TPU_WEIGHTS_DIR)")
    p.set_defaults(fn=cmd_zoo)

    p = sub.add_parser("anchors",
                       help="k-means anchor clustering over GT boxes")
    _add_common(p)
    _add_dataset(p, "train")
    p.add_argument("--num-anchors", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_anchors)

    p = sub.add_parser("export", help="checkpoint -> darknet .weights "
                       "(a JAX orbax checkpoint converts first with "
                       "tools/ckpt_to_torch.py)")
    p.add_argument("--live-weights", action="store_true",
                   help="export the raw weights even when the "
                        "checkpoint carries an EMA track")
    _add_common(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--save-cfg", default=None,
                   help="also write the darknet .cfg (+.names) for the "
                        "exported weights")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("serve", help="HTTP detection/classification endpoint")
    _add_common(p)
    _add_device(p)
    p.add_argument("--weights", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="micro-batch collection window")
    p.add_argument("--no-adaptive-window", action="store_true",
                   help="always wait the full window (default: skip it "
                        "when recent traffic is single-client)")
    p.add_argument("--dp", action="store_true",
                   help="shard micro-batches over all visible devices")
    p.add_argument("--calibration-image", default=None)
    p.add_argument("--prewarm-shape", default=None, metavar="HxW",
                   help="compile all batch buckets for this input shape "
                        "at startup (e.g. 480x640)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("bench", help="throughput benchmark (bench.py is "
                       "the JAX package's; ROADMAP A13)")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=15)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("doctor",
                       help="environment diagnostics (torch, CUDA, the "
                            "card, nvcc, kernel and native builds, zoo)")
    p.add_argument("--probe-timeout", type=float, default=90.0,
                   help="accepted for the JAX CLI's argument list; the "
                        "port's doctor runs no backend probe")
    p.set_defaults(fn=cmd_doctor)

    args = ap.parse_args(argv)
    if hasattr(args, "decoder"):
        # always set (the native default too), so that one in-process
        # call's choice does not leak into the next
        from yolo_tpu_torch.data.pipeline import set_decoder

        try:
            set_decoder(args.decoder)
        except (ValueError, ImportError) as e:
            raise SystemExit(f"--decoder {args.decoder}: {e}")
    if getattr(args, "data", None):
        from yolo_tpu_torch.cli._common import _apply_data_file

        _apply_data_file(args)
    args.fn(args)
