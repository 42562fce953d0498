#!/usr/bin/env python3
"""Repeat chip_smoke.py's phase 13 (c), the yolov4-tiny Adam overfit
scored card against CPU, and log every detection one device keeps that
the other does not match. Run from the repo root on a CUDA machine:

    python3 tools/eval_agreement.py [--repeat N] [--early]

Each repeat trains anew from the same seeded start (cuDNN's backward
makes the states differ between runs) and runs chip_smoke.py's
card_vs_cpu_eval on the overfit state and on its EARLY_STEPS snapshot.
Prints one JSON line a repeat (the "eval_misses" lines of chip_smoke.py
before it, where a detection was unmatched) and a summary line last.

--early trains only the EARLY_STEPS of the snapshot and measures the
cut that collect_detections' cap of EVAL_MAX_DETECTIONS makes in each
image: the score gap between the last kept detection and the first cut
one on each device, against the card-CPU score differences of the same
box (same class, IoU >= 0.999: their median, 99th percentile and
largest); an image whose gap is below such a difference can swap a
detection across the cap. It also runs card_vs_cpu_eval on the
snapshot.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def early_cut(cfg, params, pairs, held_out) -> None:
    """One EARLY_STEPS snapshot of yolo_overfit's Adam run: the cap's
    score gaps on both devices and card_vs_cpu_eval's verdict."""
    scenes = pairs[:cs.YOLO_OVERFIT_SCENES]
    with cs.DevicePrefetcher(cs.host_batches(
            cfg, scenes, cs.YOLO_OVERFIT_SCENES, cs.SEED,
            shuffle=False)) as staged:
        batch = next(iter(staged))
    ocfg = cs.TrainConfig(optimizer="adam", learning_rate=1e-3,
                          weight_decay=0.0005,
                          yolo_loss=cs.yolo_loss_config(cfg))
    state = cs.init_state(cfg, params, ocfg)
    step = cs.make_train_step(cfg, ocfg)
    for _ in range(cs.EARLY_STEPS):
        step(state, batch)
    folded = cs.fold_params(cfg.layers, cs.ema_params_of(state), cfg.bn_eps)
    cap = cs.EVAL_MAX_DETECTIONS
    dets = {dev: cs.uncapped_detections(cfg, folded, held_out, dev)
            for dev in ("cuda", "cpu")}
    diffs, gaps, full = [], {"cuda": [], "cpu": []}, 0
    for img in dets["cuda"]:
        for dev in gaps:
            s = [d[1] for d in dets[dev][img]]
            if len(s) > cap:
                gaps[dev].append(s[cap - 1] - s[cap])
        full += min(len(dets[d][img]) for d in gaps) > cap
        other = dets["cpu"][img]
        boxes = np.array([o for _, _, *o in other], np.float64).reshape(-1, 4)
        classes = np.array([c for c, *_ in other])
        for cls, score, *box in dets["cuda"][img]:
            same = np.nonzero(classes == cls)[0]
            if not len(same):
                continue
            iou = cs._iou_xyxy_voc(np.asarray(box, np.float64), boxes[same])
            j = int(np.argmax(iou))
            if iou[j] >= 0.999:
                diffs.append(abs(score - other[same[j]][1]))
    worst = max(diffs)
    p99 = float(np.quantile(diffs, 0.99))
    below = {dev: {"max": sum(g < worst for g in v),
                   "p99": sum(g < p99 for g in v)}
             for dev, v in gaps.items()}
    gt, _ = cs.build_ground_truth(held_out, cfg.class_names)
    verdict = cs.card_vs_cpu_eval(cfg, folded, held_out, gt, "early", 1)
    cs.emit({"early_steps": cs.EARLY_STEPS, "images": len(dets["cuda"]),
             "images_past_cap_both": full,
             "score_diff_max": worst, "score_diff_p99": p99,
             "score_diff_median": float(np.median(diffs)),
             "pairs": len(diffs),
             "cap_gap_min": {d: min(v, default=None)
                             for d, v in gaps.items()},
             "cap_gap_median": {d: float(np.median(v)) if v else None
                                for d, v in gaps.items()},
             "images_gap_below_diff": below, "card_vs_cpu": verdict})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=10)
    ap.add_argument("--early", action="store_true")
    args = ap.parse_args()
    card = cs.nvidia_smi()
    cs.build.build()
    cs.build.library()
    rng = np.random.default_rng(cs.SEED + 13)
    palette = rng.integers(0, 256, (len(cs.VOC_NAMES), 3), dtype=np.uint8)
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        roots = [os.path.join(tmp, d) for d in ("train", "held_out")]
        for d in roots:
            os.mkdir(d)
        pairs, held_out = (
            cs.write_voc_scenes(d, [cs.SCENE_HW[i % len(cs.SCENE_HW)]
                                    for i in range(n)], rng, palette=palette)
            for d, n in zip(roots, (cs.TRAIN_SCENES, cs.HELD_OUT_SCENES)))
        cfg = cs.voc_variant(cs.YOLO_OVERFIT)
        params = cs.fine_tune_init(cfg, tmp, *cs.YOLO_PARTIALS[cs.YOLO_OVERFIT])
        for i in range(args.repeat):
            t0 = time.perf_counter()
            try:
                if args.early:
                    early_cut(cfg, params, pairs, held_out)
                else:
                    cs.yolo_overfit(cfg, params, pairs, held_out, card)
                err = None
            except RuntimeError as e:
                err = str(e)
                failed += 1
            cs.emit({"repeat": i, "ok": err is None, "error": err,
                     "seconds": time.perf_counter() - t0})
    print(json.dumps({"repeats": args.repeat, "failed": failed,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
