#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (yolo_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (the kernels are built from
yolo_tpu_torch/csrc/ into build/yolo_tpu_torch/). Phases, each printing
JSON lines; any failed check raises and the script exits non-zero:

  1. device   nvidia-smi name and power limit, torch and CUDA versions
  2. build    compile the CUDA kernels from the checkout
  3. kernel   CUDA greedy-NMS suppress vs its plain PyTorch version on
              crowded scenes at the served shapes: identical keep masks
  4. serve    YOLOv2-COCO 416 (full width, seeded random weights written
              as a darknet .weights file) through yolo_tpu_torch.load and
              DetectionServer: HTTP responses equal direct detector calls,
              the kernel's launch counter rose, bf16 agrees with the fp32
              plain path at box level
  5. times    CUDA events: suppress vs plain per call over a run of
              back-to-back calls; end-to-end detector latency (median of
              synchronized calls) at batch 1/32/128 (raw 480x640 uint8
              in, bf16)

Then the kernels line, the nvidia-smi line and, last, the device line
{"ok": true, "device": {...}}. Exits non-zero without printing a result
when CUDA is not available.
"""

import http.client
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

import yolo_tpu_torch
from yolo_tpu_torch.configs import get_variant
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models.predict import make_detector
from yolo_tpu_torch.ops.cuda import build, nms_kernel
from yolo_tpu_torch.ops.nms import _geom, _suppress_torch
from yolo_tpu_torch.serve import DetectionServer, detections_to_json

SEED = 0
VARIANT = "coco"          # YOLOv2-COCO, 416x416, 80 classes, 5 anchors
SRC_HW = (480, 640)
CONF = 0.3                # suppress test threshold (phase 3)
IOU = 0.45
# (G, K) suppression grids of the served path: the fused head at conf
# >= 0.3 hands the kernel G = batch rows of K = 128 (K = 256 below 0.3,
# and for nms_batch's global top-K); exact per-class NMS is G = B * 80
KERNEL_SHAPES = [(1, 128), (1, 256), (32, 128), (32, 256), (32 * 80, 128)]
TIMED_SHAPE = (32, 128)   # the kernels line's ms / plain_ms
E2E_BATCHES = (1, 32, 128)
# box-level agreement of two detectors: a detection clearly above the
# confidence threshold (by MARGIN) must have a same-class partner with
# IoU >= MATCH_IOU in the other run, for at least MIN_MATCH of them
MARGIN = 0.05
MATCH_IOU = 0.5
MIN_MATCH = 0.9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def crowded_rows(rng, g, k, per_class):
    """(G, K) candidate rows where many boxes overlap
    (tests/test_nms_impls.py::_scene geometry), scores sorted desc. Mixed
    classes per row for the fused head; one class per row for the exact
    per-class grid."""
    boxes = np.stack([rng.uniform(0.1, 0.9, (g, k)),
                      rng.uniform(0.1, 0.9, (g, k)),
                      rng.uniform(0.05, 0.3, (g, k)),
                      rng.uniform(0.05, 0.3, (g, k))], -1).astype(np.float32)
    scores = -np.sort(-rng.uniform(0, 1, (g, k)), axis=1).astype(np.float32)
    if per_class:
        classes = np.repeat(rng.integers(0, 80, (g, 1)), k, axis=1)
    else:
        classes = rng.integers(0, 5, (g, k))
    dev = torch.device("cuda")
    return (_geom(torch.from_numpy(boxes).to(dev)).contiguous(),
            torch.from_numpy(scores).to(dev),
            torch.from_numpy(classes.astype(np.float32)).to(dev))


def cuda_ms_per_call(fn, calls: int, warmup: int = 2) -> float:
    """Device time per call: CUDA events around a run of back-to-back
    calls, divided by their number (a kernel's own time once launches
    queue faster than the device drains them)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def cuda_median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times, each call synchronized: the
    latency a lone caller sees."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def seeded_coco_weights(cfg, path: str) -> None:
    """Seeded random YOLOv2-COCO weights as a darknet .weights file: He
    scaled, box channels x0.1, objectness bias -2, so that boxes keep
    their anchors' size and most cells hold no object, as in a trained
    detector (io.darknet_weights.synthetic_detector_params; PERF.md
    reports the sweep of these two settings)."""
    dw.save(path, cfg.layers, dw.synthetic_detector_params(cfg, SEED))


def post_npy(port: int, image) -> list:
    buf = io.BytesIO()
    np.save(buf, image)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/detect", body=buf.getvalue(),
                     headers={"Content-Type": "application/x-npy"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
    finally:
        conn.close()
    check(resp.status == 200, f"/detect returned {resp.status}: {body}")
    return body["detections"]


def _iou(a, b) -> float:
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union if union > 0 else 0.0


def match_rate(ref: list, other: list, conf: float) -> tuple:
    """(matched, total) over ref's detections scoring >= conf + MARGIN:
    matched when other holds a same-class box with IoU >= MATCH_IOU."""
    sure = [d for d in ref if d["score"] >= conf + MARGIN]
    hit = sum(any(o["class"] == d["class"]
                  and _iou(o["box_xyxy"], d["box_xyxy"]) >= MATCH_IOU
                  for o in other) for d in sure)
    return hit, len(sure)


def check_agree(a: list, b: list, conf: float, what: str) -> dict:
    """Box-level agreement both ways over per-image result lists."""
    stats = {}
    for name, (x, y) in (("a_in_b", (a, b)), ("b_in_a", (b, a))):
        hit = tot = 0
        for xi, yi in zip(x, y):
            h, t = match_rate(xi, yi, conf)
            hit, tot = hit + h, tot + t
        check(tot > 0, f"{what}: no detection above conf + margin")
        stats[name] = hit / tot
        check(hit / tot >= MIN_MATCH, f"{what}: {name} match rate "
              f"{hit}/{tot} < {MIN_MATCH}")
    return stats


def phase_kernel(rng) -> float:
    worst = 0.0
    for g, k in KERNEL_SHAPES:
        geom, scores, classes = crowded_rows(rng, g, k, per_class=g > 32)
        got = nms_kernel.suppress(geom, scores, classes,
                                  conf_threshold=CONF, iou_threshold=IOU)
        torch.cuda.synchronize()
        want = _suppress_torch(geom, scores, classes, CONF, IOU)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        n_above = int((scores >= CONF).sum())
        n_kept = int(want.sum())
        emit({"phase": "kernel", "shape": [g, 5, k], "identical":
              bool(torch.equal(got, want)), "max_abs_err": err,
              "kept": n_kept, "above_conf": n_above})
        check(torch.equal(got, want), f"suppress keep mask differs from "
              f"the plain version at (G, K) = ({g}, {k})")
        check(0 < n_kept < n_above, f"({g}, {k}) scene suppresses nothing")
    return worst


def phase_serve(weights_path: str) -> tuple:
    model =yolo_tpu_torch.load(weights_path, VARIANT, device="cuda")
    model32 = yolo_tpu_torch.load(weights_path, VARIANT, device="cuda",
                                  precision="fp32")
    cfg = model.cfg
    check(cfg.input_hw == (416, 416) and cfg.num_classes == 80
          and cfg.num_anchors == 5, f"unexpected config {cfg.name}")
    names = cfg.detection_names()
    rng = np.random.default_rng(SEED + 1)
    images = rng.integers(0, 256, (6, *SRC_HW, 3), dtype=np.uint8)

    server = DetectionServer(cfg, model.params, port=0, max_batch=32)
    server.start()
    try:
        nms_kernel.launches = 0
        sequential = [post_npy(server.port, images[i]) for i in range(3)]
        burst = [None] * len(images)

        def one(i):
            burst[i] = post_npy(server.port, images[i])

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        launches = nms_kernel.launches
        stats = dict(server.stats)
    finally:
        server.stop()
    check(all(not t.is_alive() for t in threads), "a burst request hung")
    check(all(b is not None for b in burst), "a burst request failed")
    check(launches > 0, "the served path never launched the NMS kernel")
    check(stats["errors"] == 0, f"server errors: {stats}")

    # direct calls of the same detector on the same images
    direct = [detections_to_json(model(images[i:i + 1]), names)[0]
              for i in range(len(images))]
    for i, resp in enumerate(sequential):
        check(resp == direct[i], f"response {i} differs from the direct "
              f"detector call")
    conf = cfg.conf_threshold
    burst_agree = check_agree(direct, burst, conf, "burst vs direct")

    out = model(images)
    for key, shape in (("boxes", (6, 100, 4)), ("scores", (6, 100)),
                       ("classes", (6, 100)), ("valid", (6, 100))):
        check(tuple(out[key].shape) == shape, f"{key} shape "
              f"{tuple(out[key].shape)}")
    check(bool(torch.isfinite(out["boxes"]).all())
          and bool(torch.isfinite(out["scores"]).all()),
          "non-finite detections")
    # fp32 through the plain path: full decode + exact per-class NMS in
    # plain PyTorch, fp32 convs without TF32
    plain = make_detector(cfg, head="reference", nms_impl="torch")
    ref = detections_to_json(plain(model32.params,
                                   torch.from_numpy(images).cuda()), names)
    precision_agree = check_agree(ref, direct, conf, "bf16 vs fp32 plain")
    emit({"phase": "serve", "model": cfg.name,
          "input_hw": list(cfg.input_hw), "requests": stats["requests"],
          "batches": stats["batches"],
          "max_batch_seen": stats["max_batch_seen"],
          "kernel_launches": launches,
          "responses_equal_direct": True,
          "detections_per_image": [len(d) for d in direct],
          "burst_vs_direct": burst_agree,
          "bf16_vs_fp32_plain": precision_agree,
          "agreement_rule": {"margin": MARGIN, "iou": MATCH_IOU,
                             "min_match": MIN_MATCH}})
    return launches, model


def phase_times(rng, model, card: str) -> dict:
    timed = {}
    for g, k in KERNEL_SHAPES:
        geom, scores, classes = crowded_rows(rng, g, k, per_class=g > 32)
        ms = cuda_ms_per_call(lambda: nms_kernel.suppress(
            geom, scores, classes, conf_threshold=CONF,
            iou_threshold=IOU), calls=200)
        plain_ms = cuda_ms_per_call(lambda: _suppress_torch(
            geom, scores, classes, CONF, IOU), calls=5)
        timed[(g, k)] = (ms, plain_ms)
        emit({"phase": "times", "what": "suppress", "shape": [g, 5, k],
              "kernel_ms": ms, "plain_ms": plain_ms, "card": card})
    for b in E2E_BATCHES:
        images = torch.from_numpy(np.random.default_rng(b).integers(
            0, 256, (b, *SRC_HW, 3), dtype=np.uint8)).cuda()
        ms = cuda_median_ms(lambda: model(images), reps=10)
        emit({"phase": "times", "what": "detector_e2e_bf16", "batch": b,
              "src_hw": list(SRC_HW), "ms": ms, "img_per_s": b * 1000 / ms,
              "card": card})
    return timed


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    lib, compile_s = build.build()
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": compile_s,
          "library": os.path.relpath(lib, os.path.dirname(
              os.path.abspath(__file__)))})

    rng = np.random.default_rng(SEED)
    worst = phase_kernel(rng)

    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "yolov2-coco-seed.weights")
        seeded_coco_weights(get_variant(VARIANT), weights)
        launches, model = phase_serve(weights)

    timed = phase_times(rng, model, card)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "yolo_tpu"))
    check(not foreign, f"the port loaded JAX or the JAX package: {foreign}")
    ms, plain_ms = timed[TIMED_SHAPE]
    emit({"kernels": [{
        "name": "nms_suppress", "route": "cuda",
        "source": "yolo_tpu_torch/csrc/nms_suppress.cu",
        "replaces": "yolo_tpu/ops/pallas/nms_kernel.py:115",
        "launches": launches, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
