#!/usr/bin/env python3
"""Measurements of the PyTorch/CUDA port (yolo_tpu_torch) on one card,
beyond chip_smoke.py's. Run from the repo root on a CUDA machine:

    python3 tools/port_perf.py weights W.weights
        write chip_smoke.py's seeded YOLOv2-COCO weights to W.weights
    python3 tools/port_perf.py time --weights W.weights [--tree DIR]
                                    [--route ROUTE]
        end-to-end detector latency, CUDA-event median of 20 synchronized
        calls after 3 warm-up calls, at batch 1/32/128 (raw 480x640 uint8 on the card, bf16).
        --tree DIR times the yolo_tpu_torch of another checkout (an A/B:
        run parent, change, change, parent in one machine session)
    python3 tools/port_perf.py profile [--route ROUTE]
        torch.profiler breakdown of the same calls (5 calls after 3
        warm-up calls): device time per call by kernel class, wall time,
        busy share, peak memory
    python3 tools/port_perf.py sweep
        the seeded weights' head shaping (box scale x objectness shift):
        detections per image and the box-level agreement rates that
        chip_smoke.py checks, for each setting
    python3 tools/port_perf.py tiles
        the bf16 conv kernel at each YOLOv2-COCO conv shape, batch 1 and
        32, under every tile shape it is built for (unsplit at batch 32,
        split to fill the card at batch 1): device ms per call, TFLOP/s,
        and the tile conv_kernel.plan picks (its cost model's data)

ROUTE is the detector route: "default" (letterbox + F.conv2d),
"conv_impl=cuda" (the fused conv kernel on the eligible convs) or
"entry=fused" (the fused entry kernel).

Every command prints one JSON object per line, each with the card's
nvidia-smi name and power limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_HW = (480, 640)
BATCHES = (1, 32, 128)
WARMUP, REPS, PROFILED_CALLS = 3, 20, 5


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _images(torch, b: int):
    return torch.from_numpy(np.random.default_rng(b).integers(
        0, 256, (b, *SRC_HW, 3), dtype=np.uint8)).cuda()


def _write_weights(path: str, **shaping) -> None:
    """chip_smoke.py's seeded YOLOv2-COCO weights; ``shaping`` overrides
    synthetic_detector_params' head shaping (the sweep)."""
    from yolo_tpu_torch.configs import get_variant
    from yolo_tpu_torch.io import darknet_weights as dw

    cfg = get_variant("coco")
    dw.save(path, cfg.layers, dw.synthetic_detector_params(cfg, 0,
                                                           **shaping))


def cmd_weights(args, card) -> None:
    _write_weights(args.path)
    _emit({"weights": args.path, "card": card})


ROUTES = ("default", "conv_impl=cuda", "entry=fused")


def _detector(model, route: str):
    """The loaded model's detector on ``route`` (ROUTES)."""
    if route == "default":
        return model
    from yolo_tpu_torch.models.predict import detect_raw

    kw = {"conv_impl": "cuda"} if route == "conv_impl=cuda" \
        else {"entry": "fused"}
    return lambda images: detect_raw(model.cfg, model.params, images, **kw)


def cmd_time(args, card) -> None:
    import torch
    import yolo_tpu_torch

    model = yolo_tpu_torch.load(args.weights, "coco", device="cuda")
    detector = _detector(model, args.route)
    for b in BATCHES:
        images = _images(torch, b)
        for _ in range(WARMUP):
            detector(images)
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            detector(images)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        _emit({"what": "detector_e2e_bf16", "tree": args.tree or ".",
               "route": args.route,
               "package": os.path.dirname(yolo_tpu_torch.__file__),
               "batch": b, "ms": ms, "img_per_s": b * 1000 / ms,
               "reps": REPS, "card": card})


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "nms_suppress" in n:
        return "nms_kernel"
    # the conv kernel's bf16 (wgmma) and fp32 bodies and its split-K
    # reduction, before cuDNN's "conv" below
    if ("conv_bf16_kernel" in n or "conv_f32_kernel" in n
            or "conv_splitk_reduce_kernel" in n):
        return "conv_kernel"
    if "entry_conv_pool" in n:
        return "entry_kernel"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if "fprop" in n or "conv" in n or "winograd" in n or "dgrad" in n:
        return "conv"
    if "max_pool" in n:
        return "maxpool"
    if "gemm" in n:
        return "letterbox_gemm"
    if "sort" in n or "topk" in n or "radix" in n or "scan" in n:
        return "sort_topk"
    if "elementwise" in n or "vectorized" in n or "reduce" in n \
            or "copy" in n or "fill" in n or "cat" in n:
        return "elementwise"
    return "other"


def cmd_profile(args, card) -> None:
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import yolo_tpu_torch

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "w.weights")
        _write_weights(path)
        model = yolo_tpu_torch.load(path, "coco", device="cuda")
    detector = _detector(model, args.route)
    for b in BATCHES:
        images = _images(torch, b)
        for _ in range(WARMUP):
            detector(images)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_CALLS):
                detector(images)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000 / PROFILED_CALLS
        by_class, by_name = {}, {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
            cls = _kernel_class(e.name)
            by_class[cls] = by_class.get(cls, 0.0) + us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
        n = PROFILED_CALLS * 1000.0  # us -> ms per call
        device_ms = sum(by_class.values()) / n
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        _emit({"what": "profile_bf16", "route": args.route, "batch": b,
               "calls": PROFILED_CALLS,
               "wall_ms_per_call": wall_ms,
               "device_ms_per_call": device_ms,
               "busy_share": device_ms / wall_ms,
               "ms_per_call_by_class": {k: v / n for k, v in
                                        sorted(by_class.items())},
               "top_kernels_ms": [[k[:120], v / n] for k, v in top],
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "card": card})


def cmd_sweep(args, card) -> None:
    import torch

    import chip_smoke
    import yolo_tpu_torch
    from yolo_tpu_torch.models.predict import make_detector
    from yolo_tpu_torch.serve import detections_to_json

    rng = np.random.default_rng(chip_smoke.SEED + 1)
    images = torch.from_numpy(rng.integers(
        0, 256, (6, *SRC_HW, 3), dtype=np.uint8)).cuda()
    for box_scale in (1.0, 0.1):
        for obj_shift in (0.0, -1.0, -2.0, -3.0):
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "w.weights")
                _write_weights(path, box_scale=box_scale,
                               objectness_shift=obj_shift)
                model = yolo_tpu_torch.load(path, "coco", device="cuda")
                model32 = yolo_tpu_torch.load(path, "coco", device="cuda",
                                              precision="fp32")
            cfg = model.cfg
            names = cfg.detection_names()
            conf = cfg.conf_threshold
            direct = [detections_to_json(model(images[i:i + 1]), names)[0]
                      for i in range(len(images))]
            batched = detections_to_json(model(images), names)
            plain = detections_to_json(make_detector(
                cfg, head="reference", nms_impl="torch")(model32.params,
                                                         images), names)
            rates = {}
            for what, (a, b) in (("batched_vs_direct", (direct, batched)),
                                 ("bf16_vs_fp32_plain", (plain, direct))):
                for way, (x, y) in (("a_in_b", (a, b)), ("b_in_a", (b, a))):
                    hit = tot = 0
                    for xi, yi in zip(x, y):
                        h, t = chip_smoke.match_rate(xi, yi, conf)
                        hit, tot = hit + h, tot + t
                    rates[f"{what}.{way}"] = [hit, tot]
            _emit({"what": "sweep", "box_scale": box_scale,
                   "obj_shift": obj_shift,
                   "detections_per_image": [len(d) for d in direct],
                   "matched": rates,
                   "passes_rule": all(t > 0 and h / t >= chip_smoke.MIN_MATCH
                                      for h, t in rates.values()),
                   "card": card})


# (H=W, CIN, CO, ks) of YOLOv2-COCO 416's 16 convs on the conv kernel
COCO_CONVS = ((52, 128, 256, 3), (52, 256, 128, 1), (26, 256, 512, 3),
              (26, 512, 256, 1), (13, 512, 1024, 3), (13, 1024, 512, 1),
              (13, 1024, 1024, 3), (13, 1280, 1024, 3))


def cmd_tiles(args, card) -> None:
    import math

    import torch

    import chip_smoke
    from yolo_tpu_torch.ops.cuda import conv_kernel as ck

    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    chosen = ck.plan
    for b in (1, 32):
        for hw, cin, co, ks in COCO_CONVS:
            x, k, bias = chip_smoke.conv_inputs(gen, b, hw, cin, co, ks,
                                                torch.bfloat16)
            m, steps = b * hw * hw, ks * ks * cin // ck.BK
            flop = 2 * m * co * cin * ks * ks
            times = {}
            for bm, bn in ck.TILES:
                if co % bn:
                    continue
                tiles = math.ceil(m / bm) * (co // bn)
                splits = 1 if b > 1 else min(steps, math.ceil(ck.SMS / tiles))
                p = ck.Plan(bm, bn, splits, ck.workspace_bytes(m, co, splits))
                ck.plan = lambda *a, _p=p, **kw: _p  # this tile, this call
                try:
                    ms = chip_smoke.cuda_ms_per_call(
                        lambda: ck.fused_conv_bias_act(x, k, bias), calls=20)
                finally:
                    ck.plan = chosen
                times[f"{bm}x{bn}/{splits}"] = [ms, flop / ms / 1e9]
            _emit({"what": "conv_tiles_bf16", "batch": b, "hw": hw,
                   "cin": cin, "co": co, "ks": ks,
                   "plan": list(chosen(b, hw, hw, cin, co, ks)[:3]),
                   "ms_tflops_by_tile": times, "card": card})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("weights")
    w.add_argument("path")
    t = sub.add_parser("time")
    t.add_argument("--weights", required=True)
    t.add_argument("--tree", default=None)
    t.add_argument("--route", choices=ROUTES, default="default")
    prof = sub.add_parser("profile")
    prof.add_argument("--route", choices=ROUTES, default="default")
    sub.add_parser("sweep")
    sub.add_parser("tiles")
    args = ap.parse_args()
    # the package under test: another checkout's for `time --tree`
    sys.path.insert(0, os.path.abspath(getattr(args, "tree", None) or REPO))
    if getattr(args, "tree", None):
        sys.path.insert(1, REPO)
    import torch

    if not torch.cuda.is_available():
        print("port_perf: needs a CUDA device", file=sys.stderr)
        return 2
    card = _card()
    {"weights": cmd_weights, "time": cmd_time, "profile": cmd_profile,
     "sweep": cmd_sweep, "tiles": cmd_tiles}[args.cmd](args, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
