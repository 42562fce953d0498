#!/usr/bin/env python3
"""Measurements of the PyTorch/CUDA port (yolo_tpu_torch) on one card,
beyond chip_smoke.py's. Run from the repo root on a CUDA machine:

    python3 tools/port_perf.py weights W.weights [--cfg C.cfg]
        write chip_smoke.py's seeded YOLOv2-COCO weights (or the seeded
        weights of the detector darknet .cfg C.cfg describes) to
        W.weights
    python3 tools/port_perf.py time --weights W.weights [--tree DIR]
                                    [--route ROUTE] [--cfg C.cfg]
                                    [--names N.names]
        end-to-end detector latency, CUDA-event median of 20 synchronized
        calls after 3 warm-up calls, at batch 1/32/128 (raw 480x640 uint8 on the card, bf16).
        --tree DIR times the yolo_tpu_torch of another checkout (an A/B:
        run parent, change, change, parent in one machine session);
        --cfg loads W.weights through load(cfg=C.cfg) instead of as
        YOLOv2-COCO
    python3 tools/port_perf.py profile [--route ROUTE] [--variant V]
                                       [--cfg C.cfg] [--batches B ...]
        torch.profiler breakdown of the same calls (5 calls after 3
        warm-up calls): device time per call by kernel class, wall time,
        busy share, peak memory; --variant profiles another built-in
        variant (seeded weights, its published size), e.g. yolov3 or
        yolov4; --cfg the detector a darknet .cfg describes (seeded
        weights, its [net] size)
    python3 tools/port_perf.py sweep
        the seeded weights' head shaping (box scale x objectness shift):
        detections per image and the box-level agreement rates that
        chip_smoke.py checks, for each setting
    python3 tools/port_perf.py tiles
        the conv kernel's bf16 and fp32 bodies at each YOLOv2-COCO conv
        shape, batch 1 and 32, under every tile shape each is built for
        (unsplit at batch 32, split to fill the card at batch 1): device
        ms per call, TFLOP/s, and the tile conv_kernel.plan picks (its
        cost model's data)
    python3 tools/port_perf.py tiles_s8
        the s8 conv kernel (csrc/conv_s8_bias_act.cu) at each
        YOLOv2-COCO conv shape, batch 1, 32 and 128, int8 out (conv 0
        from the bf16 image, the rest from int8 codes), under every body
        and tile it is built for that takes the shape (stem and dp4a for
        conv 0, with pool 1 fused beside the plain pool; mma 64x64,
        128x64; wgmma 128x64, 128x128, each unsplit and K-split where
        the tiles do not fill the card): device ms per call, TOP/s, and the plan
        conv_s8_kernel.plan picks; and the int8 maxpool kernel (csrc/
        maxpool_s8.cu) on YOLOv2-COCO's 2x2/2 pool shapes beside its
        plain version and its byte bound
    python3 tools/port_perf.py train
        torch.profiler breakdown of the YOLOv2-VOC 416 train step at
        batch 64, fp32 and bf16, on one seeded batch already on the card
        (no host pipeline), as profile reports it
    python3 tools/port_perf.py step64 [--variant V] [--heads H]
        chip_smoke.py phase 13 (a)'s fp32 step of a yolo variant
        (yolov4 by default: its 20-class head, fine-tune start and
        batch), or phase 18 (d)'s of yolov1 (--variant yolov1), on the
        card (cuDNN, and cuDNN off) and on the CPU (its
        convs in float64), each against a float64 CPU step on the card
        step's choices: the largest per-tensor update errors;
        --heads csp-swish | gaussian takes phase 15 (e)'s nets instead
        (V's topology with yolov4-csp-swish heads at 640x384, or with
        Gaussian heads) on its micro-batch
    python3 tools/port_perf.py decode [--tree DIR] [--reps N]
                                      [--format F]
        the host decoder (native/) on chip_smoke.py phase 14 (c)'s
        480x640 4:2:0 q90 frame and the 480x640 progressive fixture
        (--format jpeg, the default), a 24-bit BMP of the frame (bmp),
        the 480x640 LZW TIFF, q80 WebP, lossless WebP, GIF, RLE HDR and
        JPEG 2000 fixtures of tests/data/torch_jpeg/ (tiff, webp,
        webp-lossless, gif, hdr; jp2: the 9/7 and 5/3 frames) or all
        of them (all): ms an image on
        one thread (median of N after 10 warm-ups) and img/s on 4 and 8
        threads; --tree DIR decodes with another
        checkout's package (an A/B: run parent, change, change, parent in
        one machine session; a tree that cannot read a file reports its
        error)
    python3 tools/port_perf.py files [--tree DIR] [--reps N]
        chip_smoke.py phase 14 (d)'s files to boxes: yolov3 @416 (seeded
        weights, bf16, batch 32) over 256 COCO-format JPEG scenes,
        inference_batches (8 workers: decode + the C letterbox) ->
        DevicePrefetcher -> make_detector_preprocessed, on the default
        route and on conv_impl="cuda"; img/s from files and of the host
        pipeline alone, N passes each; --tree DIR runs another
        checkout's package (an A/B: parent, change, change, parent in
        one machine session)
    python3 tools/port_perf.py stepcheck
        chip_smoke.py's card-against-CPU fp32 step (phase 10 (a)), tensor
        by tensor: each update's relative error, card against the CPU on
        the card's choices, the CPU on the batch reversed (choices held)
        and the card with TF32 on; and each conv's weight gradient and
        output, card and CPU in fp32 against float64 on the same inputs

ROUTE is the detector route: "default" (letterbox + F.conv2d),
"conv_impl=cuda" (the fused conv kernel on the eligible convs),
"entry=fused" (the fused entry kernel) or "precision=int8" (the weights
quantized as chip_smoke.py phase 19 does, every conv on the s8 kernel).

Every command prints one JSON object per line, each with the card's
nvidia-smi name and power limit.
"""

import argparse
import contextlib
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_HW = (480, 640)
BATCHES = (1, 32, 128)
WARMUP, REPS, PROFILED_CALLS = 3, 20, 5
TRAIN_BATCH = 64          # yolov2-voc.cfg's batch


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


def _write_weights(path: str, variant: str = "coco", cfg_path=None,
                   **shaping) -> None:
    """chip_smoke.py's seeded weights of ``variant`` (YOLOv2-COCO by
    default), or of the detector the darknet .cfg ``cfg_path`` describes;
    ``shaping`` overrides synthetic_detector_params' head shaping (the
    sweep)."""
    from yolo_tpu_torch.configs import get_variant
    from yolo_tpu_torch.configs.darknet_cfg import config_from_cfg
    from yolo_tpu_torch.io import darknet_weights as dw

    cfg = config_from_cfg(cfg_path) if cfg_path else get_variant(variant)
    dw.save(path, cfg.layers, dw.synthetic_detector_params(cfg, 0,
                                                           **shaping))


def cmd_weights(args, card) -> None:
    _write_weights(args.path, cfg_path=args.cfg)
    _emit({"weights": args.path, "cfg": args.cfg, "card": card})


ROUTES = ("default", "conv_impl=cuda", "entry=fused", "precision=int8")


def _detector(model, route: str, weights: str):
    """The loaded model's detector on ``route`` (ROUTES); precision=int8
    quantizes ``weights`` as chip_smoke.py phase 19 does (8 seeded
    frames, chained) and serves it in bf16."""
    if route == "default":
        return model
    if route == "precision=int8":
        import torch

        import chip_smoke
        from yolo_tpu_torch.models.graph import Darknet
        from yolo_tpu_torch.models.predict import make_detector

        q = chip_smoke.int8_calibrated(model.cfg, weights)[0]
        net = Darknet(model.cfg.layers, q, device="cuda",
                      dtype=torch.bfloat16)
        det = make_detector(model.cfg)
        return lambda images: det(net, images)
    from yolo_tpu_torch.models.predict import detect_raw

    kw = {"conv_impl": "cuda"} if route == "conv_impl=cuda" \
        else {"entry": "fused"}
    return lambda images: detect_raw(model.cfg, model.params, images, **kw)


def cmd_time(args, card) -> None:
    import torch
    import yolo_tpu_torch

    if args.cfg:
        model = yolo_tpu_torch.load(args.weights, cfg=args.cfg,
                                    names=args.names, device="cuda")
    else:
        model = yolo_tpu_torch.load(args.weights, "coco", device="cuda")
    detector = _detector(model, args.route, args.weights)
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
               "route": args.route, "model": model.cfg.name,
               "input_hw": list(model.cfg.input_hw),
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
    if "conv_s8_" in n:
        return "conv_s8_kernel"
    if "maxpool_s8" in n:
        return "maxpool_s8_kernel"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if ("fprop" in n or "conv" in n or "winograd" in n or "dgrad" in n
            or "wgrad" in n):
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


def _profiled(fn) -> dict:
    """torch.profiler over PROFILED_CALLS calls of fn after WARMUP: wall
    and device ms per call, busy share, device ms by kernel class, the
    top kernels, peak GiB."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_CALLS):
            fn()
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
    return {"calls": PROFILED_CALLS, "wall_ms_per_call": wall_ms,
            "device_ms_per_call": device_ms,
            "busy_share": device_ms / wall_ms,
            "ms_per_call_by_class": {k: v / n for k, v in
                                     sorted(by_class.items())},
            "top_kernels_ms": [[k[:120], v / n] for k, v in top],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def cmd_profile(args, card) -> None:
    import torch

    import yolo_tpu_torch

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "w.weights")
        _write_weights(path, args.variant, cfg_path=args.cfg)
        if args.cfg:
            model = yolo_tpu_torch.load(path, cfg=args.cfg, device="cuda")
        else:
            model = yolo_tpu_torch.load(path, args.variant, device="cuda")
        detector = _detector(model, args.route, path)
    for b in args.batches:
        images = _images(torch, b)
        _emit({"what": "profile_bf16", "model": model.cfg.name,
               "input_hw": list(model.cfg.input_hw), "route": args.route,
               "batch": b, **_profiled(lambda: detector(images)),
               "card": card})


def cmd_train(args, card) -> None:
    import torch

    from yolo_tpu_torch.configs import get_variant
    from yolo_tpu_torch.data.targets import encode_batch
    from yolo_tpu_torch.io import darknet_weights as dw
    from yolo_tpu_torch.train.loop import (TrainConfig, init_state,
                                           make_train_step)
    from yolo_tpu_torch.train.loss import region_loss_config

    cfg = get_variant("voc")
    rng = np.random.default_rng(0)
    boxes = [np.stack([rng.uniform(0.2, 0.8, 3), rng.uniform(0.2, 0.8, 3),
                       rng.uniform(0.1, 0.5, 3), rng.uniform(0.1, 0.5, 3)],
                      -1).astype(np.float32) for _ in range(TRAIN_BATCH)]
    batch = encode_batch(boxes, [rng.integers(0, 20, 3)] * TRAIN_BATCH,
                         grid=13, anchors=cfg.anchors, num_classes=20)
    batch["images"] = rng.uniform(
        0, 1, (TRAIN_BATCH, 416, 416, 3)).astype(np.float32)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    params = dw.synthetic_detector_params(cfg, 0)
    tcfg = TrainConfig(learning_rate=1e-3, loss=region_loss_config(cfg))
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        state = init_state(cfg, params, tcfg)
        step = make_train_step(cfg, tcfg, compute_dtype=dtype)
        _emit({"what": f"profile_train_{name}", "model": cfg.name,
               "batch": TRAIN_BATCH,
               **_profiled(lambda: step(state, batch)), "card": card})
        del state


def _rel(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / max(float(b.norm()), 1e-300))


def cmd_stepcheck(args, card) -> None:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from yolo_tpu_torch.configs import VOC_NAMES, get_variant
    from yolo_tpu_torch.data.synthetic import write_voc_scenes
    from yolo_tpu_torch.ops import precision
    from yolo_tpu_torch.train.loop import (TrainConfig, init_state,
                                           make_train_step)
    from yolo_tpu_torch.train.loss import region_loss_config

    cfg = get_variant(cs.TRAIN_VARIANT)
    tcfg = TrainConfig(**cs.NET_SCHEDULE, loss=region_loss_config(cfg))
    rng = np.random.default_rng(cs.SEED + 4)
    palette = rng.integers(0, 256, (len(VOC_NAMES), 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        pairs = write_voc_scenes(tmp, cs.SCENE_HW[:cs.CHECK_BATCH], rng,
                                 palette=palette)
        params = cs.fine_tune_init(cfg, tmp)
        host = next(cs.host_batches(cfg, pairs, cs.CHECK_BATCH, cs.SEED,
                                    shuffle=False,
                                    augment_cfg=cs.NET_AUGMENT))
    convs = []
    conv2d = F.conv2d

    def recording_conv(x, w, **kw):
        y = conv2d(x, w, **kw)
        y.retain_grad()
        convs.append((x.detach(), w.detach(), y, kw))
        return y

    def step_on(dev, flip=False, record=False):
        state = init_state(cfg, params, tcfg, device=dev)
        state.step = tcfg.burn_in_steps
        order = slice(None, None, -1) if flip else slice(None)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[order])).to(dev)
                 for k, v in host.items()}
        if record:
            F.conv2d = recording_conv
        try:
            make_train_step(cfg, tcfg)(state, batch)
        finally:
            F.conv2d = conv2d
        return state.net.to_numpy()

    def flipped(held):
        out = cs.HeldChoices()
        out.signs = [t.flip(0) for t in held.signs]
        out.argmax = [t.flip(0) for t in held.argmax]
        return out

    exact, loose = cs.HeldChoices(), cs.HeldChoices()
    with exact.record():
        gpu = step_on("cuda", record=True)
    with cs.tf32_on(), loose.record():
        gpu_tf32 = step_on("cuda")
    with exact.replay():
        cpu = step_on("cpu")
    reverse = flipped(exact)
    with reverse.replay():
        cpu_reversed = step_on("cpu", flip=True)
    with loose.replay():
        cpu_tf32 = step_on("cpu")
    keys = ("kernel", "gamma", "beta", "bias", "mean", "var")
    for name, (a, b) in {"card_vs_cpu": (gpu, cpu),
                         "cpu_reversed_vs_cpu": (cpu_reversed, cpu),
                         "tf32_card_vs_its_cpu": (gpu_tf32, cpu_tf32)
                         }.items():
        errs = {}
        for i, (p0, pa, pb) in enumerate(zip(params, a, b)):
            for key in keys:
                if key in p0:
                    da = torch.from_numpy(pa[key].astype(np.float64) - p0[key])
                    db = torch.from_numpy(pb[key].astype(np.float64) - p0[key])
                    errs[f"{i}.{key}"] = _rel(da, db)
        _emit({"what": "stepcheck_update", "compare": name,
               "rel_err": errs, "card": card})

    # each conv's weight gradient and output from the card step's own
    # inputs: cuDNN (TF32 off) and the CPU in fp32 against float64
    grads = []
    with precision.no_tf32():
        for i, (x, w, y, kw) in enumerate(convs):
            g = y.grad
            per = {}
            for dev, dtype in (("cuda", torch.float32),
                               ("cpu", torch.float32),
                               ("cpu", torch.float64)):
                xd, wd, gd = (t.to(dev, dtype) for t in (x, w, g))
                per[(dev, dtype)] = (
                    torch.nn.grad.conv2d_weight(xd, w.shape, gd, **kw),
                    conv2d(xd, wd, **kw))
            want_w, want_y = per[("cpu", torch.float64)]
            grads.append({
                "conv": i, "shape": list(x.shape) + list(w.shape),
                "wgrad_cuda": _rel(per[("cuda", torch.float32)][0], want_w),
                "wgrad_cpu": _rel(per[("cpu", torch.float32)][0], want_w),
                "out_cuda": _rel(per[("cuda", torch.float32)][1], want_y),
                "out_cpu": _rel(per[("cpu", torch.float32)][1], want_y)})
    _emit({"what": "stepcheck_convs_vs_float64", "convs": grads,
           "card": card})


@contextlib.contextmanager
def _cpu_float64():
    """Every fp32 cast on the CPU made float64, for a float64 reference
    step through the port's fp32 training code: Tensor.float() on CPU
    tensors and Tensor.to(torch.float32) anywhere (the CPU step's own
    tensors only, as the card's step has run by then)."""
    import torch

    to_float, to = torch.Tensor.float, torch.Tensor.to

    def to64(self, *a, **kw):
        a = tuple(torch.float64 if x is torch.float32 else x for x in a)
        if kw.get("dtype") is torch.float32:
            kw["dtype"] = torch.float64
        return to(self, *a, **kw)

    torch.Tensor.float = lambda self: (to_float(self).double()
                                       if self.device.type == "cpu"
                                       else to_float(self))
    torch.Tensor.to = to64
    try:
        yield
    finally:
        torch.Tensor.float, torch.Tensor.to = to_float, to


def cmd_step64(args, card) -> None:
    import torch

    import chip_smoke as cs

    if args.variant == "yolov1":
        # phase 18 (d)'s step: yolov1.cfg at 448, its seeded weights
        with tempfile.TemporaryDirectory() as tmp:
            cfg_path = os.path.join(tmp, "yolov1.cfg")
            with open(cfg_path, "w") as f:
                f.write(cs.YOLOV1_CFG)
            cfg = cs.config_from_cfg(cfg_path)
            params = cs.dw.synthetic_detector_params(cfg, cs.SEED)
            host, tcfg = cs.yolov1_step_inputs(cfg, cfg_path)
    else:
        subdivisions, schedule = cs.YOLO_NETS[args.variant]
        if args.heads == "csp-swish":
            cfg = cs.voc_heads(cs.csp_swish_heads(args.variant,
                                                  cs.CFG_SCALED_HW))
        elif args.heads == "gaussian":
            cfg = cs.voc_heads(cs.gaussian_heads(args.variant))
        else:
            cfg = cs.voc_variant(args.variant)
        tcfg = cs.TrainConfig(**schedule,
                              yolo_loss=cs.yolo_loss_config(cfg))
        # the micro-batch of phase 13 (a), or of phase 15 (e) for its
        # heads
        rng = np.random.default_rng(cs.SEED + (13 if args.heads == "variant"
                                               else 15))
        palette = rng.integers(0, 256, (20, 3), dtype=np.uint8)
        with tempfile.TemporaryDirectory() as tmp:
            pairs = cs.write_voc_scenes(
                tmp, cs.SCENE_HW[:cs.CHECK_BATCH], rng, palette=palette)
            params = cs.fine_tune_init(cfg, tmp,
                                       *cs.YOLO_PARTIALS[args.variant])
            host = next(cs.host_batches(cfg, pairs, cs.CHECK_BATCH, cs.SEED,
                                        shuffle=False,
                                        augment_cfg=cs.YOLO_AUGMENT))

    def step_on(dev, f64=False):
        state = cs.init_state(cfg, params, tcfg, device=dev)
        if f64:
            state.net.double()
        state.step = tcfg.burn_in_steps
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        cs.make_train_step(cfg, tcfg)(state, batch)
        return state.net.to_numpy()

    held = cs.HeldChoices()
    with held.record():
        card_step = step_on("cuda")

    def replay():
        h = cs.HeldChoices()
        h.signs, h.argmax, h.gates = held.signs, held.argmax, held.gates
        return h.replay()

    with replay(), _cpu_float64():
        ref = step_on("cpu", f64=True)
    with replay(), cs.float64_products():
        cpu = step_on("cpu")
    with replay(), torch.backends.cudnn.flags(enabled=False,
                                              allow_tf32=False):
        native = step_on("cuda")
    for name, got in (("card", card_step), ("card_cudnn_off", native),
                      ("cpu_fp32_float64_convs", cpu)):
        for keys in ({"kernel", "gamma", "beta", "bias"}, {"mean", "var"}):
            top = []
            for i, (p0, pa, pb) in enumerate(zip(params, got, ref)):
                for key in sorted(keys & p0.keys()):
                    da = pa[key].astype(np.float64) - p0[key]
                    db = pb[key].astype(np.float64) - p0[key]
                    top.append((float(np.linalg.norm(da - db) / max(
                        np.linalg.norm(db), 1e-30)), f"{i}.{key}"))
            top.sort(reverse=True)
            _emit({"what": "step64", "model": cfg.name, "step": name,
                   "tensors": "stats" if "mean" in keys else "trained",
                   "top": top[:6], "card": card})


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
    for dtype, name in chip_smoke.DTYPES:
        bf16 = dtype == torch.bfloat16
        for b in (1, 32):
            for hw, cin, co, ks in COCO_CONVS:
                x, k, bias = chip_smoke.conv_inputs(gen, b, hw, cin, co, ks,
                                                    dtype)
                m, steps = b * hw * hw, ks * ks * cin // ck.chunk(bf16)
                flop = 2 * m * co * cin * ks * ks
                times = {}
                for bm, bn in ck.tiles(bf16):
                    if co % bn:
                        continue
                    tiles = math.ceil(m / bm) * (co // bn)
                    splits = 1 if b > 1 else min(steps,
                                                 math.ceil(ck.SMS / tiles))
                    p = ck.Plan(bm, bn, splits,
                                ck.workspace_bytes(m, co, splits))
                    ck.plan = lambda *a, _p=p, **kw: _p  # this tile only
                    try:
                        ms = chip_smoke.cuda_ms_per_call(
                            lambda: ck.fused_conv_bias_act(x, k, bias),
                            calls=20)
                    finally:
                        ck.plan = chosen
                    times[f"{bm}x{bn}/{splits}"] = [ms, flop / ms / 1e9]
                _emit({"what": f"conv_tiles_{name}", "batch": b, "hw": hw,
                       "cin": cin, "co": co, "ks": ks,
                       "plan": list(chosen(b, hw, hw, cin, co, ks,
                                           bf16=bf16)[:3]),
                       "ms_tflops_by_tile": times, "card": card})


def _s8_plans(sk, m, cin, co, ks, stride, groups):
    """Every body and tile of the s8 kernel that takes a conv shape: the
    stem and dp4a (for comparison) where the stem takes it; mma 64x64
    and 128x64 where CIN % 32; wgmma 128x64 and 128x128, each unsplit
    and at wgmma_splits' split where that differs."""
    if sk.stem_takes(cin // groups, co // groups, groups, stride=stride,
                     ks=ks):
        return [sk.Plan("stem"), sk.Plan("dp4a", npt=32)]
    plans = [sk.Plan("dp4a", npt=32)] if cin % sk.CHUNK else [
        sk.Plan("mma", 64, 64), sk.Plan("mma", 128, 64)]
    if cin % sk.CHUNK == 0 and stride == 1 and groups == 1 and ks % 2:
        chunk = next(c for c in (128, 64, 32) if cin % c == 0)
        k = ks * ks * cin
        for bn in (64, 128):
            if co % bn:
                continue
            split = sk.wgmma_splits(m, k, -(-m // 128) * (co // bn))
            plans += [sk.Plan("wgmma", 128, bn, chunk=chunk, splits=s)
                      for s in sorted({1, split})]
    return plans


def cmd_tiles_s8(args, card) -> None:
    import torch

    import chip_smoke
    from yolo_tpu_torch.configs import get_variant
    from yolo_tpu_torch.models.quantize import conv_shapes
    from yolo_tpu_torch.ops import pool as pool_ops
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel as sk

    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    chosen = sk.plan
    for b in BATCHES:
        for shape in sorted(conv_shapes(get_variant("coco"))):
            h, w, cin, co, ks, stride, groups, dil, act = shape
            xq, xf, kq, scale, bias = chip_smoke.s8_inputs(gen, b, shape)
            ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
            m = b * ho * wo
            flop = 2 * m * co * ks * ks * cin // groups
            stem = sk.stem_takes(cin // groups, co // groups, groups,
                                 stride=stride, ks=ks)
            # conv 0 takes the bf16 image (the stem quantizes it; dp4a
            # after the wrapper's quantization pass), the rest int8 codes
            x = xf if stem else xq
            times = {}
            for p in _s8_plans(sk, m, cin, co, ks, stride, groups):
                sk.plan = lambda *a, _p=p, **kw: _p  # this plan only
                try:
                    ms = chip_smoke.cuda_ms_per_call(
                        lambda: sk.conv_s8_bias_act(
                            x, kq, scale, bias, x_inv=1.0, out_scale=0.05,
                            act=act, stride=stride, groups=groups,
                            dilation=dil), calls=20)
                finally:
                    sk.plan = chosen
                name = (f"{p.body}{p.bm}x{p.bn}" if p.bm else p.body) + (
                    f"k{p.chunk}" if p.chunk else "") + (
                    f"s{p.splits}" if p.splits > 1 else "")
                times[name] = [ms, flop / ms / 1e9]
            row = {"what": "conv_s8_tiles", "batch": b, "shape": list(shape),
                   "in": str(x.dtype),
                   "plan": list(chosen(m, cin // groups, co // groups,
                                       groups, stride=stride, dilation=dil,
                                       ks=ks)),
                   "ms_tops_by_plan": times, "card": card}
            if stem:
                # with pool 1 fused (2x2/2), beside dp4a and the plain
                # int8 pool after it (the conv and pool apart)
                def fused():
                    return sk.conv_s8_bias_act(
                        x, kq, scale, bias, x_inv=1.0, out_scale=0.05,
                        act=act, stride=stride, pool=(2, 2))
                out = sk.conv_s8_bias_act(x, kq, scale, bias, x_inv=1.0,
                                          out_scale=0.05, act=act,
                                          stride=stride)
                row["stem_pool2s2_ms"] = chip_smoke.cuda_ms_per_call(
                    fused, calls=20)
                row["pool2s2_plain_ms"] = chip_smoke.cuda_ms_per_call(
                    lambda: pool_ops.maxpool_s8_plain(out, 2, 2), calls=20)
                row["stem_pool2s2_bound_ms"] = chip_smoke.bound_ms(
                    flop, chip_smoke.nbytes(x, kq, scale, bias, fused()),
                    torch.int8)[0]
            _emit(row)
        for c, hw in ((64, 208), (128, 104), (256, 52), (512, 26)):
            x = torch.randint(-128, 128, (b, c, hw, hw), generator=gen,
                              device="cuda", dtype=torch.int8).contiguous(
                                  memory_format=torch.channels_last)
            out = pool_ops.maxpool_nchw(x, 2, 2)
            _emit({"what": "maxpool_s8", "batch": b, "in": [c, hw, hw],
                   "kernel_ms": chip_smoke.cuda_ms_per_call(
                       lambda: pool_ops.maxpool_nchw(x, 2, 2), calls=20),
                   "plain_ms": chip_smoke.cuda_ms_per_call(
                       lambda: pool_ops.maxpool_s8_plain(x, 2, 2),
                       calls=20),
                   "bound_ms": chip_smoke.bound_ms(
                       0, chip_smoke.nbytes(x, out), torch.int8)[0],
                   "card": card})


def cmd_decode(args, card) -> None:
    import concurrent.futures as cf
    import time

    from yolo_tpu_torch.data.synthetic import coco_scene, encode_jpeg
    from yolo_tpu_torch.native.preproc import decode_image

    img, _ = coco_scene(np.random.default_rng(14), *SRC_HW)
    fixtures = os.path.join(REPO, "tests", "data", "torch_jpeg")
    with tempfile.TemporaryDirectory() as tmp:
        baseline = os.path.join(tmp, "scene.jpg")
        with open(baseline, "wb") as f:
            f.write(encode_jpeg(img, 90, "420"))
        bmp = os.path.join(tmp, "scene.bmp")
        with open(bmp, "wb") as f:       # 24-bit, bottom-up, as cv2 writes
            step = (SRC_HW[1] * 3 + 3) & -4
            rows = np.zeros((SRC_HW[0], step), np.uint8)
            rows[:, :SRC_HW[1] * 3] = img[::-1, :, ::-1].reshape(SRC_HW[0],
                                                                  -1)
            f.write(b"BM" + struct.pack("<IIIIiiHHIIIIII", 54 + rows.size, 0,
                                        54, 40, SRC_HW[1], SRC_HW[0], 1, 24,
                                        0, 0, 0, 0, 0, 0) + rows.tobytes())
        files = {"baseline": baseline,
                 "progressive": os.path.join(fixtures,
                                             "prog_420_q85_480x640.jpg"),
                 "bmp": bmp,
                 "tiff": os.path.join(fixtures, "frame_lzw_pred_480x640.tif"),
                 "webp": os.path.join(fixtures,
                                      "frame_webp_q80_480x640.webp"),
                 "webp-lossless": os.path.join(
                     fixtures, "frame_webp_lossless_480x640.webp"),
                 "gif": os.path.join(fixtures, "frame_gif_480x640.gif"),
                 "hdr": os.path.join(fixtures, "frame_hdr_480x640.hdr"),
                 "jp2": os.path.join(fixtures, "frame_jp2_97_480x640.jp2"),
                 "jp2-lossless": os.path.join(fixtures,
                                              "frame_jp2_53_480x640.jp2")}
        chosen = {"jpeg": ("baseline", "progressive"),
                  "jp2": ("jp2", "jp2-lossless"),
                  "all": tuple(files)}.get(args.format, (args.format,))
        for name, path in ((n, files[n]) for n in chosen):
            try:
                for _ in range(10):
                    decode_image(path)
            except ValueError as e:
                _emit({"decode": name, "tree": args.tree or REPO,
                       "error": str(e), "card": card})
                continue
            times = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                decode_image(path)
                times.append((time.perf_counter() - t0) * 1e3)
            rates = {}
            for n in (4, 8):
                with cf.ThreadPoolExecutor(n) as pool:
                    list(pool.map(decode_image, [path] * n))
                    t0 = time.perf_counter()
                    list(pool.map(decode_image, [path] * args.reps))
                    rates[n] = args.reps / (time.perf_counter() - t0)
            q = statistics.quantiles(times, n=4)
            _emit({"decode": name, "tree": args.tree or REPO,
                   "src_hw": list(SRC_HW), "ms_one_thread": q[1],
                   "ms_quartiles": [q[0], q[2]], "img_per_s_4_threads":
                   rates[4], "img_per_s_8_threads": rates[8],
                   "reps": args.reps, "host_cores": os.cpu_count(),
                   "card": card})


def cmd_files(args, card) -> None:
    import time

    import torch

    from yolo_tpu_torch.configs import get_variant
    from yolo_tpu_torch.data.coco import load_coco
    from yolo_tpu_torch.data.pipeline import (DevicePrefetcher,
                                              inference_batches)
    from yolo_tpu_torch.data.synthetic import write_coco_scenes
    from yolo_tpu_torch.io import darknet_weights as dw
    from yolo_tpu_torch.models.graph import Darknet, fold_params
    from yolo_tpu_torch.models.predict import make_detector_preprocessed

    cfg = get_variant("yolov3")
    folded = fold_params(cfg.layers, dw.synthetic_detector_params(cfg, 0),
                         cfg.bn_eps)
    net = Darknet(cfg.layers, folded, device="cuda", dtype=torch.bfloat16)
    # chip_smoke.py's COCO_SIZES and seed, 256 scenes
    sizes = ((480, 640),) * 5 + ((640, 480), (427, 640), (375, 500))
    with tempfile.TemporaryDirectory() as tmp:
        json_path = write_coco_scenes(
            tmp, [sizes[i % len(sizes)] for i in range(256)], 14)
        paths = [p for p, _ in load_coco(json_path, cfg.class_names, tmp)]

        def host():
            return inference_batches(paths, 32, net_size=cfg.input_hw,
                                     workers=8)

        for route in ("torch", "cuda"):
            det = make_detector_preprocessed(cfg, conv_impl=route)
            det(net, torch.zeros((32, *cfg.input_hw, 3), device="cuda"))
            torch.cuda.synchronize()
            for _ in range(args.reps):
                t0 = time.perf_counter()
                for _b in host():
                    pass
                host_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                n = 0
                with DevicePrefetcher(host(), depth=2) as staged:
                    for b in staged:
                        det(net, b["images"])
                        n += len(b["paths"])
                torch.cuda.synchronize()
                files_s = time.perf_counter() - t0
                _emit({"files": f"conv_impl={route}",
                       "tree": args.tree or REPO, "model": cfg.name,
                       "batch": 32, "images": n,
                       "files_img_per_s": n / files_s,
                       "host_pipeline_img_per_s": n / host_s,
                       "host_cores": os.cpu_count(), "card": card})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("weights")
    w.add_argument("path")
    w.add_argument("--cfg", default=None)
    t = sub.add_parser("time")
    t.add_argument("--weights", required=True)
    t.add_argument("--tree", default=None)
    t.add_argument("--route", choices=ROUTES, default="default")
    t.add_argument("--cfg", default=None)
    t.add_argument("--names", default=None)
    prof = sub.add_parser("profile")
    prof.add_argument("--route", choices=ROUTES, default="default")
    prof.add_argument("--variant", default="coco")
    prof.add_argument("--cfg", default=None)
    prof.add_argument("--batches", type=int, nargs="+", default=BATCHES)
    dec = sub.add_parser("decode")
    dec.add_argument("--tree", default=None)
    dec.add_argument("--reps", type=int, default=200)
    dec.add_argument("--format", default="jpeg",
                     choices=("jpeg", "bmp", "tiff", "webp", "webp-lossless",
                              "gif", "hdr", "jp2", "all"))
    fil = sub.add_parser("files")
    fil.add_argument("--tree", default=None)
    fil.add_argument("--reps", type=int, default=3)
    sub.add_parser("sweep")
    sub.add_parser("tiles")
    sub.add_parser("tiles_s8")
    sub.add_parser("train")
    sub.add_parser("stepcheck")
    s64 = sub.add_parser("step64")
    s64.add_argument("--variant", default="yolov4")
    s64.add_argument("--heads", choices=("variant", "csp-swish",
                                         "gaussian"), default="variant")
    args = ap.parse_args()
    # the package under test: another checkout's for `time --tree`,
    # `decode --tree` and `files --tree`
    sys.path.insert(0, os.path.abspath(getattr(args, "tree", None) or REPO))
    if getattr(args, "tree", None):
        sys.path.insert(1, REPO)
    import torch

    if not torch.cuda.is_available():
        print("port_perf: needs a CUDA device", file=sys.stderr)
        return 2
    card = _card()
    {"weights": cmd_weights, "time": cmd_time, "profile": cmd_profile,
     "decode": cmd_decode, "files": cmd_files, "sweep": cmd_sweep,
     "tiles": cmd_tiles,
     "tiles_s8": cmd_tiles_s8,
     "train": cmd_train, "stepcheck": cmd_stepcheck,
     "step64": cmd_step64}[args.cmd](args, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
