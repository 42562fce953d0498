#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (yolo_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (the kernels are built from
yolo_tpu_torch/csrc/ into build/yolo_tpu_torch/). Phases, each printing
JSON lines; any failed check raises and the script exits non-zero:

  1. device   nvidia-smi name and power limit, torch and CUDA versions
  2. build    compile the CUDA kernels from the checkout; count the
              HGMMA (wgmma) instructions of each kernel in the library
              (cuobjdump --dump-sass): every bf16 conv kernel must have some
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
  6. conv     CUDA fused conv + bias + leaky/linear vs its plain version
              at each distinct shape of YOLOv2-COCO 416's 16 eligible
              convs, bf16 and fp32, batch 8 and batch 1 (the split-K
              plans); two calls on the same inputs give the same bytes
  7. entry    CUDA fused conv1 + bias + leaky + maxpool vs its plain
              version at 416x416 -> 208x208x32, bf16 and fp32
  8. routes   the same seeded YOLOv2-COCO 416 through
              detect_raw(conv_impl="cuda") and make_detector(cfg,
              entry="fused"), bf16 and fp32: 16 conv launches and 1
              entry launch per forward (and the NMS kernel's 1);
              box-level agreement with the fp32 plain path
  9. times    each kernel vs its plain version, the one PyTorch call
              that computes the same function where there is one
              (library_ms: F.conv2d with bias, cuDNN) and the card's bound
              for the same work (bound_ms), per conv shape at batch 1 and
              32 and summed over the 16 convs; both routes end to end
              beside the default route at batch 1/32/128

Tolerances of phases 6-7, kernel vs plain on the same inputs:
  * fp32: 1e-5 of the output's scale (max |plain|). Both sides form
    true fp32 products (the plain versions turn TF32 off) and sum them
    in other orders.
  * bf16 output: 1 bf16 ulp of the output, plus the fp32 bound above.
    Both sides form the same fp32 sums up to that bound and round once;
    where an output lies near zero its own ulp is finer than the sums'
    noise, hence the added fp32 bound.

A kernel's time is the device time per call: CUDA events around a run
of back-to-back calls that the host queues while the stream is held busy
(torch.cuda._sleep), so that at batch 1 the host's launch rate does not
set it. bound_ms is the larger of the bytes the function must move (each
input read once, each output written once) at 3.35 TB/s and its
operations at the card's peak for their type (989 TFLOP/s bf16 tensor,
67 TFLOP/s fp32), computed from this run's inputs.

Then the kernels line, the nvidia-smi line and, last, the device line
{"ok": true, "device": {...}}. Exits non-zero without printing a result
when CUDA is not available.
"""

import http.client
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

import yolo_tpu_torch
from yolo_tpu_torch.configs import get_variant
from yolo_tpu_torch.configs.specs import (Conv, MaxPool, Reorg,
                                          resolve_route)
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models.predict import detect_raw, make_detector
from yolo_tpu_torch.ops import conv, entry, precision
from yolo_tpu_torch.ops.cuda import build, conv_kernel, entry_kernel, nms_kernel
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
CONV_BATCHES = (8, 1)     # phase 6 checks; batch 1 takes split-K plans
TIMED_BATCH = 32          # phase 9: the kernels line's batch
CONV_TIMED_BATCHES = (1, TIMED_BATCH)   # phase 9 per-shape conv times
ROUTE_CONVS = 16          # YOLOv2-COCO convs with CIN, CO % 128 == 0
# the card's peaks (NVIDIA's H100 SXM data sheet, dense, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
NMS_PAIR_FLOP = 13        # one IoU and its test (nms_suppress.cu)


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


def bound_ms(flop: float, nbytes: float, dtype) -> tuple:
    """(least ms, "operations" or "bytes"): the larger of the operations
    at the card's peak for dtype and the bytes at its memory rate."""
    t_ops = flop / PEAK_FLOP_S[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def hgmma_counts(lib: str) -> dict:
    """{kernel: HGMMA instructions} of every kernel in the built library,
    from cuobjdump --dump-sass (template arguments kept, e.g.
    conv_bf16_kernel<128,256,4>)."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", lib],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _kernel_name(line.split("Function :")[1].strip())
            counts.setdefault(name, 0)
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return counts


def _kernel_name(mangled: str) -> str:
    """conv_bf16_kernel<128,256,4> from its Itanium-mangled name: the
    identifier ending in _kernel whose length prefix matches it, then its
    integer template arguments."""
    end = mangled.find("_kernel") + len("_kernel")
    if end < len("_kernel"):
        return mangled
    for start in range(end - 1, 0, -1):
        if mangled[start].isalpha() and \
                mangled[:start].endswith(str(end - start)):
            break
    else:
        return mangled
    args = re.match(r"I((?:Li\d+E)+)E", mangled[end:])
    if not args:
        return mangled[start:end]
    nums = ",".join(re.findall(r"[0-9]+", args.group(1)))
    return f"{mangled[start:end]}<{nums}>"


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
    calls, divided by their number. The stream is first held busy for
    1.5x the host time of the calls (torch.cuda._sleep, ~2 GHz cycles,
    at most 0.1 s), so that the host has queued them before the first
    one runs and the events time the device, not the host."""
    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(1.5 * host_s * calls, 0.1) * 2e9))
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
    model = yolo_tpu_torch.load(weights_path, VARIANT, device="cuda")
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
    return launches, model, model32, images, ref


def phase_times(rng, model, card: str) -> dict:
    timed = {}
    for g, k in KERNEL_SHAPES:
        geom, scores, classes = crowded_rows(rng, g, k, per_class=g > 32)
        ms = cuda_ms_per_call(lambda: nms_kernel.suppress(
            geom, scores, classes, conf_threshold=CONF,
            iou_threshold=IOU), calls=200)
        plain_ms = cuda_ms_per_call(lambda: _suppress_torch(
            geom, scores, classes, CONF, IOU), calls=5)
        # the IoUs the function needs: pairs of candidates above conf
        above = (scores >= CONF).sum(dim=1).double()
        flop = NMS_PAIR_FLOP * float((above * (above - 1) / 2).sum())
        bound, bound_by = bound_ms(flop, nbytes(geom, scores, classes)
                                   + 4 * g * k, torch.float32)
        timed[(g, k)] = (ms, plain_ms, bound, bound_by)
        emit({"phase": "times", "what": "suppress", "shape": [g, 5, k],
              "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": None,
              "bound_ms": bound, "bound_by": bound_by, "card": card})
    for b in E2E_BATCHES:
        images = torch.from_numpy(np.random.default_rng(b).integers(
            0, 256, (b, *SRC_HW, 3), dtype=np.uint8)).cuda()
        ms = cuda_median_ms(lambda: model(images), reps=10)
        emit({"phase": "times", "what": "detector_e2e_bf16", "batch": b,
              "src_hw": list(SRC_HW), "ms": ms, "img_per_s": b * 1000 / ms,
              "card": card})
    return timed


def eligible_conv_shapes(cfg) -> dict:
    """{(hw, cin, co, ks): count} of the convs the fused conv kernel
    takes (ops.conv.eligible), from the layer list at the config's input
    size."""
    shapes, outs = {}, {}
    hw, ch = cfg.input_size, cfg.in_channels
    for idx, layer in enumerate(cfg.layers):
        if isinstance(layer, Conv):
            hwio = np.broadcast_to(np.float32(0), (layer.size, layer.size,
                                                   ch, layer.filters))
            if conv.eligible(hwio, layer.stride):
                key = (hw, ch, layer.filters, layer.size)
                shapes[key] = shapes.get(key, 0) + 1
            hw, ch = hw // layer.stride, layer.filters
        elif isinstance(layer, MaxPool):
            hw //= layer.stride
        elif isinstance(layer, Reorg):
            hw, ch = hw // layer.stride, ch * layer.stride ** 2
        else:  # Route
            srcs = [outs[resolve_route(idx, r)] for r in layer.layers]
            hw, ch = srcs[0][0], sum(c for _, c in srcs)
        outs[idx] = (hw, ch)
    return shapes


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """bf16 ulp (7 stored mantissa bits) at the magnitude of x."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def kernel_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Checks got against want with the tolerances of the module
    docstring; returns max |got - want|."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
          f"{tuple(want.shape)}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = (g - w).abs()
    bound = 1e-5 * w.abs().max()
    if got.dtype == torch.bfloat16:
        bound = bound + bf16_ulp(torch.maximum(g.abs(), w.abs()))
    check(bool((err <= bound).all()), f"{what}: max |kernel - plain| "
          f"{float(err.max())} beyond the tolerance")
    return float(err.max())


def conv_inputs(gen, b, hw, cin, co, ks, dtype) -> tuple:
    """Seeded activations (B, CIN, H, W) and He-scaled kernels, both
    channels_last in dtype, and an fp32 bias, on the card."""
    x = torch.randn(b, cin, hw, hw, generator=gen, device="cuda")
    k = torch.randn(co, cin, ks, ks, generator=gen, device="cuda") \
        * (2.0 / (ks * ks * cin)) ** 0.5
    bias = torch.randn(co, generator=gen, device="cuda") * 0.5
    return (x.to(dtype).contiguous(memory_format=torch.channels_last),
            k.to(dtype).contiguous(memory_format=torch.channels_last), bias)


def entry_inputs(gen, images) -> tuple:
    """The entry kernel's padded fp32 image (from the route's letterbox)
    and He-scaled conv1 weights, on the card."""
    xpad = entry.letterbox_padded(images, 416, interp_dtype=torch.float32)
    k = torch.randn(32, 3, 3, 3, generator=gen, device="cuda") \
        * (2.0 / 27) ** 0.5
    bias = torch.randn(32, generator=gen, device="cuda") * 0.1
    return xpad, k, bias


DTYPES = ((torch.bfloat16, "bf16"), (torch.float32, "fp32"))


def phase_conv(gen, shapes) -> float:
    worst = 0.0
    for b in CONV_BATCHES:
        for hw, cin, co, ks in sorted(shapes):
            for dtype, name in DTYPES:
                x, k, bias = conv_inputs(gen, b, hw, cin, co, ks, dtype)
                got = conv_kernel.fused_conv_bias_act(x, k, bias,
                                                      act="leaky")
                again = conv_kernel.fused_conv_bias_act(x, k, bias,
                                                        act="leaky")
                torch.cuda.synchronize()
                want = conv.fused_conv_bias_act(x, k, bias, act="leaky")
                what = f"conv {b}x{hw}^2 {cin}->{co} {ks}x{ks} {name}"
                err = kernel_err(got, want, what)
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                same = torch.equal(got.view(bits), again.view(bits))
                check(same, f"{what}: two calls on the same inputs differ")
                worst = max(worst, err)
                emit({"phase": "conv", "batch": b, "hw": hw, "cin": cin,
                      "co": co, "ks": ks, "dtype": name,
                      "plan": list(conv_kernel.plan(
                          b, hw, hw, cin, co, ks,
                          bf16=dtype == torch.bfloat16)[:3]),
                      "max_abs_err": err, "deterministic": same,
                      "out_scale": float(want.float().abs().max())})
    return worst


def phase_entry(gen, images) -> float:
    worst = 0.0
    xpad, k, bias = entry_inputs(gen, images)
    for dtype, name in DTYPES:
        got = entry_kernel.fused_entry(xpad, k, bias, out_dtype=dtype)
        torch.cuda.synchronize()
        want = entry.fused_entry(xpad, k, bias, out_dtype=dtype)
        check(tuple(got.shape) == (len(images), 32, 208, 208),
              f"entry output {tuple(got.shape)}")
        err = kernel_err(got, want, f"entry 416 {name}")
        worst = max(worst, err)
        emit({"phase": "entry", "batch": len(images), "in_hw": [416, 416],
              "out": [32, 208, 208], "dtype": name, "max_abs_err": err,
              "out_scale": float(want.float().abs().max())})
    return worst


def phase_routes(model, model32, images, ref) -> dict:
    """Both kernel routes on the seeded YOLOv2-COCO 416, each count set
    to 0 just before the route runs and read just after."""
    cfg = model.cfg
    names = cfg.detection_names()
    conf = cfg.conf_threshold
    counts = {"conv": 0, "entry": 0}
    routes = (("conv_impl=cuda", lambda net: detect_raw(
                   cfg, net, images, conv_impl="cuda"), (ROUTE_CONVS, 0)),
              ("entry=fused", lambda net: make_detector(
                   cfg, entry="fused")(net, images), (0, 1)))
    for net, precision in ((model.params, "bf16"), (model32.params, "fp32")):
        for route, run, (n_conv, n_entry) in routes:
            conv_kernel.launches = entry_kernel.launches = 0
            nms_kernel.launches = 0
            out = run(net)
            torch.cuda.synchronize()
            got = (conv_kernel.launches, entry_kernel.launches)
            check(got == (n_conv, n_entry), f"{route} {precision}: "
                  f"(conv, entry) launches {got}, want {(n_conv, n_entry)} "
                  f"for one forward")
            check(nms_kernel.launches == 1, f"{route} {precision}: "
                  f"{nms_kernel.launches} NMS launches, want 1")
            counts["conv"] += got[0]
            counts["entry"] += got[1]
            check(tuple(out["boxes"].shape) == (len(images), 100, 4)
                  and bool(torch.isfinite(out["boxes"]).all())
                  and bool(torch.isfinite(out["scores"]).all()),
                  f"{route} {precision}: bad detections")
            dets = detections_to_json(out, names)
            agree = check_agree(ref, dets, conf,
                                f"{route} {precision} vs fp32 plain")
            emit({"phase": "routes", "route": route, "precision": precision,
                  "conv_launches": got[0], "entry_launches": got[1],
                  "nms_launches": nms_kernel.launches,
                  "detections_per_image": [len(d) for d in dets],
                  "vs_fp32_plain": agree})
    return counts


def conv_library_call(x, k, bias):
    """The one PyTorch call closest to the conv kernel's function: cuDNN's
    conv with bias (no leaky) on the same channels_last tensors, bf16 on
    the tensor cores, fp32 with TF32 off. A yardstick: the port never
    calls it."""
    with precision.exact_for(x.dtype):
        return F.conv2d(x, k, bias.to(x.dtype), padding=k.shape[-1] // 2)


def phase_kernel_times(gen, shapes, images, card) -> dict:
    """Per-call device time of each kernel, its plain version and the
    library call, beside the bound. The conv sums over YOLOv2-COCO's 16
    eligible convs (bf16, batch 32) and the bf16 entry at batch 32 go to
    the kernels line."""
    sums, bound_kinds = {}, {}
    for b in CONV_TIMED_BATCHES:
        for (hw, cin, co, ks), n in sorted(shapes.items()):
            for dtype, name in DTYPES:
                x, k, bias = conv_inputs(gen, b, hw, cin, co, ks, dtype)
                out = conv_library_call(x, k, bias)
                ms = cuda_ms_per_call(lambda: conv_kernel.fused_conv_bias_act(
                    x, k, bias, act="leaky"), calls=20)
                plain_ms = cuda_ms_per_call(lambda: conv.fused_conv_bias_act(
                    x, k, bias, act="leaky"), calls=20)
                library_ms = cuda_ms_per_call(
                    lambda: conv_library_call(x, k, bias), calls=20)
                flop = 2 * b * hw * hw * ks * ks * cin * co
                bound, bound_by = bound_ms(flop, nbytes(x, k, bias, out),
                                           dtype)
                emit({"phase": "times", "what": "conv", "batch": b,
                      "hw": hw, "cin": cin, "co": co, "ks": ks,
                      "dtype": name, "layers": n,
                      "plan": list(conv_kernel.plan(
                          b, hw, hw, cin, co, ks,
                          bf16=dtype == torch.bfloat16)[:3]),
                      "kernel_ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound,
                      "bound_by": bound_by,
                      "kernel_tflops": flop / ms / 1e9,
                      "library_tflops": flop / library_ms / 1e9,
                      "share_of_bound": bound / ms, "card": card})
                total = sums.setdefault((b, name), [0.0] * 4)
                for i, t in enumerate((ms, plain_ms, library_ms, bound)):
                    total[i] += n * t
                by = bound_kinds.setdefault((b, name), {})
                by[bound_by] = by.get(bound_by, 0.0) + n * bound
    for (b, name), (ms, plain_ms, library_ms, bound) in sorted(sums.items()):
        # what bounds most of the summed bound
        by = max(bound_kinds[(b, name)].items(), key=lambda kv: kv[1])[0]
        emit({"phase": "times", "what": f"conv_16_layers_{name}",
              "batch": b, "kernel_ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
              "share_of_bound": bound / ms, "card": card})
    xpad, k, bias = entry_inputs(gen, images)
    entry_times = {}
    for dtype, name in DTYPES:
        out = entry_kernel.fused_entry(xpad, k, bias, out_dtype=dtype)
        ms = cuda_ms_per_call(lambda: entry_kernel.fused_entry(
            xpad, k, bias, out_dtype=dtype), calls=20)
        plain_ms = cuda_ms_per_call(lambda: entry.fused_entry(
            xpad, k, bias, out_dtype=dtype), calls=20)
        # 3x3x3 MACs per conv1 output; the pool and the epilogue are
        # comparisons and adds of a lower order
        flop = 2 * 27 * out.shape[0] * 32 * (2 * out.shape[2]) \
            * (2 * out.shape[3])
        bound, bound_by = bound_ms(flop, nbytes(xpad, k, bias, out),
                                   torch.float32)
        entry_times[name] = (ms, plain_ms, bound, bound_by)
        emit({"phase": "times", "what": "entry", "batch": len(images),
              "dtype": name, "kernel_ms": ms, "plain_ms": plain_ms,
              "library_ms": None, "bound_ms": bound, "bound_by": bound_by,
              "card": card})
    kinds = bound_kinds[(TIMED_BATCH, "bf16")]
    return {"conv": (*sums[(TIMED_BATCH, "bf16")],
                     max(kinds.items(), key=lambda kv: kv[1])[0]),
            "entry": entry_times["bf16"]}


def phase_route_times(model, card) -> None:
    """End-to-end latency of the two kernel routes beside the default
    route (median of synchronized calls), raw 480x640 uint8 on the card,
    bf16."""
    cfg = model.cfg
    fused = make_detector(cfg, entry="fused")
    routes = (("default", lambda im: model(im)),
              ("conv_impl=cuda", lambda im: detect_raw(
                  cfg, model.params, im, conv_impl="cuda")),
              ("entry=fused", lambda im: fused(model.params, im)))
    for b in E2E_BATCHES:
        images = torch.from_numpy(np.random.default_rng(b).integers(
            0, 256, (b, *SRC_HW, 3), dtype=np.uint8)).cuda()
        for route, fn in routes:
            ms = cuda_median_ms(lambda: fn(images), reps=10)
            emit({"phase": "times", "what": "route_e2e_bf16", "route": route,
                  "batch": b, "src_hw": list(SRC_HW), "ms": ms,
                  "img_per_s": b * 1000 / ms, "card": card})


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
    hgmma = hgmma_counts(lib)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": compile_s,
          "library": os.path.relpath(lib, os.path.dirname(
              os.path.abspath(__file__))), "hgmma": hgmma})
    bf16_convs = [n for n in hgmma if n.startswith("conv_bf16_kernel")]
    check(bf16_convs and all(hgmma[n] > 0 for n in bf16_convs),
          f"the bf16 conv kernels must run on wgmma (HGMMA): {hgmma}")

    rng = np.random.default_rng(SEED)
    worst = phase_kernel(rng)

    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "yolov2-coco-seed.weights")
        seeded_coco_weights(get_variant(VARIANT), weights)
        launches, model, model32, images, ref = phase_serve(weights)

    timed = phase_times(rng, model, card)

    shapes = eligible_conv_shapes(model.cfg)
    check(sum(shapes.values()) == ROUTE_CONVS and len(shapes) == 8,
          f"eligible conv shapes {shapes}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    conv_worst = phase_conv(gen, shapes)
    entry_images = torch.from_numpy(rng.integers(
        0, 256, (CONV_BATCHES[0], *SRC_HW, 3), dtype=np.uint8)).cuda()
    entry_worst = phase_entry(gen, entry_images)
    route_launches = phase_routes(model, model32,
                                  torch.from_numpy(images).cuda(), ref)
    timed_images = torch.from_numpy(rng.integers(
        0, 256, (TIMED_BATCH, *SRC_HW, 3), dtype=np.uint8)).cuda()
    kernel_times = phase_kernel_times(gen, shapes, timed_images, card)
    phase_route_times(model, card)

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "yolo_tpu"))
    check(not foreign, f"the port loaded JAX or the JAX package: {foreign}")
    nms = timed[TIMED_SHAPE]
    conv_t = kernel_times["conv"]
    entry_t = kernel_times["entry"]
    emit({"kernels": [
        {"name": "nms_suppress", "route": "cuda",
         "source": "yolo_tpu_torch/csrc/nms_suppress.cu",
         "replaces": "yolo_tpu/ops/pallas/nms_kernel.py:86",
         "launches": launches, "max_abs_err": worst,
         "ms": nms[0], "plain_ms": nms[1], "bound_ms": nms[2],
         "bound_by": nms[3], "library_ms": None},
        {"name": "conv_bias_act", "route": "cuda",
         "source": "yolo_tpu_torch/csrc/conv_bias_act.cu",
         "replaces": "yolo_tpu/ops/pallas/conv_kernel.py:91",
         "launches": route_launches["conv"], "max_abs_err": conv_worst,
         "ms": conv_t[0], "plain_ms": conv_t[1], "bound_ms": conv_t[3],
         "bound_by": conv_t[4], "library_ms": conv_t[2]},
        {"name": "entry_conv_pool", "route": "cuda",
         "source": "yolo_tpu_torch/csrc/entry_conv_pool.cu",
         "replaces": "yolo_tpu/ops/pallas/entry_kernel.py:92",
         "launches": route_launches["entry"], "max_abs_err": entry_worst,
         "ms": entry_t[0], "plain_ms": entry_t[1], "bound_ms": entry_t[2],
         "bound_by": entry_t[3], "library_ms": None}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
