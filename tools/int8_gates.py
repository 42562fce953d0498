#!/usr/bin/env python3
"""The JAX package's int8 post-training quantization held to its own
accuracy gates (tests/test_quantize.py: the largest |score_fp32 -
score_int8| below 0.3, the top-50 overlap above 0.6) on the inputs of
chip_smoke.py phase 19: a variant at its published size with the seeded
weights of io/darknet_weights.py::synthetic_detector_params(cfg, 0),
calibrated (yolo_tpu.models.quantize.prepare_int8, chained) on the 8
seeded raw 480x640 frames phase 19 draws, letterboxed on the host; the
gates on the first 2 of them in bf16 (the JAX tests' batch and
protocol: calibrated on the batch they score), and on phase 19's unseen
frames.

    python3 tools/int8_gates.py coco yolov4

Runs on the CPU where JAX is installed (the card machine has none): the
yardstick for phase 19's gates, which the port reaches on the card. One
JSON line a variant.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

SEED = 0                      # chip_smoke.py's SEED
CALIB_SEED = SEED + 19        # int8_calibrated's frames
UNSEEN_SEED = {"coco": SEED + 1, "yolov4": SEED + 194}
GATE_BATCH = 2
SRC_HW = (480, 640)


def gates(s32, s8) -> tuple:
    s32, s8 = np.asarray(s32, np.float32), np.asarray(s8, np.float32)
    top32 = np.argsort(-s32.ravel())[:50]
    top8 = np.argsort(-s8.ravel())[:50]
    return (float(np.abs(s32 - s8).max()),
            len(set(top32) & set(top8)) / 50)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", choices=sorted(UNSEEN_SEED))
    ap.add_argument("--unseen", type=int, default=GATE_BATCH,
                    help="unseen frames scored beside the gate batch")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax.numpy as jnp

    from yolo_tpu.configs import get_variant as jget_variant
    from yolo_tpu.models import graph as jgraph
    from yolo_tpu.models import quantize as jquantize
    from yolo_tpu.models.predict import forward
    from yolo_tpu.ops.decode import decode, decode_yolo
    from yolo_tpu_torch.configs import get_variant
    from yolo_tpu_torch.data.pipeline import _host_resize
    from yolo_tpu_torch.io import darknet_weights as dw

    for name in args.variants:
        t0 = time.perf_counter()
        cfg, jcfg = get_variant(name), jget_variant(name)
        params = dw.synthetic_detector_params(cfg, SEED)

        def frames(seed, n):
            raw = np.random.default_rng(seed).integers(
                0, 256, (n, *SRC_HW, 3), dtype=np.uint8)
            return np.stack([_host_resize(f, cfg.input_hw, "letterbox")
                             for f in raw])

        calib = frames(CALIB_SEED, 8)
        q = jquantize.prepare_int8(jcfg, params, jnp.asarray(calib))
        folded = jgraph.params_to_jax(jgraph.fold_params(
            jcfg.layers, params, jcfg.bn_eps))

        def scores(x01):
            x = jnp.asarray(x01)
            lo32 = forward(jcfg, folded, x, compute_dtype=jnp.float32)
            lo8 = forward(jcfg, q, x.astype(jnp.bfloat16),
                          compute_dtype=jnp.bfloat16)
            if jcfg.head_kind == "yolo":
                heads = jcfg.yolo_heads
                kw = dict(scales=[h.scale_xy for h in heads],
                          new_coords=[h.new_coords for h in heads],
                          gaussian=[h.gaussian for h in heads])
                masks = [h.mask for h in heads]
                out = [decode_yolo(lo, jcfg.anchors, masks,
                                   jcfg.num_classes, jcfg.input_hw, **kw)[1]
                       for lo in (lo32, lo8)]
            else:
                out = [decode(lo, jcfg.anchors, jcfg.num_classes)[1]
                       for lo in (lo32, lo8)]
            return gates(*out)

        dev, overlap = scores(calib[:GATE_BATCH])
        unseen_dev, unseen_overlap = scores(frames(UNSEEN_SEED[name],
                                                   args.unseen))
        print(json.dumps({
            "package": "yolo_tpu (JAX, CPU)", "model": jcfg.name,
            "input_hw": list(jcfg.input_hw), "calibration_frames": 8,
            "gate_batch": GATE_BATCH, "score_dev": dev,
            "top50_overlap": overlap, "unseen_frames": args.unseen,
            "unseen_score_dev": unseen_dev,
            "unseen_top50_overlap": unseen_overlap,
            "gates": {"score_dev": 0.3, "top50_overlap": 0.6},
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
