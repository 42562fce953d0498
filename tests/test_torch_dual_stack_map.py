"""The port's eval stack through tests/test_dual_stack_map.py's protocol
(ROADMAP A7): the port's collect_detections (host letterbox or stretch,
torch forward, reference decode + per-class NMS, un-mapping) against the
TF oracle stack of that file (numpy letterbox, TensorFlow forward, loop
decode, protocol-mirror NMS), both scored by the port's evaluators and
by the file's clean-room VOC and COCO scorers, on the same synthetic
images and ground truth made from the detections (_synth_gt). That file
stays as it is; its helpers run here on fewer images (DUAL_IMAGES).

Bounds are the file's own: the two stacks' VOC mAP within 2e-3; the
port's evaluator and the clean-room scorer on the same detections within
1e-6 (VOC) and 1e-4 (COCO: its loop scorer covers the 'all' cells)."""

import numpy as np
import pytest
import torch

from tests.test_dual_stack_map import (EVAL_CONF, _coco_map_oracle,
                                       _make_images, _realistic_params,
                                       _synth_gt, _tf_collect,
                                       _voc_map_oracle)
from tests.torch_port import to_jax_config
from yolo_tpu_torch.configs import get_variant
from yolo_tpu_torch.eval.coco_map import evaluate_coco
from yolo_tpu_torch.eval.runner import collect_detections
from yolo_tpu_torch.eval.voc_map import evaluate
from yolo_tpu_torch.models.graph import fold_params

DUAL_IMAGES = 10


def _stacks(tmp_path, variant, resize, size=416):
    cfg = get_variant(variant, input_size=size)
    if resize == "stretch-rect":
        cfg, resize = cfg.with_input_hw(256, 416), "stretch"
    jcfg = to_jax_config(cfg)
    rng = np.random.default_rng(0)
    params = _realistic_params(jcfg, rng)
    samples = _make_images(tmp_path, rng, n=DUAL_IMAGES)
    dets = collect_detections(
        cfg, fold_params(cfg.layers, params, cfg.bn_eps),
        [(p, None) for p, _ in samples], batch=4, eval_conf=EVAL_CONF,
        compute_dtype=torch.float32, resize=resize, device="cpu")
    assert sum(len(v) for v in dets.values()) > 20
    dets_tf = _tf_collect(jcfg, params, samples, EVAL_CONF, resize=resize)
    gt = _synth_gt(dets, samples, np.random.default_rng(7), cfg.num_classes)
    return cfg, dets, dets_tf, gt


@pytest.mark.parametrize("variant, resize", [
    ("tiny-voc", "letterbox"), ("yolov3-tiny", "letterbox"),
    ("tiny-voc", "stretch"), ("tiny-voc", "stretch-rect")])
def test_dual_stack_voc_map_parity(tmp_path, variant, resize):
    cfg, dets, dets_tf, gt = _stacks(tmp_path, variant, resize)
    nc = cfg.num_classes
    map_port = evaluate(dets, gt, nc, use_07_metric=True)["map"]
    map_tf = _voc_map_oracle(dets_tf, gt, nc)
    assert 0.02 < map_port < 0.999, map_port
    assert abs(map_port - map_tf) < 2e-3, (map_port, map_tf)
    assert abs(map_port - _voc_map_oracle(dets, gt, nc)) < 1e-6


def test_dual_stack_coco_protocol(tmp_path):
    cfg, dets, dets_tf, gt = _stacks(tmp_path, "tiny-voc", "letterbox")
    nc = cfg.num_classes
    res = evaluate_coco(dets, gt, nc)
    ref = _coco_map_oracle(dets, gt, nc)
    assert 0.0 < res["map"] < 1.0
    assert abs(res["map"] - ref["map"]) < 1e-4
    assert abs(res["ar"] - ref["ar"]) < 1e-4
    # the TF stack's detections score alike under the same protocol
    assert abs(_coco_map_oracle(dets_tf, gt, nc)["map"] - res["map"]) < 2e-3
