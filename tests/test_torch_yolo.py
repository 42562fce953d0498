"""The port's yolov3/v4 serving path (configs, weights I/O, the Darknet
executor's Shortcut / Upsample / grouped Route / SPP / mish / [yolo]
layers, decode_yolo, the fused and reference [yolo] heads, load and the
server) against the JAX package on the CPU.

Tolerances, as for the yolov2 slice (tests/test_torch_graph.py,
tests/test_torch_predict.py):
  * configs equal field for field; weights files byte for byte.
  * one layer stack, fp32: rtol 1e-5 of the output's scale. bf16: at
    least 99% of elements bit-identical (the conv sums reach the fp32
    epilogue unrounded in both packages), every one within 2 bf16 ulps
    of the output's scale.
  * whole executors, fp32: rtol 1e-4 / atol 1e-4 of each head's scale
    (oneDNN and XLA sum in other orders, over 13-110 convs). bf16: 2
    bf16 ulps of each head's scale, tested on the tiny variants at full
    width.
  * decode: rtol 1e-6. Heads, on the same logits: the fixed-shape
    outputs (valid, classes) equal, scores and boxes within 1e-5.
  * detectors end to end: fp32 kept sets equal, scores 1e-4, pixel
    boxes 1e-2; bf16 at box level, every detection at conf + 0.05
    matched both ways (VOC +1 pixel IoU >= 0.5, under which a box
    clipped to a line on the frame's edge matches itself).
"""

import dataclasses
import http.client
import io
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port import to_jax_config
from yolo_tpu.io import darknet_weights as jdw
from yolo_tpu.io import zoo as jzoo
from yolo_tpu.models import graph as jgraph
from yolo_tpu.models import predict as jpredict
from yolo_tpu.ops import decode as jdecode
from yolo_tpu.ops import head as jhead
from yolo_tpu.ops import nms as jnms
import yolo_tpu_torch
from yolo_tpu_torch.api import _infer_variant
from yolo_tpu_torch.configs import (Conv, MaxPool, ModelConfig, Route,
                                    Shortcut, Upsample, YoloHead,
                                    get_variant)
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import graph as tgraph
from yolo_tpu_torch.models import predict as tpredict
from yolo_tpu_torch.ops import decode as tdecode
from yolo_tpu_torch.ops import head as thead
from yolo_tpu_torch.ops import nms as tnms
from yolo_tpu_torch.serve import DetectionServer, detections_to_json

torch.set_num_threads(1)

YOLO_VARIANTS = ("yolov3", "yolov3-spp", "yolov3-tiny", "yolov4",
                 "yolov4-tiny")
# the official .weights sizes (tests/test_yolov3.py pins the same)
OFFICIAL_BYTES = {"yolov3": 248_007_048, "yolov3-spp": 252_209_544,
                  "yolov3-tiny": 35_434_956, "yolov4-tiny": 24_251_276,
                  "yolov4": 257_717_640}

# pixel anchors for 64-pixel nets
SMALL_ANCHORS = ((4, 5), (6, 10), (10, 8), (10, 20), (20, 15), (20, 40),
                 (38, 30), (50, 60), (60, 55))
HEAD = 3 * (5 + 4)

# yolov3's layer kinds at narrow widths: stride-2 convs, residual
# blocks, SPP, three heads, upsample and absolute routes; convs 14, 21
# and 22 have CIN and CO multiples of 128 (the conv kernel's route)
NARROW_V3 = ModelConfig(
    name="narrow-v3",
    layers=(
        Conv(8), Conv(16, stride=2),                        # 0-1
        Conv(8, 1), Conv(16), Shortcut(-3),                 # 2-4
        Conv(32, stride=2),                                 # 5
        Conv(16, 1), Conv(32), Shortcut(-3),                # 6-8
        Conv(128, stride=2),                                # 9
        Conv(64, 1), Conv(128), Shortcut(-3),               # 10-12
        Conv(128, stride=2), Conv(128, 1),                  # 13-14
        MaxPool(5, 1), Route((-2,)), MaxPool(9, 1), Route((-4,)),
        MaxPool(13, 1), Route((-1, -3, -5, -6)),            # 15-20
        Conv(128, 1), Conv(128),                            # 21-22
        Conv(HEAD, 1, bn=False, act="linear"),              # 23
        YoloHead((6, 7, 8)),                                # 24 (/16)
        Route((-4,)), Conv(32, 1), Upsample(2),             # 25-27
        Route((-1, 12)), Conv(64),                          # 28-29
        Conv(HEAD, 1, bn=False, act="linear"),              # 30
        YoloHead((3, 4, 5)),                                # 31 (/8)
        Route((-4,)), Conv(16, 1), Upsample(2),             # 32-34
        Route((-1, 8)), Conv(32),                           # 35-36
        Conv(HEAD, 1, bn=False, act="linear"),              # 37
        YoloHead((0, 1, 2)),                                # 38 (/4)
    ),
    anchors=SMALL_ANCHORS, class_names=("a", "b", "c", "d"), input_size=64)

# yolov4's: mish CSP stage with a residual block, yolov4-tiny's grouped
# route block, SPP, scale_x_y heads, strided convs; layers 16, 19 and 26
# take the conv kernel's route. It downsamples by convs only, as yolov4
# does (a 2x2 max-pool window whose two largest values lie within the
# packages' fp32 distance routes its gradient to another element, and
# tests/test_torch_yolo_train.py trains this net)
NARROW_V4 = ModelConfig(
    name="narrow-v4",
    layers=(
        Conv(16, act="mish"), Conv(32, stride=2, act="mish"),   # 0-1
        Conv(32, 1, act="mish"), Route((-2,)),                  # 2-3
        Conv(32, 1, act="mish"),                                # 4
        Conv(16, 1, act="mish"), Conv(32, act="mish"),
        Shortcut(-3),                                           # 5-7
        Conv(32, 1, act="mish"), Route((-1, -7)),               # 8-9
        Conv(32, 1, act="mish"),                                # 10
        Conv(128, stride=2),                                    # 11
        Route((-1,), groups=2, group_id=1), Conv(64), Conv(64),
        Route((-1, -2)), Conv(128, 1), Route((-6, -1)),         # 12-17
        Conv(128, stride=2), Conv(128, 1),                      # 18-19
        MaxPool(5, 1), Route((-2,)), MaxPool(9, 1), Route((-4,)),
        MaxPool(13, 1), Route((-1, -3, -5, -6)),                # 20-25
        Conv(128, 1),                                           # 26
        Conv(HEAD, 1, bn=False, act="linear"),                  # 27
        YoloHead((3, 4, 5), scale_xy=1.1),                      # 28 (/8)
        Route((-3,)), Conv(32, 1), Upsample(2),                 # 29-31
        Route((-1, 11)), Conv(64),                              # 32-33
        Conv(HEAD, 1, bn=False, act="linear"),                  # 34
        YoloHead((0, 1, 2), scale_xy=1.2),                      # 35 (/4)
        Route((-3,)), Conv(64, stride=2), Route((-1, 26)),      # 36-38
        Conv(128, stride=2),                                    # 39
        Conv(HEAD, 1, bn=False, act="linear"),                  # 40
        YoloHead((6, 7, 8), scale_xy=1.05),                     # 41 (/16)
    ),
    anchors=SMALL_ANCHORS, class_names=("a", "b", "c", "d"), input_size=64,
    iou_loss="ciou", iou_normalizer=0.07, assign_iou_thresh=0.213)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _he_folded(cfg, seed=0):
    """He-scaled seeded weights (residual branches scaled, heads
    calibrated), folded."""
    return tgraph.fold_params(cfg.layers,
                              dw.synthetic_detector_params(cfg, seed),
                              cfg.bn_eps)


def _both(cfg, folded, x, dtype, conv_impl="torch"):
    """(port logits, JAX logits) as lists of fp32 numpy arrays."""
    tdt, jdt = {"fp32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    got = tgraph.Darknet(cfg.layers, folded, device="cpu", dtype=tdt)(
        torch.from_numpy(x), conv_impl=conv_impl)
    want = jgraph.apply_layers(to_jax_config(cfg).layers,
                               jgraph.params_to_jax(folded), jnp.asarray(x),
                               eps=cfg.bn_eps, compute_dtype=jdt)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


# --- configs and weights ------------------------------------------------------

@pytest.mark.parametrize("variant", YOLO_VARIANTS)
def test_yolo_variant_bytes_match_the_official_files(tmp_path, variant):
    """expected_bytes gives the official sizes, and load infers the
    variant from a file of that size (16- and 20-byte headers)."""
    cfg = get_variant(variant)
    assert dw.expected_bytes(cfg.layers) == OFFICIAL_BYTES[variant] == \
        jzoo.expected_weights_bytes(to_jax_config(cfg).layers)
    for size in (OFFICIAL_BYTES[variant], OFFICIAL_BYTES[variant] - 4):
        path = tmp_path / f"{size}.weights"
        with open(path, "wb") as f:
            f.truncate(size)   # sparse: the size is what is read
        assert _infer_variant(str(path)) == variant


@pytest.mark.parametrize("variant", ["yolov3-tiny", "yolov4-tiny"])
def test_yolo_weights_round_trip_matches_jax(tmp_path, variant):
    cfg = get_variant(variant)
    jcfg = to_jax_config(cfg)
    params = dw.random_params(cfg.layers, np.random.default_rng(3))
    jparams = jdw.random_params(jcfg.layers, np.random.default_rng(3))
    path = str(tmp_path / "w.weights")
    dw.save(path, cfg.layers, params, seen=11)
    with open(path, "rb") as f:
        data = f.read()
    assert data == jdw.to_bytes(jcfg.layers, jparams, seen=11)
    assert len(data) == OFFICIAL_BYTES[variant]
    got, header = dw.load(path, cfg.layers)
    want, jheader = jdw.load(path, jcfg.layers)
    assert header == jheader
    for p, q in zip(got, want, strict=True):
        assert set(p) == set(q)
        for key in p:
            np.testing.assert_array_equal(p[key], q[key])


def test_load_partial_takes_a_darknet53_cutoff(tmp_path):
    """darknet53.conv.74 (layers 0-73 of yolov3: Darknet-53's 52 convs)
    reads back as a 52-conv prefix in both packages."""
    cfg = get_variant("yolov3")
    head = cfg.layers[:74]
    params = dw.random_params(head, np.random.default_rng(0), scale=0.01)
    path = str(tmp_path / "darknet53.conv.74")
    dw.save(path, head, params)
    import os

    assert os.path.getsize(path) == 162_482_580
    got, header, n = dw.load_partial(path, cfg.layers)
    want, jheader, jn = jdw.load_partial(path, to_jax_config(cfg).layers)
    assert n == jn == 52 and header == jheader
    for p, q in zip(got, want, strict=True):
        for key in p:
            np.testing.assert_array_equal(p[key], q[key])
    with pytest.raises(ValueError, match="too short"):
        dw.load(path, cfg.layers)


@pytest.mark.parametrize("make", [
    lambda: Conv(8, act="swish"), lambda: Conv(8, act="logistic"),
    lambda: Shortcut(-2, weights_type="per_channel"),
    lambda: YoloHead((0,), new_coords=True),
    lambda: YoloHead((0,), gaussian=True)])
def test_custom_cfg_options_raise_when_built(make):
    """Options only a custom .cfg sets (ROADMAP A8b) used to raise when
    built; now each builds, and a small net with it matches the JAX
    package: the executor in fp32 (rtol 1e-5 of the output's scale) and,
    for the two head options, decode_yolo (rtol 1e-6)."""
    spec = make()
    rng = np.random.default_rng(11)
    if isinstance(spec, YoloHead):
        head_conv = Conv((9 if spec.gaussian else 5) + 1, 1, bn=False,
                         act="logistic" if spec.new_coords else "linear")
        layers = (Conv(8), head_conv, spec)
    elif isinstance(spec, Shortcut):
        layers = (Conv(8), Conv(8), spec)
    else:
        layers = (Conv(8), spec)
    cfg = ModelConfig(name="option", layers=layers,
                      anchors=SMALL_ANCHORS[:1], class_names=("a",),
                      input_size=32)
    params = dw.random_params(layers, rng, scale=0.3)
    if isinstance(spec, Shortcut):
        params[-1]["weights"] = rng.normal(1, 0.5, (2, 8)).astype(np.float32)
    folded = tgraph.fold_params(layers, params)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    got, want = _both(cfg, folded, x, "fp32")
    for g, w in zip(got, want, strict=True):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale)
    if isinstance(spec, YoloHead):
        flags = dict(new_coords=[spec.new_coords], gaussian=[spec.gaussian])
        boxes, scores = tdecode.decode_yolo(
            [torch.from_numpy(got[0])], cfg.anchors, [spec.mask], 1,
            cfg.input_hw, **flags)
        jboxes, jscores = jdecode.decode_yolo(
            [jnp.asarray(got[0])], cfg.anchors, [spec.mask], 1,
            cfg.input_hw, **flags)
        np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                                   rtol=1e-6, atol=1e-7)


def test_narrow_configs_carry_over_to_jax():
    for cfg in (NARROW_V3, NARROW_V4):
        jcfg = to_jax_config(cfg)
        assert jcfg.head_kind == cfg.head_kind == "yolo"
        assert [dataclasses.asdict(h) for h in jcfg.yolo_heads] == \
            [dataclasses.asdict(h) for h in cfg.yolo_heads]
        assert dw.expected_bytes(cfg.layers) == \
            jzoo.expected_weights_bytes(jcfg.layers)


# --- layers -------------------------------------------------------------------

LAYER_STACKS = {
    "shortcut": (Conv(8), Conv(8), Shortcut(-2)),
    "shortcut_wider_input": (Conv(8), Conv(12), Shortcut(-2)),
    "shortcut_narrower_input": (Conv(12), Conv(8), Shortcut(-2)),
    "upsample": (Conv(8), Upsample(2)),
    "upsample_scale": (Conv(8), Upsample(2, scale=1.5)),
    "route_groups_one_source": (Conv(8), Route((-1,), groups=2, group_id=1)),
    "route_groups_two_sources": (Conv(8), Conv(4),
                                 Route((-1, -2), groups=2, group_id=0)),
    "spp": (Conv(8), MaxPool(5, 1), Route((-2,)), MaxPool(9, 1),
            Route((-4,)), MaxPool(13, 1), Route((-1, -3, -5, -6))),
    "mish": (Conv(8, act="mish"), Conv(8, 1, act="mish")),
    "stride2": (Conv(8, stride=2), Conv(8, stride=2)),
    "yolo_heads": (Conv(8), Conv(2 * 6, 1, bn=False, act="linear"),
                   YoloHead((0, 1)), Route((-3,)), Upsample(2),
                   Conv(2 * 6, 1, bn=False, act="linear"),
                   YoloHead((2, 3))),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("stack", sorted(LAYER_STACKS))
def test_layer_stack_matches_jax(stack, dtype):
    layers = LAYER_STACKS[stack]
    rng = np.random.default_rng(7)
    params = dw.random_params(layers, rng, scale=0.3)
    folded = tgraph.fold_params(layers, params)
    cfg = ModelConfig(name=stack, layers=layers, anchors=SMALL_ANCHORS[:4],
                      class_names=("a",), input_size=32)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    got, want = _both(cfg, folded, x, dtype)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        scale = float(np.abs(w).max())
        if dtype == "fp32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale)
        else:
            assert (g == w).mean() >= 0.99
            assert np.abs(g - w).max() <= 2 * _bf16_ulp(scale)


def test_yolo_heads_are_returned_in_layer_order_and_route_through():
    layers = LAYER_STACKS["yolo_heads"]
    folded = tgraph.fold_params(
        layers, dw.random_params(layers, np.random.default_rng(0)))
    out = tgraph.Darknet(layers, folded, device="cpu")(torch.zeros(1, 8, 8, 3))
    assert [tuple(h.shape) for h in out] == [(1, 8, 8, 12), (1, 16, 16, 12)]
    assert all(h.dtype == torch.float32 for h in out)


# --- whole executors ----------------------------------------------------------

@pytest.mark.parametrize("make_cfg", [
    lambda: get_variant("yolov3-tiny", input_size=96),
    lambda: get_variant("yolov4-tiny", input_size=96),
    lambda: NARROW_V3, lambda: NARROW_V4],
    ids=["yolov3-tiny-96", "yolov4-tiny-96", "narrow-v3", "narrow-v4"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_yolo_executor_matches_jax(make_cfg, dtype):
    """On random_params(scale=0.1), as the yolov2 executor tests: the
    seeded detector weights' calibrated heads multiply the class logits
    by ~6, and a bf16 rounding difference with them."""
    cfg = make_cfg()
    folded = tgraph.fold_params(cfg.layers, dw.random_params(
        cfg.layers, np.random.default_rng(8), scale=0.1), cfg.bn_eps)
    x = np.random.default_rng(2).uniform(
        0, 1, (2, *cfg.input_hw, 3)).astype(np.float32)
    got, want = _both(cfg, folded, x, dtype)
    assert len(got) == len(cfg.yolo_heads)
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        if dtype == "fp32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale)
        else:
            assert np.abs(g - w).max() <= 2 * _bf16_ulp(scale)


@pytest.mark.parametrize("cfg", [NARROW_V3, NARROW_V4], ids=lambda c: c.name)
def test_yolo_cuda_route_matches_jax_pallas_route(monkeypatch, cfg):
    """conv_impl="cuda" sends the leaky/linear convs with CIN and CO
    multiples of 128 to the conv kernel (on the CPU its plain version)
    and keeps mish convs off it, as the JAX package's "pallas" route
    (Pallas in interpret mode) does."""
    from yolo_tpu.ops.pallas import conv_kernel as jck

    folded = _he_folded(cfg)
    x = np.random.default_rng(4).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    jax_calls, port_calls = [], []
    jfn = jck.fused_conv_bias_act

    def jcount(x, kernel, bias, *, act="leaky", interpret=False):
        jax_calls.append(tuple(kernel.shape))
        return jfn(x, kernel, bias, act=act, interpret=True)

    monkeypatch.setattr(jck, "fused_conv_bias_act", jcount)
    want = jgraph.apply_layers(to_jax_config(cfg).layers,
                               jgraph.params_to_jax(folded), jnp.asarray(x),
                               eps=cfg.bn_eps, conv_impl="pallas")
    tfn = tgraph.conv_kernel.fused_conv_bias_act

    def tcount(x, kernel, bias, *, act="leaky"):
        port_calls.append(tuple(kernel.permute(2, 3, 1, 0).shape))
        return tfn(x, kernel, bias, act=act)

    monkeypatch.setattr(tgraph.conv_kernel, "fused_conv_bias_act", tcount)
    net = tgraph.Darknet(cfg.layers, folded, device="cpu")
    got = net(torch.from_numpy(x), conv_impl="cuda")
    assert len(port_calls) == 3 and port_calls == jax_calls
    convs = [l for l in cfg.layers if isinstance(l, Conv)]
    assert all(c.act != "mish" for c, ok in zip(convs, net.kernel_eligible)
               if ok)
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * scale)


# --- decode and heads ---------------------------------------------------------

def _head_logits(seed, cfg, b=2):
    """Seeded head logits shaped for cfg's heads at its input size, with
    boxes near their anchors and a few objects per image."""
    rng = np.random.default_rng(seed)
    from yolo_tpu_torch.configs import layer_strides

    strides = layer_strides(cfg.layers)
    out = []
    for idx, l in enumerate(cfg.layers):
        if isinstance(l, YoloHead):
            s = cfg.input_size // strides[idx]
            t = rng.normal(0, 1, (b, s, s, len(l.mask), 5 + cfg.num_classes))
            t[..., 2:4] *= 0.3
            t[..., 4] = rng.normal(-4, 2.5, t.shape[:-1])
            t[..., 5:] -= 1.5
            out.append(t.reshape(b, s, s, -1).astype(np.float32))
    return out


@pytest.mark.parametrize("cfg", [NARROW_V4, get_variant("yolov3-tiny", 128)],
                         ids=["narrow-v4", "yolov3-tiny-128"])
def test_decode_yolo_matches_jax(cfg):
    heads = _head_logits(0, cfg)
    masks = [h.mask for h in cfg.yolo_heads]
    scales = [h.scale_xy for h in cfg.yolo_heads]
    boxes, scores = tdecode.decode_yolo(
        [torch.from_numpy(h) for h in heads], cfg.anchors, masks,
        cfg.num_classes, cfg.input_hw, scales=scales)
    jboxes, jscores = jdecode.decode_yolo(
        [jnp.asarray(h) for h in heads], cfg.anchors, masks,
        cfg.num_classes, cfg.input_hw, scales=scales)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-6, atol=1e-7)


def _assert_same_detections(got, want):
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-5)
    return int(want["valid"].sum())


@pytest.mark.parametrize("conf", [0.25, 0.5, 0.005])
@pytest.mark.parametrize("cfg", [NARROW_V4, get_variant("yolov3-tiny", 128)],
                         ids=["narrow-v4", "yolov3-tiny-128"])
def test_yolo_heads_match_jax(cfg, conf):
    """The fused head against JAX's detect_head_yolo (plain suppression,
    use_pallas=False) and the reference head (decode_yolo + nms_batch)
    against JAX's, on the same logits."""
    heads = _head_logits(1, cfg)
    masks = [h.mask for h in cfg.yolo_heads]
    scales = [h.scale_xy for h in cfg.yolo_heads]
    pre = 128 if conf >= 0.3 else 256
    got = thead.detect_head_yolo(
        [torch.from_numpy(h) for h in heads], cfg.anchors, masks,
        cfg.num_classes, cfg.input_hw, conf_threshold=conf,
        iou_threshold=0.45, pre_top_k=pre, use_kernel=False, scales=scales)
    want = jhead.detect_head_yolo(
        [jnp.asarray(h) for h in heads], cfg.anchors, masks,
        cfg.num_classes, cfg.input_hw, conf_threshold=conf,
        iou_threshold=0.45, pre_top_k=pre, use_pallas=False, scales=scales)
    n_fused = _assert_same_detections(got, want)
    boxes, scores = tdecode.decode_yolo(
        [torch.from_numpy(h) for h in heads], cfg.anchors, masks,
        cfg.num_classes, cfg.input_hw, scales=scales)
    jboxes, jscores = jdecode.decode_yolo(
        [jnp.asarray(h) for h in heads], cfg.anchors, masks,
        cfg.num_classes, cfg.input_hw, scales=scales)
    got = tnms.nms_batch(boxes, scores, conf_threshold=conf,
                         iou_threshold=0.45, impl="torch")
    want = jnms.nms_batch(jboxes, jscores, conf_threshold=conf,
                          iou_threshold=0.45, impl="xla")
    n_ref = _assert_same_detections(got, want)
    assert n_fused > 0 and n_ref > 0


def test_fused_yolo_head_orders_ties_as_lax_top_k():
    """Equal objectness everywhere (N = 3 heads' boxes): the prefilter
    keeps the lowest flat indices, as lax.top_k does."""
    cfg = NARROW_V4
    heads = [np.zeros_like(h) for h in _head_logits(2, cfg, b=1)]
    for h in heads:
        h.reshape(-1, 9)[:, 4] = 3.0
        h.reshape(-1, 9)[:, 5] = 3.0
    masks = [h.mask for h in cfg.yolo_heads]
    kw = dict(conf_threshold=0.5, iou_threshold=0.45, pre_top_k=64)
    got = thead.detect_head_yolo([torch.from_numpy(h) for h in heads],
                                 cfg.anchors, masks, 4, 64,
                                 use_kernel=False, **kw)
    want = jhead.detect_head_yolo([jnp.asarray(h) for h in heads],
                                  cfg.anchors, masks, 4, 64,
                                  use_pallas=False, **kw)
    _assert_same_detections(got, want)


# --- routes -------------------------------------------------------------------

@pytest.mark.parametrize("variant", YOLO_VARIANTS)
def test_fused_entry_raises_for_the_yolo_variants(variant):
    """None of the five is entry-fusable: yolov3-tiny's Route((-1, 8)) is
    absolute, the others do not start with conv3x3 + pool 2x2."""
    cfg = get_variant(variant, input_size=64)
    assert not tpredict._entry_fusable(cfg)
    jcfg = to_jax_config(cfg)
    shapes = [{"kernel": np.zeros((1, 1, 1, 1)), "bias": np.zeros(1)}]
    assert not jpredict._entry_fusable(jcfg, shapes)
    if variant == "yolov3-tiny":
        net = tgraph.Darknet(cfg.layers, _he_folded(cfg), device="cpu")
        with pytest.raises(ValueError, match="entry"):
            tpredict.detect_raw(cfg, net, torch.zeros(1, 48, 64, 3,
                                                      dtype=torch.uint8),
                                entry="fused")


@pytest.mark.parametrize("frm", [-3, 1])
def test_shortcut_reaching_the_entry_is_not_fusable(frm):
    """A Shortcut whose from reaches layer 0 or 1 keeps the entry
    unfused in both packages (predict.py::_entry_fusable)."""
    cfg = ModelConfig(
        name="entry-shortcut",
        layers=(Conv(8), MaxPool(2, 2), Conv(8), Shortcut(frm),
                Conv(HEAD, 1, bn=False, act="linear"), YoloHead((0, 1, 2))),
        anchors=SMALL_ANCHORS, class_names=("a", "b", "c", "d"),
        input_size=64)
    ok = dataclasses.replace(cfg, layers=cfg.layers[:3] + (Shortcut(-1),)
                             + cfg.layers[4:])
    params = [{"kernel": np.zeros((3, 3, 3, 8)), "bias": np.zeros(8)}]
    for c, want in ((cfg, False), (ok, True)):
        assert tpredict._entry_fusable(c) is want
        assert jpredict._entry_fusable(to_jax_config(c), params) is want


# --- seeded weights -----------------------------------------------------------

@pytest.mark.parametrize("variant", YOLO_VARIANTS)
def test_seeded_yolo_weights_keep_logits_o1(variant):
    """The residual branches' last convs are scaled and the heads
    calibrated on a probe: every head's mean |logit| stays O(1) (6-11
    here, most of it the class logits' negative offset), and no box
    overflows exp(tw) (at plain He scale yolov3's logits reach ~1e3)."""
    cfg = get_variant(variant, input_size=96)
    folded = _he_folded(cfg)
    x = np.random.default_rng(5).uniform(0, 1, (1, 96, 96, 3)).astype(
        np.float32)
    heads = tgraph.Darknet(cfg.layers, folded, device="cpu")(
        torch.from_numpy(x))
    for h in heads:
        assert 0.1 < float(h.abs().mean()) < 20.0
        t = h.reshape(1, -1, 85)
        assert float(t[..., 2:4].abs().max()) < 5.0


@pytest.mark.parametrize("variant", ["yolov3-tiny", "yolov4-tiny"])
def test_seeded_tiny_detectors_keep_a_few_detections(variant):
    """At 416 on raw 480x640 noise frames, the seeded tiny detectors keep
    a few to a few dozen detections an image at conf 0.5, as the
    seeded YOLOv2 does, and fewer boxes clear objectness 0.5 than the
    fused head's prefilter keeps."""
    cfg = get_variant(variant)
    net = tgraph.Darknet(cfg.layers, _he_folded(cfg), device="cpu")
    imgs = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 480, 640, 3), dtype=np.uint8))
    torch.set_num_threads(4)
    try:
        dets = tpredict.detect_raw(cfg, net, imgs, head="reference")
        heads = net(tpredict.letterbox(imgs, cfg.input_hw,
                                       dtype=torch.float32))
    finally:
        torch.set_num_threads(1)
    per_image = dets["valid"].sum(dim=1)
    assert bool(((per_image >= 2) & (per_image <= 60)).all()), per_image
    above = sum(int((h.reshape(2, -1, 85)[..., 4] > 0).sum()) for h in heads)
    assert above < 2 * 128


# --- the slice end to end -----------------------------------------------------

def _iou_voc(p, q):
    iw = max(0.0, min(p[2], q[2]) - max(p[0], q[0]) + 1)
    ih = max(0.0, min(p[3], q[3]) - max(p[1], q[1]) + 1)
    union = ((p[2] - p[0] + 1) * (p[3] - p[1] + 1)
             + (q[2] - q[0] + 1) * (q[3] - q[1] + 1) - iw * ih)
    return iw * ih / union


def _matched_voc(a, b, conf):
    hit = total = 0
    for bi in range(len(a["valid"])):
        kept = [(int(c), box) for c, box, v in zip(
            b["classes"][bi], b["boxes"][bi].astype(np.float64),
            b["valid"][bi]) if v]
        for c, s, box, v in zip(a["classes"][bi], a["scores"][bi],
                                a["boxes"][bi].astype(np.float64),
                                a["valid"][bi]):
            if v and s >= conf + 0.05:
                total += 1
                hit += any(c == c2 and _iou_voc(box, box2) >= 0.5
                           for c2, box2 in kept)
    return hit, total


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_yolov4_tiny_slice_matches_jax_detector(tmp_path, precision):
    """yolo_tpu_torch.load infers a seeded yolov4-tiny .weights file by
    its size; detect_raw on raw uint8 frames against JAX's make_detector
    on the same file (both fused heads)."""
    size = 160
    cfg = get_variant("yolov4-tiny", input_size=size)
    path = str(tmp_path / "yolov4-tiny.weights")
    dw.save(path, cfg.layers, dw.synthetic_detector_params(cfg, 0))
    model = yolo_tpu_torch.load(path, device="cpu", precision=precision,
                                input_size=size)
    assert model.cfg.name == "yolov4-tiny-coco"
    imgs = np.random.default_rng(1).integers(0, 256, (2, 240, 320, 3),
                                             dtype=np.uint8)
    jcfg = to_jax_config(cfg)
    jparams, _ = jdw.load(path, jcfg.layers)
    jparams = jgraph.params_to_jax(jgraph.fold_params(jcfg.layers, jparams,
                                                      jcfg.bn_eps))
    jdt = jnp.float32 if precision == "fp32" else jnp.bfloat16
    want = jpredict.make_detector(jcfg, compute_dtype=jdt, head="fused")(
        jparams, jnp.asarray(imgs))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = tpredict.detect_raw(cfg, model.params, torch.from_numpy(imgs),
                              head="fused")
    got = {k: v.numpy() for k, v in got.items()}
    assert want["valid"].sum() >= 2
    if precision == "fp32":
        v = want["valid"]
        np.testing.assert_array_equal(got["valid"], v)
        np.testing.assert_array_equal(got["classes"][v], want["classes"][v])
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got["boxes"][v], want["boxes"][v],
                                   rtol=0, atol=1e-2)
    else:
        for a, b in ((want, got), (got, want)):
            hit, total = _matched_voc(a, b, cfg.conf_threshold)
            assert total >= 2 and hit == total


def _post_npy(port, image):
    buf = io.BytesIO()
    np.save(buf, image)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/detect", body=buf.getvalue(),
                     headers={"Content-Type": "application/x-npy"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_server_answers_a_yolo_model_like_direct_calls(tmp_path):
    cfg = get_variant("yolov3-tiny", input_size=128)
    path = str(tmp_path / "w.weights")
    dw.save(path, cfg.layers, dw.synthetic_detector_params(cfg, 0))
    model = yolo_tpu_torch.load(path, "yolov3-tiny", device="cpu",
                                precision="fp32", input_size=128)
    imgs = np.random.default_rng(6).integers(0, 256, (3, 96, 128, 3),
                                             dtype=np.uint8)
    server = DetectionServer(model.cfg, model.params, port=0)
    server.start()
    try:
        responses = []
        for img in imgs:
            status, body = _post_npy(server.port, img)
            assert status == 200
            responses.append(body["detections"])
    finally:
        server.stop()
    direct = [detections_to_json(model(img[None]), cfg.class_names)[0]
              for img in imgs]
    assert responses == direct
    assert sum(len(d) for d in direct) > 0
