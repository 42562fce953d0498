"""The options only a custom darknet .cfg sets (grouped, depthwise and
dilated convs; the logistic, swish, relu and ramp activations; weighted
shortcuts; [sam]; [scale_channels] SE blocks with a global [avgpool];
scaled-yolov4 new_coords heads; [Gaussian_yolo] heads) and rectangular
nets, in the port's executors, decode, fused head, detectors, weights
I/O and losses, against the JAX package on the CPU.

Tolerances, as tests/test_torch_yolo.py states them:
  * one layer stack, fp32: rtol 1e-5 of the output's scale. bf16: at
    least 99% of elements bit-identical, every one within 2 bf16 ulps
    of the output's scale.
  * whole executors, fp32: 1e-4 of each head's scale. bf16: 2 bf16 ulps
    of each head's scale.
  * decode: rtol 1e-6. Heads, on the same logits: valid and classes
    equal, scores and boxes within 1e-5.
  * detectors end to end: fp32 kept sets equal, scores 1e-4, pixel
    boxes 1e-2; bf16 at box level, every detection at conf + 0.05
    matched both ways (VOC +1 pixel IoU >= 0.5).
  * weights files byte for byte. Losses, fp32: value and parts to a
    relative 1e-5, gradients to 1e-4 of each tensor's largest (as
    tests/test_torch_yolo_train.py); train-mode forward 1e-5 of each
    tensor's scale; three SGD steps: params 1e-5 and BN statistics 1e-6
    of each tensor's scale, loss parts to a relative 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_gaussian_yolo import GAUSS_CFG
from tests.test_rect import RECT_YOLO_CFG
from tests.test_scaled_yolov4 import COMPOSITE_CFG
from tests.test_torch_yolo import (_assert_same_detections, _bf16_ulp,
                                   _both, _matched_voc)
from tests.test_torch_yolo_train import _scale_close
from tests.torch_port import to_jax_config
from yolo_tpu.data import targets as jtgt
from yolo_tpu.io import darknet_weights as jdw
from yolo_tpu.models import graph as jgraph
from yolo_tpu.models import predict as jpredict
from yolo_tpu.ops import decode as jdecode
from yolo_tpu.ops import head as jhead
from yolo_tpu.train import loop as jloop
from yolo_tpu.train import loss as jloss
from yolo_tpu_torch.configs import (AvgPool, Conv, ModelConfig, Route, Sam,
                                    ScaleChannels, Shortcut, Upsample,
                                    YoloHead, layer_strides)
from yolo_tpu_torch.configs.darknet_cfg import config_from_cfg
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import graph as tgraph
from yolo_tpu_torch.models import predict as tpredict
from yolo_tpu_torch.ops import decode as tdecode
from yolo_tpu_torch.ops import head as thead
from yolo_tpu_torch.train import loop as tloop
from yolo_tpu_torch.train import loss as tloss

torch.set_num_threads(1)

ANCHORS = ((6, 8), (12, 10), (24, 20), (40, 36), (60, 50), (90, 80))
NAMES = ("a", "b", "c", "d")


def _cfg_text(tmp_path, text, name):
    p = tmp_path / f"{name}.cfg"
    p.write_text(text)
    return config_from_cfg(str(p))


# --- configs at narrow widths ---------------------------------------------------

# yolov4-csp-swish's head conventions on a narrow yolov4-style trunk,
# rectangular: swish where yolov4 has mish, logistic head convs,
# new_coords heads with scale_x_y 2; convs 4, 5 and 6 (leaky/linear,
# CIN and CO multiples of 128) take the conv kernel's route
SCALED_SWISH = ModelConfig(
    name="narrow-csp-swish",
    layers=(
        Conv(16, act="swish"), Conv(32, stride=2, act="swish"),   # 0-1 /2
        Conv(16, 1, act="swish"), Conv(32, act="swish"),
        Shortcut(-3),                                             # 2-4
        Conv(128, stride=2),                                      # 5 /4
        Conv(128, 1), Conv(128),                                  # 6-7
        Conv(2 * 9, 1, bn=False, act="logistic"),                 # 8
        YoloHead((2, 3), scale_xy=2.0, new_coords=True),          # 9 /4
        Route((-3,)), Conv(64, stride=2, act="swish"),            # 10-11
        Conv(2 * 9, 1, bn=False, act="logistic"),                 # 12
        YoloHead((4, 5), scale_xy=2.0, new_coords=True),          # 13 /8
    ),
    anchors=ANCHORS, class_names=NAMES, input_size=64, input_width=96,
    iou_loss="ciou", iou_normalizer=0.07)

# every other option in one net: grouped, depthwise and dilated convs,
# relu / ramp / swish / logistic, weighted shortcuts (per_feature relu,
# per_channel softmax), sam, an SE block (avgpool -> 1x1 convs ->
# scale_channels); a classic [yolo] head
EVERY_OPTION = ModelConfig(
    name="every-option",
    layers=(
        Conv(16, stride=2),                                       # 0 /2
        Conv(16, groups=4, act="relu"),                           # 1
        Conv(16, groups=16, act="ramp"),                          # 2
        Shortcut(-3, weights_type="per_feature", weights_norm="relu"),
        Conv(32, stride=2),                                       # 4 /4
        Conv(32, dilation=2, act="swish"),                        # 5
        Shortcut(-2, weights_type="per_channel", weights_norm="softmax"),
        Conv(32, 1, act="logistic"), Sam(-2),                     # 7-8
        AvgPool(), Conv(8, 1, act="relu"),                        # 9-10
        Conv(32, 1, act="logistic"), ScaleChannels(-4),           # 11-12
        Conv(3 * 9, 1, bn=False, act="linear"),                   # 13
        YoloHead((0, 1, 2)),                                      # 14 /4
    ),
    anchors=ANCHORS, class_names=NAMES, input_size=64)

# a classic and a Gaussian head on one trunk, rectangular
GAUSS_MIXED = ModelConfig(
    name="gauss-mixed",
    layers=(
        Conv(16, stride=2), Conv(32, stride=2),                   # 0-1 /4
        Conv(32, stride=2),                                       # 2 /8
        Conv(2 * 13, 1, bn=False, act="linear"),
        YoloHead((2, 3), gaussian=True),                          # 3-4 /8
        Route((-3,)), Upsample(2), Route((-1, 1)),                # 5-7 /4
        Conv(2 * 9, 1, bn=False, act="linear"), YoloHead((0, 1)),  # 8-9
    ),
    anchors=ANCHORS[:4], class_names=NAMES, input_size=96, input_width=64)


def _rect(tmp_path):
    return _cfg_text(tmp_path, RECT_YOLO_CFG, "rect")


def _gauss(tmp_path):
    return _cfg_text(tmp_path, GAUSS_CFG, "gauss")


def _composite(tmp_path):
    return _cfg_text(tmp_path, COMPOSITE_CFG, "composite")


CONFIGS = {
    "csp-swish": lambda tmp: SCALED_SWISH,
    "every-option": lambda tmp: EVERY_OPTION,
    "gauss-mixed": lambda tmp: GAUSS_MIXED,
    "rect-192x128": _rect,
    "gauss-cfg": _gauss,
    "composite-cfg": _composite,
}


def _random_blends(cfg, params, rng):
    """Non-trivial shortcut blend weights (random_params gives darknet's
    ones)."""
    for spec, p in zip(dw.weighted_specs(cfg.layers), params):
        if isinstance(spec, Shortcut):
            p["weights"] = rng.normal(1, 0.5, p["weights"].shape).astype(
                np.float32)
    return params


# --- layer stacks -----------------------------------------------------------------

WS = Shortcut  # brevity in the table below
LAYER_STACKS = {
    "grouped": (Conv(8), Conv(16, groups=2), Conv(16, 1, groups=4)),
    "depthwise": (Conv(8), Conv(8, groups=8), Conv(8, 1)),
    "dilated": (Conv(8), Conv(8, dilation=2), Conv(8, dilation=3, groups=2)),
    "dilated_strided": (Conv(8), Conv(8, stride=2, dilation=2)),
    "logistic": (Conv(8, act="logistic"), Conv(8, 1, act="logistic")),
    "swish": (Conv(8, act="swish"), Conv(8, 1, act="swish")),
    "relu": (Conv(8, act="relu"), Conv(8, 1, act="relu")),
    "ramp": (Conv(8, act="ramp"), Conv(8, 1, act="ramp")),
    "wsc_feature": (Conv(8), Conv(8), WS(-2, weights_type="per_feature")),
    "wsc_feature_relu": (Conv(8), Conv(8), WS(-2, weights_type="per_feature",
                                              weights_norm="relu")),
    "wsc_feature_softmax": (Conv(8), Conv(8), WS(
        -2, weights_type="per_feature", weights_norm="softmax")),
    "wsc_channel": (Conv(8), Conv(8), WS(-2, weights_type="per_channel")),
    "wsc_channel_relu": (Conv(8), Conv(8), WS(
        -2, weights_type="per_channel", weights_norm="relu")),
    "wsc_channel_softmax_leaky": (Conv(8), Conv(8), WS(
        -2, act="leaky", weights_type="per_channel",
        weights_norm="softmax")),
    "wsc_channel_wider_input": (Conv(8), Conv(12), WS(
        -2, weights_type="per_channel", weights_norm="softmax")),
    "wsc_channel_narrower_input": (Conv(12), Conv(8), WS(
        -2, weights_type="per_channel")),
    "wsc_feature_wider_input": (Conv(8), Conv(12), WS(
        -2, weights_type="per_feature", weights_norm="relu")),
    "sam": (Conv(8), Conv(8, act="logistic"), Sam(-2)),
    "sam_leaky": (Conv(8), Conv(8), Sam(-2, act="leaky")),
    "se_block": (Conv(8), AvgPool(), Conv(4, 1, act="relu"),
                 Conv(8, 1, act="logistic"), ScaleChannels(-4)),
    "scale_wh": (Conv(8), Conv(1, 1, act="logistic"),
                 ScaleChannels(-2, scale_wh=1)),
    "scale_channels_logistic": (Conv(8), AvgPool(), ScaleChannels(
        -2, act="logistic")),
    "avgpool": (Conv(8), AvgPool(), Conv(4, 1)),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("stack", sorted(LAYER_STACKS))
def test_layer_stack_matches_jax(stack, dtype):
    layers = LAYER_STACKS[stack]
    rng = np.random.default_rng(17)
    cfg = ModelConfig(name=stack, layers=layers, anchors=ANCHORS[:1],
                      class_names=("a",), input_size=32)
    params = _random_blends(cfg, dw.random_params(layers, rng, scale=0.3),
                            rng)
    folded = tgraph.fold_params(layers, params)
    x = rng.uniform(-1, 1, (2, 16, 12, 3)).astype(np.float32)
    got, want = _both(cfg, folded, x, dtype)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        scale = float(np.abs(w).max())
        if dtype == "fp32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale)
        else:
            assert (g == w).mean() >= 0.99
            assert np.abs(g - w).max() <= 2 * _bf16_ulp(scale)


# --- whole executors ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_executor_matches_jax(name, dtype, tmp_path):
    cfg = CONFIGS[name](tmp_path)
    rng = np.random.default_rng(8)
    folded = tgraph.fold_params(cfg.layers, _random_blends(
        cfg, dw.random_params(cfg.layers, rng, scale=0.1), rng), cfg.bn_eps)
    x = np.random.default_rng(2).uniform(
        0, 1, (2, *cfg.input_hw, 3)).astype(np.float32)
    got, want = _both(cfg, folded, x, dtype)
    assert len(got) == len(cfg.yolo_heads)
    strides = layer_strides(cfg.layers)
    for g, w, (idx, l) in zip(got, want, [(i, l) for i, l in enumerate(
            cfg.layers) if isinstance(l, YoloHead)]):
        per = (9 if l.gaussian else 5) + cfg.num_classes
        assert g.shape == (2, cfg.input_h // strides[idx],
                           cfg.input_w // strides[idx], len(l.mask) * per)
        scale = float(np.abs(w).max())
        if dtype == "fp32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale)
        else:
            assert np.abs(g - w).max() <= 2 * _bf16_ulp(scale)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_detector_matches_jax(name, dtype, tmp_path):
    """detect_raw on raw uint8 frames against JAX's on the same .weights
    bytes (seeded detector weights: heads calibrated before the
    logistic, Gaussian sigmas small), both fused heads."""
    cfg = dataclasses.replace(CONFIGS[name](tmp_path), conf_threshold=0.3)
    path = str(tmp_path / "w.weights")
    dw.save(path, cfg.layers, dw.synthetic_detector_params(cfg, 0))
    imgs = np.random.default_rng(1).integers(0, 256, (2, 90, 130, 3),
                                             dtype=np.uint8)
    jcfg = to_jax_config(cfg)
    jparams, _ = jdw.load(path, jcfg.layers)
    jparams = jgraph.params_to_jax(jgraph.fold_params(jcfg.layers, jparams,
                                                      jcfg.bn_eps))
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    want = jpredict.make_detector(jcfg, compute_dtype=jdt, head="fused")(
        jparams, jnp.asarray(imgs))
    want = {k: np.asarray(v) for k, v in want.items()}
    params, _ = dw.load(path, cfg.layers)
    net = tgraph.Darknet(cfg.layers,
                         tgraph.fold_params(cfg.layers, params, cfg.bn_eps),
                         device="cpu", dtype={"fp32": torch.float32,
                                              "bf16": torch.bfloat16}[dtype])
    got = tpredict.detect_raw(cfg, net, torch.from_numpy(imgs), head="fused")
    got = {k: v.numpy() for k, v in got.items()}
    assert want["valid"].sum() >= 2
    if dtype == "fp32":
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


@pytest.mark.parametrize("name", ["csp-swish", "rect-192x128", "gauss-mixed"])
def test_entry_fused_refuses_as_jax(name, tmp_path):
    """entry="fused" raises on these nets, as the JAX package's does
    (rectangular nets; a first layer that is not conv 3x3 leaky +
    maxpool 2x2)."""
    cfg = CONFIGS[name](tmp_path)
    params = dw.random_params(cfg.layers, np.random.default_rng(0))
    net = tgraph.Darknet(cfg.layers, tgraph.fold_params(cfg.layers, params),
                         device="cpu")
    imgs = torch.zeros((1, 40, 50, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="entry='fused'"):
        tpredict.detect_raw(cfg, net, imgs, entry="fused")
    jcfg = to_jax_config(cfg)
    with pytest.raises(ValueError, match="entry='fused'"):
        jpredict.detect_raw(jcfg, jgraph.params_to_jax(jgraph.fold_params(
            jcfg.layers, params)), jnp.asarray(imgs.numpy()), entry="fused")


# --- decode and heads ---------------------------------------------------------------

def _head_logits(seed, cfg, b=2):
    """Seeded head logits for cfg's heads at its (net_h, net_w): classic
    heads raw, new_coords heads logistic-activated (conf low for most
    boxes), Gaussian heads 9+C with small sigmas."""
    rng = np.random.default_rng(seed)
    strides = layer_strides(cfg.layers)
    c = cfg.num_classes
    out = []
    for idx, l in enumerate(cfg.layers):
        if not isinstance(l, YoloHead):
            continue
        gh, gw = cfg.input_h // strides[idx], cfg.input_w // strides[idx]
        a = len(l.mask)
        if l.gaussian:
            t = rng.normal(0, 1, (b, gh, gw, a, 9 + c))
            t[..., [4, 6]] *= 0.3
            t[..., [1, 3, 5, 7]] = rng.normal(-3, 1, (b, gh, gw, a, 4))
            t[..., 8] = rng.normal(-4, 2.5, t.shape[:-1])
            t[..., 9:] -= 1.5
        else:
            t = rng.normal(0, 1, (b, gh, gw, a, 5 + c))
            t[..., 2:4] *= 0.3
            t[..., 4] = rng.normal(-4, 2.5, t.shape[:-1])
            t[..., 5:] -= 1.5
            if l.new_coords:
                t = 1.0 / (1.0 + np.exp(-t))
        out.append(t.reshape(b, gh, gw, -1).astype(np.float32))
    return out


def _flags(cfg):
    heads = cfg.yolo_heads
    return dict(scales=[h.scale_xy for h in heads],
                new_coords=[h.new_coords for h in heads],
                gaussian=[h.gaussian for h in heads])


MIXED_NC = dataclasses.replace(SCALED_SWISH, name="mixed-nc", layers=(
    SCALED_SWISH.layers[:12]
    + (Conv(2 * 9, 1, bn=False, act="linear"), YoloHead((4, 5),
                                                        scale_xy=1.05))))
HEAD_CONFIGS = {"csp-swish": SCALED_SWISH, "gauss-mixed": GAUSS_MIXED,
                "mixed-new-coords": MIXED_NC}


@pytest.mark.parametrize("name", sorted(HEAD_CONFIGS))
def test_decode_yolo_matches_jax(name):
    cfg = HEAD_CONFIGS[name]
    heads = _head_logits(0, cfg)
    masks = [h.mask for h in cfg.yolo_heads]
    boxes, scores = tdecode.decode_yolo(
        [torch.from_numpy(h) for h in heads], cfg.anchors, masks,
        cfg.num_classes, cfg.input_hw, **_flags(cfg))
    jboxes, jscores = jdecode.decode_yolo(
        [jnp.asarray(h) for h in heads], cfg.anchors, masks,
        cfg.num_classes, cfg.input_hw, **_flags(cfg))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("conf", [0.25, 0.5, 0.005])
@pytest.mark.parametrize("name", sorted(HEAD_CONFIGS))
def test_yolo_heads_match_jax(name, conf):
    """The fused head against JAX's detect_head_yolo (plain suppression)
    and the reference head (decode_yolo + nms_batch) against JAX's, on
    the same logits."""
    from yolo_tpu.ops import nms as jnms
    from yolo_tpu_torch.ops import nms as tnms

    cfg = HEAD_CONFIGS[name]
    heads = _head_logits(1, cfg)
    masks = [h.mask for h in cfg.yolo_heads]
    pre = 128 if conf >= 0.3 else 256
    got = thead.detect_head_yolo(
        [torch.from_numpy(h) for h in heads], cfg.anchors, masks,
        cfg.num_classes, cfg.input_hw, conf_threshold=conf,
        iou_threshold=0.45, pre_top_k=pre, use_kernel=False, **_flags(cfg))
    want = jhead.detect_head_yolo(
        [jnp.asarray(h) for h in heads], cfg.anchors, masks,
        cfg.num_classes, cfg.input_hw, conf_threshold=conf,
        iou_threshold=0.45, pre_top_k=pre, use_pallas=False, **_flags(cfg))
    n_fused = _assert_same_detections(got, want)
    boxes, scores = tdecode.decode_yolo(
        [torch.from_numpy(h) for h in heads], cfg.anchors, masks,
        cfg.num_classes, cfg.input_hw, **_flags(cfg))
    jboxes, jscores = jdecode.decode_yolo(
        [jnp.asarray(h) for h in heads], cfg.anchors, masks,
        cfg.num_classes, cfg.input_hw, **_flags(cfg))
    got = tnms.nms_batch(boxes, scores, conf_threshold=conf,
                         iou_threshold=0.45, impl="torch")
    want = jnms.nms_batch(jboxes, jscores, conf_threshold=conf,
                          iou_threshold=0.45, impl="xla")
    n_ref = _assert_same_detections(got, want)
    assert n_fused > 0 and n_ref > 0


def test_mixed_head_exp_overflow_does_not_reach_new_coords_boxes():
    """A classic head whose wh logits overflow exp: the new_coords boxes
    beside it stay finite (per-box select, as JAX's jnp.where)."""
    cfg = MIXED_NC
    heads = _head_logits(2, cfg)
    b, gh, gw, _ = heads[1].shape
    classic = heads[1].reshape(b, gh, gw, 2, 9)
    classic[..., 2:4] = 200.0
    classic[..., 4] = -30.0
    heads[0].reshape(b, heads[0].shape[1], heads[0].shape[2], 2, 9)[
        ..., 4][0, 0, 0, 0] = 0.99
    out = thead.detect_head_yolo(
        [torch.from_numpy(h) for h in heads], cfg.anchors,
        [h.mask for h in cfg.yolo_heads], cfg.num_classes, cfg.input_hw,
        conf_threshold=0.25, iou_threshold=0.45, use_kernel=False,
        **_flags(cfg))
    v = out["valid"].numpy()
    assert v.sum() >= 1
    assert np.isfinite(out["boxes"].numpy()[v]).all()


# --- the conv kernel's route ---------------------------------------------------------

# convs with CIN and CO multiples of 128: leaky 3x3 (taken), linear 1x1
# (taken), swish, grouped and dilated (kept off, as the JAX route does)
GATE = ModelConfig(
    name="gate",
    layers=(Conv(128, stride=4), Conv(128), Conv(128, 1, act="linear"),
            Conv(128, act="swish"), Conv(128, groups=2),
            Conv(128, dilation=2), Conv(128, 1, act="relu"),
            Conv(128, 1), Conv(2 * 9, 1, bn=False, act="logistic"),
            YoloHead((0, 1), scale_xy=2.0, new_coords=True)),
    anchors=ANCHORS[:2], class_names=NAMES, input_size=32, input_width=64)


def test_conv_route_gate_matches_jax_pallas_route(monkeypatch):
    """conv_impl="cuda" sends exactly the convs JAX's conv_impl="pallas"
    route (Pallas in interpret mode) sends to its kernel, shape by shape:
    leaky/linear, groups 1, dilation 1, stride 1, CIN and CO multiples
    of 128; the outputs agree in fp32."""
    from yolo_tpu.ops.pallas import conv_kernel as jck

    cfg = GATE
    folded = tgraph.fold_params(cfg.layers, dw.random_params(
        cfg.layers, np.random.default_rng(4), scale=0.05))
    x = np.random.default_rng(4).uniform(0, 1, (1, 32, 64, 3)).astype(
        np.float32)
    jax_calls, port_calls = [], []
    jfn = jck.fused_conv_bias_act

    def jcount(x, kernel, bias, *, act="leaky", interpret=False):
        jax_calls.append((tuple(kernel.shape), act))
        return jfn(x, kernel, bias, act=act, interpret=True)

    monkeypatch.setattr(jck, "fused_conv_bias_act", jcount)
    want = jgraph.apply_layers(to_jax_config(cfg).layers,
                               jgraph.params_to_jax(folded), jnp.asarray(x),
                               eps=cfg.bn_eps, conv_impl="pallas")
    tfn = tgraph.conv_kernel.fused_conv_bias_act

    def tcount(x, kernel, bias, *, act="leaky"):
        port_calls.append((tuple(kernel.permute(2, 3, 1, 0).shape), act))
        return tfn(x, kernel, bias, act=act)

    monkeypatch.setattr(tgraph.conv_kernel, "fused_conv_bias_act", tcount)
    net = tgraph.Darknet(cfg.layers, folded, device="cpu")
    got = net(torch.from_numpy(x), conv_impl="cuda")
    assert port_calls == jax_calls
    assert [a for _, a in port_calls] == ["leaky", "linear", "leaky"]
    assert sum(net.kernel_eligible) == 3
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


# --- weights -----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["every-option", "gauss-mixed",
                                  "csp-swish"])
def test_weights_round_trip_matches_jax_bytes(name, tmp_path):
    """Grouped kernels (oc, ic/g, k, k), weighted shortcuts' blend
    weights and Gaussian heads' 9+C channels: random_params draws as the
    JAX package's, save writes its bytes, load reads back its params;
    expected_bytes is its size."""
    from yolo_tpu.io import zoo as jzoo

    cfg = CONFIGS[name](tmp_path)
    jcfg = to_jax_config(cfg)
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    params = _random_blends(cfg, dw.random_params(cfg.layers, rng), rng)
    jparams = _random_blends(cfg, jdw.random_params(jcfg.layers, jrng), jrng)
    path = str(tmp_path / "w.weights")
    dw.save(path, cfg.layers, params, seen=5)
    with open(path, "rb") as f:
        data = f.read()
    assert data == jdw.to_bytes(jcfg.layers, jparams, seen=5)
    assert len(data) == dw.expected_bytes(cfg.layers) == \
        jzoo.expected_weights_bytes(jcfg.layers)
    got, header = dw.load(path, cfg.layers)
    want, jheader = jdw.load(path, jcfg.layers)
    assert header == jheader
    for p, q in zip(got, want, strict=True):
        assert set(p) == set(q)
        for key in p:
            np.testing.assert_array_equal(p[key], q[key])
    blends = [p for p in dw.random_params(cfg.layers,
                                          np.random.default_rng(0))
              if "weights" in p]
    assert all((p["weights"] == 1).all() for p in blends)


def test_grouped_conv_must_divide_channels():
    layers = (Conv(6), Conv(8, groups=4))
    with pytest.raises(ValueError, match="groups=4 must divide"):
        dw.random_params(layers, np.random.default_rng(0))
    with pytest.raises(ValueError, match="groups=4 must divide"):
        jdw.random_params(to_jax_config(ModelConfig(
            "g", layers, (), ("a",))).layers, np.random.default_rng(0))


@pytest.mark.parametrize("name", ["csp-swish", "gauss-mixed", "every-option"])
def test_seeded_detector_weights_keep_a_few_boxes(name, tmp_path):
    """synthetic_detector_params calibrates every head kind before its
    activation: on a seeded noise frame the detector keeps a few
    detections an image, far fewer than the fused head's K."""
    cfg = dataclasses.replace(CONFIGS[name](tmp_path), conf_threshold=0.5)
    folded = tgraph.fold_params(cfg.layers,
                                dw.synthetic_detector_params(cfg, 0))
    net = tgraph.Darknet(cfg.layers, folded, device="cpu")
    imgs = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (2, 96, 128, 3), dtype=np.uint8))
    n = tpredict.detect_raw(cfg, net, imgs)["valid"].sum(dim=1)
    assert bool((n >= 1).all()) and bool((n <= 100).all()), n


# --- losses ---------------------------------------------------------------------------

def _targets(cfg, seed, b=2):
    rng = np.random.default_rng(seed)
    boxes, classes = [], []
    for _ in range(b):
        k = int(rng.integers(2, 5))
        wh = rng.uniform(0.1, 0.5, (k, 2))
        xy = rng.uniform(0.3, 0.7, (k, 2))
        boxes.append(np.concatenate([xy - wh / 2, xy + wh / 2], 1).clip(0, 1)
                     .astype(np.float32))
        classes.append(rng.integers(0, cfg.num_classes, k).astype(np.int32))
    return jtgt.encode_batch_for(to_jax_config(cfg), boxes, classes)


LOSS_CASES = {
    "new_coords_ciou": (SCALED_SWISH, dict(iou_loss="ciou",
                                           iou_normalizer=0.07)),
    "new_coords_giou_split": (SCALED_SWISH, dict(iou_loss="giou",
                                                 obj_normalizer=0.8,
                                                 cls_normalizer=0.5)),
    "new_coords_truth_thresh": (SCALED_SWISH, dict(
        iou_loss="diou", truth_thresh=0.05, ignore_thresh=0.9)),
    "gaussian_mixed": (GAUSS_MIXED, dict()),
    "gaussian_mixed_smooth": (GAUSS_MIXED, dict(label_smooth_eps=0.1,
                                                max_delta=0.005)),
    "mixed_new_coords": (MIXED_NC, dict(iou_loss="ciou")),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_yolo_loss_and_gradient_match_jax(case):
    cfg, ckw = LOSS_CASES[case]
    heads = _head_logits(sum(map(ord, case)) % 1000, cfg)
    targets = _targets(cfg, 5)
    masks = [h.mask for h in cfg.yolo_heads]
    kw = _flags(cfg)
    jcfg = jloss.YoloLossConfig(**ckw)
    tj = {k: jnp.asarray(v) for k, v in targets.items()}

    def jf(hs):
        return jloss.yolo_loss(hs, tj, cfg.anchors, masks, cfg.num_classes,
                               cfg.input_hw, jcfg, **kw)

    (jtotal, jparts), jgrads = jax.value_and_grad(jf, has_aux=True)(
        tuple(jnp.asarray(h) for h in heads))
    th = [torch.from_numpy(h).requires_grad_() for h in heads]
    total, parts = tloss.yolo_loss(
        th, {k: torch.from_numpy(v) for k, v in targets.items()},
        cfg.anchors, masks, cfg.num_classes, cfg.input_hw,
        tloss.YoloLossConfig(**ckw), **kw)
    total.backward()
    assert set(parts) == set(jparts)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for k in parts:
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]),
                                   rtol=1e-5, atol=1e-7)
    for g, w in zip(th, jgrads, strict=True):
        _scale_close(g.grad.numpy(), np.asarray(w), 1e-4)
    assert parts["coord"].item() != 0.0


def test_gaussian_nll_matches_jax():
    rng = np.random.default_rng(0)
    t, mu = rng.normal(0, 1, (2, 50)).astype(np.float32)
    sigma = np.concatenate([rng.uniform(1e-6, 1, 49), [0.0]]).astype(
        np.float32)
    got = tloss.gaussian_nll(torch.from_numpy(t), torch.from_numpy(mu),
                             torch.from_numpy(sigma))
    want = jloss.gaussian_nll(jnp.asarray(t), jnp.asarray(mu),
                              jnp.asarray(sigma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("case", [
    ("mse_new_coords", SCALED_SWISH, dict()),
    ("focal_new_coords", SCALED_SWISH, dict(iou_loss="ciou",
                                            focal_loss=True)),
    ("truth_thresh_gaussian", GAUSS_MIXED, dict(truth_thresh=0.5)),
    ("gaussian_and_new_coords", None, dict(iou_loss="ciou"))],
    ids=lambda c: c[0])
def test_yolo_loss_refuses_as_jax(case):
    """JAX's refusals: new_coords needs an iou-family loss and takes no
    focal loss; Gaussian heads take no truth_thresh and do not mix with
    new_coords heads."""
    _, cfg, ckw = case
    if cfg is None:
        cfg = GAUSS_MIXED
        flags = dict(new_coords=[False, True], gaussian=[True, False])
    else:
        flags = _flags(cfg)
        flags.pop("scales")
    heads = _head_logits(0, cfg)
    targets = _targets(cfg, 1)
    masks = [h.mask for h in cfg.yolo_heads]
    with pytest.raises(NotImplementedError):
        jloss.yolo_loss([jnp.asarray(h) for h in heads],
                        {k: jnp.asarray(v) for k, v in targets.items()},
                        cfg.anchors, masks, cfg.num_classes, cfg.input_hw,
                        jloss.YoloLossConfig(**ckw), **flags)
    with pytest.raises(NotImplementedError):
        tloss.yolo_loss([torch.from_numpy(h) for h in heads],
                        {k: torch.from_numpy(v) for k, v in targets.items()},
                        cfg.anchors, masks, cfg.num_classes, cfg.input_hw,
                        tloss.YoloLossConfig(**ckw), **flags)


def _train_params(cfg, seed):
    params = dw.random_params(cfg.layers, np.random.default_rng(seed))
    for p in params:
        if "kernel" in p:
            k = p["kernel"]
            p["kernel"] = (k * (np.sqrt(2.0 / np.prod(k.shape[:3])) / 0.1)) \
                .astype(np.float32)
    return _random_blends(cfg, params, np.random.default_rng(seed))


def _batch(cfg, seed, b=4):
    enc = _targets(cfg, seed, b)
    enc["images"] = np.random.default_rng(seed).uniform(
        0, 1, (b, *cfg.input_hw, 3)).astype(np.float32)
    return enc


TRAIN_CONFIGS = {"csp-swish": SCALED_SWISH, "every-option": EVERY_OPTION,
                 "gauss-mixed": GAUSS_MIXED}


@pytest.mark.parametrize("name", sorted(TRAIN_CONFIGS))
def test_train_forward_matches_jax(name):
    """DarknetTrain (batch-statistics BN, grouped / dilated convs, the
    new activations, weighted shortcuts, sam, SE blocks) in fp32: head
    logits and the new rolling statistics."""
    cfg = TRAIN_CONFIGS[name]
    params = _train_params(cfg, 0)
    x = _batch(cfg, 3)["images"]
    jlogits, jstats = jgraph.apply_layers(
        to_jax_config(cfg).layers, jgraph.params_to_jax(params),
        jnp.asarray(x), eps=cfg.bn_eps, train=True)
    net = tgraph.DarknetTrain(cfg.layers, params, device="cpu")
    with torch.no_grad():
        logits, stats = net(torch.from_numpy(x))
    assert set(stats) == set(jstats)
    for g, w in zip(logits, jlogits, strict=True):
        _scale_close(g.numpy(), np.asarray(w), 1e-5)
    for i in stats:
        for k in ("mean", "var"):
            _scale_close(stats[i][k].numpy(), np.asarray(jstats[i][k]), 1e-5)


@pytest.mark.parametrize("name", sorted(TRAIN_CONFIGS))
def test_train_steps_match_jax(name):
    """Three SGD steps (momentum, decay on kernels and blend weights,
    burn-in ramp) through train_step against JAX's: the new_coords ciou
    loss, the Gaussian NLL and the weighted shortcuts' blend weights
    train alike."""
    cfg = TRAIN_CONFIGS[name]
    jcfg = to_jax_config(cfg)
    params = _train_params(cfg, 1)
    kw = dict(learning_rate=1e-3, momentum=0.9, weight_decay=5e-4,
              burn_in_steps=2)
    ycfg = tloss.yolo_loss_config(cfg)
    jtcfg = jloop.TrainConfig(**kw, yolo_loss=jloss.YoloLossConfig(
        **dataclasses.asdict(ycfg)))
    jstate = jloop.init_state(params, jtcfg)
    jstep = jloop.make_train_step(jcfg, jtcfg)
    tcfg = tloop.TrainConfig(**kw, yolo_loss=ycfg)
    state = tloop.init_state(cfg, params, tcfg, device="cpu")
    step = tloop.make_train_step(cfg, tcfg)
    for i in range(3):
        batch = _batch(cfg, 100 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-7)
        for p, q in zip(state.net.to_numpy(), jstate["params"],
                        strict=True):
            assert set(p) == set(q)
            for key in p:
                frac = 1e-6 if key in ("mean", "var") else 1e-5
                _scale_close(p[key], np.asarray(q[key]), frac)
    moved = [np.abs(p["weights"] - q["weights"]).max()
             for p, q in zip(state.net.to_numpy(), params) if "weights" in p]
    assert all(d > 0 for d in moved)


def test_decay_mask_matches_jax():
    """Darknet decays kernels and shortcut blend weights, never biases or
    BN terms: the optimizer's decayed group is JAX's mask."""
    cfg = EVERY_OPTION
    params = _train_params(cfg, 0)
    net = tgraph.DarknetTrain(cfg.layers, params, device="cpu")
    decay, rest = tloop._kernel_mask(net)
    mask = jloop._kernel_mask(params)
    want_decay = sum(v for m in mask for v in m.values())
    assert len(decay) == want_decay
    assert len(rest) == sum(len(m) for m in mask) - want_decay \
        - 2 * sum("mean" in m for m in mask)   # BN statistics: buffers
    ids = {id(p) for p in decay}
    for block, m in zip(net.blocks, mask, strict=True):
        for name, p in block.named_parameters(recurse=False):
            assert (id(p) in ids) == m[name], name


# --- rectangular nets: the data pipeline and the server ------------------------------

@pytest.mark.parametrize("name", ["rect-192x128", "gauss-mixed"])
def test_rect_train_batches_encode_as_jax(name, tmp_path):
    """train_batches at a rectangular (net_h, net_w) with the model's
    head kind, jitter and flip on, against JAX's: images within 1e-5,
    targets exactly equal (grids (h/s, w/s), wh at net_w and net_h)."""
    from yolo_tpu.data import augment as jaug
    from yolo_tpu.data import pipeline as jpipe
    from yolo_tpu_torch.data import augment as taug
    from yolo_tpu_torch.data import pipeline as tpipe
    from yolo_tpu_torch.data.synthetic import write_voc_scenes

    from yolo_tpu_torch.configs import VOC_NAMES

    pairs = write_voc_scenes(str(tmp_path), [(75, 100), (100, 67),
                                             (96, 128)] * 2,
                             np.random.default_rng(9))
    cfg = CONFIGS[name](tmp_path)
    # 20-class heads: the synthetic scenes carry VOC classes
    cfg = dataclasses.replace(cfg, layers=_with_classes(cfg, 20),
                              class_names=VOC_NAMES)
    kw = dict(class_names=VOC_NAMES, anchors=cfg.anchors, num_classes=20,
              net_size=cfg.input_hw, batch_size=3, workers=2)
    aug = dict(jitter=0.3, hue=0.0, saturation=1.0, exposure=1.0,
               flip=True)
    got = list(tpipe.train_batches(
        pairs, rng=np.random.default_rng(1), model_cfg=cfg,
        augment_cfg=taug.AugmentConfig(**aug), **kw))
    want = list(jpipe.train_batches(
        pairs, rng=np.random.default_rng(1), model_cfg=to_jax_config(cfg),
        augment_cfg=jaug.AugmentConfig(**aug), **kw))
    assert len(got) == len(want) == 2
    assert got[0]["images"].shape == (3, *cfg.input_hw, 3)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if k == "images":
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _with_classes(cfg, c):
    """cfg's layers with every head conv sized for c classes."""
    layers = list(cfg.layers)
    for i, l in enumerate(layers):
        if isinstance(l, YoloHead):
            per = (9 if l.gaussian else 5) + c
            layers[i - 1] = dataclasses.replace(layers[i - 1],
                                                filters=len(l.mask) * per)
    return tuple(layers)


def test_server_answers_a_rect_new_coords_model_like_direct_calls(tmp_path):
    """A DetectionServer for the csp-swish net at 96x64 letterboxes each
    frame at (net_h, net_w) as a direct call does."""
    import http.client
    import io
    import json

    import yolo_tpu_torch
    from yolo_tpu_torch.configs.darknet_cfg import cfg_to_string
    from yolo_tpu_torch.serve import DetectionServer, detections_to_json

    cfg = dataclasses.replace(SCALED_SWISH, conf_threshold=0.3)
    path = tmp_path / "s.cfg"
    path.write_text(cfg_to_string(cfg))
    wpath = str(tmp_path / "s.weights")
    dw.save(wpath, cfg.layers, dw.synthetic_detector_params(cfg, 0))
    model = yolo_tpu_torch.load(wpath, cfg=str(path), device="cpu",
                                precision="fp32", conf_threshold=0.3)
    frames = np.random.default_rng(4).integers(0, 256, (2, 70, 110, 3),
                                               dtype=np.uint8)
    server = DetectionServer(model.cfg, model.params, port=0, max_batch=4,
                             conf_threshold=0.3)
    server.start()
    try:
        answers = []
        for img in frames:
            buf = io.BytesIO()
            np.save(buf, img)
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=120)
            conn.request("POST", "/detect", body=buf.getvalue(),
                         headers={"Content-Type": "application/x-npy"})
            answers.append(json.loads(conn.getresponse().read())
                           ["detections"])
            conn.close()
    finally:
        server.stop()
    names = model.cfg.detection_names()
    direct = [detections_to_json(model(frames[i:i + 1]), names)[0]
              for i in range(len(frames))]
    assert answers == direct
    assert sum(len(d) for d in direct) > 0
