"""yolo_tpu_torch.models.graph, configs and io.darknet_weights against
the JAX package on the CPU.

Configs are compared field for field and weights files byte for byte.
fold_params is numpy in both packages and must agree bit for bit.

Logits in fp32 are compared at rtol 1e-4 / atol 1e-4 * max|logit|: both
stacks run fp32 convs, but oneDNN and XLA sum the products in different
orders, and the deviations grow through the 9-23 layers of a net.

In bf16 both packages round activations and kernels to bf16, sum the
products in fp32 and apply bias and leaky to the fp32 sum. One conv
block is then bit-identical (measured: every element equal, 3 seeds);
the test allows 1% of elements one bf16 ulp off, for a CPU whose conv
sums in yet another order. Whole nets are compared at 2 bf16 ulps of
the logits' scale, ulp = 2^(floor(log2 max|logit|) - 7): measured 0 on
the narrow yolov2 and 0.5-1 on tiny-voc-96, over seeds 0-2. A conv that
rounded its output to bf16 before the bias (F.conv2d in bf16) matched
only ~71% of one block's elements, and drifted 1-2 ulps on those nets.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port import to_jax_config
from yolo_tpu.configs import get_variant as jax_get_variant
from yolo_tpu.configs import specs as jspecs
from yolo_tpu.io import darknet_weights as jdw
from yolo_tpu.io import zoo as jzoo
from yolo_tpu.models import graph as jgraph
from yolo_tpu_torch.configs import (VARIANTS, Conv, MaxPool, Reorg, Route,
                                    Shortcut, get_variant, specs)
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import graph as tgraph
from yolo_tpu_torch.ops.precision import no_tf32

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
GOLDEN_SEED = 20260816  # tests/test_golden_e2e.py::SEED


def _assert_logits_close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def _bf16_ulp(x):
    """bf16 ulp (7 stored mantissa bits) at the magnitude of x."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_matches_jax_config(variant):
    cfg = get_variant(variant)
    assert to_jax_config(cfg) == jax_get_variant(variant)
    assert to_jax_config(get_variant(variant, input_size=160)) == \
        jax_get_variant(variant, input_size=160)


def test_unported_variant_raises():
    """An unknown variant raises KeyError naming the ported ones; the
    darknet classifiers (ROADMAP A10, once unported) are built-in
    variants now, equal to the JAX package's."""
    with pytest.raises(KeyError, match="darknet53"):
        get_variant("darknet54")
    assert to_jax_config(get_variant("darknet53")) == \
        jax_get_variant("darknet53")


@pytest.mark.parametrize("variant", ["tiny-voc", "coco"])
def test_weights_io_matches_jax(tmp_path, variant):
    """random_params draws the same params from the same generator; save
    writes the same bytes; load reads both packages' files alike."""
    cfg = get_variant(variant)
    jcfg = to_jax_config(cfg)
    params = dw.random_params(cfg.layers, np.random.default_rng(5))
    jparams = jdw.random_params(jcfg.layers, np.random.default_rng(5))
    for p, q in zip(params, jparams, strict=True):
        assert set(p) == set(q)
        for key in p:
            np.testing.assert_array_equal(p[key], q[key])
    path = str(tmp_path / "w.weights")
    dw.save(path, cfg.layers, params, seen=7)
    with open(path, "rb") as f:
        data = f.read()
    assert data == jdw.to_bytes(jcfg.layers, jparams, seen=7)
    assert len(data) == dw.expected_bytes(cfg.layers) == \
        jzoo.expected_weights_bytes(jcfg.layers)
    got, header = dw.load(path, cfg.layers)
    want, jheader = jdw.load(path, jcfg.layers)
    assert header == jheader and header["seen"] == 7
    for p, q in zip(got, want, strict=True):
        for key in p:
            np.testing.assert_array_equal(p[key], q[key])


def test_weights_load_rejects_a_file_of_another_topology(tmp_path):
    cfg = get_variant("tiny-voc")
    path = str(tmp_path / "w.weights")
    dw.save(path, cfg.layers,
            dw.random_params(cfg.layers, np.random.default_rng(0)))
    with pytest.raises(ValueError, match="too short"):
        dw.load(path, get_variant("coco").layers)
    with pytest.raises(ValueError, match="not fully consumed"):
        dw.load(path, cfg.layers[:-1])


@pytest.mark.parametrize("variant", ["tiny-voc", "coco"])
def test_fold_params_bit_identical(variant):
    cfg = get_variant(variant)
    params = dw.random_params(cfg.layers, np.random.default_rng(0))
    got = tgraph.fold_params(cfg.layers, params, cfg.bn_eps)
    want = jgraph.fold_params(to_jax_config(cfg).layers, params, cfg.bn_eps)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


def test_fold_params_rejects_wrong_topology():
    cfg = get_variant("tiny-voc")
    params = dw.random_params(cfg.layers, np.random.default_rng(0))
    with pytest.raises(ValueError, match="param blocks"):
        tgraph.fold_params(cfg.layers, params[:-1], cfg.bn_eps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_params_from_numpy_round_trip(dtype):
    cfg = get_variant("tiny-voc", input_size=64)
    folded = tgraph.fold_params(
        cfg.layers, dw.random_params(cfg.layers, np.random.default_rng(1)),
        cfg.bn_eps)
    tparams = tgraph.params_from_numpy(cfg.layers, folded, "cpu", dtype)
    for p, t in zip(folded, tparams):
        assert t["kernel"].dtype == dtype and t["bias"].dtype == torch.float32
        assert t["kernel"].is_contiguous(memory_format=torch.channels_last)
        back = t["kernel"].float().permute(2, 3, 1, 0).numpy()  # OIHW->HWIO
        want = torch.from_numpy(p["kernel"]).to(dtype).float().numpy()
        np.testing.assert_array_equal(back, want)
        np.testing.assert_array_equal(t["bias"].numpy(), p["bias"])


def test_params_from_numpy_rejects_unfolded():
    cfg = get_variant("tiny-voc")
    params = dw.random_params(cfg.layers, np.random.default_rng(0))
    with pytest.raises(ValueError, match="fold_params"):
        tgraph.params_from_numpy(cfg.layers, params, "cpu")


def _small_yolov2():
    """yolov2's layer kinds (conv 3x3/1x1, pool, route, reorg, concat
    route) at narrow widths."""
    layers = (
        Conv(8), MaxPool(),                       # 0-1
        Conv(16), MaxPool(),                      # 2-3
        Conv(16), Conv(8, 1), MaxPool(),          # 4-6
        Conv(32), Conv(32),                       # 7-8
        Route((-4,)),                             # 9 -> 5
        Conv(4, 1),                               # 10
        Reorg(2),                                 # 11
        Route((-1, -4)),                          # 12 -> (11, 8)
        Conv(32),                                 # 13
        Conv(2 * (5 + 3), 1, bn=False, act="linear"),
    )
    return dataclasses.replace(get_variant("voc"), layers=layers,
                               anchors=((1.0, 1.5), (3.0, 2.0)),
                               class_names=("a", "b", "c"), input_size=64)


@pytest.mark.parametrize("make_cfg", [
    lambda: get_variant("tiny-voc", input_size=96), _small_yolov2],
    ids=["tiny-voc-96", "yolov2-narrow"])
def test_darknet_logits_match_jax_fp32(make_cfg):
    cfg = make_cfg()
    rng = np.random.default_rng(2)
    folded = tgraph.fold_params(
        cfg.layers, dw.random_params(cfg.layers, rng, scale=0.1), cfg.bn_eps)
    x = rng.uniform(0, 1, (2, *cfg.input_hw, 3)).astype(np.float32)
    net = tgraph.Darknet(cfg.layers, folded, device="cpu")
    got = net(torch.from_numpy(x)).numpy()
    want = np.asarray(jgraph.apply_layers(
        to_jax_config(cfg).layers, jgraph.params_to_jax(folded),
        jnp.asarray(x), eps=cfg.bn_eps))
    assert got.shape == want.shape and got.dtype == np.float32
    _assert_logits_close(got, want)


def test_conv_block_bf16_matches_jax_bit_for_bit():
    """One conv + bias + leaky in bf16: fp32 sums reach the epilogue
    unrounded in both packages."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 16, 16, 32)).astype(np.float32)
    p = {"kernel": rng.normal(0, 0.1, (3, 3, 32, 64)).astype(np.float32),
         "bias": rng.normal(0, 0.5, 64).astype(np.float32)}
    got = tgraph.Darknet((Conv(64, bn=False),), [p], device="cpu",
                         dtype=torch.bfloat16)(torch.from_numpy(x)).numpy()
    want, _ = jgraph.conv_block(
        jnp.asarray(x), jgraph.params_to_jax([p])[0], jspecs.Conv(64, bn=False),
        eps=1e-5, train=False, compute_dtype=jnp.bfloat16)
    want = np.asarray(want).astype(np.float32)
    assert (got == want).mean() >= 0.99
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("make_cfg", [
    lambda: get_variant("tiny-voc", input_size=96), lambda: _small_yolov2()],
    ids=["tiny-voc-96", "yolov2-narrow"])
def test_darknet_logits_match_jax_bf16(make_cfg):
    cfg = make_cfg()
    rng = np.random.default_rng(2)
    folded = tgraph.fold_params(
        cfg.layers, dw.random_params(cfg.layers, rng, scale=0.1), cfg.bn_eps)
    x = rng.uniform(0, 1, (2, *cfg.input_hw, 3)).astype(np.float32)
    got = tgraph.Darknet(cfg.layers, folded, device="cpu",
                         dtype=torch.bfloat16)(torch.from_numpy(x)).numpy()
    want = np.asarray(jgraph.apply_layers(
        to_jax_config(cfg).layers, jgraph.params_to_jax(folded),
        jnp.asarray(x), eps=cfg.bn_eps, compute_dtype=jnp.bfloat16))
    assert got.dtype == np.float32 and want.dtype == np.float32
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 2 * _bf16_ulp(scale)


def test_darknet_bf16_tracks_fp32():
    """bf16 keeps 8 mantissa bits and rounds activations after every
    conv: logits stay within 5% of the fp32 logits' scale."""
    cfg = _small_yolov2()
    rng = np.random.default_rng(3)
    folded = tgraph.fold_params(
        cfg.layers, dw.random_params(cfg.layers, rng, scale=0.1), cfg.bn_eps)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    f32 = tgraph.Darknet(cfg.layers, folded, device="cpu")(x)
    bf16 = tgraph.Darknet(cfg.layers, folded, device="cpu",
                          dtype=torch.bfloat16)(x)
    assert bf16.dtype == torch.float32
    err = (bf16 - f32).abs().max().item()
    assert err <= 0.05 * f32.abs().max().item()


def test_darknet_matches_golden_full_yolov2_checksum():
    """The seed-pinned full YOLOv2 logits fixture of
    tests/test_golden_e2e.py, through the port (BN folded first)."""
    rng = np.random.default_rng(GOLDEN_SEED + 1)
    cfg = dataclasses.replace(get_variant("coco"), input_size=160)
    params = dw.random_params(cfg.layers, rng, scale=0.03)
    x = rng.uniform(0, 1, (1, 160, 160, 3)).astype(np.float32)
    net = tgraph.Darknet(cfg.layers,
                         tgraph.fold_params(cfg.layers, params, cfg.bn_eps),
                         device="cpu")
    logits = net(torch.from_numpy(x)).numpy()
    assert logits.shape == (1, 5, 5, 425)
    golden = json.load(open(os.path.join(FIXTURES,
                                         "golden_full_checksum.json")))
    assert float(np.abs(logits).mean()) == pytest.approx(golden["abs_mean"],
                                                          rel=1e-4)
    np.testing.assert_allclose(logits[0, 2, 2, :5], golden["probe"],
                               rtol=1e-4)


@pytest.mark.parametrize("layer,item", [
    (jspecs.Shortcut(-2, weights_type="per_feature"), "A8b"),
    (jspecs.Sam(-2), "A8b"), (jspecs.Conv(8, groups=2), "A8b"),
    (jspecs.Connected(4, in_features=12 * 12 * 8), "A10"),
    (jspecs.YoloHead((0,), new_coords=True), "A8b"),
    (jspecs.DetectionHead(side=2, num=1, classes=2), "A10"),
    (jspecs.Local(4, out_h=12, out_w=12, in_c=8), "A10")])
def test_layers_outside_the_slice_raise(layer, item):
    """The JAX package's specs are not layers of the port: each is
    refused as a foreign object. The options only a custom .cfg sets
    (ROADMAP A8b: weighted shortcut, sam, conv groups, new_coords) and
    the layers of A10 (a spatial [connected]; yolov1's [detection] and
    [local]) are ported: the port's own spec of the same name and fields
    builds, and the net matches the JAX package's in fp32 (rtol 1e-5 of
    its scale)."""
    with pytest.raises(TypeError, match="not a spec"):
        tgraph._check_layer(2, layer)
    port = getattr(specs, type(layer).__name__)(**dataclasses.asdict(layer))
    tlayers = (Conv(8), Conv(8), port)
    rng = np.random.default_rng(5)
    params = dw.random_params(tlayers, rng, scale=0.3)
    if isinstance(port, Shortcut):
        params[-1]["weights"] = np.array([[0.7], [1.3]], np.float32)
    folded = tgraph.fold_params(tlayers, params)
    x = rng.uniform(-1, 1, (1, 12, 12, 3)).astype(np.float32)
    got = tgraph.Darknet(tlayers, folded, device="cpu")(torch.from_numpy(x))
    got = got[0] if isinstance(got, tuple) else got
    want = jgraph.apply_layers((jspecs.Conv(8), jspecs.Conv(8), layer),
                               jgraph.params_to_jax(folded), jnp.asarray(x))
    want = np.asarray(want[0] if isinstance(want, tuple) else want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_tf32_guard_restores_the_flag_across_overlapping_forwards():
    """cuDNN's TF32 flag is process-wide: it stays off while any fp32
    forward runs (nested or in another thread) and comes back after."""
    import threading

    before = torch.backends.cudnn.allow_tf32
    inside = threading.Event()
    release = threading.Event()

    def other_forward():
        with no_tf32():
            inside.set()
            release.wait(timeout=30)

    t = threading.Thread(target=other_forward)
    t.start()
    assert inside.wait(timeout=30)
    with no_tf32():
        assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cudnn.allow_tf32  # the thread is still in
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert torch.backends.cudnn.allow_tf32 == before
    cfg = _small_yolov2()
    folded = tgraph.fold_params(
        cfg.layers, dw.random_params(cfg.layers, np.random.default_rng(4)),
        cfg.bn_eps)
    tgraph.Darknet(cfg.layers, folded, device="cpu")(
        torch.zeros(1, 64, 64, 3))
    assert torch.backends.cudnn.allow_tf32 == before
