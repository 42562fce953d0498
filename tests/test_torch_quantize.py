"""int8 post-training quantization in the port (yolo_tpu_torch/models/
quantize.py, ops/conv_s8.py, the int8 maxpool, Darknet's int8 blocks)
against the JAX package (yolo_tpu/models/quantize.py), on the CPU.

The JAX package's own tests (tests/test_quantize.py) run again on the
port with their configs, seeds and bounds: score deviation < 0.3 and
top-50 overlap > 0.6 against fp32, positive scales, the int8 checkpoint
round trip, mAP within 0.01 on a trained model (trained once, by the JAX
package's train step, for both packages), the unknown-method refusal, and
the chained tests, chained against unchained bit-identical among them.

Parity with JAX, tolerances:
  * _chain_out_scales and quantize on the same layers, folded params and
    scales: equal outputs, int8 kernels byte-equal.
  * calibrate on the same folded params and images: every scale within
    rtol 1e-4. The two fp32 forwards sum in other orders (XLA's conv
    against PyTorch's, ~1e-7 relative a layer); an abs-max follows one
    element, and a percentile interpolates between two, so their
    distance grows with depth (2.3e-5 read at YOLOv2-COCO's conv 22).
  * the plain int8 block (conv_block_int8) against JAX's on the same
    int8 params and inputs: the int32 sums equal; leaky, linear, relu
    and ramp outputs equal, int8 codes and fp32/bf16 values; mish,
    logistic and swish within 1 code or 1e-6 relative in fp32 (the two
    packages' exp / log1p / tanh differ in the last bit).
  * the int8 maxpool equal to JAX's.
  * prepare_int8 end to end: int8 kernels, w_scale and biases equal,
    x_scale and out_scale within the calibration rtol above.
  * the whole int8 forward: tests/test_torch_quantize_slice.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import to_jax_config, to_port_config
from yolo_tpu.io import darknet_weights as jdw
from yolo_tpu.models import graph as jgraph
from yolo_tpu.models import predict as jpredict
from yolo_tpu.models import quantize as jq
from yolo_tpu.ops import pool as jpool
from yolo_tpu_torch.configs import VARIANTS, get_variant
from yolo_tpu_torch.configs.specs import Conv, ModelConfig
from yolo_tpu_torch.io import checkpoint as ckpt
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import quantize
from yolo_tpu_torch.models.graph import (Darknet, fold_params,
                                         params_from_numpy)
from yolo_tpu_torch.models.predict import detect, forward
from yolo_tpu_torch.ops import conv_s8
from yolo_tpu_torch.ops.cuda import conv_s8_kernel
from yolo_tpu_torch.ops.decode import decode, decode_yolo
from yolo_tpu_torch.ops.pool import maxpool_nhwc

torch.set_num_threads(1)

CPU = "cpu"
CALIB_RTOL = 1e-4   # calibration scales, port against JAX (see above)


def _net(cfg, params, dtype=torch.float32):
    return Darknet(cfg.layers, params, device=CPU, dtype=dtype)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _check_scores(s32, s8):
    """The JAX tests' gate: max score deviation < 0.3, top-50 overlap >
    0.6."""
    s32, s8 = np.asarray(s32), np.asarray(s8)
    dev = np.abs(s32 - s8).max()
    assert dev < 0.3, f"int8 score deviation {dev}"
    n = min(50, s32.size)
    top32 = np.argsort(-s32.ravel())[:n]
    top8 = np.argsort(-s8.ravel())[:n]
    overlap = len(set(top32) & set(top8)) / n
    assert overlap > 0.6, f"top-{n} overlap only {overlap}"


# --- tests/test_quantize.py, on the port ------------------------------------

def test_int8_score_deviation_bounded():
    cfg = dataclasses.replace(get_variant("tiny-voc"), input_size=128)
    rng = np.random.default_rng(7)
    params = dw.random_params(cfg.layers, rng, scale=0.05)
    x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    lo32 = forward(cfg, _net(cfg, fold_params(cfg.layers, params,
                                              cfg.bn_eps)),
                   torch.from_numpy(x))
    qparams = quantize.prepare_int8(cfg, params, x, device=CPU)
    assert qparams[0]["kernel_q"].dtype == np.int8
    lo8 = forward(cfg, _net(cfg, qparams), torch.from_numpy(x))
    _, s32 = decode(lo32, cfg.anchors, cfg.num_classes)
    _, s8 = decode(lo8, cfg.anchors, cfg.num_classes)
    _check_scores(s32, s8)


def test_int8_head_families_deviation_bounded(tmp_path):
    """[Gaussian_yolo], scaled-yolov4 new_coords (logistic head convs:
    the activation applies to the dequantized fp32 value) and a YOLO9000
    tree head, with the JAX test's configs and draws."""
    from tests.test_gaussian_yolo import MICRO_GAUSS
    from tests.test_scaled_yolov4 import MICRO_SCALED
    from tests.test_tree import TREE_TEXT
    from yolo_tpu_torch.configs.tree import parse_tree

    rng = np.random.default_rng(11)
    for jcfg in (MICRO_GAUSS, MICRO_SCALED):
        cfg = to_port_config(jcfg)
        params = dw.random_params(cfg.layers, rng, scale=0.05)
        h, w = cfg.input_hw
        x = torch.from_numpy(rng.uniform(0, 1, (2, h, w, 3)).astype(
            np.float32))
        lo32 = forward(cfg, _net(cfg, fold_params(cfg.layers, params,
                                                  cfg.bn_eps)), x)
        qparams = quantize.prepare_int8(cfg, params, x.numpy(), device=CPU)
        lo8 = forward(cfg, _net(cfg, qparams), x)
        heads = cfg.yolo_heads
        kw = dict(scales=[hd.scale_xy for hd in heads],
                  new_coords=[hd.new_coords for hd in heads],
                  gaussian=[hd.gaussian for hd in heads])
        masks = [hd.mask for hd in heads]
        _, s32 = decode_yolo(lo32, cfg.anchors, masks, cfg.num_classes,
                             cfg.input_hw, **kw)
        _, s8 = decode_yolo(lo8, cfg.anchors, masks, cfg.num_classes,
                            cfg.input_hw, **kw)
        _check_scores(s32, s8)

    tp = tmp_path / "micro.tree"
    tp.write_text(TREE_TEXT)
    tree = parse_tree(str(tp))
    tcfg = ModelConfig(
        name="micro9000-q",
        layers=(Conv(8, stride=2), Conv(16, stride=2), Conv(16, stride=2),
                Conv(32, stride=2), Conv(32, stride=2),
                Conv(2 * (5 + tree.n_nodes), size=1, bn=False,
                     act="linear")),
        anchors=((1.0, 1.5), (2.5, 2.0)), class_names=tree.names,
        input_size=96, tree=tree, hier_thresh=0.3)
    params = dw.random_params(tcfg.layers, rng, scale=0.05)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 96, 96, 3)).astype(
        np.float32))
    lo32 = forward(tcfg, _net(tcfg, fold_params(tcfg.layers, params,
                                                tcfg.bn_eps)), x)
    qparams = quantize.prepare_int8(tcfg, params, x.numpy(), device=CPU)
    lo8 = forward(tcfg, _net(tcfg, qparams), x)
    leaf_map = tuple(i for i in range(tree.n_nodes) if tree.leaf(i))
    _, s32 = decode(lo32, tcfg.anchors, tree.n_nodes, tree=tree,
                    tree_map=leaf_map, hier_thresh=0.3)
    _, s8 = decode(lo8, tcfg.anchors, tree.n_nodes, tree=tree,
                   tree_map=leaf_map, hier_thresh=0.3)
    _check_scores(s32, s8)


def test_calibration_scales_positive():
    cfg = dataclasses.replace(get_variant("tiny-voc"), input_size=96)
    rng = np.random.default_rng(8)
    params = dw.random_params(cfg.layers, rng, scale=0.05)
    folded = fold_params(cfg.layers, params, cfg.bn_eps)
    x = rng.uniform(0, 1, (1, 96, 96, 3)).astype(np.float32)
    scales = quantize.calibrate(cfg.layers, folded, x, cfg.bn_eps,
                                device=CPU)
    assert len(scales) == 9  # tiny-yolo conv count
    assert all(s > 0 for s in scales)


def test_int8_params_checkpoint_roundtrip(tmp_path):
    cfg = dataclasses.replace(get_variant("tiny-voc"), input_size=96)
    rng = np.random.default_rng(9)
    params = dw.random_params(cfg.layers, rng, scale=0.05)
    x = rng.uniform(0, 1, (1, 96, 96, 3)).astype(np.float32)
    qparams = quantize.prepare_int8(cfg, params, x, device=CPU)
    path = str(tmp_path / "q")
    ckpt.save(path, [dict(p) for p in qparams])
    restored = ckpt.restore(path)
    assert np.asarray(restored[0]["kernel_q"]).dtype == np.int8
    np.testing.assert_array_equal(np.asarray(restored[0]["kernel_q"]),
                                  np.asarray(qparams[0]["kernel_q"]))
    # the restored tree serves as the int8 params it was saved from
    back = [{k: np.asarray(v, np.float32) if k != "kernel_q"
             else np.asarray(v) for k, v in p.items()} for p in restored]
    xt = torch.from_numpy(x)
    assert torch.equal(_net(cfg, back)(xt), _net(cfg, qparams)(xt))


@pytest.fixture(scope="module")
def trained_micro():
    """The JAX test's micro model overfit for 800 Adam steps by the JAX
    package's train step on its 4 scenes: (scenes, raw numpy params)."""
    from tests.test_map_integration import _dataset
    from tests.test_train import MICRO
    from yolo_tpu.data import targets as tgt
    from yolo_tpu.train.loop import TrainConfig, init_state, make_train_step

    scenes = _dataset()
    enc = tgt.encode_batch([s[1] for s in scenes], [s[2] for s in scenes],
                           grid=MICRO.grid_size, anchors=MICRO.anchors,
                           num_classes=MICRO.num_classes)
    batch = {k: jnp.asarray(v) for k, v in enc.items()}
    batch["images"] = jnp.asarray(np.stack([s[0] for s in scenes]))
    tcfg = TrainConfig(learning_rate=3e-3, optimizer="adam",
                       weight_decay=0.0)
    state = init_state(jdw.random_params(MICRO.layers,
                                         np.random.default_rng(0)), tcfg)
    step = make_train_step(MICRO, tcfg)
    for _ in range(800):
        state, _ = step(state, batch)
    raw = [{k: np.asarray(v) for k, v in p.items()}
           for p in state["params"]]
    return scenes, raw


def _scene_map(scenes, out, num_classes) -> float:
    from yolo_tpu_torch.eval.voc_map import evaluate

    gt, detections = {}, {}
    for i, (_, boxes, classes) in enumerate(scenes):
        xyxy = np.stack([
            (boxes[:, 0] - boxes[:, 2] / 2) * 64,
            (boxes[:, 1] - boxes[:, 3] / 2) * 64,
            (boxes[:, 0] + boxes[:, 2] / 2) * 64,
            (boxes[:, 1] + boxes[:, 3] / 2) * 64], axis=-1)
        gt[i] = {"boxes": xyxy, "classes": classes,
                 "difficult": np.zeros(len(classes), np.int32)}
        dets = []
        for j in np.nonzero(out["valid"][i])[0]:
            cx, cy, w, h = np.asarray(out["boxes"][i][j], np.float64)
            dets.append((int(out["classes"][i][j]),
                         float(out["scores"][i][j]),
                         (cx - w / 2) * 64, (cy - h / 2) * 64,
                         (cx + w / 2) * 64, (cy + h / 2) * 64))
        detections[i] = dets
    return evaluate(detections, gt, num_classes)["map"]


def test_int8_map_parity_on_trained_model(trained_micro):
    """Both calibrations (abs-max, percentile-99.9) hold the trained
    micro model's mAP within 0.01 of fp32, in the port and in the JAX
    package, on the same trained weights."""
    from tests.test_train import MICRO as JMICRO

    scenes, raw = trained_micro
    cfg = to_port_config(JMICRO)
    images = np.stack([s[0] for s in scenes])

    def port_map(params):
        out = detect(cfg, _net(cfg, params), torch.from_numpy(images),
                     conf_threshold=0.05, head="reference", nms_impl="torch")
        return _scene_map(scenes, {k: v.numpy() for k, v in out.items()},
                          cfg.num_classes)

    def jax_map(params):
        out = jpredict.detect(JMICRO, params, jnp.asarray(images),
                              conf_threshold=0.05, head="reference",
                              nms_impl="xla")
        return _scene_map(scenes, {k: np.asarray(v) for k, v in out.items()},
                          cfg.num_classes)

    base = port_map(fold_params(cfg.layers, raw, cfg.bn_eps))
    jbase = jax_map(jgraph.params_to_jax(
        jgraph.fold_params(JMICRO.layers, raw, JMICRO.bn_eps)))
    assert base > 0.99 and jbase > 0.99, \
        f"training did not converge (mAP {base}, JAX {jbase})"
    for method in ("absmax", "percentile"):
        m = port_map(quantize.prepare_int8(cfg, raw, images, method=method,
                                           device=CPU))
        assert m > base - 0.01, f"{method} int8 mAP {m} vs fp32 {base}"
        jm = jax_map(jq.prepare_int8(JMICRO, raw, jnp.asarray(images),
                                     method=method))
        assert jm > jbase - 0.01, f"JAX {method} int8 mAP {jm}"


def test_calibrate_rejects_unknown_method():
    cfg = dataclasses.replace(get_variant("tiny-voc"), input_size=96)
    rng = np.random.default_rng(10)
    params = dw.random_params(cfg.layers, rng, scale=0.05)
    folded = fold_params(cfg.layers, params, cfg.bn_eps)
    x = rng.uniform(0, 1, (1, 96, 96, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="calibration method"):
        quantize.calibrate(cfg.layers, folded, x, cfg.bn_eps,
                           method="entropy", device=CPU)


class TestChainedInt8:
    """Chained int8 serving: int8 activations between sole-consumer conv
    pairs (models/quantize.py::_chain_out_scales)."""

    def test_straight_chain_exact_vs_unchained(self):
        """On straight conv/pool topologies the chained forward is
        BIT-IDENTICAL to the unchained one in fp32 (direct requant ==
        dequant + requant at the same scale; max-pooling commutes with
        the monotone quantization)."""
        for name in ("tiny-voc", "yolov3-tiny"):
            cfg = get_variant(name, input_size=128)
            rng = np.random.default_rng(3)
            raw = dw.random_params(cfg.layers, rng, scale=0.05)
            x = rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
            q0 = quantize.prepare_int8(cfg, raw, x, chain=False, device=CPU)
            q1 = quantize.prepare_int8(cfg, raw, x, chain=True, device=CPU)
            assert any("out_scale" in p for p in q1)
            o0 = _tuple(_net(cfg, q0)(torch.from_numpy(x)))
            o1 = _tuple(_net(cfg, q1)(torch.from_numpy(x)))
            for a, b in zip(o0, o1):
                np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                              err_msg=name)

    def test_chain_respects_route_consumers(self):
        """yolov2's passthrough source (consumed by route -9 AND the next
        pool) and the conv before a route must not be chained."""
        from yolo_tpu_torch.configs.specs import Route, resolve_route

        cfg = get_variant("coco")
        rng = np.random.default_rng(4)
        raw = dw.random_params(cfg.layers, rng, scale=0.05)
        x = rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
        q = quantize.prepare_int8(dataclasses.replace(cfg, input_size=128),
                                  raw, x, chain=True, device=CPU)
        conv_at = [i for i, l in enumerate(cfg.layers)
                   if isinstance(l, Conv)]
        route_srcs = set()
        for idx, l in enumerate(cfg.layers):
            if isinstance(l, Route):
                for r in l.layers:
                    route_srcs.add(resolve_route(idx, r))
        for ci, layer_idx in enumerate(conv_at):
            if layer_idx in route_srcs:
                assert "out_scale" not in q[ci], f"conv {ci} feeds a route"
        assert "out_scale" not in q[-1]
        assert sum(1 for p in q if "out_scale" in p) >= 15

    def test_int8_maxpool_matches_float_pool(self):
        """maxpool on int8 codes == quantize(maxpool(float)): the padding
        is the int8 minimum, not -inf."""
        rng = np.random.default_rng(5)
        xf = rng.uniform(-2.0, 2.0, (1, 7, 7, 3)).astype(np.float32)
        scale = 2.0 / 127.0
        xq = np.clip(np.round(xf / scale), -127, 127).astype(np.int8)
        for size, stride in ((2, 2), (2, 1), (3, 1)):
            a = maxpool_nhwc(torch.from_numpy(xq), size, stride).numpy()
            b = np.clip(np.round(maxpool_nhwc(
                torch.from_numpy(xf), size, stride).numpy() / scale),
                -127, 127).astype(np.int8)
            np.testing.assert_array_equal(a, b, err_msg=f"{size}s{stride}")

    def test_chained_boxes_match_unchained_at_production_thresholds(self):
        """Full yolov2 (routes, reorg, pool-widened chains): the chained
        detector's boxes agree with unchained int8's at conf 0.3."""
        cfg = dataclasses.replace(get_variant("coco"), input_size=128)
        rng = np.random.default_rng(6)
        raw = dw.random_params(cfg.layers, rng, scale=0.03)
        x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
        # the JAX test hands detect the uint8 frames themselves (values
        # 0-255 where [0, 1] are expected); so does this one
        imgs = torch.from_numpy((x * 255).astype(np.uint8))
        q0 = quantize.prepare_int8(cfg, raw, x, chain=False, device=CPU)
        q1 = quantize.prepare_int8(cfg, raw, x, chain=True, device=CPU)
        d0 = detect(cfg, _net(cfg, q0), imgs, conf_threshold=0.3,
                    head="reference", nms_impl="torch")
        d1 = detect(cfg, _net(cfg, q1), imgs, conf_threshold=0.3,
                    head="reference", nms_impl="torch")
        v0, v1 = d0["valid"].numpy(), d1["valid"].numpy()
        assert v0.sum() == v1.sum()
        np.testing.assert_allclose(
            d0["boxes"].numpy()[v0.astype(bool)],
            d1["boxes"].numpy()[v1.astype(bool)], rtol=0.1, atol=0.05)


def test_yolov1_refused():
    """A yolov1-family topology ([crop], [local] or [detection]) raises
    before anything is read, with the JAX package's message."""
    import types

    from yolo_tpu_torch.configs.specs import Crop

    v1 = types.SimpleNamespace(
        layers=(Crop(32, 32),) + get_variant("tiny-voc").layers)
    with pytest.raises(NotImplementedError, match="yolov1"):
        quantize.prepare_int8(v1, None, np.zeros((1, 32, 32, 3)),
                              device=CPU)


# --- parity with the JAX package, module by module ---------------------------

@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_chain_out_scales_matches_jax(name):
    """_chain_out_scales on every built-in variant's layers with the same
    seeded scales and output maxima: the same chains, scales and widened
    scales; and without out_maxes (pool-mediated chains dropped)."""
    cfg = get_variant(name)
    jcfg = to_jax_config(cfg)
    n = sum(isinstance(l, Conv) for l in cfg.layers)
    rng = np.random.default_rng(len(name))
    scales = list(rng.uniform(0.001, 0.1, n))
    out_maxes = list(rng.uniform(0.1, 20.0, n))
    for om in (out_maxes, None):
        want = jq._chain_out_scales(jcfg.layers, scales, om)
        got = quantize._chain_out_scales(cfg.layers, scales, om)
        assert got == want


@pytest.mark.parametrize("name", ["tiny-voc", "yolov3-tiny", "yolov4-tiny",
                                  "darknet19"])
def test_quantize_matches_jax(name):
    """quantize on the same folded params and scales, chained and not:
    equal blocks, the int8 kernels byte-equal, the [connected] tail and
    blend weights passed through."""
    cfg = get_variant(name, input_size=64)
    jcfg = to_jax_config(cfg)
    rng = np.random.default_rng(12)
    folded = fold_params(cfg.layers, dw.random_params(cfg.layers, rng),
                         cfg.bn_eps)
    n = sum(isinstance(l, Conv) for l in cfg.layers)
    scales = list(rng.uniform(0.001, 0.1, n))
    out_maxes = list(rng.uniform(0.1, 20.0, n))
    for chain in (False, True):
        want = jq.quantize(jcfg.layers, folded, scales, chain=chain,
                           out_maxes=out_maxes)
        got = quantize.quantize(cfg.layers, folded, scales, chain=chain,
                                out_maxes=out_maxes)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype
                assert np.asarray(g[k]).tobytes() == \
                    np.asarray(w[k]).tobytes(), k


def _jax_calibrate_inputs(name, size, seed):
    cfg = get_variant(name, input_size=size)
    rng = np.random.default_rng(seed)
    raw = dw.random_params(cfg.layers, rng, scale=0.05)
    x = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    return cfg, raw, x


@pytest.mark.parametrize("method", ["absmax", "percentile"])
def test_calibrate_matches_jax(method):
    """calibrate on the same folded params and images: scales and output
    maxima within CALIB_RTOL (the fp32 forwards sum in other orders)."""
    cfg, raw, x = _jax_calibrate_inputs("coco", 96, 13)
    folded = fold_params(cfg.layers, raw, cfg.bn_eps)
    want = jq.calibrate(to_jax_config(cfg).layers, folded, x, cfg.bn_eps,
                        method=method, return_out_maxes=True)
    got = quantize.calibrate(cfg.layers, folded, x, cfg.bn_eps,
                             method=method, return_out_maxes=True,
                             device=CPU)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=CALIB_RTOL, atol=0)


@pytest.mark.parametrize("n, pct", [(1000, 99.9), (777, 50.0), (5, 100.0),
                                    (4096, 0.0), (123457, 99.9)])
def test_percentile_matches_jnp(n, pct):
    """_percentile against jnp.percentile's linear interpolation, from
    either tail, as JAX's calibrate calls it: inside jit, with the
    percentile a constant (XLA folds q * (n - 1) in order; eagerly, with
    q a runtime value, it reassociates into pct * ((n - 1) / 100), which
    may put the position one ulp apart). The same position and
    neighbours; the result within 2 ulps (rtol 2.4e-7): XLA:CPU
    contracts the interpolation's lo * w_lo + hi * w_hi into an FMA,
    the port rounds each product."""
    import jax

    a = np.abs(np.random.default_rng(n).standard_normal(n)).astype(
        np.float32)
    want = float(jax.jit(lambda v: jnp.percentile(v, pct))(a))
    got = quantize._percentile(torch.from_numpy(a), pct)
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)


# conv shapes of the plain block: (cin, co, ks, stride, groups, dilation,
# act, hw); conv 0 (cin 3), stride 2, grouped, depthwise, dilated, 1x1,
# every activation
BLOCK_SHAPES = [
    (3, 16, 3, 1, 1, 1, "leaky", 12),
    (32, 64, 3, 2, 1, 1, "leaky", 11),
    (64, 32, 1, 1, 1, 1, "linear", 9),
    (32, 32, 3, 1, 4, 1, "leaky", 10),
    (16, 16, 3, 1, 16, 1, "relu", 10),
    (32, 48, 3, 1, 1, 2, "ramp", 12),
    (24, 40, 5, 1, 1, 1, "mish", 9),
    (64, 64, 3, 1, 2, 1, "logistic", 8),
    (32, 24, 3, 2, 1, 1, "swish", 13),
]


def _block_params(rng, cin, co, ks, groups, chained_out):
    kq = rng.integers(-127, 128, (ks, ks, cin // groups, co)).astype(np.int8)
    p = {"kernel_q": kq,
         "w_scale": rng.uniform(0.001, 0.01, co).astype(np.float32),
         "x_scale": np.float32(rng.uniform(0.01, 0.05)),
         "bias": rng.uniform(-1, 1, co).astype(np.float32)}
    if chained_out:
        p["out_scale"] = np.float32(rng.uniform(0.02, 0.2))
    return p


@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=lambda s: (
    f"{s[0]}-{s[1]}-k{s[2]}s{s[3]}g{s[4]}d{s[5]}-{s[6]}"))
def test_conv_block_int8_matches_jax(shape):
    """The plain int8 block against JAX's conv_block_int8 on the same
    int8 params: float input (fp32 and bf16 values) and chained int8
    input; int8, fp32 and bf16 outputs. The int32 sums equal; the outputs
    equal for leaky, linear, relu and ramp; mish, logistic and swish
    within 1 code, or 1e-6 relative in fp32 and 1 bf16 ulp."""
    from yolo_tpu.configs.specs import Conv as JConv

    cin, co, ks, stride, groups, dil, act, hw = shape
    rng = np.random.default_rng(cin * co + ks)
    spec = Conv(co, size=ks, stride=stride, groups=groups, dilation=dil,
                act=act)
    jspec = JConv(co, size=ks, stride=stride, groups=groups, dilation=dil,
                  act=act)
    exact = act in ("leaky", "linear", "relu", "ramp")
    xf = rng.uniform(-3, 3, (2, hw, hw, cin)).astype(np.float32)
    xq = rng.integers(-127, 128, (2, hw, hw, cin)).astype(np.int8)
    for chained_out in (False, True):
        p = _block_params(rng, cin, co, ks, groups, chained_out)
        tp = params_from_numpy((spec,), [p], CPU)[0]
        # the int32 sums
        from jax import lax

        pad = (ks // 2) * dil
        want_acc = np.asarray(lax.conv_general_dilated(
            jnp.asarray(xq), jnp.asarray(p["kernel_q"]), (stride, stride),
            ((pad, pad), (pad, pad)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=groups, rhs_dilation=(dil, dil),
            preferred_element_type=jnp.int32))
        got_acc = conv_s8.conv_s8_sums(
            torch.from_numpy(xq).permute(0, 3, 1, 2), tp["kernel_q"],
            stride=stride, groups=groups, dilation=dil)
        np.testing.assert_array_equal(
            got_acc.permute(0, 2, 3, 1).numpy(), want_acc)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        for x in (xf, xq):
            for jdt, tdt in ((jnp.float32, torch.float32),
                             (jnp.bfloat16, torch.bfloat16)):
                if x.dtype == np.int8:
                    jx, tx = jnp.asarray(x), torch.from_numpy(x)
                else:
                    jx = jnp.asarray(x, jdt)
                    tx = torch.from_numpy(np.asarray(
                        jx.astype(jnp.float32))).to(tdt)
                want = np.asarray(jq.conv_block_int8(
                    jx, jp, jspec, compute_dtype=jdt).astype(jnp.float32))
                got = quantize.conv_block_int8(
                    tx.permute(0, 3, 1, 2).contiguous(
                        memory_format=torch.channels_last), tp, spec,
                    compute_dtype=tdt)
                assert got.dtype == (torch.int8 if chained_out else tdt)
                got = got.permute(0, 2, 3, 1).float().numpy()
                if exact:
                    np.testing.assert_array_equal(got, want)
                elif chained_out:
                    assert np.abs(got - want).max() <= 1
                elif tdt == torch.float32:
                    np.testing.assert_allclose(got, want, rtol=1e-6,
                                               atol=1e-6)
                else:
                    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                               atol=1e-6)


def test_maxpool_int8_matches_jax():
    rng = np.random.default_rng(14)
    x = rng.integers(-127, 128, (2, 13, 11, 8)).astype(np.int8)
    for size, stride in ((2, 2), (2, 1), (3, 1), (5, 1), (3, 2)):
        want = np.asarray(jpool.maxpool_nhwc(jnp.asarray(x), size, stride))
        got = maxpool_nhwc(torch.from_numpy(x), size, stride).numpy()
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want, err_msg=f"{size}s{stride}")


def test_prepare_int8_matches_jax():
    """prepare_int8 end to end (fold, calibrate, chain, quantize) on the
    same raw params and images: kernels, w_scale and biases equal, x_scale
    and out_scale within CALIB_RTOL."""
    cfg, raw, x = _jax_calibrate_inputs("yolov3-tiny", 96, 15)
    want = jq.prepare_int8(to_jax_config(cfg), raw, jnp.asarray(x))
    got = quantize.prepare_int8(cfg, raw, x, device=CPU)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("kernel_q", "w_scale", "bias"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
        for k in set(w) & {"x_scale", "out_scale"}:
            np.testing.assert_allclose(g[k], np.asarray(w[k]),
                                       rtol=CALIB_RTOL)


def test_int8_net_refuses_the_fused_entry():
    cfg = get_variant("tiny-voc", input_size=64)
    rng = np.random.default_rng(17)
    raw = dw.random_params(cfg.layers, rng, scale=0.05)
    q = quantize.prepare_int8(cfg, raw, rng.uniform(0, 1, (1, 64, 64, 3)),
                              device=CPU)
    from yolo_tpu_torch.models.predict import detect_raw

    with pytest.raises(ValueError, match="folded-BN params"):
        detect_raw(cfg, _net(cfg, q, torch.bfloat16),
                   torch.zeros((1, 64, 64, 3), dtype=torch.uint8),
                   entry="fused")


def test_wrapper_takes_the_plain_block_on_cpu():
    """The s8 kernel's wrapper on CPU tensors is the plain block, and
    counts no launch; its plan picks the body by shape: the stem for
    windows of at most 32 bytes (conv 0), wgmma for the stride-1
    ungrouped convs with CIN % 32 and CO % 64 (K split where its tiles
    do not fill the card), mma for the other CIN % 32, dp4a for the
    rest."""
    rng = np.random.default_rng(18)
    spec = Conv(64, size=3)
    p = params_from_numpy((spec,), [_block_params(rng, 32, 64, 3, 1, True)],
                          CPU)[0]
    x = torch.from_numpy(rng.integers(-127, 128, (1, 32, 9, 9)).astype(
        np.int8)).contiguous(memory_format=torch.channels_last)
    before = conv_s8_kernel.launches
    got = conv_s8_kernel.conv_s8_bias_act(
        x, p["kernel_q"], p["x_scale"] * p["w_scale"], p["bias"],
        x_inv=1.0, out_scale=float(p["out_scale"]), act="leaky")
    assert conv_s8_kernel.launches == before
    assert torch.equal(got, quantize.conv_block_int8(x, p, spec))
    assert conv_s8_kernel.plan(169, 1024, 1024, 1) == \
        conv_s8_kernel.Plan("wgmma", 128, 128, chunk=128, splits=8)
    assert conv_s8_kernel.plan(346112, 64, 128, 1) == \
        conv_s8_kernel.Plan("wgmma", 128, 64, chunk=64)
    assert conv_s8_kernel.plan(43264, 32, 64, 1).chunk == 32
    assert conv_s8_kernel.plan(169 * 32, 3, 32, 1) == \
        conv_s8_kernel.Plan("stem")
    assert conv_s8_kernel.plan(100, 1, 1, 64).npt == 1
    assert conv_s8_kernel.plan(10 ** 6, 512, 1024, 1) == \
        conv_s8_kernel.Plan("wgmma", 128, 128, chunk=128)
    assert conv_s8_kernel.plan(10 ** 6, 512, 1024, 1, ks=1).bn == 64
    assert conv_s8_kernel.plan(5408, 1024, 425, 1, ks=1) == \
        conv_s8_kernel.Plan("mma", 128, 64)
    assert conv_s8_kernel.plan(169, 1024, 425, 1, ks=1) == \
        conv_s8_kernel.Plan("mma", 64, 64)
    assert conv_s8_kernel.plan(5408, 1024, 1024, 1).bn == 128
    for kw in ({"stride": 2}, {"dilation": 2}, {"ks": 2}):
        assert conv_s8_kernel.plan(10 ** 6, 512, 1024, 1, **kw).body == \
            "mma"
    assert conv_s8_kernel.plan(10 ** 6, 128, 128, 4).body == "mma"
    assert conv_s8_kernel.plan(10 ** 6, 64, 64, 1, stride=2) == \
        conv_s8_kernel.Plan("mma", 128, 64)
