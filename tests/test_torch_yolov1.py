"""The yolov1 family in the port against the JAX package, on the CPU:
[crop]/[local]/[detection] in configs/darknet_cfg.py, the [local]
blocks of io/darknet_weights.py, models/graph.py's _local and _crop,
ops/decode.py::decode_detection, data/targets.py::encode_v1,
train/loss.py::detection_loss, the yolov1 train step and the [detection]
route of models/predict.py.

The JAX package's own yolov1 tests (tests/test_yolov1.py) run again with
the port's parser, specs, weights I/O, executor, decode, loss, encoder,
train step or command line in the JAX ones' place (thin adaptors turn
numpy/jax arrays into tensors and back). The rest holds the port against
the JAX functions on the same seeded numpy inputs:

  * _local: within 1e-5 relative of graph.py::_local_layer;
  * [crop]: test and train mode equal, the window and the flip of every
    key the same;
  * decode_detection: boxes within 1e-5, scores within 1e-6;
  * encode_v1: equal;
  * detection_loss: parts within 1e-5 relative, the gradient within
    1e-4 of its scale;
  * .weights: the same bytes; cfg fields and cfg_to_string text equal;
  * detect_raw, fp32: equal valid flags and classes, scores within 1e-4,
    pixel boxes within 1e-2 (tests/test_torch_predict.py's bounds);
  * one fp32 SGD step with dropout (and [crop] jitter): the params
    within 2e-5 of each tensor's scale (tests/test_torch_train.py's).
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_yolov1 as jt1
import tests.tf_oracle as jtf
import yolo_tpu
import yolo_tpu.cli  # noqa: F401  (the attribute the tests swap)
import yolo_tpu.configs.darknet_cfg as jdc
import yolo_tpu.data.targets as jtargets
import yolo_tpu.models.quantize as jquantize
from tests.torch_port import PortCli, rerun_jax_test, to_jax_config
from yolo_tpu.configs import specs as jspecs
from yolo_tpu.io import darknet_weights as jdw
from yolo_tpu.io import zoo as jzoo
from yolo_tpu.models import graph as jgraph
from yolo_tpu.models import predict as jpredict
from yolo_tpu.ops import decode as jdecode
from yolo_tpu.train import loop as jloop
from yolo_tpu.train import loss as jloss
import yolo_tpu_torch.configs.darknet_cfg as tdc
from yolo_tpu_torch.configs import specs as tspecs
from yolo_tpu_torch.data import targets as ttargets
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.io import zoo as tzoo
from yolo_tpu_torch.models import graph as tgraph
from yolo_tpu_torch.models import predict as tpredict
from yolo_tpu_torch.models import quantize as tquantize
from yolo_tpu_torch.ops import decode as tdecode
from yolo_tpu_torch.train import loop as tloop
from yolo_tpu_torch.train import loss as tloss

torch.set_num_threads(1)

# tests/test_torch_train.py's bound for fp32 SGD steps
STEP_TOL = 2e-5


def _v1(tmp_path, text=jt1.V1_CFG):
    p = tmp_path / "v1.cfg"
    p.write_text(text)
    return str(p), tdc.config_from_cfg(str(p))


def _jax_layers(layers):
    return to_jax_config(tspecs.ModelConfig(
        name="x", layers=tuple(layers), anchors=(),
        class_names=("a",))).layers


# --- adaptors: the port behind the JAX names the tests call ------------------

def _nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2)


def _port_local_layer(x, p, spec, *, compute_dtype=None):
    y = tgraph._local(spec, _nchw(x),
                      torch.from_numpy(np.asarray(p["kernel"], np.float32)),
                      torch.from_numpy(np.asarray(p["bias"], np.float32)))
    return y.permute(0, 2, 3, 1).numpy()


def _port_apply_layers(layers, params, x, *, eps=1e-5, train=False,
                       dropout_rng=None, **_):
    x = torch.from_numpy(np.array(x, np.float32))
    if train:
        net = tgraph.DarknetTrain(layers, params, device="cpu", eps=eps)
        key = None if dropout_rng is None else np.asarray(dropout_rng)
        with torch.no_grad():
            out, stats = net(x, dropout_key=key)
        return out.numpy(), stats
    net = tgraph.Darknet(layers, tgraph.fold_params(layers, params, eps),
                         device="cpu")
    return net(x).numpy()


def _port_decode_detection(flat, head):
    boxes, scores = tdecode.decode_detection(
        torch.from_numpy(np.array(flat, np.float32)), head)
    return boxes.numpy(), scores.numpy()


def _port_detect(cfg, params, images_01, **kw):
    net = tgraph.Darknet(cfg.layers, tgraph.fold_params(
        cfg.layers, params, cfg.bn_eps), device="cpu")
    out = tpredict.detect(cfg, net, torch.from_numpy(
        np.array(images_01, np.float32)), **kw)
    return {k: v.numpy() for k, v in out.items()}


def _port_detection_loss(flat, targets, head):
    total, parts = tloss.detection_loss(
        torch.from_numpy(np.array(flat, np.float32)),
        {k: torch.from_numpy(np.array(v)) for k, v in targets.items()}, head)
    return total.item(), {k: v.item() for k, v in parts.items()}


def _port_prepare_int8(cfg, params, calibration_images, **kw):
    return tquantize.prepare_int8(cfg, params,
                                  np.asarray(calibration_images), **kw,
                                  device="cpu")


class _PortTrain:
    """init_state / make_train_step in the JAX package's signatures over
    the port's: the state is built at the first step, where the model
    config is known, and a step returns (state, metrics)."""

    @staticmethod
    def init_state(params, tcfg):
        return {"params": params, "tcfg": tcfg}

    @staticmethod
    def make_train_step(cfg, tcfg):
        def step(state, batch):
            if "net" not in state:
                state["net"] = tloop.init_state(cfg, state["params"], tcfg,
                                                device="cpu")
            m = tloop.train_step(
                state["net"], {k: torch.from_numpy(np.array(v))
                               for k, v in batch.items()},
                mcfg=cfg, tcfg=tcfg)
            return state, {k: v.item() for k, v in m.items()}
        return step


_J_RUN_LAYERS = jtf.run_layers


def _run_layers_jax_specs(layers, params, x, eps=1e-5):
    """The TF oracle, which dispatches on the JAX package's specs, on
    the port's."""
    return _J_RUN_LAYERS(_jax_layers(layers), params, x, eps=eps)


@pytest.fixture
def port(monkeypatch):
    """tests/test_yolov1.py with the port in the JAX package's place."""
    for name in ("Connected", "Crop", "DetectionHead", "Local"):
        monkeypatch.setattr(jt1, name, getattr(tspecs, name))
    monkeypatch.setattr(jt1, "config_from_cfg", tdc.config_from_cfg)
    monkeypatch.setattr(jt1, "cfg_to_string", tdc.cfg_to_string)
    monkeypatch.setattr(jdc, "config_from_cfg", tdc.config_from_cfg)
    monkeypatch.setattr(jdc, "cfg_to_string", tdc.cfg_to_string)
    monkeypatch.setattr(jt1, "dw", dw)
    monkeypatch.setattr(jt1, "zoo", tzoo)
    monkeypatch.setattr(jgraph, "_local_layer", _port_local_layer)
    monkeypatch.setattr(jgraph, "apply_layers", _port_apply_layers)
    monkeypatch.setattr(jgraph, "params_to_jax", lambda p: p)
    monkeypatch.setattr(jtf, "run_layers", _run_layers_jax_specs)
    monkeypatch.setattr(jdecode, "decode_detection", _port_decode_detection)
    monkeypatch.setattr(jpredict, "detect", _port_detect)
    monkeypatch.setattr(jquantize, "prepare_int8", _port_prepare_int8)
    monkeypatch.setattr(jloss, "detection_loss", _port_detection_loss)
    monkeypatch.setattr(jtargets, "encode_v1", ttargets.encode_v1)
    monkeypatch.setattr(jtargets, "encode_for", ttargets.encode_for)
    monkeypatch.setattr(jloop, "TrainConfig", tloop.TrainConfig)
    monkeypatch.setattr(jloop, "init_state", _PortTrain.init_state)
    monkeypatch.setattr(jloop, "make_train_step", _PortTrain.make_train_step)
    monkeypatch.setattr(yolo_tpu, "cli", PortCli)


# every test of tests/test_yolov1.py, the 28 of them
JAX_TESTS = [
    "TestCfg.test_parse", "TestCfg.test_round_trip",
    "TestCfg.test_head_width_mismatch_rejected",
    "TestCfg.test_resize_rejected", "TestCfg.test_detection_must_be_last",
    "TestCfg.test_mixing_rejected",
    "TestLocalLayer.test_matches_loop_oracle",
    "TestLocalLayer.test_strided_no_pad",
    "TestDecode.test_matches_oracle", "TestDecode.test_sqrt_flag",
    "TestWeightsIO.test_round_trip_and_byte_count",
    "TestWeightsIO.test_local_block_layout",
    "TestWeightsIO.test_truncated_mid_local_raises",
    "TestForward.test_tf_oracle_parity",
    "TestForward.test_detect_e2e_and_fused_rejected",
    "TestForward.test_int8_rejects", "TestForward.test_predict_cli_e2e",
    "TestTraining.test_loss_matches_oracle",
    "TestTraining.test_loss_matches_oracle_no_rescore_no_sqrt",
    "TestTraining.test_zero_iou_rmse_fallback",
    "TestTraining.test_train_step_overfits",
    "TestTraining.test_encoder_first_object_wins",
    "TestCliTrain.test_train_cli_e2e_and_multiscale_rejected",
    "TestEvalCli.test_eval_v1_runs",
    "TestCropLayer.test_test_mode_center_crop_and_scale",
    "TestCropLayer.test_train_jitter_per_batch_window",
    "TestCropLayer.test_train_without_rng_falls_back_to_center",
    "TestCropLayer.test_cfg_flip_noadjust_roundtrip",
]


def test_every_jax_yolov1_test_is_rerun():
    from tests.torch_port import jax_test_names

    assert sorted(jax_test_names(jt1)) == sorted(JAX_TESTS)


@pytest.mark.parametrize("name", JAX_TESTS)
def test_jax_yolov1_tests_hold_for_the_port(name, port, tmp_path, capsys):
    rerun_jax_test(jt1, name, {"tmp_path": tmp_path, "capsys": capsys})


# --- cfg and weights ------------------------------------------------------------

YOLOV1_448 = "\n".join(
    ["[net]", "width=448", "height=448", "channels=3", ""]
    + [f"[convolutional]\nbatch_normalize=1\nfilters={f}\nsize={k}\n"
       f"stride={s}\npad=1\nactivation=leaky\n"
       if f else "[maxpool]\nsize=2\nstride=2\n"
       for f, k, s in [(64, 7, 2), (0, 0, 0), (192, 3, 1), (0, 0, 0),
                       (128, 1, 1), (256, 3, 1), (256, 1, 1), (512, 3, 1),
                       (0, 0, 0)] + [(256, 1, 1), (512, 3, 1)] * 4
       + [(512, 1, 1), (1024, 3, 1), (0, 0, 0)]
       + [(512, 1, 1), (1024, 3, 1)] * 2
       + [(1024, 3, 1), (1024, 3, 2), (1024, 3, 1), (1024, 3, 1)]]
    + ["[local]\nsize=3\nstride=1\npad=1\nfilters=256\nactivation=leaky\n",
       "[dropout]\nprobability=.5\n",
       "[connected]\noutput=1715\nactivation=linear\n",
       "[detection]\nclasses=20\ncoords=4\nrescore=1\nside=7\nnum=3\n"
       "softmax=0\nsqrt=1\njitter=.2\nobject_scale=1\nnoobject_scale=.5\n"
       "class_scale=1\ncoord_scale=5\n"])


@pytest.mark.parametrize("text", [jt1.V1_CFG, YOLOV1_448,
                                  jt1.V1_CFG.replace(
                                      "crop_width=64\n",
                                      "crop_width=48\nflip=1\nnoadjust=1\n")],
                         ids=["v1-64", "yolov1-448", "crop-flip"])
def test_cfg_fields_and_text_match_jax(text, tmp_path):
    """config_from_cfg field for field, and cfg_to_string's text."""
    path, cfg = _v1(tmp_path, text)
    want = jdc.config_from_cfg(path)
    assert to_jax_config(cfg) == want
    assert tdc.cfg_to_string(cfg) == jdc.cfg_to_string(want)
    assert tzoo.expected_weights_bytes(cfg.layers) == \
        jzoo.expected_weights_bytes(want.layers)


def test_weights_bytes_match_jax(tmp_path):
    """random_params draw the same values in both packages, and to_bytes
    / save write the same bytes; load reads them back alike."""
    path, cfg = _v1(tmp_path)
    jcfg = jdc.config_from_cfg(path)
    params = dw.random_params(cfg.layers, np.random.default_rng(3))
    jparams = jdw.random_params(jcfg.layers, np.random.default_rng(3))
    blob = dw.to_bytes(cfg.layers, params)
    assert blob == jdw.to_bytes(jcfg.layers, jparams)
    got, _ = dw.load(io.BytesIO(blob), cfg.layers)
    want, _ = jdw.load(io.BytesIO(blob), jcfg.layers)
    for p, q in zip(got, want, strict=True):
        assert set(p) == set(q)
        for k in p:
            np.testing.assert_array_equal(p[k], q[k])


# --- layers ---------------------------------------------------------------------

@pytest.mark.parametrize("geom", [(3, 1, True, "leaky", 5, 5, 6, 4),
                                  (2, 2, False, "linear", 6, 7, 3, 5),
                                  (3, 2, True, "leaky", 7, 7, 8, 3)])
def test_local_matches_jax(geom):
    """_local against graph.py::_local_layer within 1e-5 relative, on
    odd extents, strides and pads."""
    k, s, pad, act, h, w, c, f = geom
    p = k // 2 if pad else 0
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    spec = tspecs.Local(filters=f, size=k, stride=s, pad=pad, act=act,
                        out_h=oh, out_w=ow, in_c=c)
    rng = np.random.default_rng(sum(geom[:2]) + h)
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    params = {"kernel": rng.normal(size=(oh, ow, f, c, k, k)).astype(
                  np.float32),
              "bias": rng.normal(size=(oh, ow, f)).astype(np.float32)}
    want = np.asarray(jgraph._local_layer(
        jnp.asarray(x), params, _jax_layers([spec])[0]))
    got = _port_local_layer(x, params, spec)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("crop", [(4, 4, True, False), (6, 3, False, False),
                                  (8, 8, True, True), (5, 7, True, False)])
def test_crop_matches_jax(crop):
    """[crop] in test mode and in train mode on ten keys: the same
    window, flip and scale as apply_layers, exactly."""
    ch, cw, flip, noadjust = crop
    layers = (tspecs.Crop(ch, cw, flip=flip, noadjust=noadjust),)
    jlayers = _jax_layers(layers)
    x = np.random.default_rng(ch * cw).uniform(
        0, 1, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        _port_apply_layers(layers, [], x),
        np.asarray(jgraph.apply_layers(jlayers, [], jnp.asarray(x))))
    seen = set()
    for seed in range(10):
        key = jax.random.PRNGKey(seed)
        want, _ = jgraph.apply_layers(jlayers, [], jnp.asarray(x),
                                      train=True, dropout_rng=key)
        got, _ = _port_apply_layers(layers, [], x, train=True,
                                    dropout_rng=key)
        np.testing.assert_array_equal(got, np.asarray(want))
        seen.add(got.tobytes())
    if flip or (ch, cw) != (8, 8):
        assert len(seen) > 1


# --- decode, encoder, loss ------------------------------------------------------

@pytest.mark.parametrize("head", [(4, 2, 3, True), (7, 3, 20, True),
                                  (3, 1, 5, False)])
def test_decode_detection_matches_jax(head):
    s, n, c, sq = head
    spec = tspecs.DetectionHead(side=s, num=n, classes=c, sqrt=sq)
    flat = np.random.default_rng(s * n).normal(
        size=(3, 1, 1, s * s * (c + n * 5))).astype(np.float32)
    jb, js = jdecode.decode_detection(jnp.asarray(flat),
                                      _jax_layers([spec])[0])
    tb, ts = _port_decode_detection(flat, spec)
    np.testing.assert_allclose(tb, np.asarray(jb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-6)


def _scene(rng, b, c, side):
    boxes, classes = [], []
    for _ in range(b):
        g = int(rng.integers(1, 6))
        boxes.append(np.stack([
            rng.uniform(0.05, 0.95, g), rng.uniform(0.05, 0.95, g),
            rng.uniform(0.02, 0.5, g), rng.uniform(0.02, 0.5, g)], -1))
        classes.append(rng.integers(0, c, g))
    boxes[0] = np.concatenate([boxes[0], boxes[0][:1] + 0.01])  # shared cell
    classes[0] = np.concatenate([classes[0], classes[0][:1]])
    boxes[-1][0, 2] = 0.0                                       # dropped
    return boxes, classes


@pytest.mark.parametrize("side", [2, 4, 7])
def test_encode_v1_matches_jax(side):
    rng = np.random.default_rng(side)
    for bx, cl in zip(*_scene(rng, 6, 3, side)):
        want = jtargets.encode_v1(bx, cl, side)
        got = ttargets.encode_v1(bx, cl, side)
        assert set(got) == set(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("head", [
    dict(side=4, num=2, classes=3, sqrt=True, rescore=True),
    dict(side=3, num=3, classes=2, sqrt=False, rescore=False,
         coord_scale=5.0, noobject_scale=0.5),
    dict(side=7, num=3, classes=20, sqrt=True, rescore=True,
         coord_scale=5.0, noobject_scale=0.5)])
def test_detection_loss_matches_jax(head):
    """Parts within 1e-5 relative and the gradient of the total with
    respect to the flat activations within 1e-4 of its scale; the boxes
    of the first image's cells have zero width, so the min-distance
    fallback picks their responsible predictor."""
    spec = tspecs.DetectionHead(**head)
    jspec = _jax_layers([spec])[0]
    s, n, c = spec.side, spec.num, spec.classes
    rng = np.random.default_rng(s * 10 + n)
    boxes, classes = _scene(rng, 4, c, s)
    enc = [jtargets.encode_v1(b, cl, s) for b, cl in zip(boxes, classes)]
    targets = {k: np.stack([e[k] for e in enc]) for k in enc[0]}
    flat = rng.uniform(0, 1, (4, s * s * (c + n * 5))).astype(np.float32)
    flat.reshape(4, -1)[0, s * s * (c + n):].reshape(s * s, n, 4)[
        ..., 2:] = 0.0
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    (jtotal, jparts), jgrad = jax.value_and_grad(
        lambda f: jloss.detection_loss(f, jt, jspec), has_aux=True)(
            jnp.asarray(flat))
    x = torch.from_numpy(flat).requires_grad_(True)
    total, parts = tloss.detection_loss(
        x, {k: torch.from_numpy(v) for k, v in targets.items()}, spec)
    total.backward()
    for k in jparts:
        assert parts[k].item() == pytest.approx(float(jparts[k]), rel=1e-5,
                                                abs=1e-7), k
    assert total.item() == pytest.approx(float(jtotal), rel=1e-5)
    jg = np.asarray(jgrad)
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0,
                               atol=1e-4 * np.abs(jg).max())


# --- end to end -------------------------------------------------------------------

def test_detect_raw_matches_jax(tmp_path):
    """detect_raw on the same .weights and uint8 frames, fp32, the
    reference head (the CPU's; on CUDA "auto" resolves to it too)."""
    path, cfg = _v1(tmp_path)
    cfg = dataclasses.replace(cfg, conf_threshold=0.05)
    jcfg = to_jax_config(cfg)
    wpath = str(tmp_path / "v1.weights")
    dw.save(wpath, cfg.layers,
            dw.random_params(cfg.layers, np.random.default_rng(0)))
    imgs = np.random.default_rng(1).integers(0, 256, (2, 48, 80, 3),
                                             dtype=np.uint8)
    jparams, _ = jdw.load(wpath, jcfg.layers)
    want = jpredict.detect_raw(
        jcfg, jgraph.params_to_jax(jgraph.fold_params(
            jcfg.layers, jparams, jcfg.bn_eps)), jnp.asarray(imgs),
        compute_dtype=jnp.float32, head="reference")
    want = {k: np.asarray(v) for k, v in want.items()}
    params, _ = dw.load(wpath, cfg.layers)
    net = tgraph.Darknet(cfg.layers, tgraph.fold_params(
        cfg.layers, params, cfg.bn_eps), device="cpu")
    got = tpredict.make_detector(cfg)(net, torch.from_numpy(imgs))
    got = {k: v.numpy() for k, v in got.items()}
    v = want["valid"]
    assert v.sum() >= 4
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["classes"][v], want["classes"][v])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=0,
                               atol=1e-2)
    with pytest.raises(ValueError, match="fused"):
        tpredict.make_detector(cfg, head="fused")(net, torch.from_numpy(imgs))
    with pytest.raises(ValueError, match="entry"):
        tpredict.make_detector(cfg, entry="fused")(net,
                                                   torch.from_numpy(imgs))


@pytest.mark.parametrize("case", ["plain", "flip-crop", "accum2"])
def test_train_step_matches_jax(case, tmp_path):
    """Two fp32 SGD steps of the same params on the same batches: the
    [dropout] masks are JAX's (the key chain fold_in(PRNGKey(0), step),
    per sub-batch under accumulation), as is the [crop] jitter of a
    48-pixel flip crop of the 64-pixel input."""
    text = jt1.V1_CFG
    if case == "flip-crop":
        text = text.replace("width=64\nheight=64", "width=80\nheight=80") \
            .replace("crop_width=64\n", "crop_width=64\nflip=1\n")
    _, cfg = _v1(tmp_path, text)
    jcfg = to_jax_config(cfg)
    kw = dict(learning_rate=1e-3, grad_accum=2 if case == "accum2" else 1)
    params = dw.random_params(cfg.layers, np.random.default_rng(0),
                              scale=0.05)
    jstate = jloop.init_state(params, jloop.TrainConfig(**kw))
    jstep = jloop.make_train_step(jcfg, jloop.TrainConfig(**kw))
    tcfg = tloop.TrainConfig(**kw)
    state = tloop.init_state(cfg, params, tcfg, device="cpu")
    rng = np.random.default_rng(5)
    for i in range(2):
        boxes, classes = _scene(rng, 4, 3, 4)
        batch = ttargets.encode_batch_for(cfg, boxes, classes)
        batch["images"] = rng.uniform(
            0, 1, (4, cfg.input_h, cfg.input_w, 3)).astype(np.float32)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        m = tloop.train_step(state, {k: torch.from_numpy(v)
                                     for k, v in batch.items()},
                             mcfg=cfg, tcfg=tcfg)
        for k in jm:
            assert m[k].item() == pytest.approx(float(jm[k]), rel=1e-4), k
    for p, q in zip(state.net.to_numpy(), jstate["params"], strict=True):
        assert set(p) == set(q)
        for k in p:
            want = np.asarray(q[k], np.float64)
            np.testing.assert_allclose(p[k], want, rtol=0,
                                       atol=STEP_TOL * np.abs(want).max())


def test_recall_objectness_matches_jax(tmp_path):
    """recall's class-free decode of a [detection] head: the boxes and
    the per-box confidence as objectness, within 1e-6 of the JAX
    package's on the same flat head values."""
    from yolo_tpu.eval import recall as jrecall
    from yolo_tpu_torch.eval import recall as trecall

    _, cfg = _v1(tmp_path)
    flat = np.random.default_rng(8).normal(
        size=(3, 1, 1, 208)).astype(np.float32)
    jb, jo = jrecall.decode_boxes_objectness(to_jax_config(cfg),
                                             jnp.asarray(flat))
    tb, to = trecall.decode_boxes_objectness(cfg, torch.from_numpy(flat))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
