"""The port's yolov3/v4 training path (the [yolo] targets, yolo_loss,
DarknetTrain's new layers, train_step's head dispatch, train_batches'
model_cfg) against the JAX package on the CPU, on the same seeded numpy
inputs.

Tolerances:
  * targets: exactly equal.
  * yolo_loss, fp32: value and parts to a relative 1e-5 of JAX's,
    gradients to 1e-4 of each head's largest gradient (against
    jax.grad, and against the loop delta oracle of tests/delta_oracle.py
    in float64 for the base case).
  * train-mode forward, fp32: head logits and BN statistics to 1e-5 of
    each tensor's scale (the convs sum in other orders).
  * three SGD steps of a narrow yolov4-style net (mish, CSP, SPP,
    ciou, assign_iou_thresh 0.213): params within 1e-5 and BN statistics
    within 1e-6 of each tensor's scale, loss parts to a relative 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.delta_oracle import yolo_delta_np
from tests.test_torch_yolo import NARROW_V4, YOLO_VARIANTS
from tests.test_yolov3 import MICRO_V3, MICRO_V3_STRIDES, _random_v3_scene
from tests.torch_port import to_jax_config
from yolo_tpu.configs import get_variant as jax_get_variant
from yolo_tpu.data import augment as jaug
from yolo_tpu.data import pipeline as jpipe
from yolo_tpu.data import targets as jtgt
from yolo_tpu.models import graph as jgraph
from yolo_tpu.train import loop as jloop
from yolo_tpu.train import loss as jloss
from yolo_tpu_torch.configs import VOC_NAMES, get_variant
from yolo_tpu_torch.configs.variants import LAYER_BUILDERS
from yolo_tpu_torch.data import augment as taug
from yolo_tpu_torch.data import pipeline as tpipe
from yolo_tpu_torch.data import targets as ttgt
from yolo_tpu_torch.data.synthetic import write_voc_scenes
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import graph as tgraph
from yolo_tpu_torch.train import loop as tloop
from yolo_tpu_torch.train import loss as tloss

torch.set_num_threads(1)

def _scale_close(got, want, frac):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale)


# --- configs -------------------------------------------------------------------

@pytest.mark.parametrize("variant", YOLO_VARIANTS)
def test_yolo_training_fields_match_jax(variant):
    """The [yolo] keys and the loss config built from them, as the JAX
    package's train command builds it."""
    cfg, jcfg = get_variant(variant), jax_get_variant(variant)
    assert cfg.head_kind == jcfg.head_kind == "yolo"
    want = jloss.YoloLossConfig(
        ignore_thresh=jcfg.ignore_thresh, iou_loss=jcfg.iou_loss,
        iou_normalizer=jcfg.iou_normalizer,
        cls_normalizer=jcfg.cls_normalizer,
        obj_normalizer=jcfg.obj_normalizer, focal_loss=jcfg.focal_loss,
        truth_thresh=jcfg.truth_thresh)
    assert dataclasses.asdict(tloss.yolo_loss_config(cfg)) == \
        dataclasses.asdict(want)
    assert [dataclasses.asdict(h) for h in cfg.yolo_heads] == \
        [dataclasses.asdict(h) for h in jcfg.yolo_heads]


@pytest.mark.parametrize("variant", sorted(LAYER_BUILDERS))
def test_layer_builders_take_a_class_count(variant):
    """A VOC fine-tune of a COCO variant: the same builder with
    3 * (5 + 20) head filters, the weights file sized accordingly."""
    cfg = get_variant(variant)
    voc = dataclasses.replace(cfg, layers=LAYER_BUILDERS[variant](75),
                              class_names=VOC_NAMES)
    heads = [voc.layers[i - 1] for i, l in enumerate(voc.layers)
             if type(l).__name__ == "YoloHead"]
    assert [h.filters for h in heads] == [75] * len(cfg.yolo_heads)
    assert dw.expected_bytes(voc.layers) < dw.expected_bytes(cfg.layers)


# --- targets -------------------------------------------------------------------

@pytest.mark.parametrize("assign", [1.0, 0.213])
@pytest.mark.parametrize("variant", ["yolov3", "yolov3-tiny", "yolov4"])
def test_encode_yolo_matches_jax(variant, assign):
    """encode_batch_for equal to JAX's (multi-head best-anchor
    assignment, shared anchors, the iou_thresh multi-positive pass)."""
    cfg = dataclasses.replace(get_variant(variant, input_size=128),
                              assign_iou_thresh=assign)
    jcfg = to_jax_config(cfg)
    rng = np.random.default_rng(3)
    boxes, classes = [], []
    for _ in range(4):
        g = int(rng.integers(1, 12))
        boxes.append(np.stack([
            rng.uniform(0.05, 0.95, g), rng.uniform(0.05, 0.95, g),
            rng.uniform(0.02, 0.9, g), rng.uniform(0.02, 0.9, g)], -1))
        classes.append(rng.integers(0, 80, g))
    boxes[0][0, 2] = 0.0   # a degenerate box is skipped
    got = ttgt.encode_batch_for(cfg, boxes, classes)
    want = jtgt.encode_batch_for(jcfg, boxes, classes)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ttgt._head_strides(cfg.layers) == jtgt._head_strides(jcfg)
    n_obj = sum(got[f"obj_mask_{h}"].sum()
                for h in range(len(cfg.yolo_heads)))
    assert n_obj >= 4


# --- yolo_loss -----------------------------------------------------------------

def _v3_setup(seed, b=2):
    """MICRO_V3 (2 heads, 4 classes, net 64) head logits and targets."""
    rng = np.random.default_rng(seed)
    boxes, classes = _random_v3_scene(rng, b)
    targets = jtgt.encode_batch_for(MICRO_V3, boxes, classes)
    heads = [rng.normal(size=(b, 64 // st, 64 // st, 2 * 9)).astype(
        np.float32) for st in MICRO_V3_STRIDES]
    return heads, targets


LOSS_CASES = {
    "mse": (dict(), dict()),
    "mse_scale_xy": (dict(), dict(scales=[1.1, 1.05])),
    "iou": (dict(iou_loss="iou"), dict()),
    "giou": (dict(iou_loss="giou"), dict()),
    "diou": (dict(iou_loss="diou"), dict(scales=[1.2, 1.05])),
    "ciou": (dict(iou_loss="ciou", iou_normalizer=0.07),
             dict(scales=[1.1, 1.05])),
    "max_delta_smooth_split_normalizers": (
        dict(label_smooth_eps=0.1, max_delta=0.005, obj_normalizer=0.8,
             cls_normalizer=0.6), dict()),
    "per_head_overrides_classic_normalizer": (
        dict(max_delta=0.004, label_smooth_eps=0.05, cls_normalizer=0.5),
        dict(max_deltas=[0.0, None], smooth_eps=[None, 0.2])),
    "focal": (dict(focal_loss=True), dict()),
    "truth_thresh_mse": (dict(truth_thresh=0.05, ignore_thresh=0.9),
                         dict(scales=[1.1, 1.05])),
    "truth_thresh_ciou": (dict(truth_thresh=0.05, ignore_thresh=0.9,
                               iou_loss="ciou"), dict()),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_yolo_loss_and_gradient_match_jax(case):
    ckw, kw = LOSS_CASES[case]
    heads, targets = _v3_setup(sum(map(ord, case)) % 1000)
    masks = [h.mask for h in MICRO_V3.yolo_heads]
    anchors = MICRO_V3.anchors
    jcfg = jloss.YoloLossConfig(**ckw)
    tj = {k: jnp.asarray(v) for k, v in targets.items()}

    def jf(hs):
        return jloss.yolo_loss(hs, tj, anchors, masks, 4, 64, jcfg, **kw)

    (jtotal, jparts), jgrads = jax.value_and_grad(jf, has_aux=True)(
        tuple(jnp.asarray(h) for h in heads))
    th = [torch.from_numpy(h).requires_grad_() for h in heads]
    total, parts = tloss.yolo_loss(
        th, {k: torch.from_numpy(v) for k, v in targets.items()}, anchors,
        masks, 4, 64, tloss.YoloLossConfig(**ckw), **kw)
    total.backward()
    assert set(parts) == set(jparts)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=1e-5, atol=1e-7)
    for g, w in zip(th, jgrads, strict=True):
        _scale_close(g.grad.numpy(), np.asarray(w), 1e-4)
    if case.startswith("truth_thresh"):
        base = tloss.yolo_loss(
            [torch.from_numpy(h) for h in heads],
            {k: torch.from_numpy(v) for k, v in targets.items()}, anchors,
            masks, 4, 64, tloss.YoloLossConfig(
                **{**ckw, "truth_thresh": 1.0}), **kw)[1]
        assert float(parts["obj"]) > float(base["obj"]) + 1e-6


def test_yolo_loss_gradient_matches_the_delta_oracle():
    """Against darknet's deltas, transcribed loop by loop in float64
    (tests/delta_oracle.py)."""
    heads, targets = _v3_setup(4)
    masks = [h.mask for h in MICRO_V3.yolo_heads]
    th = [torch.from_numpy(h).double().requires_grad_() for h in heads]
    total, _ = tloss.yolo_loss(
        th, {k: torch.from_numpy(v).double() if v.dtype == np.float32
             else torch.from_numpy(v) for k, v in targets.items()},
        MICRO_V3.anchors, masks, 4, 64, tloss.YoloLossConfig())
    total.backward()
    want = yolo_delta_np(heads, targets, MICRO_V3.anchors, masks, 4, 64,
                         jloss.YoloLossConfig())
    for g, w in zip(th, want, strict=True):
        _scale_close(g.grad.numpy(), w, 1e-6)


def test_clip_grad_is_identity_forward_and_clamps_backward():
    x = torch.tensor([-3.0, -0.1, 0.05, 2.0], requires_grad=True)
    y = tloss._clip_grad(x, 0.5)
    assert torch.equal(y, x)
    (y * torch.tensor([10.0, -0.2, 0.3, -7.0])).sum().backward()
    assert torch.equal(x.grad, torch.tensor([0.5, -0.2, 0.3, -0.5]))


def test_ciou_alpha_carries_no_gradient():
    """CIoU's alpha is a constant of the gradient (JAX stop_gradient)."""
    p = torch.tensor([[0.5, 0.5, 0.3, 0.2]], dtype=torch.float64,
                     requires_grad=True)
    g = torch.tensor([[0.57, 0.43, 0.22, 0.41]], dtype=torch.float64)
    tloss._diag_iou_variant(p, g, "ciou").sum().backward()
    jg = jax.grad(lambda q: jloss._diag_iou_variant(
        q, jnp.asarray(g.numpy(), jnp.float32), "ciou").sum())(
            jnp.asarray(p.detach().numpy(), jnp.float32))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)


# --- train mode -------------------------------------------------------------------

def _params(cfg, seed=0):
    """random_params with He-scaled kernels, residual branches scaled as
    the seeded detector weights do."""
    params = dw.random_params(cfg.layers, np.random.default_rng(seed))
    for p in params:
        k = p["kernel"]
        p["kernel"] = (k * (np.sqrt(2.0 / np.prod(k.shape[:3])) / 0.1)) \
            .astype(np.float32)
    return params


def _batch(cfg, seed, b=4):
    rng = np.random.default_rng(seed)
    boxes, classes = _random_v3_scene(rng, b)
    enc = jtgt.encode_batch_for(to_jax_config(cfg), boxes, classes)
    enc["images"] = rng.uniform(
        0, 1, (b, cfg.input_size, cfg.input_size, 3)).astype(np.float32)
    return enc


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_yolo_train_forward_matches_jax(dtype):
    """DarknetTrain on NARROW_V4 (mish after batch-statistics BN,
    shortcut, grouped route, SPP, upsample): the heads' logits and the
    new rolling statistics. bf16: the convs emit bf16 on both sides, so
    a sum near a rounding boundary may round the other way, and BN
    amplifies it. As test_torch_train.py holds the bf16 yolov2 forward
    (2e-2 there): every tensor lies within 4e-2 of the fp32 scale of
    JAX's bf16 (this deeper mish net's head: 2.3e-2, where JAX's own
    bf16 lies 3.6e-2 from its fp32), and closer than JAX's own bf16
    lies to its fp32."""
    cfg = NARROW_V4
    params = _params(cfg)
    x = _batch(cfg, 3)["images"]
    tdt, jdt = {"fp32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]

    def jax_forward(dt):
        return jgraph.apply_layers(
            to_jax_config(cfg).layers, jgraph.params_to_jax(params),
            jnp.asarray(x), eps=cfg.bn_eps, train=True, compute_dtype=dt)

    jlogits, jstats = jax_forward(jdt)
    j32, j32stats = jax_forward(jnp.float32)
    net = tgraph.DarknetTrain(cfg.layers, params, device="cpu")
    with torch.no_grad():
        logits, stats = net(torch.from_numpy(x), compute_dtype=tdt)
    assert len(logits) == len(jlogits) == 3
    assert set(stats) == set(jstats)
    pairs = [(g.numpy(), np.asarray(w), np.asarray(r))
             for g, w, r in zip(logits, jlogits, j32)]
    pairs += [(stats[i][k].numpy(), np.asarray(jstats[i][k]),
               np.asarray(j32stats[i][k]))
              for i in stats for k in ("mean", "var")]
    for got, want, ref in pairs:
        if dtype == "fp32":
            _scale_close(got, want, 1e-5)
            continue
        err = float(np.abs(got - want).max())
        assert err <= 4e-2 * float(np.abs(ref).max())
        assert err <= float(np.abs(want - ref).max())


def test_yolo_train_steps_match_jax():
    """Three SGD steps of NARROW_V4 through train_step (momentum,
    kernel-only decay, burn-in ramp; ciou with iou_normalizer 0.07,
    assign_iou_thresh 0.213) against JAX's."""
    cfg = NARROW_V4
    jcfg = to_jax_config(cfg)
    params = _params(cfg, seed=1)
    kw = dict(learning_rate=1e-3, momentum=0.9, weight_decay=5e-4,
              burn_in_steps=2)
    jyolo = jloss.YoloLossConfig(ignore_thresh=cfg.ignore_thresh,
                                 iou_loss=cfg.iou_loss,
                                 iou_normalizer=cfg.iou_normalizer)
    jtcfg = jloop.TrainConfig(**kw, yolo_loss=jyolo)
    jstate = jloop.init_state(params, jtcfg)
    jstep = jloop.make_train_step(jcfg, jtcfg)
    tcfg = tloop.TrainConfig(**kw, yolo_loss=tloss.yolo_loss_config(cfg))
    state = tloop.init_state(cfg, params, tcfg, device="cpu")
    step = tloop.make_train_step(cfg, tcfg)
    for i in range(3):
        batch = _batch(cfg, 100 + i)
        assert batch["obj_mask_0"].sum() + batch["obj_mask_1"].sum() > 0
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m) == set(jm) == {"loss", "coord", "obj", "noobj",
                                     "class"}
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-7)
        for p, q in zip(state.net.to_numpy(), jstate["params"],
                        strict=True):
            assert set(p) == set(q)
            for key in p:
                frac = 1e-6 if key in ("mean", "var") else 1e-5
                _scale_close(p[key], np.asarray(q[key]), frac)
    assert state.step == int(jstate["step"]) == 3


def test_objectness_smooth_training_raises():
    cfg = dataclasses.replace(NARROW_V4, objectness_smooth=True)
    state = tloop.init_state(cfg, _params(cfg), tloop.TrainConfig(),
                             device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0, 2).items()}
    with pytest.raises(NotImplementedError, match="objectness_smooth"):
        tloop.make_train_step(cfg, tloop.TrainConfig())(state, batch)


# --- the data pipeline --------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_voc_scenes(str(tmp_path_factory.mktemp("voc")),
                            [(75, 100), (100, 67), (96, 128)] * 2,
                            np.random.default_rng(9),
                            filters=(0, 1, 2), difficult=0.2)


def test_train_batches_encode_for_a_yolo_model_as_jax(dataset):
    """train_batches(model_cfg=yolov3 with a VOC head) against JAX's,
    jitter and flip on: images within 1e-5, targets exactly equal."""
    cfg = dataclasses.replace(
        get_variant("yolov3", input_size=96),
        layers=LAYER_BUILDERS["yolov3"](75), class_names=VOC_NAMES)
    kw = dict(class_names=VOC_NAMES, anchors=cfg.anchors, num_classes=20,
              net_size=96, batch_size=3, workers=2)
    # jitter and flip; the HSV distortion is held against cv2's in
    # tests/test_torch_data.py
    aug = dict(jitter=0.3, hue=0.0, saturation=1.0, exposure=1.0)
    got = list(tpipe.train_batches(
        dataset, rng=np.random.default_rng(1), model_cfg=cfg,
        augment_cfg=taug.AugmentConfig(**aug), **kw))
    want = list(jpipe.train_batches(
        dataset, rng=np.random.default_rng(1), model_cfg=to_jax_config(cfg),
        augment_cfg=jaug.AugmentConfig(**aug), **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert "obj_mask_2" in g and "tbox_0" in g
        for k in g:
            if k == "images":
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("key", ["mosaic", "mixup"])
def test_train_batches_still_raise_for_mosaic_and_mixup(dataset, key):
    """Mosaic and mixup, once refused, now give JAX's yolo targets
    exactly on the same seed (a narrow yolov4's three heads), the images
    exactly with mosaic and within the letterbox's 1e-5 with mixup (HSV
    off: its one-level difference is held in tests/test_torch_data.py)."""
    kw = dict(class_names=VOC_NAMES, anchors=NARROW_V4.anchors,
              num_classes=20, net_size=64, batch_size=2, workers=2)
    aug = dict(jitter=0.3, hue=0.0, saturation=1.0, exposure=1.0,
               **{key: True})
    got = list(tpipe.train_batches(
        dataset, rng=np.random.default_rng(0), model_cfg=NARROW_V4,
        augment_cfg=taug.AugmentConfig(**aug), **kw))
    want = list(jpipe.train_batches(
        dataset, rng=np.random.default_rng(0),
        model_cfg=to_jax_config(NARROW_V4),
        augment_cfg=jaug.AugmentConfig(**aug), **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) and "obj_mask_2" in g
        for k in g:
            if k == "images":
                atol = 0.0 if key == "mosaic" else 1e-5
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# --- eval ------------------------------------------------------------------------

def test_yolo_eval_matches_jax(dataset):
    """collect_detections (the reference [yolo] head at the PR-curve
    threshold) and quick_map of a 20-class yolov4-tiny at 96 against the
    JAX package's, as tests/test_torch_eval.py holds YOLOv2: classes
    exact, scores 1e-5, pixel boxes 1e-3, mAP 1e-4."""
    from yolo_tpu.eval import runner as jrunner
    from yolo_tpu_torch.eval import runner as trunner

    cfg = dataclasses.replace(
        get_variant("yolov4-tiny", input_size=96),
        layers=LAYER_BUILDERS["yolov4-tiny"](75), class_names=VOC_NAMES)
    jcfg = to_jax_config(cfg)
    params = dw.synthetic_detector_params(cfg, 0)
    folded = tgraph.fold_params(cfg.layers, params, cfg.bn_eps)
    want = jrunner.collect_detections(jcfg, jgraph.params_to_jax(folded),
                                      dataset, batch=4)
    got = trunner.collect_detections(cfg, folded, dataset, batch=4,
                                     device="cpu")
    assert set(got) == set(want)
    n = 0
    for i in got:
        assert len(got[i]) == len(want[i])
        n += len(got[i])
        for g, w in zip(got[i], want[i]):
            assert g[0] == w[0]
            np.testing.assert_allclose(g[1], w[1], rtol=0, atol=1e-5)
            np.testing.assert_allclose(g[2:], w[2:], rtol=0, atol=1e-3)
    assert n >= 100
    got_map = trunner.quick_map(cfg, params, dataset, batch=4, device="cpu")
    want_map = jrunner.quick_map(jcfg, jgraph.params_to_jax(params),
                                 dataset, batch=4)
    assert abs(got_map - want_map) <= 1e-4
