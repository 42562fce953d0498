"""Classifier training and the YOLO9000 tree region loss in the port
against the JAX package, on the CPU: train/loss.py (classifier_loss flat,
tree and with a temperature; _tree_class_sq; region_loss's tree branch),
the classifier step of train/loop.py (and darknet's dropout),
data/imagefolder.py and `train --imagefolder`.

Losses: values within 1e-6 of the JAX package's (relative) and gradients
within 1e-6 of the gradient's scale, from the same numpy logits. A train
step: the updated params within 1e-5 of the JAX step's scale, fp32. The
JAX package's own classifier-training tests (tests/test_classifier_train
.py) run again with the port's command line or imagefolder module in the
JAX one's place."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_classifier_train as jct
import tests.test_tree as jtt
import yolo_tpu
import yolo_tpu.cli  # noqa: F401  (the attribute the tests swap)
import yolo_tpu.data.augment as jaugment
import yolo_tpu.data.imagefolder as jimagefolder
from tests.torch_port import PortCli, rerun_jax_test, to_jax_config
from yolo_tpu.configs import tree as jtree
from yolo_tpu.data import targets as jtargets
from yolo_tpu.train import loop as jloop
from yolo_tpu.train import loss as jloss
import yolo_tpu_torch.data.augment as taugment
import yolo_tpu_torch.data.imagefolder as timagefolder
from yolo_tpu_torch.configs import (AvgPool, Connected, Conv, Dropout,
                                    MaxPool, ModelConfig, SoftmaxHead)
from yolo_tpu_torch.configs import tree as ttree
from yolo_tpu_torch.data.synthetic import write_tree
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import graph as tgraph
from yolo_tpu_torch.train import loop as tloop
from yolo_tpu_torch.train import loss as tloss

torch.set_num_threads(1)


def _trees(tmp_path):
    (tmp_path / "micro.tree").write_text(jtt.TREE_TEXT)
    write_tree(str(tmp_path / "g.tree"), 200, seed=4)
    return [(ttree.parse_tree(str(p)), jtree.parse_tree(str(p)))
            for p in (tmp_path / "micro.tree", tmp_path / "g.tree")]


def _close(got, want, rel=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


# --- losses ---------------------------------------------------------------------

@pytest.mark.parametrize("which", ["flat", "micro", "g200"])
@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_classifier_loss_matches_jax(which, temperature, tmp_path):
    """classifier_loss (flat, a tree with leaf and internal-node labels,
    a temperature): the CE and top1 within 1e-6, the gradient on the
    logits within 1e-6 of its scale (darknet's straight-through 1/T)."""
    tree = jt = None
    c = 7
    if which != "flat":
        tree, jt = _trees(tmp_path)[0 if which == "micro" else 1]
        c = tree.n_nodes
    rng = np.random.default_rng(len(which))
    logits = rng.normal(0, 2, (5, c)).astype(np.float32)
    labels = rng.integers(0, c, 5).astype(np.int32)
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss, parts = tloss.classifier_loss(lt, torch.from_numpy(labels),
                                        tree=tree, temperature=temperature)
    loss.backward()

    def f(l):
        return jloss.classifier_loss(l, jnp.asarray(labels), tree=jt,
                                     temperature=temperature)

    (jl, jparts), jg = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(logits))
    _close(loss.item(), float(jl))
    assert parts["top1"].item() == pytest.approx(float(jparts["top1"]))
    _close(lt.grad.numpy(), np.asarray(jg))


def test_classifier_loss_gradient_is_darknet_delta():
    """TestTemperature.test_training_gradient_is_darknet_delta_no_1_over_T
    on the port: (p - onehot) / B with p at l / T, no 1/T factor."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(0, 1, (3, 4)).astype(np.float32)
                              ).requires_grad_(True)
    labels = np.array([0, 2, 1])
    tloss.classifier_loss(logits, torch.from_numpy(labels),
                          temperature=2.0)[0].backward()
    z = logits.detach().numpy() / 2.0
    p = np.exp(z - z.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(logits.grad.numpy(),
                               (p - np.eye(4)[labels]) / 3, rtol=1e-5,
                               atol=1e-7)


def test_internal_node_labels_score_on_ancestry(tmp_path):
    """TestHierarchicalAccuracy on the port: an internal-node label
    counts when the predicted leaf descends from it."""
    tree, _ = _trees(tmp_path)[0]
    logits = torch.full((2, 8), -5.0)
    logits[:, [1, 3, 7]] = 8.0
    _, parts = tloss.classifier_loss(logits, torch.tensor([3, 4]), tree=tree)
    assert parts["top1"].item() == pytest.approx(0.5)


@pytest.mark.parametrize("which", [0, 1])
def test_tree_class_sq_matches_jax(which, tmp_path):
    tree, jt = _trees(tmp_path)[which]
    rng = np.random.default_rng(which)
    logits = rng.normal(0, 2, (2, 3, 4, tree.n_nodes)).astype(np.float32)
    tcls = rng.integers(0, tree.n_nodes, (2, 3, 4)).astype(np.int32)
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = tloss._tree_class_sq(lt, torch.from_numpy(tcls), tree)
    got.sum().backward()
    want, jg = jax.value_and_grad(lambda l: jloss._tree_class_sq(
        l, jnp.asarray(tcls), jt).sum())(jnp.asarray(logits))
    _close(got.sum().item(), float(want))
    _close(got.detach().numpy(), np.asarray(
        jloss._tree_class_sq(jnp.asarray(logits), jnp.asarray(tcls), jt)))
    _close(lt.grad.numpy(), np.asarray(jg))


ANCHORS = ((1.0, 1.5), (2.5, 2.0))


def _region_targets(tree, seed, s=4):
    """encode_batch targets (the JAX package's encoder) of two images
    with GT boxes labelled with tree nodes."""
    rng = np.random.default_rng(seed)
    boxes, classes = [], []
    for _ in range(2):
        n = 3
        xy = rng.uniform(0.2, 0.8, (n, 2))
        wh = rng.uniform(0.1, 0.4, (n, 2))
        boxes.append(np.concatenate([xy, wh], -1).astype(np.float32))
        classes.append(rng.integers(0, tree.n_nodes, n).astype(np.int32))
    return jtargets.encode_batch(boxes, classes, grid=s, anchors=ANCHORS,
                                 num_classes=tree.n_nodes)


@pytest.mark.parametrize("which", [0, 1])
def test_region_loss_with_a_tree_matches_jax(which, tmp_path):
    """region_loss(tree=): every part within 1e-6 (relative) of the JAX
    package's and the gradient on the logits within 1e-6 of its scale."""
    tree, jt = _trees(tmp_path)[which]
    c = tree.n_nodes
    targets = _region_targets(tree, which)
    rng = np.random.default_rng(10 + which)
    logits = rng.normal(0, 1, (2, 4, 4, len(ANCHORS) * (5 + c))).astype(
        np.float32)
    lt = torch.from_numpy(logits).requires_grad_(True)
    cfg = tloss.LossConfig()
    total, parts = tloss.region_loss(
        lt, {k: torch.from_numpy(np.asarray(v)) for k, v in
             targets.items()}, ANCHORS, c, cfg, 0, tree=tree)
    total.backward()

    def f(l):
        return jloss.region_loss(l, {k: jnp.asarray(v) for k, v in
                                     targets.items()}, ANCHORS, c,
                                 jloss.LossConfig(), jnp.asarray(0),
                                 tree=jt)

    (jt_total, jparts), jg = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(logits))
    _close(total.item(), float(jt_total))
    for k in jparts:
        _close(parts[k].item(), float(jparts[k]))
    assert parts["class"].item() > 0
    _close(lt.grad.numpy(), np.asarray(jg))


# --- the train step -------------------------------------------------------------

def _cls_cfg(tree=None, dropout=None, temperature=1.0):
    c = tree.n_nodes if tree is not None else 5
    layers = (Conv(8), MaxPool(), Conv(16), Conv(12, size=1, bn=False,
                                                 act="linear"), AvgPool())
    if dropout is not None:
        layers += (Dropout(dropout),)
    layers += (Connected(c), SoftmaxHead(tree=tree, temperature=temperature))
    return ModelConfig(name="cls", layers=layers, anchors=(),
                       class_names=(tree.names if tree is not None
                                    else tuple("abcde")),
                       input_size=32)


@pytest.mark.parametrize("kind", ["flat", "tree", "temperature", "accum"])
def test_classifier_train_step_matches_jax(kind, tmp_path):
    """Two train steps (SGD with momentum and decay; "accum": two
    sub-batches) of a small classifier from the same params and batch:
    the loss parts each step within 1e-5, and the params, rolling
    statistics and momentum after them within 1e-5 of the JAX step's
    scale, fp32. A [dropout] of p 0 keeps both packages' forward
    deterministic."""
    tree = jt = None
    if kind == "tree":
        tree, jt = _trees(tmp_path)[0]
    cfg = _cls_cfg(tree, dropout=0.0,
                   temperature=2.0 if kind == "temperature" else 1.0)
    jcfg = to_jax_config(cfg)
    params = dw.random_params(cfg.layers, np.random.default_rng(1),
                              scale=0.2)
    kw = dict(learning_rate=0.05, momentum=0.9, weight_decay=5e-4,
              grad_accum=2 if kind == "accum" else 1)
    tcfg, jtcfg = tloop.TrainConfig(**kw), jloop.TrainConfig(**kw)
    state = tloop.init_state(cfg, params, tcfg, device="cpu")
    jstate = jloop.init_state(params, jtcfg)
    rng = np.random.default_rng(2)
    step = tloop.make_train_step(cfg, tcfg)
    for _ in range(2):
        x = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, cfg.num_classes, 4).astype(np.int32)
        m = step(state, {"images": torch.from_numpy(x),
                         "labels": torch.from_numpy(y)})
        jstate, jm = jloop.train_step(
            jstate, {"images": jnp.asarray(x), "labels": jnp.asarray(y)},
            mcfg=jcfg, tcfg=jtcfg)
        for k in jm:
            _close(m[k].item(), float(jm[k]), 1e-5)
    for got, want in zip(state.net.to_numpy(), jstate["params"]):
        assert set(got) == set(want)
        for k in got:
            _close(got[k], want[k], 1e-5)


def test_dropout_in_training(tmp_path):
    """darknet's inverted dropout in DarknetTrain: the JAX package's
    masks (apply_layers(train=True) on the same key, element for
    element), about p of the activations zeroed, survivors scaled by
    1/(1-p), a new mask each key, and the identity without a key
    (inference)."""
    from yolo_tpu.models import graph as jgraph

    cfg = ModelConfig(name="d", layers=(Conv(16, size=1, bn=False,
                                             act="linear"), Dropout(0.3)),
                      anchors=(), class_names=("a",), input_size=32)
    params = dw.random_params(cfg.layers, np.random.default_rng(0))
    net = tgraph.DarknetTrain(cfg.layers, params, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0.5, 1, (2, 32, 32, 3)).astype(np.float32))
    base, _ = net(x)
    keys = [jax.random.fold_in(jax.random.PRNGKey(0), s) for s in (3, 4)]
    a, _ = net(x, dropout_key=np.asarray(keys[0]))
    b, _ = net(x, dropout_key=np.asarray(keys[0]))
    c, _ = net(x, dropout_key=np.asarray(keys[1]))
    assert torch.equal(a, b) and not torch.equal(a, c)
    jlayers = to_jax_config(cfg).layers
    for got, key in ((a, keys[0]), (c, keys[1])):
        want, _ = jgraph.apply_layers(jlayers, jgraph.params_to_jax(params),
                                      jnp.asarray(x.numpy()), train=True,
                                      dropout_rng=key)
        np.testing.assert_array_equal(got.detach().numpy() == 0,
                                      np.asarray(want) == 0)
    zero = (a == 0) & (base != 0)
    assert abs(zero.float().mean().item() - 0.3) < 0.02
    kept = ~zero
    torch.testing.assert_close(a[kept], base[kept] / 0.7, rtol=1e-6,
                               atol=0)
    assert torch.equal(net(x, dropout_key=None)[0], base)


def test_dropout_classifier_trains(tmp_path):
    """A classifier with [dropout] 0.5 trains: the step draws fresh masks
    (the loss of one batch moves between steps while the params do)
    and the CE falls over 30 steps on a separable colour task."""
    cfg = _cls_cfg(dropout=0.5)
    params = dw.random_params(cfg.layers, np.random.default_rng(0),
                              scale=0.2)
    tcfg = tloop.TrainConfig(learning_rate=0.05, optimizer="adam",
                             weight_decay=0.0)
    state = tloop.init_state(cfg, params, tcfg, device="cpu")
    step = tloop.make_train_step(cfg, tcfg)
    rng = np.random.default_rng(3)
    y = rng.integers(0, 3, 12)
    x = np.zeros((12, 32, 32, 3), np.float32)
    x[np.arange(12), :, :, y] = 0.9
    batch = {"images": torch.from_numpy(x),
             "labels": torch.from_numpy(y.astype(np.int32))}
    ces = [step(state, batch)["ce"].item() for _ in range(30)]
    assert ces[-1] < 0.5 * ces[0]


# --- imagefolder -----------------------------------------------------------------

def _folder(tmp_path, n=(5, 2), size=(20, 24)):
    import cv2

    rng = np.random.default_rng(0)
    for cls, k in zip(("red", "green"), n):
        os.makedirs(tmp_path / "d" / cls, exist_ok=True)
        for i in range(k):
            cv2.imwrite(str(tmp_path / "d" / cls / f"{i}.png"),
                        rng.integers(30, 225, size + (3,), np.uint8))
    return str(tmp_path / "d")


@pytest.mark.parametrize("augment", [False, True])
def test_classifier_train_batches_match_jax(augment, tmp_path):
    """list_imagefolder equals JAX's; classifier_train_batches gives its
    labels exactly and its images within 1e-6 (the preprocess's resize),
    with the HSV distortion too where this host's cv2 converts HSV -> RGB
    in the AVX2 build data/augment.py reproduces (else within one grey
    level on at most 0.5% of the values), over three epochs with
    wrapping batches, and from start_step alike."""
    from tests.torch_port import cv2_hsv_is_avx2

    root = _folder(tmp_path)
    samples = timagefolder.list_imagefolder(root, ("red", "green"))
    assert samples == jimagefolder.list_imagefolder(root, ("red", "green"))
    kw = dict(epochs=3, seed=7)
    taug = jaug = None
    if augment:
        taug = taugment.AugmentConfig(hue=0.1, saturation=1.5,
                                      exposure=1.5)
        jaug = jaugment.AugmentConfig(hue=0.1, saturation=1.5, exposure=1.5)
    for start in (0, 3):
        got = list(timagefolder.classifier_train_batches(
            samples, 4, 32, start_step=start, augment_cfg=taug, **kw))
        want = list(jimagefolder.classifier_train_batches(
            samples, 4, 32, start_step=start, augment_cfg=jaug, **kw))
        assert len(got) == len(want) == 6 - start
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["labels"], w["labels"])
            d = np.abs(g["images"] - w["images"])
            if augment and not cv2_hsv_is_avx2():
                assert d.max() <= 1 / 255 + 1e-6
                assert (d > 1e-6).mean() <= 5e-3
            else:
                assert d.max() <= 1e-6


def test_classifier_geometry_augment_raises(tmp_path):
    """The classifier geometry crop, once refused here, now runs: on a
    square net the batches equal JAX's (the crop byte for byte, then HSV
    byte for byte on the AVX2 build, else within one level on at most
    0.5% of the values, as above); on a rectangular net both packages
    raise the same ValueError."""
    from tests.torch_port import cv2_hsv_is_avx2

    samples = timagefolder.list_imagefolder(_folder(tmp_path), ("red",
                                                                "green"))
    kw = dict(angle=7.0, aspect=0.75, min_crop=28, max_crop=48)
    for hsv in (dict(hue=0.0, saturation=1.0, exposure=1.0),
                dict(hue=0.1, saturation=1.5, exposure=1.5)):
        got = list(timagefolder.classifier_train_batches(
            samples, 4, 32, epochs=2, seed=5,
            augment_cfg=taugment.AugmentConfig(**kw, **hsv)))
        want = list(jimagefolder.classifier_train_batches(
            samples, 4, 32, epochs=2, seed=5,
            augment_cfg=jaugment.AugmentConfig(**kw, **hsv)))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["labels"], w["labels"])
            d = np.abs(g["images"] - w["images"])
            if hsv["hue"] == 0.0 or cv2_hsv_is_avx2():
                assert d.max() == 0.0
            else:
                assert d.max() <= 1 / 255 + 1e-6
                assert (d > 1e-6).mean() <= 5e-3
    for mod, aug in ((timagefolder, taugment), (jimagefolder, jaugment)):
        with pytest.raises(ValueError, match="rectangular"):
            next(mod.classifier_train_batches(
                samples, 4, (32, 48),
                augment_cfg=aug.AugmentConfig(angle=10)))


@pytest.mark.parametrize("name", [
    "TestImagefolder.test_batches_wrap_and_shuffle",
    "TestImagefolder.test_unknown_class_dir_rejected",
    "TestResumeDataPosition.test_start_step_resumes_exact_stream",
    "TestAugment.test_hsv_augment_position_independent"])
def test_jax_imagefolder_tests_hold_for_the_port(name, tmp_path,
                                                 monkeypatch):
    """tests/test_classifier_train.py's imagefolder tests with the port's
    list_imagefolder, classifier_train_batches and AugmentConfig."""
    for fn in ("list_imagefolder", "classifier_train_batches"):
        monkeypatch.setattr(jimagefolder, fn, getattr(timagefolder, fn))
    monkeypatch.setattr(jaugment, "AugmentConfig", taugment.AugmentConfig)
    rerun_jax_test(jct, name, {"tmp_path": tmp_path})


@pytest.mark.parametrize("name", [
    "TestCli.test_train_export_classify_loop",
    "TestCli.test_detector_rejects_imagefolder_and_classifier_rejects_voc",
    "TestCli.test_detector_still_requires_weights",
    "TestEvalDuringTrain.test_eval_every_logs_and_saves_best",
    "TestEvalDuringTrain.test_detector_rejects_eval_imagefolder",
    "TestResumeDataPosition.test_cli_fail_then_resume",
    "TestResumeDataPosition.test_cli_resume_adapts_ema_track",
    "TestAugment.test_cli_cfg_keys_enable_augment",
    "test_cli_classifier_geometry_augment"])
def test_jax_classifier_train_cli_tests_hold_for_the_port(
        name, tmp_path, capsys, monkeypatch):
    """tests/test_classifier_train.py's command-line tests on the port's
    CLI (--device cpu), the same argv."""
    monkeypatch.setattr(yolo_tpu, "cli", PortCli)
    rerun_jax_test(jct, name, {"tmp_path": tmp_path, "capsys": capsys})


def _color_folder(tmp_path, per=4):
    import cv2

    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    for ci, cls in enumerate(("red", "green", "blue")):
        os.makedirs(data / cls)
        for i in range(per):
            img = np.zeros((32, 32, 3), np.uint8)
            img[:, :, 2 - ci] = rng.integers(160, 255)
            cv2.imwrite(str(data / cls / f"{i}.png"), img)
    return str(data)


def test_train_command_matches_the_jax_cli(tmp_path, capsys):
    """`train --imagefolder` of the same classifier cfg on the same
    images and argv (batch 8, the JAX CLI's device count divides it):
    the logged loss of every step within 1e-4 (relative) of the JAX
    command's, and the final checkpoints' params within 1e-4 of their
    scale."""
    import yolo_tpu.cli as jcli
    import yolo_tpu_torch.cli as tcli
    from yolo_tpu.io import checkpoint as jckpt
    from yolo_tpu_torch.io import checkpoint as tckpt

    cfg_path, names = jct._write_cls_cfg(tmp_path)
    data = _color_folder(tmp_path)
    argv = ["train", "--cfg", cfg_path, "--names", names, "--imagefolder",
            data, "--epochs", "2", "--batch", "8", "--lr", "0.02",
            "--precision", "fp32", "--seed", "3", "--log-every", "1"]
    logs = {}
    for tag, main, extra in (("j", jcli.main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        ck = str(tmp_path / f"ck_{tag}")
        log = str(tmp_path / f"{tag}.jsonl")
        main(argv + ["--checkpoint-dir", ck, "--log-file", log] + extra)
        capsys.readouterr()
        with open(log) as f:
            logs[tag] = [json.loads(l) for l in f if l.strip()]
    assert len(logs["t"]) == len(logs["j"]) == 4
    for a, b in zip(logs["t"], logs["j"]):
        assert a["step"] == b["step"]
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
    want = jckpt.restore(str(tmp_path / "ck_j" / "final"))["params"]
    got = tckpt.restore(str(tmp_path / "ck_t" / "final"))["params"]
    for g, w in zip(got, want):
        for k in g:
            _close(g[k].numpy(), np.asarray(w[k]), 1e-4)
