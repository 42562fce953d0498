"""The darknet classifiers in the port against the JAX package, on the
CPU: the [connected]/[dropout]/[softmax] cfg sections, the connected
weights I/O and `partial`, the classifier forward (Darknet's Connected
and SoftmaxHead, flat, tree and temperature), models/classify.py
(preprocess, top-k, accuracy, the hierarchy helpers), the `classify`
command, load() of a classifier and POST /classify.

The JAX package's own classifier tests (tests/test_classifier.py) run
again with a parser that runs both packages and compares them, or with
the port's command line in the JAX one's place. Tolerances: parsing,
weights bytes and command lines exact; forward fp32 within 1e-5 of the
output's scale; the preprocess within 1e-6 of cv2.resize (and the JAX
package's); probabilities through the commands (printed at 6 decimals)
within one unit of the last."""

import dataclasses
import io
import json
import subprocess
import sys
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_classifier as jtc
import yolo_tpu
import yolo_tpu.cli  # noqa: F401  (the attribute the tests swap)
import yolo_tpu.configs.darknet_cfg as jdc
from tests.torch_port import (PortCli, rerun_jax_test, to_jax_config,
                              to_port_config)
from yolo_tpu.configs import get_variant as jget_variant
from yolo_tpu.io import darknet_weights as jdw
from yolo_tpu.io import zoo as jzoo
from yolo_tpu.models import classify as jclassify
from yolo_tpu.models import graph as jgraph
import yolo_tpu_torch
import yolo_tpu_torch.api
import yolo_tpu_torch.cli
import yolo_tpu_torch.configs.darknet_cfg as tdc
from yolo_tpu_torch.configs import (AvgPool, Connected, Conv, Dropout,
                                    MaxPool, ModelConfig, SoftmaxHead,
                                    get_variant)
from yolo_tpu_torch.configs import tree as ttree
from yolo_tpu_torch.configs.variants import VARIANTS
from yolo_tpu_torch.data.synthetic import write_tree
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.io import zoo
from yolo_tpu_torch.models import classify as tclassify
from yolo_tpu_torch.models import graph as tgraph

torch.set_num_threads(1)


class _DualParser:
    """The JAX parser's entry points, each run through the port's parser
    too and held to it (config field for field, text byte for byte, or
    the same exception and message); returns the JAX package's."""

    @staticmethod
    def config_from_cfg(cfg_path, names_path=None, name=None):
        try:
            want = jdc._orig_config_from_cfg(cfg_path, names_path=names_path,
                                             name=name)
        except Exception as jerr:  # noqa: BLE001 — compared below
            with pytest.raises(type(jerr)) as perr:
                tdc.config_from_cfg(cfg_path, names_path=names_path,
                                    name=name)
            assert str(perr.value) == str(jerr)
            raise
        got = tdc.config_from_cfg(cfg_path, names_path=names_path, name=name)
        assert to_jax_config(got) == want
        return want

    @staticmethod
    def cfg_to_string(cfg):
        text = jdc._orig_cfg_to_string(cfg)
        assert tdc.cfg_to_string(to_port_config(cfg)) == text
        return text


@pytest.fixture()
def dual_parser(monkeypatch):
    monkeypatch.setattr(jdc, "_orig_config_from_cfg", jdc.config_from_cfg,
                        raising=False)
    monkeypatch.setattr(jdc, "_orig_cfg_to_string", jdc.cfg_to_string,
                        raising=False)
    monkeypatch.setattr(jdc, "config_from_cfg", _DualParser.config_from_cfg)
    monkeypatch.setattr(jdc, "cfg_to_string", _DualParser.cfg_to_string)


@pytest.mark.parametrize("name", [
    "TestClassifierCfg.test_parse", "TestClassifierCfg.test_round_trip",
    "TestClassifierCfg.test_connected_spatial_input_pins_features",
    "TestClassifierCfg.test_connected_after_spatial_route_pins_features",
    "TestClassifierCfg.test_connected_bn_rejected",
    "TestClassifierCfg.test_grouped_softmax_rejected",
    "TestClassifierCfg.test_softmax_must_be_last"])
def test_jax_classifier_cfg_tests_hold_for_the_port(name, tmp_path,
                                                    dual_parser):
    """tests/test_classifier.py's parser tests with both parsers run and
    compared on every cfg they read or write."""
    rerun_jax_test(jtc, name, {"tmp_path": tmp_path})


@pytest.mark.parametrize("name", [
    "TestClassifierCli.test_classify_e2e",
    "TestClassifierCli.test_detection_commands_reject_classifier",
    "TestClassifierCli.test_classify_rejects_detector",
    "TestClassifyAccuracyEval.test_accuracy_counts",
    "TestClassifyAccuracyEval.test_unknown_class_dir_rejected",
    "TestClassifyAccuracyEval.test_image_and_images_mutually_exclusive",
    "TestClassifyAccuracyEval.test_bad_batch_rejected",
    "TestClassifyAccuracyEval.test_top_controls_the_metric"])
def test_jax_classify_cli_tests_hold_for_the_port(name, tmp_path, capsys,
                                                  monkeypatch):
    """tests/test_classifier.py's command-line tests on the port's CLI
    (--device cpu), the same argv."""
    monkeypatch.setattr(yolo_tpu, "cli", PortCli)
    rerun_jax_test(jtc, name, {"tmp_path": tmp_path, "capsys": capsys})


# --- narrow versions of the three classifiers ----------------------------------

def _narrow(name, width=16, depth=None, size=64):
    """A built-in classifier at 1/width of its filters (the head's class
    count kept at 10) and its first ``depth`` layers of trunk, the
    global pool and the head kept."""
    cfg = get_variant(name)
    trunk = [l for l in cfg.layers if not isinstance(
        l, (AvgPool, Connected, SoftmaxHead))]
    head = cfg.layers[len(trunk):]
    if name.startswith("darknet19"):
        trunk, head = trunk[:-1], (Conv(10, size=1, bn=False,
                                        act="linear"),) + head
    if depth is not None:
        trunk = trunk[:depth]
    trunk = [dataclasses.replace(l, filters=max(4, l.filters // width))
             if isinstance(l, Conv) else l for l in trunk]
    head = tuple(dataclasses.replace(l, out=10) if isinstance(l, Connected)
                 else l for l in head)
    return ModelConfig(name=f"narrow-{name}", layers=tuple(trunk) + head,
                       anchors=(), class_names=tuple(f"c{i}" for i in
                                                     range(10)),
                       input_size=size)


NARROW = {"darknet19": _narrow("darknet19", depth=12),
          "darknet19-448": _narrow("darknet19-448", depth=12, size=96),
          "darknet53": _narrow("darknet53", width=32, depth=26)}


def _tree_classifier(tmp_path, n=40):
    tree = ttree.parse_tree(write_tree(str(tmp_path / "c.tree"), n, seed=2))
    cfg = ModelConfig(
        name="tree-cls",
        layers=(Conv(8), MaxPool(), Conv(16), MaxPool(),
                Conv(n, size=1, bn=False, act="linear"), AvgPool(),
                SoftmaxHead(tree=tree)),
        anchors=(), class_names=tree.names, input_size=32, tree=tree,
        tree_file="c.tree")
    return cfg


def _jax_forward(cfg, params, x, softmax_logits=False):
    jcfg = to_jax_config(cfg)
    folded = jgraph.params_to_jax(jgraph.fold_params(jcfg.layers, params,
                                                     jcfg.bn_eps))
    return np.asarray(jgraph.apply_layers(jcfg.layers, folded,
                                          jnp.asarray(x), eps=jcfg.bn_eps,
                                          softmax_logits=softmax_logits))


def _port_forward(cfg, params, x, softmax_logits=False,
                  dtype=torch.float32):
    net = tgraph.Darknet(cfg.layers, tgraph.fold_params(cfg.layers, params,
                                                        cfg.bn_eps),
                         device="cpu", dtype=dtype)
    return net(torch.from_numpy(x), softmax_logits=softmax_logits).numpy()


@pytest.mark.parametrize("name", sorted(NARROW))
@pytest.mark.parametrize("logits", [False, True])
def test_classifier_forward_matches_jax(name, logits):
    """The narrow classifiers' fp32 forward (probabilities, or the
    logits before the softmax) within 1e-5 of the JAX package's output
    scale, and their configs equal field for field."""
    cfg = NARROW[name]
    rng = np.random.default_rng(3)
    params = dw.random_params(cfg.layers, rng, scale=0.2)
    x = rng.uniform(0, 1, (2, cfg.input_size, cfg.input_size, 3)
                    ).astype(np.float32)
    want = _jax_forward(cfg, params, x, logits)
    got = _port_forward(cfg, params, x, logits)
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def test_classifier_bf16_forward_ranks_as_fp32():
    """bf16 (fp32 sums on bf16-rounded values) keeps the fp32 top-1 of
    the narrow darknet53 and stays within 2e-2 of its probabilities."""
    cfg = NARROW["darknet53"]
    rng = np.random.default_rng(4)
    params = dw.synthetic_detector_params(cfg, 4)
    x = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    a = _port_forward(cfg, params, x)
    b = _port_forward(cfg, params, x, dtype=torch.bfloat16)
    assert (a.argmax(-1) == b.argmax(-1)).all()
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-2)


@pytest.mark.parametrize("temperature", [1.0, 2.5])
def test_tree_classifier_matches_jax(temperature, tmp_path):
    """A tree classifier ([softmax] tree=, temperature): its per-group
    conditionals within 1e-6 of the JAX package's; make_classifier,
    hierarchy_leaf_probs and hierarchy_path give JAX's values and
    path."""
    cfg = _tree_classifier(tmp_path)
    cfg = dataclasses.replace(cfg, layers=cfg.layers[:-1] + (
        SoftmaxHead(tree=cfg.tree, temperature=temperature),))
    rng = np.random.default_rng(5)
    params = dw.random_params(cfg.layers, rng, scale=0.3)
    x = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    want = _jax_forward(cfg, params, x)
    folded = tgraph.fold_params(cfg.layers, params, cfg.bn_eps)
    net = tgraph.Darknet(cfg.layers, folded, device="cpu")
    got = tclassify.make_classifier(cfg)(net, x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    jtree = to_jax_config(cfg).tree
    np.testing.assert_allclose(
        tclassify.hierarchy_leaf_probs(got, cfg.tree),
        jclassify.hierarchy_leaf_probs(want, jtree), rtol=0, atol=1e-6)
    for row_t, row_j in zip(got, want):
        pt = tclassify.hierarchy_path(row_t, cfg.tree)
        pj = jclassify.hierarchy_path(row_j, jtree)
        assert [n for n, _, _ in pt] == [n for n, _, _ in pj]
        np.testing.assert_allclose([p for _, _, p in pt],
                                   [p for _, _, p in pj], rtol=0, atol=1e-6)


def test_dropout_is_the_identity_at_inference():
    cfg = ModelConfig(name="d", layers=(Conv(6, size=1), AvgPool(),
                                        Dropout(0.7), Connected(4),
                                        SoftmaxHead()),
                      anchors=(), class_names=tuple("abcd"), input_size=32)
    params = dw.random_params(cfg.layers, np.random.default_rng(0))
    x = np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    np.testing.assert_allclose(_port_forward(cfg, params, x),
                               _jax_forward(cfg, params, x), rtol=0,
                               atol=1e-6)


# --- weights -------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(NARROW) + ["micro"])
def test_connected_weights_io_is_byte_for_byte(name, tmp_path):
    """random_params draws as JAX's, save writes its bytes, load and
    load_partial read them back; expected_bytes is the file's size."""
    cfg = to_port_config(jtc.MICRO_CLS) if name == "micro" else NARROW[name]
    jl = to_jax_config(cfg).layers
    params = dw.random_params(cfg.layers, np.random.default_rng(7))
    jparams = jdw.random_params(jl, np.random.default_rng(7))
    buf = io.BytesIO()
    dw.save(buf, cfg.layers, params, seen=12)
    blob = buf.getvalue()
    assert blob == jdw.to_bytes(jl, jparams, seen=12)
    assert len(blob) == dw.expected_bytes(cfg.layers) == \
        jzoo.expected_weights_bytes(jl) == zoo.expected_weights_bytes(
            cfg.layers)
    got, header = dw.load(io.BytesIO(blob), cfg.layers)
    want, _ = jdw.load(io.BytesIO(blob), jl)
    assert header["seen"] == 12
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    last = dw.weighted_specs(cfg.layers)[-1]
    with pytest.raises(ValueError, match="connected" if isinstance(
            last, Connected) else "conv"):
        dw.load_partial(io.BytesIO(blob[:-8]), cfg.layers)


def test_classifier_byte_pins():
    """The published classifiers' file sizes: darknet19 (and -448)
    83427124 bytes, darknet53 166582580, as the JAX package pins them."""
    for name, size in (("darknet19", 83427124), ("darknet19-448", 83427124),
                       ("darknet53", 166582580)):
        cfg = get_variant(name)
        assert dw.expected_bytes(cfg.layers) == size == \
            jzoo.expected_weights_bytes(jget_variant(name).layers)


@pytest.mark.parametrize("name, layers", [("darknet19", 23),
                                          ("darknet53", 74)])
def test_partial_of_a_classifier_is_byte_for_byte(name, layers, tmp_path,
                                                  capsys):
    """`partial` of a classifier (darknet19_448.conv.23's and
    darknet53.conv.74's cut-offs) on narrow versions of the full
    classifiers: the port's file equals the JAX CLI's, and load_partial
    reads the trunk back into the matching detector's prefix."""
    full = _narrow(name, depth=None, size=64)
    cfg_path = tmp_path / f"{name}.cfg"
    cfg_path.write_text(tdc.cfg_to_string(full))
    w = str(tmp_path / "full.weights")
    dw.save(w, full.layers, dw.random_params(full.layers,
                                             np.random.default_rng(1)))
    outs = []
    for tag, main in (("t", yolo_tpu_torch.cli.main), ("j", None)):
        out = str(tmp_path / f"{tag}.conv")
        argv = ["partial", "--cfg", str(cfg_path), "--weights", w,
                "--layers", str(layers), "--output", out]
        if main is None:
            import yolo_tpu.cli as jcli

            jcli.main(argv)
        else:
            main(argv)
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    n_convs = sum(isinstance(l, Conv) for l in full.layers[:layers])
    params, _, n = dw.load_partial(io.BytesIO(outs[0]), full.layers)
    assert n == n_convs == (18 if name == "darknet19" else 52)


# --- preprocess, top-k and accuracy --------------------------------------------

@pytest.mark.parametrize("shape, net", [
    ((100, 140, 3), 64), ((37, 51, 3), 32), ((480, 640, 3), 448),
    ((300, 200, 3), 224), ((64, 64, 3), 32), ((64, 64, 3), 128),
    ((33, 70, 3), (64, 96)), ((40, 40, 1), 32), ((2, 9, 3), 32)])
def test_classifier_preprocess_matches_cv2(shape, net):
    """classifier_preprocess within 1e-6 of the JAX package's (cv2.resize
    INTER_LINEAR on float32) and its resize_linear within 1e-6 of
    cv2.resize itself, at the sizes the preprocess asks for."""
    import cv2

    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    got = tclassify.classifier_preprocess(img, net)
    want = jclassify.classifier_preprocess(
        img[..., 0] if shape[2] == 1 else img, net)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    src = img.astype(np.float32) / 255.0
    for nw, nh in ((net if isinstance(net, int) else net[1]) + 7, 45), \
            (23, 61):
        ref = cv2.resize(src, (nw, nh), interpolation=cv2.INTER_LINEAR)
        ref = ref[..., None] if ref.ndim == 2 else ref
        np.testing.assert_allclose(tclassify.resize_linear(src, nw, nh),
                                   ref, rtol=0, atol=1e-6)


def test_top_k_and_accuracy_match_jax(tmp_path):
    """top_k, accuracy_counts / accuracy_from_arrays (a partial last
    batch, flat and tree classifiers, leaf and internal-node labels)
    give the JAX package's results."""
    rng = np.random.default_rng(6)
    for cfg in (NARROW["darknet19"], _tree_classifier(tmp_path)):
        params = dw.random_params(cfg.layers, rng, scale=0.3)
        folded = tgraph.fold_params(cfg.layers, params, cfg.bn_eps)
        net = tgraph.Darknet(cfg.layers, folded, device="cpu")
        s = cfg.input_size
        xs = rng.uniform(0, 1, (7, s, s, 3)).astype(np.float32)
        labels = rng.integers(0, cfg.num_classes, 7)
        jcfg = to_jax_config(cfg)
        jparams = jgraph.params_to_jax(folded)
        for k in (1, 3):
            got = tclassify.accuracy_from_arrays(cfg, net, xs, labels,
                                                 batch=3, k=k)
            want = jclassify.accuracy_from_arrays(jcfg, jparams, xs,
                                                  labels, batch=3, k=k)
            assert got == want
        probs = tclassify.make_classifier(cfg)(net, xs[:1]).numpy()[0]
        assert tclassify.top_k(probs, cfg.class_names, 4) == \
            [(n, pytest.approx(p, abs=1e-6)) for n, p in jclassify.top_k(
                np.asarray(jclassify.make_classifier(jcfg)(
                    jparams, xs[:1]))[0], jcfg.class_names, 4)]
    with pytest.raises(ValueError, match="not a classifier"):
        tclassify.make_classifier(get_variant("tiny-voc"))


# --- load(), classify and /classify --------------------------------------------

def _color_model(tmp_path):
    """The JAX tests' hand-made colour classifier as .cfg + .names +
    .weights files."""
    jcfg, params = jtc._color_classifier()
    cfg = to_port_config(jcfg)
    cfg_path = tmp_path / "color.cfg"
    cfg_path.write_text(tdc.cfg_to_string(cfg))
    names = tmp_path / "color.names"
    names.write_text("red\ngreen\nblue\n")
    wpath = str(tmp_path / "color.weights")
    dw.save(wpath, cfg.layers, params)
    return str(cfg_path), str(names), wpath


def test_load_takes_classifiers(tmp_path):
    """load() of a classifier .cfg (or a built-in classifier variant)
    returns a Classifier whose top-k equals JAX's load_classifier;
    load_classifier refuses a detector as JAX's does."""
    cfg_path, names, wpath = _color_model(tmp_path)
    clf = yolo_tpu_torch.load(wpath, cfg=cfg_path, names=names,
                              device="cpu", precision="fp32", k=2)
    assert isinstance(clf, yolo_tpu_torch.api.Classifier)
    jclf = yolo_tpu.load_classifier(wpath, cfg=cfg_path, names=names,
                                    precision="fp32", k=2)
    imgs = []
    for c in range(3):
        img = np.random.default_rng(c).integers(0, 60, (40, 60, 3),
                                                dtype=np.uint8)
        img[..., c] = 230
        imgs.append(img)
    got, want = clf(imgs), jclf(imgs)
    assert [[n for n, _ in r] for r in got] == [[n for n, _ in r]
                                                for r in want]
    assert [r[0][0] for r in got] == ["red", "green", "blue"]
    for r, s in zip(got, want):
        np.testing.assert_allclose([p for _, p in r], [p for _, p in s],
                                   rtol=0, atol=1e-6)
    clf2 = yolo_tpu_torch.api.load_classifier(wpath, cfg=cfg_path,
                                              names=names, device="cpu",
                                              precision="fp32")
    assert clf2(imgs[:1])[0][0][0] == "red"
    det = get_variant("tiny-voc")
    dpath = str(tmp_path / "det.weights")
    dw.save(dpath, det.layers, dw.random_params(det.layers,
                                                np.random.default_rng(0)))
    with pytest.raises(ValueError, match="detector"):
        yolo_tpu_torch.api.load_classifier(dpath, "tiny-voc", device="cpu")
    d19 = get_variant("darknet19", input_size=64)
    w19 = str(tmp_path / "d19.weights")
    dw.save(w19, d19.layers, dw.synthetic_detector_params(d19, 0))
    clf19 = yolo_tpu_torch.load(w19, "darknet19", input_size=64,
                                device="cpu", precision="fp32")
    out = clf19([imgs[0]])[0]
    assert len(out) == 5 and out[0][0].startswith("imagenet_")


def _classify(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.strip().splitlines()


def test_classify_lines_equal_the_jax_cli(tmp_path, capsys):
    """`classify --image` (flat and tree, top-k and --hierarchy) and
    `classify --images`: the port's lines equal the JAX CLI's on the
    same argv, probabilities (printed at 6 decimals) within one unit of
    the last."""
    import cv2
    import yolo_tpu.cli as jcli

    cfg_path, names, wpath = _color_model(tmp_path)
    img = str(tmp_path / "g.png")
    x = np.zeros((40, 50, 3), np.uint8)
    x[..., 1] = 210
    cv2.imwrite(img, x[..., ::-1])
    tree_cfg = _tree_classifier(tmp_path)
    tcfg_path = tmp_path / "tree.cfg"
    tcfg_path.write_text(tdc.cfg_to_string(tree_cfg))
    tw = str(tmp_path / "tree.weights")
    dw.save(tw, tree_cfg.layers, dw.random_params(
        tree_cfg.layers, np.random.default_rng(3), scale=0.3))
    root = tmp_path / "val"
    for ci, name in enumerate(("red", "green", "blue")):
        (root / name).mkdir(parents=True)
        for j in range(2):
            y = np.zeros((30, 40, 3), np.uint8)
            y[..., ci] = 150 + 40 * j
            cv2.imwrite(str(root / name / f"{j}.png"), y[..., ::-1])
    cases = [
        ["classify", "--cfg", cfg_path, "--names", names, "--weights",
         wpath, "--image", img, "--top", "3", "--precision", "fp32"],
        ["classify", "--cfg", str(tcfg_path), "--weights", tw, "--image",
         img, "--top", "6", "--precision", "fp32"],
        ["classify", "--cfg", str(tcfg_path), "--weights", tw, "--image",
         img, "--hierarchy", "--precision", "fp32"],
        ["classify", "--cfg", cfg_path, "--names", names, "--weights",
         wpath, "--images", str(root), "--batch", "4", "--top", "2",
         "--precision", "fp32"]]
    for argv in cases:
        want = [json.loads(l) for l in _classify(jcli.main, argv, capsys)]
        got = [json.loads(l) for l in _classify(
            yolo_tpu_torch.cli.main, argv + ["--device", "cpu"], capsys)]
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in g:
                if isinstance(w[k], float):
                    # printed at 6 decimals: one unit of the last apart
                    assert abs(g[k] - w[k]) <= 1e-6 + 1e-12, (argv, k)
                else:
                    assert g[k] == w[k], (argv, k)


def _post(port, path, body, ctype="image/png"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_classify_endpoint_equals_a_direct_call(tmp_path):
    """POST /classify (PNG and .npy bodies, one request and four at once)
    answers a direct Classifier call's top-5; /detect on a classifier is
    a 400, as the JAX server's."""
    from concurrent.futures import ThreadPoolExecutor

    from yolo_tpu_torch.data.png import encode_png
    from yolo_tpu_torch.serve import DetectionServer

    cfg_path, names, wpath = _color_model(tmp_path)
    clf = yolo_tpu_torch.load(wpath, cfg=cfg_path, names=names,
                              device="cpu", precision="fp32")
    server = DetectionServer(clf.cfg, clf.params, port=0, max_batch=4)
    server.start()
    try:
        imgs = []
        for c in range(4):
            img = np.random.default_rng(c).integers(0, 80, (36, 52, 3),
                                                    dtype=np.uint8)
            img[..., c % 3] = 200
            imgs.append(img)
        want = [[{"class": n, "prob": round(p, 6)} for n, p in r]
                for r in clf(imgs)]
        code, out = _post(server.port, "/classify", encode_png(imgs[0]))
        assert code == 200 and out == {"classes": want[0]}
        buf = io.BytesIO()
        np.save(buf, imgs[1])
        code, out = _post(server.port, "/classify", buf.getvalue(),
                          "application/x-npy")
        assert code == 200 and out == {"classes": want[1]}
        with ThreadPoolExecutor(4) as ex:
            outs = list(ex.map(lambda im: _post(
                server.port, "/classify", encode_png(im)), imgs))
        assert [o for _, o in outs] == [{"classes": w} for w in want]
        code, out = _post(server.port, "/detect", encode_png(imgs[0]))
        assert code == 400 and "serves /classify" in out["error"]
    finally:
        server.stop()


def test_serve_command_serves_a_classifier(tmp_path):
    """`serve --cfg <classifier>` in a subprocess (--device cpu) answers
    POST /classify like load()'s Classifier."""
    import socket

    from yolo_tpu_torch.data.png import encode_png

    cfg_path, names, wpath = _color_model(tmp_path)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    proc = subprocess.Popen(
        [sys.executable, "-m", "yolo_tpu_torch.cli", "serve", "--cfg",
         cfg_path, "--names", names, "--weights", wpath, "--port",
         str(port), "--precision", "fp32", "--device", "cpu"],
        stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stderr:
            if "serving" in line:
                assert "POST /classify" in line
                break
        img = np.zeros((30, 30, 3), np.uint8)
        img[..., 2] = 220
        code, out = _post(port, "/classify", encode_png(img))
        assert code == 200 and out["classes"][0]["class"] == "blue"
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_every_classifier_variant_is_built_in():
    for name in ("darknet19", "darknet19-448", "darknet53"):
        assert name in VARIANTS and get_variant(name).head_kind == "softmax"
        assert to_jax_config(get_variant(name, input_size=224)) == \
            jget_variant(name, input_size=224)
