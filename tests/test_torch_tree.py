"""YOLO9000 trees in the port against the JAX package, on the CPU:
yolo_tpu_torch/configs/tree.py (the .tree/.map reader), the tree math of
ops/decode.py, ops/head.py::detect_head_tree, the chunked suppression of
ops/nms.py, the tree route of models/predict.py and the [region]
tree=/map= cfg keys.

The JAX package's own tree tests (tests/test_tree.py) run again with the
port's reader, parser, classifier helpers or command line in the JAX
ones' place. The rest holds the port against the JAX functions on the
same numpy inputs: the tree math within 1e-6, the traversal's nodes
exactly, decode and the fused tree head with boxes within 1e-5, scores
within 1e-6 and classes and valid flags equal, detect_raw on a tree
model alike in both decode modes. The JAX NMS runs its XLA path
(use_pallas=False), as its own CPU tests do. The keep masks of the
chunked suppression are bit-identical to the unchunked ones whatever
_CHUNK_ELEMS is (the JAX package's tests/test_nms_impls.py pins the same
of its own)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_tree as jtt
import yolo_tpu
import yolo_tpu.cli  # noqa: F401  (the attribute the tests swap)
import yolo_tpu.configs.darknet_cfg as jdc
import yolo_tpu.models.classify as jclassify
from tests.torch_port import PortCli, rerun_jax_test, to_jax_config
from yolo_tpu.configs import specs as jspecs
from yolo_tpu.configs import tree as jtree
from yolo_tpu.io import darknet_weights as jdw
from yolo_tpu.models import graph as jgraph
from yolo_tpu.models import predict as jpredict
from yolo_tpu.ops import decode as jdecode
from yolo_tpu.ops import head as jhead
from yolo_tpu.ops import nms as jnms
import yolo_tpu_torch
import yolo_tpu_torch.configs.darknet_cfg as tdc
from yolo_tpu_torch.configs import specs as tspecs
from yolo_tpu_torch.configs import tree as ttree
from yolo_tpu_torch.data.synthetic import synth_tree_parents, write_map, \
    write_tree
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import classify as tclassify
from yolo_tpu_torch.models import predict as tpredict
from yolo_tpu_torch.ops import decode as tdecode
from yolo_tpu_torch.ops import head as thead
from yolo_tpu_torch.ops import nms as tnms

torch.set_num_threads(1)


# --- the JAX package's tree tests, on the port --------------------------------

def _port_tree_fixture(tmp_path):
    p = tmp_path / "micro.tree"
    p.write_text(jtt.TREE_TEXT)
    return ttree.parse_tree(str(p))


@pytest.mark.parametrize("name", [
    "TestParse.test_structure", "TestParse.test_padded_tables",
    "TestParse.test_parent_must_precede_child",
    "TestParse.test_interleaved_sibling_runs_rejected",
    "TestParse.test_roots_must_lead", "TestParse.test_malformed_line",
    "TestParse.test_map"])
def test_jax_parse_tests_hold_for_the_port(name, tmp_path, monkeypatch):
    """tests/test_tree.py's reader tests with the port's parse_tree,
    parse_map, tree_paths_padded and group_members_padded."""
    for fn in ("parse_tree", "parse_map", "tree_paths_padded",
               "group_members_padded"):
        monkeypatch.setattr(jtt, fn, getattr(ttree, fn))
    rerun_jax_test(jtt, name, {"tmp_path": tmp_path,
                               "tree": _port_tree_fixture(tmp_path)})


@pytest.mark.parametrize("name", [
    "TestCfg.test_parse_populates_tree",
    "TestCfg.test_classes_tree_mismatch_rejected",
    "TestCfg.test_map_requires_tree", "TestCfg.test_round_trip",
    "TestClassifier.test_parse_and_round_trip",
    "TestClassifier.test_nodes_must_match_head_width"])
def test_jax_cfg_tests_hold_for_the_port(name, tmp_path, monkeypatch):
    """tests/test_tree.py's [region]/[softmax] tree= parser tests with
    the port's config_from_cfg and cfg_to_string (and its SoftmaxHead)."""
    monkeypatch.setattr(jdc, "config_from_cfg", tdc.config_from_cfg)
    monkeypatch.setattr(jdc, "cfg_to_string", tdc.cfg_to_string)
    monkeypatch.setattr(jspecs, "SoftmaxHead", tspecs.SoftmaxHead)
    rerun_jax_test(jtt, name, {"tmp_path": tmp_path})


def test_jax_leaf_probs_and_path_hold_for_the_port(tmp_path, monkeypatch):
    """TestClassifier.test_leaf_probs_and_path with the port's
    hierarchy_leaf_probs, hierarchy_path and top_k."""
    for fn in ("hierarchy_leaf_probs", "hierarchy_path", "top_k"):
        monkeypatch.setattr(jclassify, fn, getattr(tclassify, fn))
    rerun_jax_test(jtt, "TestClassifier.test_leaf_probs_and_path",
                   {"tree": _port_tree_fixture(tmp_path)})


@pytest.mark.parametrize("name", [
    "TestCli.test_predict_cli_traversal_and_map",
    "TestCli.test_flags_reject_non_tree_model",
    "TestClassifier.test_classify_cli_hierarchy",
    "TestClassifier.test_hierarchy_flag_rejects_flat_classifier",
    "TestEvalCli.test_eval_use_tree_map_projects_gt",
    "TestTrainCli.test_train_cli_tree_region"])
def test_jax_cli_tree_tests_hold_for_the_port(name, tmp_path, capsys,
                                              monkeypatch):
    """tests/test_tree.py's command-line tests on the port's CLI
    (--device cpu), the same argv."""
    monkeypatch.setattr(yolo_tpu, "cli", PortCli)
    rerun_jax_test(jtt, name, {"tmp_path": tmp_path, "capsys": capsys})


# --- the reader ---------------------------------------------------------------

def test_generated_9k_tree_and_map_match_jax(tmp_path):
    """The generated 9418-node hierarchy (data/synthetic.py, the shape
    of benchmarks/tree_bench.py::synth_tree, draw for draw) parses to
    the JAX package's tree field for field, with its padded tables; an
    80-leaf map reads alike."""
    from benchmarks.tree_bench import synth_tree

    path = write_tree(str(tmp_path / "9k.tree"), 9418)
    got, want = ttree.parse_tree(path), jtree.parse_tree(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(synth_tree(9418))
    assert got.n_nodes == 9418 and list(got.parents) == \
        synth_tree_parents(9418)
    np.testing.assert_array_equal(ttree.tree_paths_padded(got),
                                  jtree.tree_paths_padded(want))
    np.testing.assert_array_equal(ttree.group_members_padded(got),
                                  jtree.group_members_padded(want))
    nodes = write_map(str(tmp_path / "80.map"), got, 80)
    assert len(set(nodes)) == 80 and all(got.leaf(n) for n in nodes)
    assert ttree.parse_map(str(tmp_path / "80.map"), got) == \
        jtree.parse_map(str(tmp_path / "80.map"), want) == nodes


@pytest.mark.parametrize("text, match", [
    ("a 1\nb -1\n", "precede"), ("r -1\na 0\nb 1\nc 0\n", "contiguous"),
    ("", "empty"), ("a -1 x\n", "expected"), ("a x\n", "parent must be"),
    ("r -1\na -2\n", "< -1"), ("r -1\na 0\nb 0\nc -1\n", "two separate")])
def test_bad_tree_files_raise_as_jax(text, match, tmp_path):
    p = tmp_path / "bad.tree"
    p.write_text(text)
    with pytest.raises(ValueError, match=match) as got:
        ttree.parse_tree(str(p))
    with pytest.raises(ValueError) as want:
        jtree.parse_tree(str(p))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("text", ["x\n", "-1\n", "8\n", ""])
def test_bad_map_files_raise_as_jax(text, tmp_path):
    tree = _port_tree_fixture(tmp_path)
    p = tmp_path / "bad.map"
    p.write_text(text)
    with pytest.raises(ValueError) as got:
        ttree.parse_map(str(p), tree)
    with pytest.raises(ValueError) as want:
        jtree.parse_map(str(p), jtree.parse_tree(str(tmp_path /
                                                     "micro.tree")))
    assert str(got.value) == str(want.value)


# --- the tree math -------------------------------------------------------------

def _trees(tmp_path):
    """The micro tree, a 300-node and the 9418-node generated tree, in
    both packages."""
    out = []
    for name, make in (("micro", None), ("t300", 300), ("t9k", 9418)):
        p = tmp_path / f"{name}.tree"
        if make is None:
            p.write_text(jtt.TREE_TEXT)
        else:
            write_tree(str(p), make, seed=3)
        out.append((ttree.parse_tree(str(p)), jtree.parse_tree(str(p))))
    return out


@pytest.mark.parametrize("which", [0, 1, 2])
def test_tree_math_matches_jax(which, tmp_path):
    """tree_conditional_probs, tree_log_conditional and
    tree_absolute_probs within 1e-6 of the JAX package's on logits of
    spread 3 (and leading dims (2, 3)); tree_top_prediction's nodes
    exactly equal at five thresholds."""
    tt, jt = _trees(tmp_path)[which]
    rng = np.random.default_rng(which)
    x = rng.normal(0, 3, (2, 3, tt.n_nodes)).astype(np.float32)
    for fn in ("tree_conditional_probs", "tree_log_conditional"):
        got = getattr(tdecode, fn)(torch.from_numpy(x), tt).numpy()
        want = np.asarray(getattr(jdecode, fn)(jnp.asarray(x), jt))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    cond = np.asarray(jdecode.tree_conditional_probs(jnp.asarray(x), jt))
    got = tdecode.tree_absolute_probs(torch.from_numpy(cond), tt).numpy()
    want = np.asarray(jdecode.tree_absolute_probs(jnp.asarray(cond), jt))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for thresh in (0.0, 0.1, 0.3, 0.5, 0.9):
        got = tdecode.tree_top_prediction(torch.from_numpy(cond), tt,
                                          thresh).numpy()
        want = np.asarray(jdecode.tree_top_prediction(jnp.asarray(cond),
                                                      jt, thresh))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32


def test_tree_math_of_an_empty_batch(tmp_path):
    tt, _ = _trees(tmp_path)[0]
    x = torch.zeros((0, 3, tt.n_nodes))
    assert tdecode.tree_conditional_probs(x, tt).shape == x.shape
    assert tdecode.tree_absolute_probs(x, tt).shape == x.shape
    assert tdecode.tree_top_prediction(x, tt, 0.5).shape == (0, 3)


# --- decode, the fused head and NMS --------------------------------------------

ANCHORS = ((1.0, 1.5), (2.5, 2.0), (0.6, 0.8))


def _tree_logits(seed, c, b=2, h=4, w=5, obj_shift=-1.0):
    rng = np.random.default_rng(seed)
    t = rng.normal(0, 2, (b, h, w, len(ANCHORS), 5 + c)).astype(np.float32)
    t[..., 2:4] *= 0.3
    t[..., 4] += obj_shift
    return t.reshape(b, h, w, -1)


@pytest.mark.parametrize("which, mode, hier", [
    (0, "traversal", 0.3), (0, "map", 0.5), (1, "traversal", 0.5),
    (1, "map", 0.5), (2, "traversal", 0.2), (2, "map", 0.5)])
def test_decode_tree_branch_matches_jax(which, mode, hier, tmp_path):
    """decode(tree=, tree_map=, hier_thresh=): boxes within 1e-5, scores
    within 1e-6 of the JAX package's (the traversal's one-hot at the
    same node)."""
    tt, jt = _trees(tmp_path)[which]
    c = tt.n_nodes
    logits = _tree_logits(which, c)
    tmap = (tuple(int(v) for v in np.random.default_rng(9).choice(
        [i for i in range(c) if tt.leaf(i)], 4, replace=False))
        if mode == "map" else None)
    tb, ts = tdecode.decode(torch.from_numpy(logits), ANCHORS, c, tree=tt,
                            tree_map=tmap, hier_thresh=hier)
    jb, js = jdecode.decode(jnp.asarray(logits), ANCHORS, c, tree=jt,
                            tree_map=tmap, hier_thresh=hier)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-6)
    assert ts.shape[-1] == (len(tmap) if tmap else c)


def _same_dets(got, want, boxes_atol=1e-5):
    """Fixed-shape detections alike: valid flags and classes equal,
    scores within 1e-6, boxes within ``boxes_atol`` on valid slots."""
    got = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
           for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    v = want["valid"].astype(bool)
    np.testing.assert_array_equal(got["valid"].astype(bool), v)
    np.testing.assert_array_equal(got["classes"][v], want["classes"][v])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=0,
                               atol=boxes_atol)
    return int(v.sum())


@pytest.mark.parametrize("which, mode, conf", [
    (0, "traversal", 0.3), (0, "map", 0.1), (1, "traversal", 0.3),
    (1, "map", 0.05), (2, "traversal", 0.3), (2, "map", 1e-6)])
def test_detect_head_tree_matches_jax(which, mode, conf, tmp_path):
    """detect_head_tree in both modes against the JAX package's (XLA
    suppression): valid flags and classes equal, boxes within 1e-5,
    scores within 1e-6; at least one detection each."""
    tt, jt = _trees(tmp_path)[which]
    c = tt.n_nodes
    logits = _tree_logits(10 + which, c)
    tmap = (tuple(int(v) for v in np.random.default_rng(8).choice(
        [i for i in range(c) if tt.leaf(i)], 4, replace=False))
        if mode == "map" else None)
    kw = dict(conf_threshold=conf, iou_threshold=0.45, hier_thresh=0.4,
              tree_map=tmap, pre_top_k=64, max_detections=50)
    got = thead.detect_head_tree(torch.from_numpy(logits), ANCHORS, tt,
                                 use_kernel=True, **kw)
    want = jhead.detect_head_tree(jnp.asarray(logits), ANCHORS, jt,
                                  use_pallas=False, **kw)
    assert _same_dets(got, want) >= 1


def test_fused_tree_head_equals_reference_path(tmp_path):
    """Traversal mode: the fused head's cut is exact (a box's score is
    its objectness), so it keeps the reference decode + per-class NMS's
    detections (boxes, scores, classes) while fewer boxes clear conf
    than it prefilters; the 9418-node tree."""
    tt, _ = _trees(tmp_path)[2]
    c = tt.n_nodes
    logits = torch.from_numpy(_tree_logits(21, c))
    fused = thead.detect_head_tree(logits, ANCHORS, tt, conf_threshold=0.3,
                                   iou_threshold=0.45, hier_thresh=0.4,
                                   pre_top_k=64, max_detections=50)
    boxes, scores = tdecode.decode(logits, ANCHORS, c, tree=tt,
                                   hier_thresh=0.4)
    ref = tnms.nms_batch(boxes, scores, conf_threshold=0.3,
                         iou_threshold=0.45, top_k=64, max_detections=50,
                         impl="torch")
    for bi in range(2):
        rows = []
        for d in (fused, ref):
            v = d["valid"][bi].numpy()
            r = np.concatenate([d["boxes"][bi].numpy()[v],
                                d["scores"][bi].numpy()[v, None],
                                d["classes"][bi].numpy()[v, None]], -1)
            rows.append(r[np.lexsort(r.T)])
        assert len(rows[0]) >= 1
        np.testing.assert_allclose(rows[0], rows[1], rtol=0, atol=1e-6)


def _scene(seed, b=2, n=40, c=6):
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0.1, 0.9, (b, n)),
                      rng.uniform(0.1, 0.9, (b, n)),
                      rng.uniform(0.05, 0.3, (b, n)),
                      rng.uniform(0.05, 0.3, (b, n))], -1).astype(np.float32)
    scores = (rng.uniform(0, 1, (b, n, c)) ** 3).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("budget_rows", [1, 2, 5, 7, 1000])
def test_chunked_suppression_is_bit_identical(impl, budget_rows,
                                              monkeypatch):
    """nms_batch's per-class path under _CHUNK_ELEMS budgets of 1-1000
    rows (class chunks floored to one, ragged tails, the whole grid):
    keep masks and detections bit-identical to the unchunked run, and
    equal to the JAX package's XLA path. Both impls chunk the classes by
    the (rows, 5, K) geometry gather; impl "cuda" takes, on the CPU, the
    kernel's plain version."""
    boxes, scores = _scene(budget_rows)
    k = scores.shape[1]
    kw = dict(conf_threshold=0.2, iou_threshold=0.45, top_k=k,
              max_detections=64, impl=impl)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    monkeypatch.setattr(tnms, "_CHUNK_ELEMS", 10 ** 9)
    want = tnms.nms_batch(tb, ts, **kw)
    monkeypatch.setattr(tnms, "_CHUNK_ELEMS", budget_rows * 5 * k)
    calls = []
    real = tnms._suppress

    def counted(geom, *a, **k2):
        calls.append(geom.shape[0])
        return real(geom, *a, **k2)

    monkeypatch.setattr(tnms, "_suppress", counted)
    got = tnms.nms_batch(tb, ts, **kw)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    b, c = scores.shape[0], scores.shape[2]
    cc = max(1, budget_rows // b)
    assert len(calls) == -(-c // cc)       # one suppression per chunk
    jwant = jnms.nms_batch(jnp.asarray(boxes), jnp.asarray(scores),
                           **dict(kw, impl="xla"))
    _same_dets(got, jwant, boxes_atol=1e-6)


@pytest.mark.parametrize("rows", [1, 3, 4096])
def test_row_chunked_plain_suppression_is_bit_identical(rows, monkeypatch):
    """_suppress_torch_rows in chunks of 1, 3 or all rows: the keep mask
    equals _suppress_torch's, bit for bit (rows are independent)."""
    boxes, scores = _scene(3, b=3, n=24, c=5)
    k = 24
    order = np.argsort(-scores.transpose(0, 2, 1), axis=-1, kind="stable")
    sc = np.take_along_axis(scores.transpose(0, 2, 1), order, -1)
    geom = tnms._geom(torch.from_numpy(boxes))[:, None].expand(
        3, 5, 5, k).reshape(15, 5, k)
    cls = torch.arange(5, dtype=torch.float32).repeat(3)[:, None].expand(
        15, k)
    s = torch.from_numpy(sc.reshape(15, k).copy())
    want = tnms._suppress_torch(geom, s, cls, 0.2, 0.4)
    monkeypatch.setattr(tnms, "_CHUNK_ELEMS", rows * k * k)
    assert torch.equal(tnms._suppress_torch_rows(geom, s, cls, 0.2, 0.4),
                       want)


# --- the tree route of predict -------------------------------------------------

def _tree_model(tmp_path, n_nodes=300, net=96, seed=0):
    """A YOLO9000-topology-like cfg at a narrow width (three stride-2
    convs, two pools, the 1x1 head of 3 * (5 + n_nodes) filters,
    [region] tree= and map=), seeded region weights written as a
    .weights file."""
    write_tree(str(tmp_path / "g.tree"), n_nodes, seed=seed)
    tree = ttree.parse_tree(str(tmp_path / "g.tree"))
    write_map(str(tmp_path / "g.map"), tree, 8, seed=seed)
    conv = ("[convolutional]\nbatch_normalize=1\nfilters={f}\nsize=3\n"
            "stride={s}\npad=1\nactivation=leaky\n")
    text = (f"[net]\nwidth={net}\nheight={net}\nchannels=3\n"
            + conv.format(f=16, s=2) + conv.format(f=32, s=2)
            + "[maxpool]\nsize=2\nstride=2\n" + conv.format(f=32, s=2)
            + "[maxpool]\nsize=2\nstride=2\n"
            + f"[convolutional]\nfilters={3 * (5 + n_nodes)}\nsize=1\n"
            "stride=1\npad=1\nactivation=linear\n"
            "[region]\nanchors = 0.6,0.8, 1.5,1.9, 3.1,2.8\n"
            f"classes={n_nodes}\nnum=3\ntree=g.tree\nmap=g.map\n")
    cfg_path = tmp_path / "g9000.cfg"
    cfg_path.write_text(text)
    cfg = tdc.config_from_cfg(str(cfg_path))
    wpath = str(tmp_path / "g.weights")
    dw.save(wpath, cfg.layers, dw.synthetic_detector_params(
        cfg, seed, objectness_shift=-1.0))
    return str(cfg_path), wpath, cfg


@pytest.mark.parametrize("use_map", [False, True])
@pytest.mark.parametrize("head", ["reference", "fused"])
def test_detect_raw_on_a_tree_model_matches_jax(use_map, head, tmp_path):
    """load(cfg=<tree cfg>) and detect_raw in both decode modes against
    the JAX package's detect_raw on the same .weights and frames, fp32:
    valid flags and classes equal, scores within 1e-6, pixel boxes
    within 1e-3; the cfg parses to the JAX package's config."""
    cfg_path, wpath, cfg = _tree_model(tmp_path)
    jcfg = jdc.config_from_cfg(cfg_path)
    assert to_jax_config(cfg) == jcfg
    model = yolo_tpu_torch.load(wpath, cfg=cfg_path, device="cpu",
                                precision="fp32")
    assert model.cfg.tree is not None and model.cfg.tree_map is not None
    imgs = np.random.default_rng(4).integers(0, 256, (2, 72, 100, 3),
                                             dtype=np.uint8)
    # a mapped node's absolute probability is a path product: lower
    kw = dict(conf_threshold=2e-3 if use_map else 0.25, head=head,
              use_tree_map=use_map, hier_thresh=0.4)
    got = tpredict.detect_raw(model.cfg, model.params,
                              torch.from_numpy(imgs), **kw)
    jparams, _ = jdw.load(wpath, jcfg.layers)
    jparams = jgraph.params_to_jax(jgraph.fold_params(jcfg.layers, jparams,
                                                      jcfg.bn_eps))
    want = jpredict.detect_raw(jcfg, jparams, jnp.asarray(imgs),
                               nms_impl="xla", **kw)
    assert _same_dets(got, want, boxes_atol=1e-3) >= 1
    names = model.cfg.detection_names(use_map)
    assert names == jcfg.detection_names(use_map)
    assert len(names) == (8 if use_map else 300)


def test_make_detector_threads_the_tree_flags(tmp_path):
    """make_detector / make_detector_preprocessed pass use_tree_map and
    hier_thresh through; use_tree_map without a map raises as the JAX
    package's does; the model's own hier_thresh is the default."""
    cfg_path, wpath, cfg = _tree_model(tmp_path)
    model = yolo_tpu_torch.load(wpath, cfg=cfg_path, device="cpu",
                                precision="fp32", conf_threshold=0.25)
    imgs = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (1, 96, 96, 3), dtype=np.uint8))
    for use_map in (False, True):
        a = tpredict.make_detector(cfg, conf_threshold=0.25,
                                   use_tree_map=use_map, hier_thresh=0.5)(
            model.params, imgs)
        b = tpredict.detect_raw(cfg, model.params, imgs,
                                conf_threshold=0.25, use_tree_map=use_map)
        assert all(torch.equal(a[k], b[k]) for k in a)
    x = imgs.float() / 255.0
    pre = tpredict.make_detector_preprocessed(
        cfg, conf_threshold=0.25, use_tree_map=True)(model.params, x)
    ref = tpredict.detect(cfg, model.params, x, conf_threshold=0.25,
                          use_tree_map=True)
    assert all(torch.equal(pre[k], ref[k]) for k in pre)
    bare = dataclasses.replace(cfg, tree_map=None)
    with pytest.raises(ValueError, match="no .region. map"):
        tpredict.detect(bare, model.params, x, use_tree_map=True)


def test_tree_eval_collects_like_jax(tmp_path):
    """collect_detections(use_tree_map=...) on the port and the JAX
    package over the same PNG scenes: the same detections (classes in
    the projected vocabulary; scores within 1e-5, boxes within 1e-2
    pixels), fp32, the reference head and exact per-class NMS."""
    from yolo_tpu.eval.runner import collect_detections as jcollect
    from yolo_tpu_torch.data.synthetic import write_voc_scenes
    from yolo_tpu_torch.eval.runner import collect_detections
    from yolo_tpu_torch.models.graph import fold_params

    cfg_path, wpath, cfg = _tree_model(tmp_path)
    (tmp_path / "voc").mkdir()
    samples = write_voc_scenes(str(tmp_path / "voc"),
                               [(80, 96), (96, 72), (64, 64)],
                               np.random.default_rng(1))
    params, _ = dw.load(wpath, cfg.layers)
    folded = fold_params(cfg.layers, params, cfg.bn_eps)
    jcfg = jdc.config_from_cfg(cfg_path)
    for use_map in (False, True):
        conf = 2e-3 if use_map else 0.2
        got = collect_detections(cfg, folded, samples, batch=2,
                                 eval_conf=conf, device="cpu",
                                 use_tree_map=use_map, hier_thresh=0.4)
        want = jcollect(jcfg, jgraph.params_to_jax(folded), samples,
                        batch=2, eval_conf=conf, use_tree_map=use_map,
                        hier_thresh=0.4)
        assert set(got) == set(want)
        n = 0
        for i in want:
            g, w = sorted(got[i]), sorted(want[i])
            assert [d[0] for d in g] == [d[0] for d in w]
            np.testing.assert_allclose(np.asarray(g)[:, 1:] if g else 0,
                                       np.asarray(w)[:, 1:] if w else 0,
                                       rtol=0, atol=1e-2)
            n += len(w)
        assert n >= 1
