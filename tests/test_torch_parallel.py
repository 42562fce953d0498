"""The port's data parallelism (yolo_tpu_torch/parallel/sharding.py) on
an 8-entry CPU mesh, against the port on one device and against the JAX
package's make_dp_* on conftest's 8 fake CPU devices, on the same seeded
inputs: the 8 non-slow tests of tests/test_parallel.py, rerun on the
port, a grad-accum case whose shards do not split evenly into the
sub-batches (16 rows over 8 shards, accum 4: each shard holds 2 rows and
so only two of the four sub-batches), a dropout net (the masks drawn over
the whole batch) and a 2-process gloo group.

Tolerances are tests/test_parallel.py's: the train step's loss to a
relative 1e-5 and every trained tensor to rtol 1e-4 / atol 1e-6,
detections to rtol 1e-4 / atol 1e-5, the classifier's top1 equal.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_train import MICRO, _random_scene
from tests.torch_port import to_port_config
from yolo_tpu.io import darknet_weights as jdw
from yolo_tpu.models import graph as jgraph
from yolo_tpu.parallel import sharding as jshd
from yolo_tpu.train import loop as jloop
from yolo_tpu_torch.models import graph as tgraph
from yolo_tpu_torch.models.predict import make_detector
from yolo_tpu_torch.parallel import sharding as shd
from yolo_tpu_torch.train import loop as tloop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mesh():
    return shd.make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"
    return jshd.make_mesh()


def _batch(rng, batch, cfg=MICRO):
    targets = _random_scene(rng, batch, cfg.grid_size, cfg.num_classes)
    out = dict(targets)
    out["images"] = rng.uniform(0, 1, (batch, 64, 64, 3)).astype(np.float32)
    return out


def _close_params(got, want):
    for p, q in zip(got, want, strict=True):
        assert set(p) == set(q)
        for k in p:
            np.testing.assert_allclose(p[k], np.asarray(q[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def _train_case(cfg, jcfg, params, batch, mesh, jmesh, lr=1e-3,
                jax_kw=None, **kw):
    """One step three ways: the port on one device and on the mesh, and
    the JAX package's DP step (jax_kw: its own config objects); returns
    the metrics of each."""
    kw.update(learning_rate=lr, weight_decay=0.0)
    tcfg = tloop.TrainConfig(**kw)
    single = tloop.init_state(cfg, params, tcfg, device="cpu")
    m1 = tloop.make_train_step(cfg, tcfg)(
        single, {k: torch.from_numpy(v) for k, v in batch.items()})
    dp = tloop.init_state(cfg, params, tcfg, device="cpu")
    m2 = shd.make_dp_train_step(cfg, tcfg, mesh)(
        dp, shd.shard_batch(mesh, batch))
    jtcfg = jloop.TrainConfig(**{**kw, **(jax_kw or {})})
    jstate = jshd.replicate(jmesh, jloop.init_state(params, jtcfg))
    jstate, m3 = jshd.make_dp_train_step(jcfg, jtcfg, jmesh)(
        jstate, jshd.shard_batch(jmesh, {k: jnp.asarray(v)
                                         for k, v in batch.items()}))
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m2["loss"]) == pytest.approx(float(m3["loss"]), rel=1e-5)
    assert set(m2) == set(m1) == set(m3)
    _close_params(dp.net.to_numpy(), single.net.to_numpy())
    _close_params(dp.net.to_numpy(), jstate["params"])
    assert dp.step == single.step == 1
    assert dp.seen == single.seen == int(jstate["seen"])
    return m1, m2, m3


def test_dp_step_matches_single_device(mesh, jmesh):
    rng = np.random.default_rng(0)
    params = jdw.random_params(MICRO.layers, rng)
    _train_case(to_port_config(MICRO), MICRO, params, _batch(rng, 16),
                mesh, jmesh)


@pytest.mark.parametrize("accum", [2, 4])
def test_dp_step_matches_single_device_grad_accum(mesh, jmesh, accum):
    """accum 2: each shard's 2 rows give one row to each sub-batch; accum
    4 (16 rows / 8 shards % 4 != 0): shard s holds global rows 2s, 2s+1,
    so sub-batch i takes rows of only half the shards, each its first or
    second row, and the others sit the sub-batch out."""
    rng = np.random.default_rng(7)
    params = jdw.random_params(MICRO.layers, rng)
    _train_case(to_port_config(MICRO), MICRO, params, _batch(rng, 16),
                mesh, jmesh, grad_accum=accum)


def test_dp_step_draws_dropout_over_the_whole_batch(mesh, jmesh):
    """A [dropout] layer: each shard's mask is its rows of the mask drawn
    over the whole batch's NHWC shape (utils/prng.py), as under jit."""
    from yolo_tpu.configs.specs import Conv, Dropout, MaxPool, ModelConfig

    jcfg = ModelConfig(
        name="micro-drop",
        layers=(Conv(8), MaxPool(2, 2), Conv(16), MaxPool(2, 2),
                Dropout(0.5), Conv(16), MaxPool(2, 2), Conv(16),
                MaxPool(2, 2), Conv(16), MaxPool(2, 2),
                Conv(3 * (5 + 4), size=1, bn=False, act="linear")),
        anchors=MICRO.anchors, class_names=MICRO.class_names,
        input_size=64)
    rng = np.random.default_rng(3)
    params = jdw.random_params(jcfg.layers, rng)
    _train_case(to_port_config(jcfg), jcfg, params, _batch(rng, 16, jcfg),
                mesh, jmesh)


def test_dp_step_yolo_heads_divide_by_the_whole_batch(mesh, jmesh):
    """MICRO_V3's two [yolo] heads, ciou with a max_delta clip: the
    shards' losses divide by the whole batch, and so does the clip of
    the box gradient (max_delta / b)."""
    from tests.test_yolov3 import MICRO_V3, _random_v3_scene
    from yolo_tpu.data import targets as jtgt
    from yolo_tpu.train import loss as jloss
    from yolo_tpu_torch.train import loss as tloss

    rng = np.random.default_rng(5)
    params = jdw.random_params(MICRO_V3.layers, rng)
    boxes, classes = _random_v3_scene(rng, 16)
    batch = dict(jtgt.encode_batch_for(MICRO_V3, boxes, classes))
    batch["images"] = rng.uniform(0, 1, (16, 64, 64, 3)).astype(np.float32)
    loss = dict(iou_loss="ciou", iou_normalizer=0.07, max_delta=0.01)
    _train_case(to_port_config(MICRO_V3), MICRO_V3, params, batch, mesh,
                jmesh, yolo_loss=tloss.YoloLossConfig(**loss),
                jax_kw={"yolo_loss": jloss.YoloLossConfig(**loss)},
                grad_accum=2)


def _detect_case(jcfg, params, images, mesh, jmesh, jax_kw=None, **kw):
    """The port's DP detector against its single-device one and the JAX
    package's DP detector (jax_kw: options that differ in name there)."""
    cfg = to_port_config(jcfg)
    folded = jgraph.fold_params(jcfg.layers, params, jcfg.bn_eps)
    net = tgraph.Darknet(cfg.layers, folded, device="cpu")
    x = torch.from_numpy(images)
    want = make_detector(cfg, **kw)(net, x)
    got = shd.make_dp_detector(cfg, mesh, **kw)(shd.replicate(mesh, net),
                                                shd.shard_batch(mesh, x))
    jparams = jgraph.params_to_jax(folded)
    jgot = jshd.make_dp_detector(jcfg, jmesh, compute_dtype=jnp.float32,
                                 **{**kw, **(jax_kw or {})})(
        jshd.replicate(jmesh, jparams),
        jax.device_put(jnp.asarray(images), jshd.batch_sharding(jmesh)))
    for key in ("boxes", "scores", "classes", "valid"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(jgot[key]),
                                   rtol=1e-4, atol=1e-5)
    assert int(got["valid"].sum()) > 0


def test_sharded_inference_matches_unsharded(mesh, jmesh):
    rng = np.random.default_rng(1)
    params = jdw.random_params(MICRO.layers, rng)
    images = rng.integers(0, 256, (8, 96, 128, 3), dtype=np.uint8)
    _detect_case(MICRO, params, images, mesh, jmesh, conf_threshold=0.1)


def test_sharded_inference_matches_unsharded_yolov3(mesh, jmesh):
    from tests.test_yolov3 import MICRO_V3

    rng = np.random.default_rng(2)
    params = jdw.random_params(MICRO_V3.layers, rng)
    images = rng.integers(0, 256, (8, 96, 128, 3), dtype=np.uint8)
    _detect_case(MICRO_V3, params, images, mesh, jmesh, conf_threshold=0.1)


def test_maybe_init_distributed_noop_without_env(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert shd.maybe_init_distributed() is False
    monkeypatch.setenv("RANK", "0")   # a partial set is no group either
    assert shd.maybe_init_distributed() is False


def test_dp_classifier_train_matches_single_device(mesh, jmesh, tmp_path):
    from tests.test_classifier_train import _color_batch, _write_cls_cfg
    from yolo_tpu.configs.darknet_cfg import config_from_cfg as jconfig
    from yolo_tpu_torch.configs.darknet_cfg import config_from_cfg

    cfg_path, names = _write_cls_cfg(tmp_path)
    jcfg = jconfig(cfg_path, names_path=names)
    cfg = config_from_cfg(cfg_path, names_path=names)
    rng = np.random.default_rng(0)
    params = jdw.random_params(jcfg.layers, rng, scale=0.05)
    imgs, labels = _color_batch(rng, 16)
    m1, m2, m3 = _train_case(cfg, jcfg, params,
                             {"images": imgs, "labels": labels}, mesh,
                             jmesh, lr=1e-2)
    assert float(m2["top1"]) == pytest.approx(float(m1["top1"]))
    assert float(m2["top1"]) == pytest.approx(float(m3["top1"]))

    # the DP classifier forward (serve --dp of a classifier)
    folded = tgraph.fold_params(cfg.layers, params, cfg.bn_eps)
    net = tgraph.Darknet(cfg.layers, folded, device="cpu")
    from yolo_tpu_torch.models.classify import make_classifier

    want = make_classifier(cfg)(net, imgs)
    got = shd.make_dp_classifier(cfg, mesh)(shd.replicate(mesh, net), imgs)
    jgot = jshd.make_dp_classifier(jcfg, jmesh, compute_dtype=jnp.float32)(
        jshd.replicate(jmesh, jgraph.params_to_jax(folded)),
        jax.device_put(jnp.asarray(imgs), jshd.batch_sharding(jmesh)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-4,
                               atol=1e-5)


def _tree_case(tmp_path):
    from tests.test_tree import _write_tree_model
    from yolo_tpu.configs.darknet_cfg import config_from_cfg

    jcfg = config_from_cfg(_write_tree_model(tmp_path))
    rng = np.random.default_rng(2)
    params = jdw.random_params(jcfg.layers, rng)
    images = rng.integers(0, 256, (8, 48, 64, 3), dtype=np.uint8)
    return jcfg, params, images


def test_sharded_tree_inference_matches_unsharded(mesh, jmesh, tmp_path):
    jcfg, params, images = _tree_case(tmp_path)
    _detect_case(jcfg, params, images, mesh, jmesh, conf_threshold=0.05,
                 use_tree_map=True)


def test_sharded_exact_nms_chunked_matches_unsharded(mesh, jmesh, tmp_path,
                                                     monkeypatch):
    from yolo_tpu.ops import nms as jnms
    from yolo_tpu_torch.ops import nms as tnms

    jcfg, params, images = _tree_case(tmp_path)
    monkeypatch.setattr(jnms, "_CHUNK_ELEMS", 1)
    monkeypatch.setattr(tnms, "_CHUNK_ELEMS", 1)
    _detect_case(jcfg, params, images, mesh, jmesh, conf_threshold=0.05,
                 head="reference", nms_impl="torch",
                 jax_kw={"nms_impl": "xla"})


def test_mesh_of_one_is_the_single_device_step():
    """A mesh of one device outside a process group is make_train_step's
    step: the same params bit for bit."""
    rng = np.random.default_rng(4)
    params = jdw.random_params(MICRO.layers, rng)
    batch = _batch(rng, 4)
    cfg = to_port_config(MICRO)
    tcfg = tloop.TrainConfig(learning_rate=1e-3, weight_decay=0.0)
    a = tloop.init_state(cfg, params, tcfg, device="cpu")
    b = tloop.init_state(cfg, params, tcfg, device="cpu")
    tloop.make_train_step(cfg, tcfg)(
        a, {k: torch.from_numpy(v) for k, v in batch.items()})
    mesh1 = shd.make_mesh(1, devices=["cpu"])
    shd.make_dp_train_step(cfg, tcfg, mesh1)(
        b, {k: torch.from_numpy(v) for k, v in batch.items()})
    for p, q in zip(a.net.to_numpy(), b.net.to_numpy()):
        for k in p:
            np.testing.assert_array_equal(p[k], q[k])


def test_mesh_and_shard_checks():
    with pytest.raises(RuntimeError, match="found only 1 device"):
        shd.make_mesh(2, devices=["cpu"])
    mesh = shd.make_mesh(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="does not divide"):
        shd.shard_batch(mesh, {"images": np.zeros((4, 2))})
    sh = shd.shard_batch(mesh, {"images": np.arange(6.0), "meta": "x"})
    assert [s["images"].tolist() for s in sh] == [[0, 1], [2, 3], [4, 5]]
    assert all(s["meta"] == "x" for s in sh)


def test_gloo_two_processes_match_single_process(tmp_path):
    """Two processes of a gloo group (torchrun's variables, set by hand)
    each take half of a batch on a 2-entry CPU mesh: maybe_init_distributed
    joins the group, the step sums the BN statistics and the gradients
    over it, and both processes end with the single-process step's
    params and loss."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", YOLO_TPU_TEST_BACKEND="cpu")
    worker = os.path.join(REPO, "tests", "torch_dp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(tmp_path / f"r{r}.npz")], cwd=REPO,
        env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    from tests.torch_dp_worker import case

    cfg, params, batch, tcfg = case()
    state = tloop.init_state(cfg, params, tcfg, device="cpu")
    m = tloop.make_train_step(cfg, tcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    want = state.net.to_numpy()
    for r in (0, 1):
        got = np.load(tmp_path / f"r{r}.npz")
        assert float(got["loss"]) == pytest.approx(float(m["loss"]),
                                                   rel=1e-5)
        for i, p in enumerate(want):
            for k in p:
                np.testing.assert_allclose(got[f"{i}.{k}"], p[k], rtol=1e-4,
                                           atol=1e-6)
