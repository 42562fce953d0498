"""The port's training checkpoints (yolo_tpu_torch/io/checkpoint.py,
train.loop.state_to_tree / state_from_tree) on the CPU: the files, the
atomic and background writes, the exact round trip of a train state, and
JAX orbax checkpoints carried across by from_numpy_state: the port's
next step from a converted JAX state matches JAX's own next step within
tests/test_torch_train.py's fp32 step bounds (2e-5 of each tensor's
scale; Adam as there)."""

import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import NARROW_V2, _batch, _compare_state, _params
from tests.torch_port import to_jax_config
from yolo_tpu.io import checkpoint as jckpt
from yolo_tpu.train import loop as jloop
from yolo_tpu_torch.io import checkpoint as ckpt
from yolo_tpu_torch.train import loop as tloop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree_equal(a, b) -> None:
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def _trained_state(tcfg, steps=2):
    state = tloop.init_state(NARROW_V2, _params(NARROW_V2, seed=1), tcfg,
                             device="cpu")
    step = tloop.make_train_step(NARROW_V2, tcfg)
    for i in range(steps):
        step(state, {k: torch.from_numpy(v)
                     for k, v in _batch(NARROW_V2, 100 + i).items()})
    return state, step


def test_save_restore_files_and_meta(tmp_path):
    state, _ = _trained_state(tloop.TrainConfig(learning_rate=1e-3,
                                                ema_alpha=0.5))
    tree = tloop.state_to_tree(state)
    path = str(tmp_path / "ck")
    ckpt.save(path, tree, model=NARROW_V2.name)
    assert sorted(os.listdir(path)) == ["meta.json", "state.pt"]
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta == {"format": 1, "keys": sorted(tree), "step": 2,
                    "model": "narrow-v2"}
    assert ckpt.has_top_level_key(path, "ema_params")
    assert not ckpt.has_top_level_key(path, "grain")
    # plain tensors, ints and strings: loadable with weights_only
    raw = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    _tree_equal(raw, tree)
    _tree_equal(ckpt.restore(path, template=tree), tree)
    # the kernels are HWIO, the darknet_weights layout
    assert tuple(tree["params"][0]["kernel"].shape) == (3, 3, 3, 8)
    assert tuple(tree["opt_state"]["momentum_buffer"][0]["kernel"].shape) \
        == (3, 3, 3, 8)


def test_restore_checks_the_template(tmp_path):
    state, _ = _trained_state(tloop.TrainConfig(learning_rate=1e-3), 1)
    tree = tloop.state_to_tree(state)
    ckpt.save(str(tmp_path / "ck"), tree)
    other = tloop.state_to_tree(tloop.init_state(
        NARROW_V2, _params(NARROW_V2, seed=2),
        tloop.TrainConfig(ema_alpha=0.5), device="cpu"))
    with pytest.raises(ValueError, match="keys"):
        ckpt.restore(str(tmp_path / "ck"), template=other)
    bad = dict(tree, params=[dict(p) for p in tree["params"]])
    bad["params"][0]["kernel"] = torch.zeros(3, 3, 3, 9)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path / "ck"), template=bad)
    with pytest.raises(FileNotFoundError, match="ckpt_to_torch"):
        ckpt.restore(str(tmp_path))


def test_save_is_atomic(tmp_path, monkeypatch):
    """A write that dies midway leaves the previous checkpoint whole and
    no directory at a half-written path."""
    path = str(tmp_path / "ck")
    first = {"params": [{"kernel": torch.ones(2)}], "step": 1, "seen": 4}
    ckpt.save(path, first)

    def die(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", die)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(path, dict(first, step=2))
    with pytest.raises(OSError):
        ckpt.save(str(tmp_path / "new"), first)
    monkeypatch.undo()
    _tree_equal(ckpt.restore(path), first)
    assert not os.path.exists(tmp_path / "new")
    ckpt.save(path, dict(first, step=3))
    assert ckpt.restore(path)["step"] == 3
    assert os.listdir(tmp_path) == ["ck"]


def test_async_saver_snapshots_and_writes_in_background(tmp_path,
                                                        monkeypatch):
    gate = threading.Event()
    real = ckpt._write

    def slow(*a, **k):
        gate.wait(30)
        real(*a, **k)

    monkeypatch.setattr(ckpt, "_write", slow)
    t = torch.zeros(4)
    with ckpt.AsyncSaver() as saver:
        saver.save(str(tmp_path / "a"), {"params": [{"x": t}], "step": 1})
        t += 5.0     # after save() returns: the snapshot is unaffected
        assert not os.path.exists(tmp_path / "a")
        gate.set()
    assert torch.equal(ckpt.restore(str(tmp_path / "a"))["params"][0]["x"],
                       torch.zeros(4))
    monkeypatch.setattr(ckpt, "_write", lambda *a, **k: 1 / 0)
    saver = ckpt.AsyncSaver()
    saver.save(str(tmp_path / "b"), {"step": 1})
    with pytest.raises(ZeroDivisionError):
        saver.close()


@pytest.mark.parametrize("kw", [
    dict(learning_rate=1e-3), dict(learning_rate=1e-3, ema_alpha=0.9),
    dict(learning_rate=1e-3, optimizer="adam")], ids=["sgd", "ema", "adam"])
def test_round_trip_continues_exactly(tmp_path, kw):
    """A state saved after 2 steps and restored takes a third step to the
    bytes of the state that was never saved."""
    tcfg = tloop.TrainConfig(**kw)
    state, step = _trained_state(tcfg)
    ckpt.save(str(tmp_path / "ck"), tloop.state_to_tree(state))
    again = tloop.state_from_tree(ckpt.restore(str(tmp_path / "ck")),
                                  NARROW_V2, tcfg, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(NARROW_V2, 102).items()}
    step(state, batch)
    step(again, batch)
    _tree_equal(tloop.state_to_tree(again), tloop.state_to_tree(state))


@pytest.mark.parametrize("kw", [
    dict(learning_rate=1e-3, momentum=0.9, weight_decay=5e-4),
    dict(learning_rate=1e-3, ema_alpha=0.9, ema_start_step=1),
    dict(learning_rate=1e-3, optimizer="adam", weight_decay=5e-4)],
    ids=["sgd", "ema", "adam"])
def test_jax_checkpoint_continues_in_the_port(tmp_path, kw):
    """2 JAX steps, an orbax checkpoint, from_numpy_state: the carried
    params, EMA and optimizer state are JAX's exactly, and the port's
    third step matches JAX's third step."""
    jcfg = to_jax_config(NARROW_V2)
    jtcfg = jloop.TrainConfig(**kw)
    jstate = jloop.init_state(_params(NARROW_V2, seed=1), jtcfg)
    jstep = jloop.make_train_step(jcfg, jtcfg)
    for i in range(2):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                   _batch(NARROW_V2, 100 + i).items()})
    jckpt.save(str(tmp_path / "orbax"), jax.device_get(dict(jstate)))
    tree = ckpt.from_numpy_state(jax.device_get(
        jckpt.restore(str(tmp_path / "orbax"))))
    for got, want in zip(tree["params"], jstate["params"]):
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    adam = kw.get("optimizer") == "adam"
    opt = tree["opt_state"]
    assert opt["optimizer"] == ("adam" if adam else "sgd")
    if adam:
        assert opt["count"] == 2
        mu = jstate["opt_state"][1][0].mu
        np.testing.assert_array_equal(opt["exp_avg"][3]["kernel"].numpy(),
                                      np.asarray(mu[3]["kernel"]))
    else:
        trace = jstate["opt_state"][1][0].trace
        np.testing.assert_array_equal(
            opt["momentum_buffer"][3]["gamma"].numpy(),
            np.asarray(trace[3]["gamma"]))
    tcfg = tloop.TrainConfig(**kw)
    state = tloop.state_from_tree(tree, NARROW_V2, tcfg, device="cpu")
    assert (state.step, state.seen) == (2, 8)
    batch = _batch(NARROW_V2, 102)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tloop.make_train_step(NARROW_V2, tcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    _compare_state(state, jstate, 2e-5,
                   adam_cap=2 * kw["learning_rate"] * 3 if adam else None)
    if kw.get("ema_alpha"):
        _compare_state(state, jstate, 2e-5, ema=True)


def test_ckpt_to_torch_tool(tmp_path):
    """tools/ckpt_to_torch.py converts a JAX checkpoint directory into
    one the port restores."""
    jstate = jloop.init_state(_params(NARROW_V2, seed=1),
                              jloop.TrainConfig(ema_alpha=0.5), seen=12)
    jckpt.save(str(tmp_path / "orbax"), jax.device_get(dict(jstate)))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "ckpt_to_torch.py"),
         str(tmp_path / "orbax"), str(tmp_path / "port"), "--model",
         "narrow-v2"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr
    tree = ckpt.restore(str(tmp_path / "port"))
    assert tree["seen"] == 12 and "ema_params" in tree
    np.testing.assert_array_equal(tree["params"][2]["kernel"].numpy(),
                                  np.asarray(jstate["params"][2]["kernel"]))
