"""Training checkpoints of the port (counterpart of
yolo_tpu/io/checkpoint.py, which writes orbax directories; the card
machine has no orbax).

A checkpoint is a directory holding

  * ``state.pt``: ``torch.save`` of a tree of plain tensors, lists, ints,
    strings and dicts, readable with ``torch.load(..., weights_only=True)``;
  * ``meta.json``: the format version, the tree's top-level keys, the
    step and the model's name.

The tree of a train state (train.loop.state_to_tree) is

  params      [per weighted layer {name: fp32 tensor}], the JAX package's
              unfolded layout (HWIO kernels, rolling mean/var beside
              gamma/beta), what io.darknet_weights.save writes
  ema_params  the same layout, the EMA track (optional)
  opt_state   {"optimizer": "sgd", "momentum_buffer": [per layer
              {name: tensor}]} or {"optimizer": "adam", "exp_avg": [...],
              "exp_avg_sq": [...], "count": int}; the trained names only
              (kernel, gamma, beta, bias, weights), HWIO kernels
  step, seen  ints

save writes a temporary directory beside the target and renames it into
place, so a run killed mid-write never leaves a half-written checkpoint;
AsyncSaver.save returns once the tree is copied to host memory and a
thread writes it. from_numpy_state turns the numpy tree of a JAX train
state (``jax.device_get(yolo_tpu.io.checkpoint.restore(path))``) into
this tree: tools/ckpt_to_torch.py runs it where JAX and orbax are
installed.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

FORMAT_VERSION = 1
STATE_FILE = "state.pt"
META_FILE = "meta.json"
# the names the optimizer updates (train.loop._kernel_mask's two groups)
TRAINED = ("kernel", "gamma", "beta", "bias", "weights")


def _to_cpu(tree):
    """A copy of ``tree`` with every tensor detached on the CPU and numpy
    arrays and numpy scalars made tensors and Python numbers."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return (torch.from_numpy(np.array(tree)) if tree.ndim
                else tree.item())
    if isinstance(tree, np.generic):
        return tree.item()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree


def _write(path: str, tree: Dict[str, Any], model: str) -> None:
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        torch.save(tree, os.path.join(tmp, STATE_FILE))
        top = tree if isinstance(tree, dict) else {}
        meta = {"format": FORMAT_VERSION, "keys": sorted(top),
                "step": int(top.get("step", 0)), "model": model}
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    old = None
    if os.path.exists(path):
        old = f"{path}.old-{os.getpid()}"
        shutil.rmtree(old, ignore_errors=True)
        os.rename(path, old)
    os.rename(tmp, path)
    if old is not None:
        shutil.rmtree(old)


def save(path: str, tree, model: str = "") -> None:
    """Write a checkpoint directory (blocking); an existing one at
    ``path`` is replaced. ``tree`` is a train state's dict, or any tree
    of the same leaves, such as a list of int8 param blocks
    (models/quantize.py), whose leaves keep their dtype: int8 kernels
    come back int8. (from_numpy_state casts a train state's leaves to
    fp32 and is not for such trees.)"""
    _write(path, _to_cpu(tree), model)


class AsyncSaver:
    """Checkpoint writes off the training thread: save() copies the tree
    to host memory and returns; one thread writes the files in order.
    wait() (or close(), or leaving a with block) blocks until every
    write is done and raises the first write's error."""

    def __init__(self):
        self._pool = cf.ThreadPoolExecutor(1)
        self._pending = []

    def save(self, path: str, tree: Dict[str, Any], model: str = "") -> None:
        self._pending.append(self._pool.submit(_write, path, _to_cpu(tree),
                                               model))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _meta(path: str) -> Dict[str, Any]:
    meta_path = os.path.join(path, META_FILE)
    if not (os.path.isfile(os.path.join(path, STATE_FILE))
            and os.path.isfile(meta_path)):
        raise FileNotFoundError(
            f"{path}: not a checkpoint of the port (no {STATE_FILE} and "
            f"{META_FILE}); a JAX orbax checkpoint converts with "
            f"tools/ckpt_to_torch.py")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format {meta.get('format')}, "
                         f"this version reads {FORMAT_VERSION}")
    return meta


def has_top_level_key(path: str, key: str) -> bool:
    """Whether the saved tree carries ``key`` at its top level (the
    optional 'ema_params' track), from meta.json alone."""
    return key in _meta(path)["keys"]


def _check_like(got, want, where: str) -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"checkpoint {where}: keys "
                             f"{sorted(got) if isinstance(got, dict) else got}"
                             f" do not match {sorted(want)}")
        for k in want:
            _check_like(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"checkpoint {where}: {len(got)} entries, "
                             f"expected {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _check_like(g, w, f"{where}[{i}]")
    elif isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.shape != want.shape:
            raise ValueError(f"checkpoint {where}: shape "
                             f"{getattr(got, 'shape', type(got))} does not "
                             f"match {tuple(want.shape)}")


def restore(path: str, template: Optional[Dict[str, Any]] = None
            ) -> Dict[str, Any]:
    """Read a checkpoint tree (tensors on the CPU). With a template (a
    tree of the same structure, e.g. a fresh state_to_tree), the keys,
    list lengths and tensor shapes must match it: a checkpoint of another
    model raises ValueError."""
    _meta(path)
    tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    if template is not None:
        _check_like(tree, _to_cpu(template), "")
    return tree


def _find(tree, keys):
    """The first dict in ``tree`` (depth first) holding every key."""
    if isinstance(tree, dict):
        if all(k in tree for k in keys):
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _find(child, keys)
        if found is not None:
            return found
    return None


def _trained(blocks):
    return [{k: torch.from_numpy(np.array(v, np.float32)) for k, v in b.items()
             if k in TRAINED} for b in blocks]


def from_numpy_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """The numpy tree of a JAX train state (params, opt_state, step,
    seen, optionally ema_params; yolo_tpu/train/loop.py::init_state) ->
    this module's tree. The optax state carries across: SGD's momentum
    ``trace`` becomes torch SGD's momentum_buffer, Adam's ``mu``/``nu``/
    ``count`` its exp_avg/exp_avg_sq/step; a state without either
    (step 0) carries no optimizer state."""
    def blocks(src):
        return [{k: torch.from_numpy(np.array(v, np.float32))
                 for k, v in b.items()} for b in src]

    out = {"params": blocks(state["params"]),
           "step": int(np.asarray(state["step"])),
           "seen": int(np.asarray(state["seen"]))}
    if state.get("ema_params") is not None:
        out["ema_params"] = blocks(state["ema_params"])
    opt = state.get("opt_state")
    sgd = _find(opt, ("trace",))
    adam = _find(opt, ("mu", "nu", "count"))
    if adam is not None:
        out["opt_state"] = {"optimizer": "adam",
                            "exp_avg": _trained(adam["mu"]),
                            "exp_avg_sq": _trained(adam["nu"]),
                            "count": int(np.asarray(adam["count"]))}
    elif sgd is not None:
        out["opt_state"] = {"optimizer": "sgd",
                            "momentum_buffer": _trained(sgd["trace"])}
    return out
