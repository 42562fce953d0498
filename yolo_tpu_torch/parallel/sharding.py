"""Data parallelism over this process's devices (port of
yolo_tpu/parallel/sharding.py).

The JAX package shards the batch over a one-axis ("data") device mesh
and replicates the weights; jit inserts the gradient sum. Here a Mesh is
this process's ordered tuple of torch.devices (a device may appear more
than once: ["cpu"] * 8 in the tests, ["cuda:0", "cuda:0"] for two
replicas on one card). shard_batch splits the leading axis into equal
contiguous shards, one per mesh entry; replicate puts a copy of the
weights on each device. The functions make_dp_* return run one thread
per shard (each with its own CUDA stream on a card) and give back what
the single-device function gives for the whole batch:

  * make_dp_detector / make_dp_classifier: each shard through its own
    replica, the outputs concatenated in batch order on the mesh's first
    device (no communication: NMS is per image).
  * make_dp_train_step: the whole batch's step. Each shard's forward and
    backward run on its device; BN takes the statistics of the whole
    (sub-)batch (the shards' sums of y and (y - m)^2 summed, the Bessel
    factor from the whole count), the losses divide by the whole batch,
    dropout masks are drawn over the whole batch and sliced, and the
    state's parameters get the sum of the shards' gradients, so the
    step equals train.loop.train_step on the concatenated batch. Under
    gradient accumulation sub-batch i is the whole batch's rows i::accum,
    which each shard takes from its own rows.

Across processes (torchrun: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT),
maybe_init_distributed joins the group; the train step then also sums
the BN statistics and the gradients over the group, so W processes give
the step of one process on their batches concatenated in rank order.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from yolo_tpu_torch.device import resolve as resolve_device

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def maybe_init_distributed() -> bool:
    """Join the process group torchrun describes: when RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT are all set, init_process_group over
    NCCL where CUDA is available (each process on card LOCAL_RANK) and
    over gloo on the CPU, and return True; else return False. (The JAX
    package reads JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
    JAX_PROCESS_ID instead.)"""
    if not all(os.environ.get(k) for k in _TORCHRUN_VARS):
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


class Mesh:
    """This process's devices, in order, on one "data" axis."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh(data={[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (any list of devices, repeats allowed),
    by default over this process's cards: every CUDA device, or the
    current one inside a torch.distributed group. n_devices takes the
    first n and raises when fewer exist, naming the count and the fix."""
    if devices is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() \
                and torch.cuda.is_available():
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise RuntimeError(
                f"make_mesh({n_devices}) found only {len(devices)} "
                f"device(s) (torch.cuda.device_count() = "
                f"{torch.cuda.device_count()}). Pass devices=[...] for a "
                f"mesh over other devices: a device may repeat, e.g. "
                f"['cpu'] * {n_devices}, or ['cuda:0'] * {n_devices} for "
                f"replicas on one card.")
        devices = devices[:n_devices]
    if not devices:
        raise RuntimeError("make_mesh() found no CUDA device; pass "
                           "devices=['cpu'] (or ['cpu'] * n) to run on the "
                           "CPU")
    return Mesh(devices)


@dataclass(frozen=True)
class Sharding:
    """How a tree lies on a mesh: its leading axis split over the
    devices (batch=True) or a copy on each (batch=False)."""
    mesh: Mesh
    batch: bool


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis (batch) sharding for any rank."""
    return Sharding(mesh, True)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, False)


class Sharded(tuple):
    """A batch split over a mesh: entry i, a tree like the batch, holds
    its shard i on mesh.devices[i]."""

    def __new__(cls, mesh: Mesh, shards):
        obj = super().__new__(cls, shards)
        obj.mesh = mesh
        return obj


class Replicated(tuple):
    """A tree copied onto a mesh: entry i on mesh.devices[i]; entries on
    the same device are one object."""

    def __new__(cls, mesh: Mesh, copies):
        obj = super().__new__(cls, copies)
        obj.mesh = mesh
        return obj


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(lambda v: out.append(v), tree)
    return out


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray))


def _to(v, device: torch.device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))
    return t.to(device)


def shard_batch(mesh: Mesh, tree) -> Sharded:
    """Split a batch (a tree of arrays or tensors with one leading size,
    B) into len(mesh) contiguous shards of B / len(mesh) rows, shard i
    as tensors on mesh.devices[i]; leaves that are not arrays are kept
    in every shard. B must divide by the mesh size."""
    if isinstance(tree, Sharded) and tree.mesh is mesh:
        return tree
    sizes = {int(v.shape[0]) for v in _leaves(tree) if _is_array(v)}
    if len(sizes) != 1:
        raise ValueError(f"a batch needs one leading size, got "
                         f"{sorted(sizes)}")
    b = sizes.pop()
    n = len(mesh)
    if b % n:
        raise ValueError(f"batch {b} does not divide over the {n} devices "
                         f"of the mesh")
    rows = b // n
    return Sharded(mesh, [
        _tree_map(lambda v, i=i, d=d: (_to(v[i * rows:(i + 1) * rows], d)
                                       if _is_array(v) else v), tree)
        for i, d in enumerate(mesh.devices)])


def _module_to(module: torch.nn.Module, device: torch.device):
    own = getattr(module, "device", None)
    if own is not None and resolve_device(own) == device:
        return module
    out = copy.deepcopy(module).to(device)
    if hasattr(out, "device"):
        out.device = device
    return out


def replicate(mesh: Mesh, tree) -> Replicated:
    """A copy of a tree of modules (a Darknet, a DarknetTrain), tensors
    and arrays on each mesh device; a module already on a device is used
    there as it is, and a device named twice gets one copy."""
    if isinstance(tree, Replicated) and tree.mesh is mesh:
        return tree
    by_device: Dict[torch.device, Any] = {}

    def leaf(v, d):
        if isinstance(v, torch.nn.Module):
            return _module_to(v, d)
        return _to(v, d) if _is_array(v) else v

    for d in mesh.devices:
        if d not in by_device:
            by_device[d] = _tree_map(lambda v, d=d: leaf(v, d), tree)
    return Replicated(mesh, [by_device[d] for d in mesh.devices])


class _ShardRunner:
    """Runs fn(i) for each shard i of a mesh on a thread of its own; on a
    card each shard runs on a CUDA stream of its own that first waits
    for the caller's stream, and the caller's stream waits for it after.
    Returns the results in shard order; a shard's exception is raised
    once every shard has ended."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._streams: Dict[int, Any] = {}
        # kept for the runner's life: a thread new to the card takes its
        # own cuDNN and cuBLAS handles and workspaces (~20 ms a call at
        # batch 32 with a pool a call, on an H100)
        self._pool = cf.ThreadPoolExecutor(len(mesh))

    def _stream(self, i: int):
        if i not in self._streams:
            self._streams[i] = torch.cuda.Stream(self.mesh.devices[i])
        return self._streams[i]

    def map(self, fn: Callable[[int], Any]) -> List[Any]:
        devices = self.mesh.devices
        callers = {d: torch.cuda.current_stream(d)
                   for d in set(devices) if d.type == "cuda"}

        def run(i):
            d = devices[i]
            if d.type != "cuda":
                return fn(i)
            s = self._stream(i)
            with torch.cuda.device(d):
                s.wait_stream(callers[d])
                with torch.cuda.stream(s):
                    return fn(i)

        futures = [self._pool.submit(run, i) for i in range(len(devices))]
        cf.wait(futures)
        for i, d in enumerate(devices):
            if d.type == "cuda":
                callers[d].wait_stream(self._stream(i))
        outs = [f.result() for f in futures]
        for i, d in enumerate(devices):
            if d.type == "cuda":
                # the caller's stream reads these next: the allocator must
                # not hand their memory to the shard's stream before that
                _tree_map(lambda v, c=callers[d]: v.record_stream(c)
                          if isinstance(v, torch.Tensor) else None, outs[i])
        return outs


def _concat(outs: List[Any], device: torch.device):
    """Per-shard outputs (tensors or dicts of them) -> the whole batch's
    on ``device``, in shard order."""
    if isinstance(outs[0], dict):
        return {k: _concat([o[k] for o in outs], device) for k in outs[0]}
    return torch.cat([o.to(device) for o in outs])


def _check_dtype(net, compute_dtype) -> None:
    if compute_dtype is not None and net.compute_dtype != compute_dtype:
        raise ValueError(f"compute_dtype={compute_dtype}, but the params "
                         f"compute in {net.compute_dtype} (set where the "
                         f"Darknet module is built)")


def make_dp_detector(cfg, mesh: Mesh, compute_dtype=None, **det_kw):
    """Batch-sharded detection: ``fn(params, images_u8) -> detections``
    of the whole batch on mesh.devices[0], each shard through
    models.predict.detect_raw (det_kw: its options, conv_impl among
    them) on its own replica. params: replicate(mesh, darknet) (a bare
    module is replicated on each call); images_u8: shard_batch(mesh,
    images), or the whole batch, which is sharded here. compute_dtype,
    where given, must be the params'."""
    from yolo_tpu_torch.models.predict import detect_raw

    runner = _ShardRunner(mesh)

    def fn(params, images_u8):
        reps = replicate(mesh, params)
        _check_dtype(reps[0], compute_dtype)
        shards = shard_batch(mesh, images_u8)
        outs = runner.map(lambda i: detect_raw(cfg, reps[i], shards[i],
                                               **det_kw))
        return _concat(outs, mesh.devices[0])

    return fn


def make_dp_classifier(cfg, mesh: Mesh, compute_dtype=None):
    """Batch-sharded classifier forward: ``fn(params, images) -> (B, C)``
    probabilities on mesh.devices[0], as models.classify.make_classifier
    gives them; images: the preprocessed (B, net_h, net_w, C) [0, 1]
    batch (classifier_preprocess runs on the host), sharded or whole."""
    if cfg.head_kind != "softmax":
        raise ValueError(f"{cfg.name} is not a classifier "
                         f"(head_kind={cfg.head_kind})")
    runner = _ShardRunner(mesh)

    def fn(params, images):
        reps = replicate(mesh, params)
        _check_dtype(reps[0], compute_dtype)
        shards = shard_batch(mesh, images)
        outs = runner.map(lambda i: reps[i](shards[i].float()))
        return _concat(outs, mesh.devices[0])

    return fn


class _AllSum:
    """The sum of one tensor over the shards that take part in a
    (sub-)batch, for the BN statistics: each shard's thread hands in its
    tensor, the first adds them in shard order on its device (and over
    the process group, differentiably), and each gets the sum on its own
    device; autograd carries the gradient back to every shard."""

    def __init__(self, devices: Sequence[torch.device], group):
        self.devices = list(devices)
        self.group = group
        self._slots: List[Optional[torch.Tensor]] = [None] * len(devices)
        self._result: Optional[torch.Tensor] = None
        self._barrier = threading.Barrier(len(devices))

    def abort(self) -> None:
        self._barrier.abort()

    def __call__(self, k: int, t: torch.Tensor) -> torch.Tensor:
        self._slots[k] = t
        self._barrier.wait()
        if k == 0:
            acc = self._slots[0]
            for other in self._slots[1:]:
                acc = acc + other.to(acc.device)
            if self.group is not None:
                from torch.distributed.nn.functional import all_reduce

                acc = all_reduce(acc, group=self.group)
            self._result = acc
        self._barrier.wait()
        out = self._result.to(self.devices[k])
        self._barrier.wait()
        return out


@dataclass
class _Shard:
    """What DarknetTrain.forward and the losses read of a shard: its
    first row in the whole (sub-)batch, the whole (sub-)batch's rows and
    the sum over the shards."""
    start: int
    total: int
    k: int
    reducer: _AllSum

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.reducer(self.k, t)


def _group():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def make_dp_train_step(mcfg, tcfg, mesh: Mesh, compute_dtype=None):
    """The data-parallel training step: ``fn(state, batch) -> metrics``,
    in place on ``state`` (train.loop.init_state's), equal to
    train.loop.train_step on the whole batch (see the module docstring).
    batch: shard_batch(mesh, batch), or the whole batch of host arrays,
    sharded here. A mesh of one device outside a process group is
    make_train_step's step itself."""
    from yolo_tpu_torch.train.loop import make_train_step

    compute_dtype = compute_dtype or torch.float32
    if len(mesh) == 1 and _group() is None:
        return make_train_step(mcfg, tcfg, compute_dtype)
    if tcfg.remat:
        raise ValueError("remat is not supported with a sharded batch "
                         "(the recomputed blocks would sum the BN "
                         "statistics over the shards again); train "
                         "without remat or on a mesh of one device")
    return _DPStep(mcfg, tcfg, mesh, compute_dtype)


class _DPStep:
    def __init__(self, mcfg, tcfg, mesh: Mesh, compute_dtype):
        self.mcfg, self.tcfg, self.mesh = mcfg, tcfg, mesh
        self.compute_dtype = compute_dtype
        self._replicas: Dict[torch.device, Any] = {}
        self._pool = cf.ThreadPoolExecutor(len(mesh))   # as _ShardRunner

    def _nets(self, master) -> List[Any]:
        """The net each shard runs: the state's own on its device, a
        replica holding the state's current values elsewhere."""
        nets = []
        for d in self.mesh.devices:
            if d == master.device:
                nets.append(master)
                continue
            rep = self._replicas.get(d)
            if rep is None:
                rep = self._replicas[d] = _module_to(master, d)
            else:
                with torch.no_grad():
                    for a, b in zip(rep.state_dict().values(),
                                    master.state_dict().values()):
                        a.copy_(b)
            nets.append(rep)
        return nets

    def __call__(self, state, batch) -> Dict[str, torch.Tensor]:
        from yolo_tpu_torch.models.graph import apply_bn_updates
        from yolo_tpu_torch.ops.precision import exact_for
        from yolo_tpu_torch.train.loop import _loss_fn, finish_step
        from yolo_tpu_torch.utils import prng

        mesh, tcfg = self.mesh, self.tcfg
        shards = shard_batch(mesh, batch)
        n = len(mesh)
        rows = int(shards[0]["images"].shape[0])
        group = _group()
        import torch.distributed as dist

        world = dist.get_world_size(group) if group is not None else 1
        rank = dist.get_rank(group) if group is not None else 0
        batch_size = world * n * rows
        accum = max(1, int(tcfg.grad_accum))
        if batch_size % accum:
            raise ValueError(
                f"batch {batch_size} not divisible by grad_accum {accum} "
                f"(darknet requires batch % subdivisions == 0 too)")
        if group is not None and rows < accum:
            raise ValueError(f"{rows} rows a shard cannot give each of the "
                             f"{accum} sub-batches a row (every process of "
                             f"the group must take part in each)")
        master = state.net
        nets = self._nets(master)
        distinct = list({id(x): x for x in nets}.values())
        state.optimizer.zero_grad(set_to_none=True)
        for net in nets:
            if net is not master:
                net.zero_grad(set_to_none=True)
        step_key = prng.fold_in(prng.PRNGKey(0), state.step)
        sub_bs = batch_size // accum
        losses, parts_list = [], []
        with exact_for(self.compute_dtype):
            for i in range(accum):
                # sub-batch i: the whole batch's rows i::accum; a shard
                # holding rows [g0, g0 + rows) takes its own of them
                work = []
                for s in range(n):
                    g0 = (rank * n + s) * rows
                    r0 = (i - g0) % accum
                    if r0 < rows:
                        work.append((s, r0, (g0 + r0 - i) // accum))
                reducer = _AllSum([mesh.devices[s] for s, _, _ in work],
                                  group)
                key = prng.fold_in(step_key, i) if accum > 1 else step_key
                seen = state.seen + i * sub_bs

                def run(k, work=work, key=key, seen=seen, reducer=reducer):
                    s, r0, start = work[k]
                    sub = {kk: (v[r0::accum] if isinstance(v, torch.Tensor)
                                else v) for kk, v in shards[s].items()}
                    try:
                        return _loss_fn(
                            state, sub, seen, key, mcfg=self.mcfg, tcfg=tcfg,
                            compute_dtype=self.compute_dtype, net=nets[s],
                            shard=_Shard(start, sub_bs, k, reducer))
                    except BaseException:
                        reducer.abort()
                        raise

                futures = [self._pool.submit(run, k)
                           for k in range(len(work))]
                cf.wait(futures)
                outs = [f.result() for f in futures]
                dev0 = mesh.devices[work[0][0]]
                loss = outs[0][0]
                for other in outs[1:]:
                    loss = loss + other[0].to(dev0)
                loss.backward()
                # every shard computed the same statistics
                for net in distinct:
                    apply_bn_updates(net, {
                        c: {kk: t.to(net.device) for kk, t in st.items()}
                        for c, st in outs[0][2].items()})
                parts = {kk: sum(o[1][kk].detach().to(dev0) for o in outs)
                         for kk in outs[0][1]}
                total = loss.detach()
                if group is not None:
                    stacked = torch.stack([total] + list(parts.values()))
                    dist.all_reduce(stacked, group=group)
                    total = stacked[0]
                    parts = dict(zip(parts, stacked[1:]))
                losses.append(total.to(master.device))
                parts_list.append({kk: v.to(master.device)
                                   for kk, v in parts.items()})
        _sum_grads(master, [x for x in distinct if x is not master], group)
        return finish_step(state, tcfg, batch_size, losses, parts_list)


def _sum_grads(master, replicas, group) -> None:
    """Add the replicas' gradients into the master's, then (in a process
    group) sum the master's over the group."""
    params = list(master.parameters())
    for rep in replicas:
        for p, q in zip(params, rep.parameters()):
            if q.grad is None:
                continue
            g = q.grad.to(p.device)
            p.grad = g if p.grad is None else p.grad + g
    if group is not None:
        import torch.distributed as dist

        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            dist.all_reduce(p.grad, group=group)
