"""Training step for the region heads (YOLO9000 trees too), the [yolo]
heads, the yolov1 [detection] head and the darknet classifiers (port of
yolo_tpu/train/loop.py).

  state = init_state(mcfg, params, tcfg)          # device="cuda"
  step = make_train_step(mcfg, tcfg, compute_dtype=torch.bfloat16)
  metrics = step(state, batch)                    # updates state in place

The state holds a ``DarknetTrain`` module, a ``torch.optim`` optimizer
and the step and seen counters. As the JAX package's optax chain:

  * SGD: add_decayed_weights on kernels only, then momentum: one
    torch.optim.SGD with two parameter groups (decay on kernels, none on
    gamma, beta, bias), dampening 0, no nesterov.
  * Adam: the decay enters the gradient before the moments
    (torch.optim.Adam's weight_decay, not AdamW's decoupled form).
  * LR: each group's lr is set from lr_schedule(step) before every
    optimizer.step(); darknet's batch_num is step + 1. policy=random
    draws its factor from jax.random's generator (utils/prng.py), keyed
    on (lr_random_seed, batch_num) as the JAX schedule is.

Gradient accumulation splits the batch with a stride (sub-batch i is
batch[i::accum]), chains the rolling BN statistics through the
sub-passes and averages loss, parts and gradients. The EMA track
(ema_alpha) follows kernels, gamma, beta and biases. A classifier's
batch holds "images" and "labels"; its step trains classifier_loss on
the softmax head's logits. The [dropout] masks and the [crop] jitter
are the JAX package's: drawn from fold_in(PRNGKey(0), step), and under
accumulation from fold_in of that with the sub-batch index.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from yolo_tpu_torch.configs.specs import ModelConfig, SoftmaxHead
from yolo_tpu_torch.device import resolve as resolve_device
from yolo_tpu_torch.models.graph import DarknetTrain, apply_bn_updates
from yolo_tpu_torch.ops.precision import exact_for
from yolo_tpu_torch.train.loss import (LossConfig, YoloLossConfig,
                                       classifier_loss, detection_loss,
                                       region_loss, yolo_loss)
from yolo_tpu_torch.utils import prng

# Darknet multi-scale training sizes (yolov2.cfg random=1: {320..608}/32).
MULTISCALE_SIZES = tuple(range(320, 609, 32))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's TrainConfig. The multi-scale knobs are read by the train command (cli/train_cmd.py:
    size_for_batch through pick_scale); loss is the region head's, yolo_loss the [yolo] heads'
    (train.loss.region_loss_config / yolo_loss_config build them from a
    ModelConfig). See yolo_tpu/train/loop.py for each policy's darknet
    source."""
    learning_rate: float = 1e-4
    optimizer: str = "sgd"          # "sgd" (darknet) | "adam"
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-7
    momentum: float = 0.9
    weight_decay: float = 5e-4      # darknet decay, kernels only
    remat: bool = False             # torch.utils.checkpoint per conv block
    bn_stats_fp32: bool = True
    burn_in_steps: int = 0          # lr * (batch/burn_in)^power ramp
    lr_decay_steps: tuple = ()      # policy=steps
    lr_decay_scales: tuple = ()
    lr_poly_max_steps: int = 0      # policy=poly
    lr_poly_power: float = 4.0      # [net] power (poly and burn-in)
    lr_step_size: int = 0           # policy=step
    lr_step_scale: float = 1.0
    lr_exp_gamma: float = 0.0       # policy=exp
    lr_sig_gamma: float = 0.0       # policy=sigmoid
    lr_sig_step: int = 0
    lr_sgdr_cycle: int = 0          # policy=sgdr
    lr_sgdr_mult: int = 2
    lr_min: float = 1e-5
    lr_random: bool = False         # policy=random: lr * u^power
    lr_random_seed: int = 0         # u keyed on (seed, batch_num)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    yolo_loss: YoloLossConfig = dataclasses.field(
        default_factory=YoloLossConfig)
    ema_alpha: float = 0.0
    ema_start_step: int = 0
    grad_accum: int = 1
    multi_scale: bool = False       # darknet random=1
    multi_scale_every: int = 10     # batches between size draws
    multi_scale_sizes: tuple = MULTISCALE_SIZES


def train_config_from_cfg(cfg_path: str, model_cfg: ModelConfig
                          ) -> TrainConfig:
    """The TrainConfig a darknet .cfg's [net] section and head sections
    give, as the JAX package's train command resolves them with no flag
    set (cli/train_cmd.py with train_helpers.py::_optimizer_from,
    _lr_schedule_from and _batch_accum_from): lr 1e-4, momentum 0.9,
    decay 5e-4, no burn-in, constant lr, SGD and no accumulation where
    the cfg is silent; policy steps / poly / step / exp / sigmoid / sgdr
    with their keys, adam=1 with B1/B2/eps, subdivisions as grad_accum,
    ema_alpha with its start at max_batches // 2; the loss configs from
    ``model_cfg`` (parsed from the same file); policy=random as the JAX
    command's --allow-deviations at --seed 0 gives it (lr_random, seed
    0). Where the JAX command exits, this raises ValueError."""
    from yolo_tpu_torch.configs.darknet_cfg import net_training_params
    from yolo_tpu_torch.train.loss import (region_loss_config,
                                           yolo_loss_config)

    hp = net_training_params(cfg_path)
    kw = {"optimizer": "adam" if hp.get("adam") else "sgd"}
    if kw["optimizer"] == "adam":
        kw.update(adam_b1=hp.get("B1", 0.9), adam_b2=hp.get("B2", 0.999),
                  adam_eps=hp.get("eps", 1e-7))
    kw["lr_poly_power"] = float(hp.get("power", 4.0))
    policy = hp.get("policy", "constant")
    if policy == "steps":
        if "steps" not in hp or "scales" not in hp:
            raise ValueError("[net] policy=steps needs both steps and "
                             "scales (darknet refuses this cfg too)")
        if len(hp["steps"]) != len(hp["scales"]):
            raise ValueError("[net] steps and scales lengths differ")
        kw.update(lr_decay_steps=hp["steps"], lr_decay_scales=hp["scales"])
    elif policy == "poly":
        if not hp.get("max_batches"):
            raise ValueError("[net] policy=poly needs max_batches "
                             "(darknet's decay horizon)")
        kw["lr_poly_max_steps"] = int(hp["max_batches"])
    elif policy == "step":
        kw["lr_step_size"] = int(hp.get("step", 1))
        kw["lr_step_scale"] = float(hp.get("scale", 1.0))
    elif policy in ("exp", "sigmoid"):
        gamma = float(hp.get("gamma", 1.0))
        if gamma <= 0:
            raise ValueError(f"[net] policy={policy} gamma={gamma:g} must "
                             f"be > 0")
        if policy == "exp":
            kw["lr_exp_gamma"] = gamma
        else:
            kw.update(lr_sig_gamma=gamma, lr_sig_step=int(hp.get("step", 1)))
    elif policy == "sgdr":
        cycle = int(hp.get("sgdr_cycle", hp.get("max_batches", 0)))
        if not cycle:
            raise ValueError("[net] policy=sgdr needs sgdr_cycle or "
                             "max_batches (the first cycle length)")
        kw.update(lr_sgdr_cycle=cycle, lr_sgdr_mult=int(hp.get("sgdr_mult",
                                                               2)),
                  lr_min=float(hp.get("learning_rate_min", 1e-5)))
    elif policy == "random":
        kw["lr_random"] = True
    batch = int(hp.get("batch", 32))
    accum = int(hp.get("subdivisions", 1))
    if accum < 1 or batch % accum:
        raise ValueError(f"[net] batch={batch} is not divisible by "
                         f"subdivisions={accum}")
    tcfg = TrainConfig(
        learning_rate=hp.get("learning_rate", 1e-4),
        burn_in_steps=hp.get("burn_in", 0),
        momentum=hp.get("momentum", 0.9),
        weight_decay=hp.get("decay", 5e-4), grad_accum=accum,
        ema_alpha=hp.get("ema_alpha", 0.0),
        ema_start_step=hp.get("max_batches", 0) // 2,
        loss=region_loss_config(model_cfg),
        yolo_loss=yolo_loss_config(model_cfg), **kw)
    return tcfg


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates: the module (params and rolling
    statistics), the optimizer, the completed steps, the images seen and
    the EMA track (per conv, name -> tensor) when ema_alpha > 0."""
    net: DarknetTrain
    optimizer: torch.optim.Optimizer
    step: int = 0
    seen: int = 0
    ema: Optional[List[Dict[str, torch.Tensor]]] = None


def _kernel_mask(net: DarknetTrain):
    """(decayed, not decayed) parameters: darknet decays the kernels and
    the weighted shortcuts' blend weights (loop.py::_kernel_mask)."""
    decay, rest = [], []
    for b in net.blocks:
        for name, p in b.named_parameters(recurse=False):
            (decay if name in ("kernel", "weights") else rest).append(p)
    return decay, rest


def lr_schedule(cfg: TrainConfig):
    """Darknet LR schedule (network.c get_current_rate) -> fn(step) ->
    np.float32, computed in float32 in the JAX schedule's order, with
    subnormal results flushed to zero as XLA does. While
    batch_num < burn_in it returns the ramp lr * (batch_num /
    burn_in)^power alone; after it, the policy term. batch_num = step + 1
    (darknet counts the batch before update_network). policy=random
    multiplies by u^power, u = jax.random.uniform(fold_in(PRNGKey(
    lr_random_seed), batch_num)) as utils/prng.py draws it."""
    tiny = np.finfo(np.float32).tiny

    def f32(v) -> np.float32:
        # XLA flushes subnormal floats to zero; so does the schedule
        v = np.float32(v)
        return v if abs(v) >= tiny else np.float32(0.0)

    base = f32(cfg.learning_rate)
    power = f32(cfg.lr_poly_power)

    def schedule(step: int) -> np.float32:
        bnum = int(step) + 1
        fb = f32(bnum)
        policy_lr = base
        for at, scale in zip(cfg.lr_decay_steps, cfg.lr_decay_scales):
            if bnum >= at:
                policy_lr = f32(policy_lr * f32(scale))
        if cfg.lr_poly_max_steps:
            frac = max(f32(f32(1.0) - fb / f32(cfg.lr_poly_max_steps)),
                       f32(0.0))
            policy_lr = f32(policy_lr * f32(frac ** power))
        if cfg.lr_step_size:
            policy_lr = f32(policy_lr * f32(
                f32(cfg.lr_step_scale) ** f32(bnum // cfg.lr_step_size)))
        if cfg.lr_exp_gamma:
            policy_lr = f32(policy_lr * f32(f32(cfg.lr_exp_gamma) ** fb))
        if cfg.lr_sig_gamma:
            with np.errstate(over="ignore"):   # exp -> inf gives lr 0
                policy_lr = f32(policy_lr / f32(f32(1.0) + np.exp(f32(
                    f32(cfg.lr_sig_gamma) * f32(fb - f32(cfg.lr_sig_step))))))
        if cfg.lr_random:
            u = prng.uniform(prng.fold_in(prng.PRNGKey(cfg.lr_random_seed),
                                          bnum))
            policy_lr = f32(policy_lr * f32(u ** power))
        if cfg.lr_sgdr_cycle:
            # the boundary batch stays in the old cycle (strict <)
            lo = f32(cfg.lr_min)
            start, size = 0, cfg.lr_sgdr_cycle
            if cfg.lr_sgdr_mult <= 1:
                start = ((bnum - 1) // size) * size
            else:
                while bnum > start + size:
                    start, size = start + size, size * cfg.lr_sgdr_mult
            frac = f32(f32(fb - f32(start)) / f32(size))
            policy_lr = f32(lo + f32(f32(0.5) * f32(policy_lr - lo)) * f32(
                f32(1.0) + np.cos(f32(f32(np.pi) * frac))))
        if not cfg.burn_in_steps or bnum >= cfg.burn_in_steps:
            return f32(policy_lr)
        ramp = min(f32(f32(fb / f32(cfg.burn_in_steps)) ** power), f32(1.0))
        return f32(base * ramp)

    return schedule


def make_optimizer(net: DarknetTrain, cfg: TrainConfig
                   ) -> torch.optim.Optimizer:
    """SGD with momentum or Adam over two parameter groups: kernels with
    the weight decay, gamma/beta/bias without."""
    decay, rest = _kernel_mask(net)
    groups = [{"params": decay, "weight_decay": cfg.weight_decay},
              {"params": rest, "weight_decay": 0.0}]
    lr = float(cfg.learning_rate)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=cfg.momentum,
                               dampening=0.0, nesterov=False)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(groups, lr=lr,
                                betas=(cfg.adam_b1, cfg.adam_b2),
                                eps=cfg.adam_eps)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def init_state(mcfg: ModelConfig, params, tcfg: TrainConfig, *,
               seen: int = 0, device="cuda") -> TrainState:
    """Train state from unfolded numpy params (darknet_weights.load /
    load_partial + random_params) on ``device``: "cuda" by default,
    which raises without a card; "cpu" only when asked for."""
    if not 0.0 <= tcfg.ema_alpha < 1.0:
        raise ValueError(
            f"ema_alpha={tcfg.ema_alpha} out of range [0, 1): 0 "
            f"disables, scaled-yolov4 cfgs use 0.9998; 1.0 would never "
            f"move off the initial weights")
    net = DarknetTrain(mcfg.layers, params, device=resolve_device(device),
                       eps=mcfg.bn_eps)
    state = TrainState(net=net, optimizer=make_optimizer(net, tcfg),
                       seen=int(seen))
    if tcfg.ema_alpha:
        state.ema = [{k: v.detach().clone()
                      for k, v in b.named_parameters(recurse=False)}
                     for b in net.blocks]
    return state


def _hwio(name: str, t: torch.Tensor) -> torch.Tensor:
    """A trained tensor in the checkpoint layout (HWIO kernels)."""
    return t.permute(2, 3, 1, 0) if name == "kernel" and t.dim() == 4 else t


def _from_hwio(name: str, t: torch.Tensor, device) -> torch.Tensor:
    t = t.permute(3, 2, 0, 1) if name == "kernel" and t.dim() == 4 else t
    return t.to(device=device, dtype=torch.float32).contiguous()


def state_to_tree(state: TrainState) -> Dict[str, Any]:
    """The train state as an io.checkpoint tree: params (and the EMA
    track) in the JAX package's numpy layout, the optimizer's per-tensor
    state, step and seen."""
    net, opt = state.net, state.optimizer
    as_tree = lambda blocks: [{k: torch.from_numpy(v) for k, v in b.items()}
                              for b in blocks]
    tree: Dict[str, Any] = {"params": as_tree(net.to_numpy()),
                            "step": int(state.step), "seen": int(state.seen)}
    if state.ema is not None:
        tree["ema_params"] = as_tree(net.to_numpy(state.ema))
    adam = isinstance(opt, torch.optim.Adam)
    names = ("exp_avg", "exp_avg_sq") if adam else ("momentum_buffer",)
    opt_tree: Dict[str, Any] = {"optimizer": "adam" if adam else "sgd"}
    per = {n: [] for n in names}
    count = 0
    for b in net.blocks:
        for n in names:
            per[n].append({})
        for name, p in b.named_parameters(recurse=False):
            st = opt.state.get(p, {})
            for n in names:
                if st.get(n) is not None:
                    per[n][-1][name] = _hwio(name, st[n].detach()).cpu()
            if "step" in st:
                count = int(st["step"])
    if any(per[names[0]]):
        opt_tree.update(per)
    if adam:
        opt_tree["count"] = count
    tree["opt_state"] = opt_tree
    return tree


def state_from_tree(tree: Dict[str, Any], mcfg: ModelConfig,
                    tcfg: TrainConfig, *, device="cuda") -> TrainState:
    """A train state from an io.checkpoint tree (state_to_tree's, or
    io.checkpoint.from_numpy_state's): the same params, rolling
    statistics, optimizer state, step and seen. The EMA track is the
    tree's when both keep one; a run with ema_alpha starts one from the
    params when the tree has none, and a run without drops the tree's
    (the JAX train command's _restore_adapt_ema)."""
    params = [{k: v.numpy() for k, v in b.items()} for b in tree["params"]]
    state = init_state(mcfg, params, tcfg, seen=int(tree["seen"]),
                       device=device)
    state.step = int(tree["step"])
    dev = state.net.device
    if state.ema is not None and "ema_params" in tree:
        state.ema = [{k: _from_hwio(k, src[k], dev) for k in track}
                     for track, src in zip(state.ema, tree["ema_params"])]
    opt_tree = tree.get("opt_state") or {}
    kind = opt_tree.get("optimizer", tcfg.optimizer)
    if kind != tcfg.optimizer:
        raise ValueError(f"the checkpoint's optimizer is {kind}, this run's "
                         f"{tcfg.optimizer}")
    names = (("exp_avg", "exp_avg_sq") if kind == "adam"
             else ("momentum_buffer",))
    if names[0] in opt_tree:
        for i, b in enumerate(state.net.blocks):
            for name, p in b.named_parameters(recurse=False):
                st = {n: _from_hwio(name, opt_tree[n][i][name], dev)
                      for n in names}
                if kind == "adam":
                    st["step"] = torch.tensor(float(opt_tree["count"]))
                state.optimizer.state[p] = st
    return state


def ema_params_of(state: TrainState):
    """The weights a consumer should use, as unfolded numpy params: the
    EMA track when the run keeps one (rolling mean/var stay the live
    net's), else the live params."""
    return state.net.to_numpy(state.ema)


def _loss_fn(state: TrainState, sub: Dict[str, torch.Tensor], seen: int,
             dropout_key: np.ndarray, *, mcfg: ModelConfig, tcfg: TrainConfig,
             compute_dtype, net: Optional[DarknetTrain] = None, shard=None):
    """The loss of one (sub-)batch on ``net`` (the state's by default).
    shard: ``sub`` is one shard of a batch that other shards forward at
    the same time (DarknetTrain.forward); the loss then divides by the
    whole batch, shard.total, and the shards' losses sum to its loss."""
    classifier = mcfg.head_kind == "softmax"
    net = state.net if net is None else net
    total_b = None if shard is None else shard.total
    logits, bn_updates = net(
        sub["images"], compute_dtype=compute_dtype,
        bn_stats_fp32=tcfg.bn_stats_fp32, remat=tcfg.remat,
        softmax_logits=classifier, dropout_key=dropout_key, shard=shard)
    if classifier:
        # the SoftmaxHead layer holds the tree and temperature that
        # inference applies, so training reads them there too
        head = next(l for l in mcfg.layers if isinstance(l, SoftmaxHead))
        total, parts = classifier_loss(logits, sub["labels"], tree=head.tree,
                                       temperature=head.temperature,
                                       batch_total=total_b)
    elif mcfg.head_kind == "detection":
        total, parts = detection_loss(logits, sub, mcfg.detection_head,
                                      batch_total=total_b)
    elif mcfg.head_kind == "yolo":
        if mcfg.objectness_smooth:
            # as the JAX package's train_step: no reference source pins
            # the IoU-derived objectness targets
            raise NotImplementedError(
                "[yolo] objectness_smooth=1 training is not supported")
        heads = mcfg.yolo_heads
        total, parts = yolo_loss(
            logits, sub, mcfg.anchors, [h.mask for h in heads],
            mcfg.num_classes, tuple(sub["images"].shape[1:3]),
            tcfg.yolo_loss, scales=[h.scale_xy for h in heads],
            max_deltas=[h.max_delta for h in heads],
            smooth_eps=[h.label_smooth_eps for h in heads],
            new_coords=[h.new_coords for h in heads],
            gaussian=[h.gaussian for h in heads], batch_total=total_b)
    else:
        total, parts = region_loss(logits, sub, mcfg.anchors,
                                   mcfg.num_classes, tcfg.loss, seen,
                                   tree=mcfg.tree, batch_total=total_b)
    return total, parts, bn_updates


def train_step(state: TrainState, batch: Dict[str, Any], *,
               mcfg: ModelConfig, tcfg: TrainConfig,
               compute_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """One optimizer step, in place on ``state``. batch: 'images' (B, S,
    S, 3) in [0, 1] and the targets of data.targets.encode_batch_for, as
    tensors on the state's device. Returns the loss and its parts as
    0-d tensors (no host sync)."""
    net = state.net
    images = batch["images"]
    batch_size = images.shape[0]
    accum = max(1, int(tcfg.grad_accum))
    if batch_size % accum:
        raise ValueError(
            f"batch {batch_size} not divisible by grad_accum {accum} "
            f"(darknet requires batch % subdivisions == 0 too)")
    for key, t in batch.items():
        if isinstance(t, torch.Tensor) and t.device != net.device:
            raise ValueError(f"batch[{key!r}] is on {t.device}, the state "
                             f"on {net.device}")
    state.optimizer.zero_grad(set_to_none=True)
    # the JAX step's key: fold_in(PRNGKey(0), step), folded again with
    # the sub-batch index under accumulation
    step_key = prng.fold_in(prng.PRNGKey(0), state.step)
    loss_fn = partial(_loss_fn, mcfg=mcfg, tcfg=tcfg,
                      compute_dtype=compute_dtype)
    sub_bs = batch_size // accum
    losses, parts_list = [], []
    with exact_for(compute_dtype):
        for i in range(accum):
            sub = ({k: v[i::accum] for k, v in batch.items()}
                   if accum > 1 else batch)
            loss, parts, bn_updates = loss_fn(
                state, sub, state.seen + i * sub_bs,
                prng.fold_in(step_key, i) if accum > 1 else step_key)
            loss.backward()
            # rolling statistics chain through the sub-passes; mean/var
            # take no gradient, so the weight gradients are unchanged
            apply_bn_updates(net, bn_updates)
            losses.append(loss.detach())
            parts_list.append({k: v.detach() for k, v in parts.items()})
    return finish_step(state, tcfg, batch_size, losses, parts_list)


def finish_step(state: TrainState, tcfg: TrainConfig, batch_size: int,
                losses: List[torch.Tensor],
                parts_list: List[Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """The end of a step, once the net's gradients hold the sum of the
    sub-batches': their mean, the optimizer at this step's rate, the EMA
    track, the counters (batch_size images seen) and the metrics, the
    means over the sub-batches of each loss and part."""
    net = state.net
    accum = len(losses)
    if accum > 1:
        # each sub-loss is a mean over its sub-batch: the mean of the
        # per-sub gradients is the whole-batch gradient
        for p in net.parameters():
            if p.grad is not None:
                p.grad.div_(accum)
    lr = float(lr_schedule(tcfg)(state.step))   # the float32 rate
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    if state.ema is not None:
        # before ema_start_step the track mirrors the live weights
        a = np.float32(tcfg.ema_alpha if state.step >= tcfg.ema_start_step
                       else 0.0)
        with torch.no_grad():
            for track, b in zip(state.ema, net.blocks):
                for k, v in b.named_parameters(recurse=False):
                    track[k].copy_(float(a) * track[k]
                                   + float(np.float32(1.0) - a) * v)
    state.step += 1
    state.seen += batch_size
    metrics = {k: torch.stack([p[k] for p in parts_list]).mean()
               for k in parts_list[0]}
    metrics["loss"] = torch.stack(losses).mean()
    return metrics


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig,
                    compute_dtype=torch.float32):
    """``fn(state, batch) -> metrics``, train_step bound to its configs."""
    return partial(train_step, mcfg=mcfg, tcfg=tcfg,
                   compute_dtype=compute_dtype)


def pick_scale(step: int, rng: np.random.Generator, every: int = 10,
               sizes: tuple = MULTISCALE_SIZES):
    """Multi-scale size for this step, changing every ``every`` steps;
    None on the steps between. Entries are square ints or (net_h, net_w)
    tuples."""
    if step % every:
        return None
    s = sizes[int(rng.integers(0, len(sizes)))]
    return s if isinstance(s, tuple) else int(s)


def pick_scale_indexed(step: int, seed: int, every: int = 10,
                       sizes: tuple = MULTISCALE_SIZES):
    """Random-access pick_scale: the size for any step from (seed,
    step) alone, one draw per ``every``-step interval."""
    interval = step // max(every, 1)
    u = np.random.default_rng((int(seed), int(interval))).integers(
        0, len(sizes))
    s = sizes[int(u)]
    return s if isinstance(s, tuple) else int(s)


def proportional_sizes(net_h: int, net_w: int,
                       coef: float = 1.4) -> tuple:
    """Aspect-preserving multi-scale ladder for rectangular nets: the
    long side steps through its /32 ladder over [long/coef, long*coef],
    the short side scales with it (floor 32); the cfg's own size is
    always a member."""
    if coef <= 1.0:
        raise ValueError(f"multi-scale coefficient must be > 1, "
                         f"got {coef:g}")
    long_is_w = net_w >= net_h
    long, short = (net_w, net_h) if long_is_w else (net_h, net_w)
    lo = max(32, int(round(long / coef / 32)) * 32)
    hi = max(lo, int(round(long * coef / 32)) * 32)
    out = []
    for ell in range(lo, hi + 1, 32):
        s = max(32, int(round(short * (ell / long) / 32)) * 32)
        hw = (s, ell) if long_is_w else (ell, s)
        if hw not in out:
            out.append(hw)
    base = (net_h, net_w)
    if base not in out:
        out.append(base)
        out.sort()
    return tuple(out)
