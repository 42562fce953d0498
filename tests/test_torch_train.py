"""The port's training path (yolo_tpu_torch.train, DarknetTrain,
load_partial) against the JAX package, on the CPU, on the same seeded
numpy inputs.

Tolerances:
  * region loss, fp32: value, parts and the autograd gradient to a
    relative 1e-4 of JAX's (and of the loop delta oracle in float64).
  * train-mode forward, fp32: logits and new BN statistics to a relative
    1e-5 (of each tensor's largest magnitude): the convs sum in other
    orders (oneDNN vs XLA).
  * train steps, fp32: after each of 3 steps, params and BN statistics
    within 2e-5 of each tensor's largest magnitude, loss parts to a
    relative 1e-4. Adam moves every element by about lr whatever the
    gradient's size, so an element whose gradient is a rounding error
    away from zero may step the other way: Adam holds 99% of the
    elements within 2e-5 of the scale and every one within 2 lr per
    step, and its loss parts to a relative 1e-3.
  * bf16: the conv output is rounded to bf16 before BN on both sides,
    and a sum near a rounding boundary may round the other way; maxpool
    may route a tied window's gradient to another element. The forward
    is held closely (test_train_forward_matches_jax_bf16); train steps
    against the distance between JAX's own bf16 and fp32 runs
    (test_train_steps_match_jax_bf16).
  * lr_schedule: float32, within 1 ulp of the JAX schedule run op by op
    (under jit XLA turns a division by a constant into a product with
    its reciprocal, a few ulps away).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.delta_oracle import region_delta_np
from tests.torch_port import to_jax_config
from yolo_tpu.data import targets as jtgt
from yolo_tpu.io import darknet_weights as jdw
from yolo_tpu.models import graph as jgraph
from yolo_tpu.train import loop as jloop
from yolo_tpu.train import loss as jloss
from yolo_tpu_torch.configs import (Conv, MaxPool, ModelConfig, Reorg, Route,
                                    VARIANTS, get_variant)
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import graph as tgraph
from yolo_tpu_torch.train import loop as tloop
from yolo_tpu_torch.train import loss as tloss

torch.set_num_threads(1)

ANCHORS3 = ((1.0, 1.5), (3.0, 3.0), (6.0, 4.0))

# the yolov2 layer set at narrow widths: convs with and without BN, 1x1
# and 3x3, maxpool, the passthrough route + reorg + concat
NARROW_V2 = ModelConfig(
    name="narrow-v2",
    layers=(
        Conv(8), MaxPool(),                     # 0-1
        Conv(16), MaxPool(),                    # 2-3
        Conv(16), Conv(8, 1), Conv(16),         # 4-6
        MaxPool(),                              # 7
        Conv(16), MaxPool(),                    # 8-9
        Conv(32),                               # 10 (/16, passthrough)
        MaxPool(),                              # 11
        Conv(32), Conv(32),                     # 12-13
        Route((-4,)),                           # 14 -> 10
        Conv(8, 1),                             # 15
        Reorg(2),                               # 16
        Route((-1, -4)),                        # 17 -> (16, 13)
        Conv(32),                               # 18
        Conv(3 * (5 + 4), size=1, bn=False, act="linear"),   # 19
    ),
    anchors=ANCHORS3,
    class_names=("a", "b", "c", "d"),
    input_size=96,
)


def _scale_close(got, want, frac):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale)


def _scene(rng, b, grid, c, anchors=ANCHORS3):
    boxes, classes = [], []
    for _ in range(b):
        g = rng.integers(1, 4)
        boxes.append(np.stack([
            rng.uniform(0.2, 0.8, g), rng.uniform(0.2, 0.8, g),
            rng.uniform(0.05, 0.5, g), rng.uniform(0.05, 0.5, g)], axis=-1))
        classes.append(rng.integers(0, c, g))
    return boxes, classes


def _batch(cfg, seed, b=4):
    """Seeded images and encoded targets as numpy (the JAX encoder)."""
    rng = np.random.default_rng(seed)
    grid = cfg.input_size // 32
    boxes, classes = _scene(rng, b, grid, cfg.num_classes, cfg.anchors)
    enc = jtgt.encode_batch(boxes, classes, grid=grid, anchors=cfg.anchors,
                            num_classes=cfg.num_classes)
    enc["images"] = rng.uniform(
        0, 1, (b, cfg.input_size, cfg.input_size, 3)).astype(np.float32)
    return enc


def _params(cfg, seed=0):
    """random_params with He-scaled kernels, so activations stay O(1)."""
    params = dw.random_params(cfg.layers, np.random.default_rng(seed))
    for p in params:
        k = p["kernel"]
        p["kernel"] = (k * (np.sqrt(2.0 / np.prod(k.shape[:3])) / 0.1)) \
            .astype(np.float32)
    return params


# --- configs -------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_region_training_fields_match_jax(variant):
    from yolo_tpu.configs import get_variant as jax_get_variant

    cfg, jcfg = get_variant(variant), jax_get_variant(variant)
    for f in ("region_thresh", "region_object_scale",
              "region_noobject_scale", "region_class_scale",
              "region_coord_scale", "region_rescore"):
        assert getattr(cfg, f) == getattr(jcfg, f)
    assert dataclasses.asdict(tloss.region_loss_config(cfg)) == \
        dataclasses.asdict(jloss.region_loss_config(jcfg))


# --- region loss -----------------------------------------------------------

@pytest.mark.parametrize("seen,rescore,seed", [
    (0, True, 11), (20000, True, 11), (0, False, 77), (20000, False, 202)])
def test_region_loss_and_gradient_match_jax(seen, rescore, seed):
    rng = np.random.default_rng(seed)
    b, s, c = 2, 4, 4
    cfg = jloss.LossConfig(rescore=rescore)
    tcfg = tloss.LossConfig(**dataclasses.asdict(cfg))
    logits = rng.normal(0, 1, (b, s, s, 3 * (5 + c))).astype(np.float32)
    boxes, classes = _scene(rng, b, s, c)
    targets = jtgt.encode_batch(boxes, classes, grid=s, anchors=ANCHORS3,
                                num_classes=c)

    tj = {k: jnp.asarray(v) for k, v in targets.items()}
    (jtotal, jparts), jgrad = jax.value_and_grad(
        lambda l: jloss.region_loss(l, tj, ANCHORS3, c, cfg,
                                    jnp.asarray(seen)), has_aux=True)(
        jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    tt = {k: torch.from_numpy(v) for k, v in targets.items()}
    total, parts = tloss.region_loss(tl, tt, ANCHORS3, c, tcfg, seen)
    total.backward()

    parts = {k: float(v.detach()) for k, v in parts.items()}
    assert set(parts) == set(jparts)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-4)
    for k in parts:
        np.testing.assert_allclose(parts[k], float(jparts[k]), rtol=1e-4,
                                   atol=1e-7)
    assert (parts["warmup"] > 0) == (seen < 12800)
    _scale_close(tl.grad.numpy(), np.asarray(jgrad), 1e-4)
    want = region_delta_np(logits, targets, ANCHORS3, c, cfg, seen)
    _scale_close(tl.grad.numpy(), want, 1e-4)


# --- train-mode forward ----------------------------------------------------

def test_train_forward_matches_jax_fp32():
    cfg = NARROW_V2
    jcfg = to_jax_config(cfg)
    params = _params(cfg)
    x = _batch(cfg, 3)["images"]
    jlogits, jstats = jgraph.apply_layers(
        jcfg.layers, jgraph.params_to_jax(params), jnp.asarray(x),
        eps=cfg.bn_eps, train=True)
    net = tgraph.DarknetTrain(cfg.layers, params, device="cpu")
    with torch.no_grad():
        logits, stats = net(torch.from_numpy(x))
    _scale_close(logits.numpy(), np.asarray(jlogits), 1e-5)
    assert set(stats) == set(jstats)
    for i in stats:
        for key in ("mean", "var"):
            _scale_close(stats[i][key].numpy(), np.asarray(jstats[i][key]),
                         1e-5)


def test_remat_gives_the_same_step():
    """remat re-runs each block in the backward: the same gradients, and
    the rolling statistics still move once per step."""
    cfg = NARROW_V2
    params, batch = _params(cfg), _batch(cfg, 5)
    out = []
    for remat in (False, True):
        tcfg = tloop.TrainConfig(learning_rate=1e-2, remat=remat)
        state = tloop.init_state(cfg, params, tcfg, device="cpu")
        tloop.train_step(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                         mcfg=cfg, tcfg=tcfg)
        out.append(state.net.to_numpy())
    for p, q in zip(*out):
        for key in p:
            np.testing.assert_array_equal(p[key], q[key])


# --- train steps -------------------------------------------------------------

STEP_CASES = {
    # darknet's SGD: momentum, kernel-only decay, burn-in ramp, steps
    "sgd_burn_in": (dict(learning_rate=1e-3, momentum=0.9,
                         weight_decay=5e-4, burn_in_steps=2,
                         lr_decay_steps=(3,), lr_decay_scales=(0.1,)),
                    2e-5),
    "adam": (dict(learning_rate=1e-3, optimizer="adam", weight_decay=5e-4),
             2e-5),
    "grad_accum_2": (dict(learning_rate=1e-3, grad_accum=2), 2e-5),
    "ema": (dict(learning_rate=1e-3, ema_alpha=0.9, ema_start_step=1),
            2e-5),
}


def _compare_state(state, jstate, frac, ema=False, adam_cap=None):
    """Params and BN statistics within frac of each tensor's scale; with
    adam_cap, 1% of the elements may instead lie within adam_cap."""
    got = tloop.ema_params_of(state) if ema else state.net.to_numpy()
    want = (jloop.ema_params_of(jstate) if ema else jstate["params"])
    far = total = 0
    for i, (p, q) in enumerate(zip(got, want, strict=True)):
        assert set(p) == set(q)
        for key in p:
            q_key = np.asarray(q[key], np.float64)
            if adam_cap is None:
                _scale_close(p[key], q_key, frac)
                continue
            d = np.abs(p[key] - q_key)
            assert d.max() <= adam_cap, (i, key, d.max())
            far += int((d > frac * np.abs(q_key).max()).sum())
            total += d.size
    assert far <= 1e-2 * total, (far, total)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax_fp32(case):
    kw, frac = STEP_CASES[case]
    # Adam's elements that stepped the other way move the later losses
    loss_rtol = 1e-3 if kw.get("optimizer") == "adam" else 1e-4
    cfg = NARROW_V2
    jcfg = to_jax_config(cfg)
    params = _params(cfg, seed=1)
    jstate = jloop.init_state(params, jloop.TrainConfig(**kw))
    jstep = jloop.make_train_step(jcfg, jloop.TrainConfig(**kw))
    tcfg = tloop.TrainConfig(**kw)
    state = tloop.init_state(cfg, params, tcfg, device="cpu")
    step = tloop.make_train_step(cfg, tcfg)
    for i in range(3):
        batch = _batch(cfg, 100 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=loss_rtol, atol=1e-7)
        cap = (2 * kw["learning_rate"] * (i + 1)
               if kw.get("optimizer") == "adam" else None)
        _compare_state(state, jstate, frac, adam_cap=cap)
        if kw.get("ema_alpha"):
            _compare_state(state, jstate, frac, ema=True)
    assert state.step == int(jstate["step"]) == 3
    assert state.seen == int(jstate["seen"]) == 12


def test_train_forward_matches_jax_bf16():
    """bf16 train-mode forward: the first block (a bf16 conv, BN on its
    bf16 output in fp32, leaky, bf16) equals JAX's on >= 99.9% of its
    elements; the logits lie within 2e-2 of the scale of JAX's bf16
    logits, closer than JAX's own bf16 lies to its fp32."""
    cfg = NARROW_V2
    jcfg = to_jax_config(cfg)
    params = _params(cfg, 3)
    x = _batch(cfg, 200)["images"]
    jp = jgraph.params_to_jax(params)
    jouts = jgraph.apply_layers(jcfg.layers, jp, jnp.asarray(x),
                                eps=cfg.bn_eps, train=True,
                                compute_dtype=jnp.bfloat16, return_all=True)
    jlogits, _ = jgraph.apply_layers(jcfg.layers, jp, jnp.asarray(x),
                                     eps=cfg.bn_eps, train=True,
                                     compute_dtype=jnp.bfloat16)
    j32, _ = jgraph.apply_layers(jcfg.layers, jp, jnp.asarray(x),
                                 eps=cfg.bn_eps, train=True)
    net = tgraph.DarknetTrain(cfg.layers, params, device="cpu")
    b = net.blocks[0]
    with torch.no_grad():
        logits, _ = net(torch.from_numpy(x), compute_dtype=torch.bfloat16)
        y, _, _ = tgraph._train_conv_block(
            torch.from_numpy(x).permute(0, 3, 1, 2), b.kernel, b.gamma,
            b.beta, b.mean, b.var, None, spec=cfg.layers[0], eps=cfg.bn_eps,
            compute_dtype=torch.bfloat16, bn_stats_fp32=True)
    assert y.dtype == torch.bfloat16
    same = (y.float().permute(0, 2, 3, 1).numpy()
            == np.asarray(jouts[0]).astype(np.float32))
    assert same.mean() >= 0.999
    scale = float(np.abs(np.asarray(j32)).max())
    err = float(np.abs(logits.numpy() - np.asarray(jlogits)).max())
    assert err <= 2e-2 * scale
    assert err <= float(np.abs(np.asarray(jlogits) - np.asarray(j32)).max())


def test_train_steps_match_jax_bf16():
    """3 bf16 SGD steps beside JAX's bf16 and fp32 runs from the same
    state: each step's loss, and each param and statistic tensor after
    the third, lie as close to JAX's bf16 run as 3x JAX's own bf16-to-
    fp32 distance plus 1e-2 of the value (loss) or 1e-3 of the scale
    (tensors). bf16 rounding at batch 4 moves the loss parts by up to
    25% between any two of these runs."""
    kw = dict(learning_rate=1e-3, momentum=0.9, weight_decay=5e-4)
    cfg = NARROW_V2
    jcfg = to_jax_config(cfg)
    params = _params(cfg, seed=2)
    jtcfg = jloop.TrainConfig(**kw)
    jstate, j32state = (jloop.init_state(params, jtcfg),
                        jloop.init_state(params, jtcfg))
    jstep = jloop.make_train_step(jcfg, jtcfg, compute_dtype=jnp.bfloat16)
    j32step = jloop.make_train_step(jcfg, jtcfg)
    tcfg = tloop.TrainConfig(**kw)
    state = tloop.init_state(cfg, params, tcfg, device="cpu")
    step = tloop.make_train_step(cfg, tcfg, compute_dtype=torch.bfloat16)
    for i in range(3):
        batch = _batch(cfg, 200 + i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jstate, jm = jstep(jstate, jb)
        j32state, jm32 = j32step(j32state, jb)
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        want, ref = float(jm["loss"]), float(jm32["loss"])
        assert abs(float(m["loss"]) - want) <= \
            3 * abs(want - ref) + 1e-2 * abs(want)
    for p, q, r in zip(state.net.to_numpy(), jstate["params"],
                       j32state["params"], strict=True):
        for key in p:
            q_key, r_key = np.asarray(q[key]), np.asarray(r[key])
            bound = (3 * np.abs(q_key - r_key).max()
                     + 1e-3 * np.abs(q_key).max())
            assert np.abs(p[key] - q_key).max() <= bound, key


def test_grad_accum_rejects_a_ragged_split():
    cfg = NARROW_V2
    tcfg = tloop.TrainConfig(grad_accum=3)
    state = tloop.init_state(cfg, _params(cfg), tcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    with pytest.raises(ValueError, match="grad_accum"):
        tloop.train_step(state, batch, mcfg=cfg, tcfg=tcfg)


def test_optimizer_decays_kernels_only():
    cfg = NARROW_V2
    state = tloop.init_state(cfg, _params(cfg), tloop.TrainConfig(),
                             device="cpu")
    decay, rest = state.optimizer.param_groups
    assert decay["weight_decay"] == 5e-4 and rest["weight_decay"] == 0.0
    assert all(p.dim() == 4 for p in decay["params"])
    assert all(p.dim() == 1 for p in rest["params"])
    n_convs = len([l for l in cfg.layers if isinstance(l, Conv)])
    assert len(decay["params"]) == n_convs


# --- LR schedule -------------------------------------------------------------

SCHEDULES = {
    "constant": {},
    "yolov2_voc": dict(learning_rate=1e-3, burn_in_steps=1000,
                       lr_decay_steps=(40000, 60000),
                       lr_decay_scales=(0.1, 0.1)),
    "poly": dict(learning_rate=1e-3, burn_in_steps=100,
                 lr_poly_max_steps=5000, lr_poly_power=4.0),
    "step": dict(learning_rate=0.1, lr_step_size=700, lr_step_scale=0.5),
    "exp": dict(learning_rate=0.1, lr_exp_gamma=0.9995),
    "sigmoid": dict(learning_rate=0.1, lr_sig_gamma=0.01, lr_sig_step=2000),
    "sgdr_mult1": dict(learning_rate=0.1, lr_sgdr_cycle=500, lr_sgdr_mult=1),
    "sgdr_mult2": dict(learning_rate=0.1, lr_sgdr_cycle=300, lr_sgdr_mult=2,
                       burn_in_steps=50, lr_poly_power=2.0),
}
SCHEDULE_STEPS = (0, 1, 2, 49, 50, 98, 99, 100, 299, 300, 499, 500, 699,
                  700, 998, 999, 1000, 1999, 2000, 2100, 4999, 5000, 39998,
                  39999, 40000, 59999, 60000, 100000)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(name):
    kw = SCHEDULES[name]
    jfn = jloop.lr_schedule(jloop.TrainConfig(**kw))
    fn = tloop.lr_schedule(tloop.TrainConfig(**kw))
    for step in SCHEDULE_STEPS:
        want = np.float32(jfn(jnp.asarray(step, jnp.int32)))
        got = fn(step)
        assert isinstance(got, np.float32)
        assert abs(int(got.view(np.int32)) - int(want.view(np.int32))) <= 1, \
            (step, got, want)


def test_lr_random_is_not_ported():
    """policy=random was the one schedule left unported (ROADMAP A9e,
    now closed): lr_schedule and make_train_step take lr_random, and
    its rates equal the JAX schedule's bit for bit
    (tests/test_torch_prng.py holds more steps and seeds)."""
    kw = dict(learning_rate=1e-3, lr_random=True, lr_random_seed=5)
    jfn = jloop.lr_schedule(jloop.TrainConfig(**kw))
    fn = tloop.lr_schedule(tloop.TrainConfig(**kw))
    for step in SCHEDULE_STEPS:
        want = np.float32(jfn(jnp.asarray(step, jnp.int32)))
        assert fn(step).view(np.int32) == want.view(np.int32), step
    tloop.make_train_step(NARROW_V2, tloop.TrainConfig(**kw))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.init_state(NARROW_V2, _params(NARROW_V2), tloop.TrainConfig())


@pytest.mark.parametrize("kw", [
    dict(every=10), dict(every=3, sizes=((320, 416), (352, 480)))])
def test_scale_pickers_match_jax(kw):
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    for step in range(25):
        assert tloop.pick_scale(step, rng_a, **kw) == \
            jloop.pick_scale(step, rng_b, **kw)
        assert tloop.pick_scale_indexed(step, 9, **kw) == \
            jloop.pick_scale_indexed(step, 9, **kw)
    assert tloop.proportional_sizes(320, 544) == \
        jloop.proportional_sizes(320, 544)
    assert tloop.proportional_sizes(608, 416, 1.2) == \
        jloop.proportional_sizes(608, 416, 1.2)


# --- weights: load_partial and the weight carry ------------------------------

def test_load_partial_matches_jax(tmp_path):
    """A darknet partial file (the first 23 layers of yolov2-voc, 18
    convs, as darknet19_448.conv.23 is cut) loads the same prefix in
    both packages; a cut inside a layer raises in both."""
    cfg = get_variant("voc")
    jcfg = to_jax_config(cfg)
    params = dw.random_params(cfg.layers, np.random.default_rng(3))
    path = str(tmp_path / "darknet19.conv.23")
    dw.save(path, cfg.layers[:23], params[:18], seen=64)
    got, header, n = dw.load_partial(path, cfg.layers)
    want, jheader, jn = jdw.load_partial(path, jcfg.layers)
    assert n == jn == 18 and header == jheader and header["seen"] == 64
    for p, q in zip(got, want, strict=True):
        assert set(p) == set(q)
        for key in p:
            np.testing.assert_array_equal(p[key], q[key])
    with pytest.raises(ValueError, match="only 18 of 23"):
        dw.load(path, cfg.layers)
    with open(path, "rb") as f:
        data = f.read()
    cut = str(tmp_path / "cut.weights")
    with open(cut, "wb") as f:
        f.write(data[:-400])
    for mod, layers in ((dw, cfg.layers), (jdw, jcfg.layers)):
        with pytest.raises(ValueError, match="ends mid-layer"):
            mod.load_partial(cut, layers)


def test_weight_carry_round_trip():
    """numpy (JAX layout) -> DarknetTrain -> numpy is exact, and the
    trained result serves through fold_params + Darknet."""
    cfg = NARROW_V2
    params = _params(cfg)
    net = tgraph.DarknetTrain(cfg.layers, params, device="cpu")
    back = net.to_numpy()
    for p, q in zip(params, back, strict=True):
        assert set(p) == set(q)
        for key in p:
            assert q[key].dtype == np.float32
            np.testing.assert_array_equal(p[key], q[key])
    tensors = tgraph.train_params_from_numpy(cfg.layers, params, "cpu")
    assert tensors[0]["kernel"].is_contiguous(
        memory_format=torch.channels_last)
    tgraph.Darknet(cfg.layers, tgraph.fold_params(cfg.layers, back),
                   device="cpu")
    with pytest.raises(ValueError, match="unfolded"):
        tgraph.train_params_from_numpy(
            cfg.layers, tgraph.fold_params(cfg.layers, params), "cpu")
