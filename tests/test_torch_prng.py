"""yolo_tpu_torch/utils/prng.py against jax.random, bit for bit, on the
CPU: PRNGKey, fold_in, split, the random bits and uniform, randint and
bernoulli, on many keys and shapes (odd sizes among them), and the
policy=random learning rate of train/loop.py::lr_schedule against the
JAX package's schedule, step by step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yolo_tpu.train import loop as jloop
from yolo_tpu_torch.train import loop as tloop
from yolo_tpu_torch.utils import prng

SEEDS = (0, 1, 3, 42, -1, -7, 2 ** 31 - 1, -2 ** 31, 123456789)
SHAPES = ((), (1,), (2,), (3,), (7, 5), (2, 3, 4, 5), (1, 7, 7, 64),
          (4, 13, 13, 3), (1001,))


def _keys():
    """Keys made every way the JAX package makes them."""
    out = []
    for s in SEEDS:
        k = jax.random.PRNGKey(s)
        out += [k, jax.random.fold_in(k, 7), jax.random.split(k, 3)[2]]
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_fold_in_split(seed):
    key = prng.PRNGKey(seed)
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    assert key.dtype == np.uint32 and key.shape == (2,)
    for d in (0, 1, 7, 1000, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(key, d),
                                      np.asarray(jax.random.fold_in(jkey, d)))
    for n in (1, 2, 3, 5, 17):
        np.testing.assert_array_equal(prng.split(key, n),
                                      np.asarray(jax.random.split(jkey, n)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform(shape):
    for jkey in _keys():
        key = np.asarray(jkey)
        np.testing.assert_array_equal(
            prng.random_bits(key, shape),
            np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
        got = prng.uniform(key, shape)
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(
            got, np.asarray(jax.random.uniform(jkey, shape)))


@pytest.mark.parametrize("bounds", [(0, 1), (0, 2), (0, 5), (0, 65), (3, 17),
                                    (-3, 1000), (0, 2 ** 31 - 1), (5, 5),
                                    (7, 3)])
def test_randint(bounds):
    lo, hi = bounds
    for jkey in _keys():
        for shape in ((), (3,), (7, 5)):
            got = prng.randint(np.asarray(jkey), shape, lo, hi)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(
                got, np.asarray(jax.random.randint(jkey, shape, lo, hi)))


@pytest.mark.parametrize("p", [0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0])
def test_bernoulli(p):
    for jkey in _keys():
        for shape in ((), (5,), (2, 7, 7, 3)):
            got = prng.bernoulli(np.asarray(jkey), p, shape)
            assert got.dtype == np.bool_
            np.testing.assert_array_equal(
                got, np.asarray(jax.random.bernoulli(jkey, p, shape)))


@pytest.mark.parametrize("kw", [
    dict(learning_rate=1e-3, lr_random=True),
    dict(learning_rate=0.1, lr_random=True, lr_random_seed=7,
         lr_poly_power=2.0),
    dict(learning_rate=1e-3, lr_random=True, lr_random_seed=3,
         burn_in_steps=10, lr_decay_steps=(20,), lr_decay_scales=(0.1,))])
def test_lr_random_matches_jax(kw):
    """policy=random's rate at every step equals the JAX TrainConfig's:
    the draw is the same u, and u^power is taken in float32 by both."""
    jfn = jloop.lr_schedule(jloop.TrainConfig(**kw))
    fn = tloop.lr_schedule(tloop.TrainConfig(**kw))
    rates = set()
    for step in list(range(40)) + [99, 1000, 123456]:
        want = np.float32(jfn(jnp.asarray(step, jnp.int32)))
        got = fn(step)
        assert isinstance(got, np.float32)
        assert got.view(np.int32) == want.view(np.int32), (step, got, want)
        rates.add(float(got))
    assert len(rates) > 30
