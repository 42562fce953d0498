"""``jax.random``'s default generator in numpy, bit for bit: threefry2x32
with ``jax_threefry_partitionable`` on (the default since JAX 0.5), for
the draws the JAX package's training makes, so that the port draws the
same values without JAX: [dropout] masks, the [crop] train jitter and
the policy=random learning rate.

A key is a (2,) uint32 array, as ``jax.random.PRNGKey`` returns it.

  * PRNGKey(seed) = [0, seed mod 2^32] (a 32-bit seed; JAX's x32 mode).
  * fold_in(key, d) = threefry2x32(key, (0, d)), the two output words.
  * split(key, n)[i] = fold_in(key, i): the partitionable split hashes
    the 64-bit counter i as (hi, lo) words, as fold_in hashes (0, d).
  * random bits of a shape: element j (row-major) is the xor of the two
    words threefry2x32(key, (j >> 32, j & 0xffffffff)).
  * uniform: bits >> 9 | 0x3f800000 read as float32 in [1, 2), minus 1.
  * randint: two bit draws from split(key), hi % span * (2^32 % span) +
    lo % span, mod span (JAX's multiply-mod, in uint32).
  * bernoulli(key, p, shape) = uniform(key, shape) < p.

Everything runs on the host; masks are copied to the device by the
caller.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under ``key``; uint32 arrays of one shape in and out."""
    k0, k1 = (np.asarray(key, _U32)[i] for i in (0, 1))
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for a seed in [-2^31, 2^31)."""
    if not -2 ** 31 <= int(seed) < 2 ** 31:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data), data a 32-bit integer."""
    a, b = threefry2x32(key, np.zeros(1, _U32),
                        np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.concatenate([a, b])


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num): (num, 2) keys."""
    a, b = threefry2x32(key, np.zeros(num, _U32), np.arange(num, dtype=_U32))
    return np.stack([a, b], axis=-1)


def random_bits(key, shape: Tuple[int, ...] = ()) -> np.ndarray:
    """32 random bits an element (jax.random.bits(key, shape, uint32))."""
    shape = tuple(int(d) for d in shape)
    j = np.arange(math.prod(shape), dtype=np.uint64)
    a, b = threefry2x32(key, (j >> np.uint64(32)).astype(_U32),
                        (j & np.uint64(0xFFFFFFFF)).astype(_U32))
    return (a ^ b).reshape(shape)


def uniform(key, shape: Tuple[int, ...] = ()) -> np.ndarray:
    """jax.random.uniform(key, shape): float32 in [0, 1). (Other bounds
    are left out: XLA may fuse their scale and shift into one rounding.)"""
    bits = (random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def randint(key, shape: Tuple[int, ...], minval: int, maxval: int
            ) -> np.ndarray:
    """jax.random.randint(key, shape, minval, maxval) as int32, for
    bounds within int32."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(1 if maxval <= minval else (maxval - minval) & 0xFFFFFFFF)
    mask = np.uint64(0xFFFFFFFF)
    mult = np.uint64(_U32(65536) % span)
    mult = (mult * mult & mask) % np.uint64(span)
    off = ((hi % span).astype(np.uint64) * mult
           + (lo % span).astype(np.uint64)) & mask
    off = (off % np.uint64(span)).astype(_U32)
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def bernoulli(key, p: float = 0.5, shape: Tuple[int, ...] = ()
              ) -> np.ndarray:
    """jax.random.bernoulli(key, p, shape) for a float32 p: bool."""
    return uniform(key, shape) < np.float32(p)
