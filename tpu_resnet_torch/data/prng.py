"""The part of ``jax.random`` that the reference's data path draws from, in
numpy, bit for bit (threefry-2x32 keys, in the partitionable form that
jax 0.9 uses by default).

The reference orders each epoch of its device-resident split with
``jax.random.permutation(fold_in(PRNGKey(seed), epoch), n)``
(``tpu_resnet/data/device_data.py``) and draws its crops and flips with
``randint`` and ``bernoulli`` from a key folded per step
(``tpu_resnet/train/step.py``). Threefry is a pure function of 32-bit
integers, so the same draws come out here, on the host, and a port run
sees the same batches, in the same order, with the same crops.

A key is a uint32 array of shape (2,). Every function here is a pure
function of its arguments.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray,
                 x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key``; uint32 arrays of one shape in and out."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(_PARITY))
    with np.errstate(over="ignore"):
        a = np.asarray(x0, _U32) + ks[0]
        b = np.asarray(x1, _U32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32)."""
    seed = int(seed)
    return np.array([seed >> 32 & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The 64-bit iota 0..n-1 as (high, low) uint32 halves."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(_U32), (i & np.uint64(0xFFFFFFFF)
                                                ).astype(_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: [num, 2] uint32."""
    a, b = threefry2x32(key, *_counters(num))
    return np.stack([a, b], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for data in [0, 2**32)."""
    a, b = threefry2x32(key, np.zeros(1, _U32),
                        np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([a[0], b[0]], _U32)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` in 32 bits: uint32 of ``shape``."""
    shape = (int(shape),) if np.ndim(shape) == 0 else tuple(
        int(d) for d in shape)
    a, b = threefry2x32(key, *_counters(math.prod(shape)))
    return (a ^ b).reshape(shape)


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: ``ceil(3 ln n / ln(2**32 - 1))``
    rounds of a stable sort of the indices on fresh 32-bit keys. int32."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(2 ** 32 - 1)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 bounds:
    two 32-bit draws per value, combined modulo the span. int32."""
    hi_key, lo_key = split(key)
    hi, lo = random_bits(hi_key, shape), random_bits(lo_key, shape)
    span = _U32(maxval - minval if maxval > minval else 1)
    with np.errstate(over="ignore"):
        mult = _U32((2 ** 16) % int(span))
        mult = (mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def uniform(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1): the top 23
    bits as the mantissa of a number in [1, 2), minus 1."""
    bits = (random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    return np.maximum(bits.view(np.float32) - np.float32(1.0),
                      np.float32(0.0))


def bernoulli(key: np.ndarray, p: float, shape) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` for a float32 p: bool."""
    return uniform(key, shape) < np.float32(p)
