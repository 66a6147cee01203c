"""The port's numpy copy of ``jax.random`` (``tpu_resnet_torch/data/prng.py``)
against ``jax.random`` itself, bit for bit, over many seeds: the reference's
data path draws its epoch order and its crops and flips from these
functions, so the port sees the same batches only if every bit agrees."""

import jax
import numpy as np
import pytest

from tpu_resnet_torch.data import prng

SEEDS = [0, 1, 2, 3, 7, 42, 1234, 99991, 2 ** 31 - 1, 2 ** 32 - 1]


def _key(seed):
    return np.asarray(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.prng_key(seed), _key(seed))


@pytest.mark.parametrize("num", [1, 2, 3, 8, 1000])
def test_split(num):
    for seed in SEEDS:
        np.testing.assert_array_equal(
            prng.split(prng.prng_key(seed), num),
            np.asarray(jax.random.split(_key(seed), num)))


@pytest.mark.parametrize("data", [0, 1, 5, 99, 2 ** 20 + 3, 2 ** 32 - 1])
def test_fold_in(data):
    for seed in SEEDS:
        np.testing.assert_array_equal(
            prng.fold_in(prng.prng_key(seed), data),
            np.asarray(jax.random.fold_in(_key(seed), data)))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 4), (128, 1, 1, 1),
                                   (4097,)])
def test_random_bits(shape):
    for seed in SEEDS:
        np.testing.assert_array_equal(
            prng.random_bits(prng.prng_key(seed), shape),
            np.asarray(jax.random.bits(_key(seed), shape)))


@pytest.mark.parametrize("n", [1, 7, 1000, 50000])
def test_permutation(n):
    seeds = SEEDS if n < 50000 else SEEDS[:3]
    for seed in seeds:
        for epoch in (0, 1):
            key = prng.fold_in(prng.prng_key(seed), epoch)
            want = jax.random.permutation(
                jax.random.fold_in(_key(seed), epoch), n)
            np.testing.assert_array_equal(prng.permutation(key, n),
                                          np.asarray(want))


@pytest.mark.parametrize("lo, hi", [(0, 5), (0, 2), (3, 4), (0, 1000),
                                    (-7, 9), (4, 4)])
def test_randint(lo, hi):
    for seed in SEEDS:
        got = prng.randint(prng.prng_key(seed), (128,), lo, hi)
        want = jax.random.randint(_key(seed), (128,), lo, hi)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("p", [0.5, 0.1, 0.9])
def test_bernoulli_and_uniform(p):
    for seed in SEEDS:
        key = prng.prng_key(seed)
        np.testing.assert_array_equal(
            prng.bernoulli(key, p, (128, 1, 1, 1)),
            np.asarray(jax.random.bernoulli(_key(seed), p, (128, 1, 1, 1))))
        np.testing.assert_array_equal(
            prng.uniform(key, (64,)),
            np.asarray(jax.random.uniform(_key(seed), (64,))))
