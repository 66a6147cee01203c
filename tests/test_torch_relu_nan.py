"""The ReLU keeps a NaN (fault 7): the port's plain versions, which the
wrappers take for CPU tensors, against the reference's kernels in interpret
mode on inputs with NaNs at seeded places, where ``jnp.maximum(v, 0)``
propagates them: ``sbr`` and ``sbr_add``, the fused block's forward and its
training forward, and the fused bottleneck's forward. Each output is NaN
exactly where the reference's is and agrees with it elsewhere. The CUDA
kernels are held against the same plain versions on NaN inputs on the card
(``tests/test_torch_cuda.py::test_kernels_keep_a_nan``,
``tpu_resnet_torch/tools/nan_check.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.ops import epilogue as jax_ep
from tpu_resnet.ops import fused_block as jax_fb
from tpu_resnet.ops import fused_bottleneck as jax_fbn
from tpu_resnet_torch.ops import epilogue as ep
from tpu_resnet_torch.ops import fused_block as fb
from tpu_resnet_torch.ops import fused_bottleneck as fbn

EPS = 1e-5


def _poisoned(shape, seed, nans=3):
    """Seeded normal x with ``nans`` NaNs at seeded places."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1)[rng.choice(x.size, nans, replace=False)] = np.nan
    return x


def _vec(rng, c, lo, hi):
    return rng.uniform(lo, hi, c).astype(np.float32)


def _same_nans(got, want, what):
    """NaN exactly where the reference's output is, and within float32
    rounding of it elsewhere (another summation order)."""
    got = got.detach().double().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert np.isnan(want).any(), f"{what}: no NaN reached the output"
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4,
                               equal_nan=True, err_msg=what)


@pytest.mark.parametrize("add", [False, True], ids=["sbr", "sbr_add"])
def test_sbr_keeps_the_nan(add):
    rng = np.random.default_rng(1)
    x = _poisoned((2, 4, 4, 16), seed=1)
    s, b = _vec(rng, 16, 0.5, 1.5), _vec(rng, 16, -0.5, 0.5)
    r = rng.normal(size=x.shape).astype(np.float32)
    j = list(map(jnp.asarray, (x, s, b, r)))
    t = list(map(torch.from_numpy, (x, s, b, r)))
    if add:
        want = jax_ep.scale_bias_relu_add(*j, interpret=True)
        got = ep.scale_bias_relu_add(*t)
    else:
        want = jax_ep.scale_bias_relu(*j[:3], interpret=True)
        got = ep.scale_bias_relu(*t[:3])
    _same_nans(got, want, "sbr_add" if add else "sbr")


def _block_params(rng, c):
    std = (9 * c) ** -0.5
    return ((rng.normal(size=(3, 3, c, c)) * std).astype(np.float32),
            (rng.normal(size=(3, 3, c, c)) * std).astype(np.float32),
            _vec(rng, c, 0.5, 1.5), _vec(rng, c, -0.3, 0.3),
            _vec(rng, c, 0.5, 1.5), _vec(rng, c, -0.3, 0.3))


@pytest.mark.parametrize("c", [16, 128])
def test_block_fwd_keeps_the_nan(c):
    """The folded block's forward (both ReLUs between the convolutions)."""
    rng = np.random.default_rng(c)
    x = _poisoned((2, 6, 6, c), seed=c)
    params = _block_params(rng, c)
    want = jax_fb.block_fwd(*map(jnp.asarray, (x, *params)), batch_tile=2,
                            interpret=True)
    got = fb.block_fwd(*map(torch.from_numpy, (x, *params)))
    _same_nans(got, want, f"block_fwd C={c}")


def test_block_train_fwd_keeps_the_nan():
    """The live-BN block's forward: the NaN reaches every moment and y."""
    rng = np.random.default_rng(2)
    x = _poisoned((2, 6, 6, 16), seed=2)
    params = _block_params(rng, 16)
    want_y, want_m = jax_fb.block_train_fwd(
        *map(jnp.asarray, (x, *params)), EPS, batch_tile=2, interpret=True)
    got_y, got_m = fb.block_train_fwd(*map(torch.from_numpy, (x, *params)))
    _same_nans(got_y, want_y, "y")
    for name, g, w in zip(("mean1", "var1", "mean2", "var2"), got_m,
                          want_m):
        _same_nans(g, w, name)


def test_bottleneck_fwd_keeps_the_nan():
    """The folded bottleneck's forward (three BN+ReLUs)."""
    rng = np.random.default_rng(3)
    c4, f = 256, 64
    x = _poisoned((2, 6, 6, c4), seed=3)
    args = (x, (rng.normal(size=(c4, f)) / 16).astype(np.float32),
            (rng.normal(size=(3, 3, f, f)) / 24).astype(np.float32),
            (rng.normal(size=(f, c4)) / 8).astype(np.float32),
            _vec(rng, c4, 0.5, 1.5), _vec(rng, c4, -0.3, 0.3),
            _vec(rng, f, 0.5, 1.5), _vec(rng, f, -0.3, 0.3),
            _vec(rng, f, 0.5, 1.5), _vec(rng, f, -0.3, 0.3))
    want = jax_fbn.bottleneck_fwd(*map(jnp.asarray, args), interpret=True)
    got = fbn.bottleneck_fwd(*map(torch.from_numpy, args))
    _same_nans(got, want, "bottleneck_fwd")
