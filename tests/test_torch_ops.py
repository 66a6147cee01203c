"""The port's kernel wrappers on the CPU (their plain versions) against the
reference's Pallas kernels run in interpret mode, on the same numpy inputs.
The CUDA kernels themselves are held against the same plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.ops import epilogue as jax_ep
from tpu_resnet.ops import fused_block as jax_fb
from tpu_resnet_torch.ops import epilogue as ep
from tpu_resnet_torch.ops import fused_block as fb


def _sbr_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.normal(0, 0.5, c).astype(np.float32))


def _block_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    std = np.sqrt(1.0 / (9 * c))
    return (rng.normal(size=shape).astype(np.float32),
            (rng.normal(size=(3, 3, c, c)) * std).astype(np.float32),
            (rng.normal(size=(3, 3, c, c)) * std).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.normal(0, 0.5, c).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.normal(0, 0.5, c).astype(np.float32))


def _torch(arrays, x_dtype=torch.float32):
    out = [torch.from_numpy(a) for a in arrays]
    out[0] = out[0].to(x_dtype)
    return out


def _jax(arrays, x_dtype=jnp.float32):
    out = [jnp.asarray(a) for a in arrays]
    out[0] = out[0].astype(x_dtype)
    return out


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (2, 4, 4, 64)])
def test_scale_bias_relu_matches_reference_f32(shape):
    a = _sbr_inputs(shape)
    got = ep.scale_bias_relu(*_torch(a))
    want = jax_ep.scale_bias_relu(*_jax(a), None, True)
    assert got.dtype == torch.float32 and got.shape == shape
    # Same elementwise f32 arithmetic: equal up to the last bit or so.
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (2, 4, 4, 64)])
def test_scale_bias_relu_matches_reference_bf16(shape):
    a = _sbr_inputs(shape, seed=1)
    got = ep.scale_bias_relu(*_torch(a, torch.bfloat16))
    want = jax_ep.scale_bias_relu(*_jax(a, jnp.bfloat16), None, True)
    assert got.dtype == torch.bfloat16
    # One bfloat16 ulp (2^-8 relative) for a rounding tie broken apart.
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=2 ** -8)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (2, 4, 4, 32)])
def test_block_fwd_matches_reference_f32(shape):
    a = _block_inputs(shape)
    got = fb.block_fwd(*_torch(a))
    want = jax_fb.block_fwd(*_jax(a), interpret=True)
    assert got.dtype == torch.float32 and got.shape == shape
    # The convs sum 9*C products in another order than XLA's.
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (2, 4, 4, 64)])
def test_block_fwd_matches_reference_bf16(shape):
    a = _block_inputs(shape, seed=2)
    got = fb.block_fwd(*_torch(a, torch.bfloat16))
    want = jax_fb.block_fwd(*_jax(a, jnp.bfloat16), interpret=True)
    assert got.dtype == torch.bfloat16
    # f32 math, stored in bfloat16: a sum-order difference can move the
    # stored value by one ulp (2^-8 relative) at most.
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-2, rtol=2 ** -7)


def test_fold_matches_reference():
    rng = np.random.default_rng(3)
    g, b, m = (rng.normal(size=16).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.1, 2.0, 16).astype(np.float32)
    got = fb._fold(*map(torch.from_numpy, (g, b, m, v)), 1e-5)
    want = jax_fb._fold(*map(jnp.asarray, (g, b, m, v)), 1e-5)
    for x, y in zip(got, want):
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "channels", "scale_shape",
                                 "scale_device"])
def test_scale_bias_relu_rejects(bad):
    x, s, b = _torch(_sbr_inputs((1, 2, 2, 16)))
    if bad == "dtype":
        x = x.half()
    elif bad == "channels":
        x, s, b = x[..., :12], s[:12], b[:12]
    elif bad == "scale_shape":
        s = s[:8]
    else:
        s = s.to("meta")
    with pytest.raises(ValueError):
        ep.scale_bias_relu(x, s, b)


@pytest.mark.parametrize("bad", ["channels", "smem", "weight_shape",
                                 "weight_dtype"])
def test_block_fwd_rejects(bad):
    a = _torch(_block_inputs((1, 4, 4, 16)))
    if bad == "channels":
        a = _torch(_block_inputs((1, 4, 4, 24)))
    elif bad == "smem":
        # Every block kernel runs on tiles of pixels and takes a plane that
        # no image-a-block kernel could hold in an H100 block's 227 KB of
        # shared memory, the folded gradient too; the stats' sums against
        # float64 ones, within 1e-5·Σ|terms| + 1e-6.
        a = _torch(_block_inputs((1, 64, 64, 16)))
        assert fb.block_fwd(*a).shape == (1, 64, 64, 16)
        gy = torch.ones(1, 64, 64, 16)
        assert fb.block_bwd(a[0], gy, *a[1:])[0].shape == (1, 64, 64, 16)
        total, squares, c1 = fb.block_stats(a[0], a[1], a[3], a[4])
        assert c1.shape == (1, 64, 64, 16) and c1.dtype == torch.float32
        c64 = fb._c1(a[0].double(), a[1], a[3].double(), a[4].double())
        for got, terms in ((total, c64), (squares, c64 * c64)):
            want = terms.sum((0, 1, 2))
            limit = 1e-5 * terms.abs().sum((0, 1, 2)) + 1e-6
            assert bool(((got.double() - want).abs() <= limit).all())
        return
    elif bad == "weight_shape":
        a[1] = a[1][:, :, :8]
    else:
        a[2] = a[2].double()
    with pytest.raises(ValueError):
        fb.block_fwd(*a)


def test_wrappers_have_no_plain_path_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version: it
    launches the CUDA kernel or raises (here: a device with no kernel)."""
    x, s, b = (t.to("meta") for t in _torch(_sbr_inputs((1, 2, 2, 16))))
    before = ep.launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        ep.scale_bias_relu(x, s, b)
    a = [t.to("meta") for t in _torch(_block_inputs((1, 4, 4, 16)))]
    with pytest.raises(ValueError, match="cpu or cuda"):
        fb.block_fwd(*a)
    assert ep.launches == before


def test_cpu_calls_do_not_count_launches():
    before = (ep.launches, fb.launches)
    ep.scale_bias_relu(*_torch(_sbr_inputs((1, 2, 2, 16))))
    fb.block_fwd(*_torch(_block_inputs((1, 4, 4, 16))))
    assert (ep.launches, fb.launches) == before
