"""The port's softmax cross-entropy and the BN+ReLU epilogue's backward on
the CPU (their plain versions) against the reference's Pallas kernels run
in interpret mode, on the same numpy inputs. The CUDA kernels are held
against the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.ops import epilogue as jax_ep
from tpu_resnet.ops import softmax_xent as jax_sx
from tpu_resnet_torch.ops import epilogue as ep
from tpu_resnet_torch.ops import softmax_xent as sx
from tpu_resnet_torch.train.step import softmax_xent as plain_chain

SHAPES = [(128, 10), (16, 100), (8, 1000), (5, 10)]


def _xent_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    b, c = shape
    return ((rng.normal(size=shape) * 3).astype(np.float32),
            rng.integers(0, c, b).astype(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_xent_forward_matches_reference(shape):
    x, y = _xent_inputs(shape)
    want = jax_sx.softmax_xent_per_example(jnp.asarray(x), jnp.asarray(y),
                                           interpret=True)
    got = sx.softmax_xent_per_example(torch.from_numpy(x),
                                      torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    # 1e-6, plus two float32 ulps of losses near 15 (the sum of C
    # exponentials is taken in another order).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=2.5e-7)
    plain = sx.softmax_xent_per_example_reference(torch.from_numpy(x),
                                                  torch.from_numpy(y))
    assert torch.equal(plain, got)


@pytest.mark.parametrize("shape", SHAPES)
def test_xent_mean_gradient_matches_reference(shape):
    x, y = _xent_inputs(shape, seed=1)
    want = jax.grad(lambda a: jax_sx.softmax_xent_mean(
        a, jnp.asarray(y), interpret=True))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    sx.softmax_xent_mean(t, torch.from_numpy(y)).backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("shape", [(16, 10), (8, 1000)])
def test_xent_kernel_path_equals_the_plain_chain(shape):
    """The kernel's loss and the train step's plain chain (label smoothing
    0) compute the same mean, as the reference's two arms do."""
    x, y = _xent_inputs(shape, seed=2)
    a = sx.softmax_xent_mean(torch.from_numpy(x), torch.from_numpy(y))
    b = plain_chain(torch.from_numpy(x), torch.from_numpy(y), shape[1])
    np.testing.assert_allclose(a.item(), b.item(), rtol=1e-6)


def test_xent_bwd_reference_matches_autograd_and_masks_bad_labels():
    x, y = _xent_inputs((6, 7), seed=3)
    y[2] = -1           # outside [0, C): the one-hot row is all zeros
    g = np.random.default_rng(4).uniform(size=6).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_(True)
    loss = sx.softmax_xent_per_example(t, torch.from_numpy(y))
    (loss * torch.from_numpy(g)).sum().backward()
    want = sx.softmax_xent_bwd_reference(torch.from_numpy(x),
                                         torch.from_numpy(y),
                                         torch.from_numpy(g))
    assert torch.equal(t.grad, want)
    np.testing.assert_allclose(
        loss[2].item(), float(torch.logsumexp(torch.from_numpy(x[2]), 0)),
        rtol=1e-6)
    ref = jax_sx.softmax_xent_per_example(jnp.asarray(x), jnp.asarray(y),
                                          interpret=True)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref),
                               atol=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "rank", "labels", "device"])
def test_xent_rejects(bad):
    x, y = (torch.from_numpy(a) for a in _xent_inputs((4, 10)))
    if bad == "dtype":
        x = x.double()
    elif bad == "rank":
        x = x[None]
    elif bad == "labels":
        y = y[:3]
    else:
        x, y = x.to("meta"), y.to("meta")
    with pytest.raises(ValueError):
        sx.softmax_xent_per_example(x, y)


# ----------------------------------------------------- epilogue backward
def _sbr_inputs(shape, seed, zeros=False):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    s = rng.uniform(0.5, 1.5, c).astype(np.float32)
    b = rng.normal(0, 0.5, c).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    if zeros:
        # x = 0 where b = 0: the pre-activation is exactly 0, and the strict
        # mask (x*s + b > 0) must give these elements no gradient.
        b[::2] = 0.0
        x[..., ::2][rng.uniform(size=x[..., ::2].shape) < 0.5] = 0.0
    return x, s, b, g


def _vjp_reference(x, s, b, g, dtype):
    xj = jnp.asarray(x).astype(dtype)
    _, vjp = jax.vjp(lambda a, sc, bi: jax_ep.scale_bias_relu(
        a, sc, bi, None, True), xj, jnp.asarray(s), jnp.asarray(b))
    return vjp(jnp.asarray(g).astype(dtype))


@pytest.mark.parametrize("dtype, zeros", [
    ("float32", False), ("bfloat16", False), ("float32", True),
    ("bfloat16", True)])
def test_sbr_bwd_matches_reference_vjp(dtype, zeros):
    shape = (2, 8, 8, 16)
    x, s, b, g = _sbr_inputs(shape, seed=5, zeros=zeros)
    tdt = getattr(torch, dtype)
    want = _vjp_reference(x, s, b, g, getattr(jnp, dtype))
    xt, gt = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    dx, ds, db = ep.scale_bias_relu_bwd(xt, torch.from_numpy(s),
                                        torch.from_numpy(b), gt)
    assert dx.dtype == tdt and ds.dtype == db.dtype == torch.float32
    # dx: the same single rounding of g*s; ds/db: f32 sums over 128 pixels
    # in another order.
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(want[0], np.float32))
    np.testing.assert_allclose(ds.numpy(), np.asarray(want[1]), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(want[2]), atol=1e-5,
                               rtol=1e-5)
    if zeros:
        dead = (x == 0) & (b == 0)
        assert dead.any() and not dx.float().numpy()[dead].any()


def test_sbr_autograd_uses_the_backward():
    x, s, b, g = _sbr_inputs((2, 4, 4, 16), seed=6, zeros=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    st = torch.from_numpy(s).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    (ep.scale_bias_relu(xt, st, bt) * torch.from_numpy(g)).sum().backward()
    want = ep.scale_bias_relu_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b),
        torch.from_numpy(g))
    for got, ref in zip((xt.grad, st.grad, bt.grad), want):
        assert torch.equal(got, ref)


def test_sbr_bwd_rejects_mismatched_cotangent():
    x, s, b, g = (torch.from_numpy(a) for a in _sbr_inputs((1, 2, 2, 8), 7))
    with pytest.raises(ValueError, match="g must match"):
        ep.scale_bias_relu_bwd(x, s, b, g.to(torch.bfloat16))
    with pytest.raises(ValueError, match="g must match"):
        ep.scale_bias_relu_bwd(x, s, b, g[:, :1])


def test_backward_wrappers_have_no_plain_path_off_the_cpu():
    x, s, b, g = (torch.from_numpy(a).to("meta")
                  for a in _sbr_inputs((1, 2, 2, 16), 8))
    before = (ep.bwd_launches, sx.fwd_launches, sx.bwd_launches)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ep.scale_bias_relu_bwd(x, s, b, g)
    logits, labels = (torch.from_numpy(a).to("meta")
                      for a in _xent_inputs((4, 10)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        sx.softmax_xent_bwd(logits, labels, torch.ones(4, device="meta"))
    assert (ep.bwd_launches, sx.fwd_launches, sx.bwd_launches) == before
