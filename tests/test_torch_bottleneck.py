"""The port's fused bottleneck on the CPU (its plain version) against the
reference's Pallas kernel run in interpret mode and against the reference's
plain version, on the same numpy inputs; and the port's fused and plain
bottleneck blocks against the reference's, with converted weights. The
CUDA kernel itself is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.models import resnet as jax_resnet
from tpu_resnet.ops import fused_bottleneck as jax_fbn
from tpu_resnet_torch import convert
from tpu_resnet_torch.models.resnet import (BottleneckBlock,
                                            FusedBottleneckBlock)
from tpu_resnet_torch.ops import fused_bottleneck as fbn
from tpu_resnet_torch.ops.epilogue import scale_bias_relu_math


def _inputs(shape, seed=0):
    """x, w1, w2, w3 and BN folds that are not the identity: the biases
    have both signs, so a halo row computed as relu(b2) instead of zero
    would change the result."""
    rng = np.random.default_rng(seed)
    c4 = shape[-1]
    f = c4 // 4
    out = [rng.normal(size=shape).astype(np.float32),
           (rng.normal(size=(c4, f)) / np.sqrt(c4)).astype(np.float32),
           (rng.normal(size=(3, 3, f, f)) / np.sqrt(9 * f)).astype(np.float32),
           (rng.normal(size=(f, c4)) / np.sqrt(f)).astype(np.float32)]
    for n in (c4, f, f):
        out += [rng.uniform(0.5, 1.5, n).astype(np.float32),
                rng.normal(0, 0.5, n).astype(np.float32)]
    return out


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


# (shape, row_tile): H=8 in bands of 4 and H=6 in bands of 2, so the
# reference kernel runs several row bands with halos at band and image edges.
CASES = [((2, 8, 8, 32), 4), ((1, 6, 5, 32), 2)]


@pytest.mark.parametrize("shape, row_tile", CASES)
def test_bottleneck_fwd_matches_reference_f32(shape, row_tile):
    a = _inputs(shape)
    got = fbn.bottleneck_fwd(*_torch(a))
    kernel = jax_fbn.bottleneck_fwd(*_jax(a), batch_tile=1,
                                    row_tile=row_tile, interpret=True)
    plain = jax_fbn.bottleneck_fwd_reference(*_jax(a))
    assert got.dtype == torch.float32 and got.shape == shape
    # float32 throughout; products summed in another order than XLA's.
    np.testing.assert_allclose(_np(got), _np(kernel), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(got), _np(plain), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape, row_tile", CASES)
def test_bottleneck_fwd_matches_reference_bf16(shape, row_tile):
    a = _inputs(shape, seed=1)
    got = fbn.bottleneck_fwd(*_torch(a, torch.bfloat16))
    want = jax_fbn.bottleneck_fwd(*_jax(a, jnp.bfloat16), batch_tile=1,
                                  row_tile=row_tile, interpret=True)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    # f32 math on the same bf16 inputs, stored in bf16: a sum-order
    # difference can move the stored value by one ulp (2^-8 relative).
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-2, rtol=2 ** -7)


def test_zero_halo_rows_are_not_relu_b2():
    """With W1 = 0, c1 = 0 everywhere, so p2 = relu(b2) inside the image and
    0 in the padding: the top and bottom rows then see fewer taps than the
    middle ones. A kernel that padded with relu(b2) would make every row
    equal."""
    a = _inputs((1, 6, 4, 32), seed=2)
    a[1][:] = 0.0
    a[7][:] = np.abs(a[7]) + 0.5        # b2 > 0: relu(b2) is not zero
    got = _np(fbn.bottleneck_fwd(*_torch(a)))
    want = _np(jax_fbn.bottleneck_fwd(*_jax(a), batch_tile=1, row_tile=2,
                                      interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    r = got - a[0]
    assert not np.allclose(r[:, 0], r[:, 2], atol=1e-3)
    np.testing.assert_allclose(r[:, 1], r[:, 4], atol=1e-5)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, seed", [((2, 8, 8, 32), 6),
                                         ((1, 6, 5, 64), 7)])
def test_folded_chain_is_the_live_chain_at_mean_0_inv_1(shape, seed,
                                                        x_dtype):
    """The live chain with (μ, i) = (0, 1) and the folds (s, b) in the
    places of (γ, β) gives the folded forward's p2 bit for bit: v − 0 and
    v·1 are exact. The forward's first launch on the card computes its p2
    so, in the code of the live passes' p2."""
    x, w1, _, _, s1, b1, s2, b2, _, _ = _torch(_inputs(shape, seed), x_dtype)
    got = fbn._chain(x, w1, s1, b1, 0, 1, s2, b2, 0, 1)[-1]
    p1 = scale_bias_relu_math(x.float(), s1, b1)
    want = scale_bias_relu_math(torch.einsum("bhwc,cf->bhwf", p1, w1), s2,
                                b2)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert bool((want == 0).any()) and bool((want > 0).any())


def test_fold_bn_matches_reference():
    rng = np.random.default_rng(3)
    g, b, m = (rng.normal(size=64).astype(np.float32) for _ in range(3))
    inv = (1 / np.sqrt(rng.uniform(0.1, 2.0, 64) + 1e-5)).astype(np.float32)
    got = fbn._fold_bn(*map(torch.from_numpy, (g, b, m, inv)))
    want = jax_fbn._fold_bn(*map(jnp.asarray, (g, b, m, inv)))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(_np(x), _np(y))


@pytest.mark.parametrize("bad", ["channels", "w2_shape", "w3_dtype",
                                 "s3_shape", "rank", "x_dtype"])
def test_bottleneck_fwd_rejects(bad):
    a = _torch(_inputs((1, 4, 4, 32)))
    if bad == "channels":
        a[0] = a[0][..., :16]
    elif bad == "w2_shape":
        a[2] = a[2][:, :, :4]
    elif bad == "w3_dtype":
        a[3] = a[3].double()
    elif bad == "s3_shape":
        a[8] = a[8][:4]
    elif bad == "rank":
        a[0] = a[0][0]
    else:
        a[0] = a[0].half()
    with pytest.raises(ValueError):
        fbn.bottleneck_fwd(*a)


def test_bottleneck_fwd_has_no_plain_path_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version: it
    launches the CUDA kernel or raises (here: a device with no kernel)."""
    a = [t.to("meta") for t in _torch(_inputs((1, 4, 4, 32)))]
    before = fbn.launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        fbn.bottleneck_fwd(*a)
    fbn.bottleneck_fwd(*_torch(_inputs((1, 4, 4, 32))))
    assert fbn.launches == before


# ------------------------------------------------------------ the blocks
def _block_variables(module, x, seed):
    """Reference block variables with BN parameters and statistics moved off
    their init values, so all three folds are exercised."""
    variables = jax.device_get(module.init(jax.random.PRNGKey(seed),
                                           jnp.asarray(x), False))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a, np.float32)
        if "'scale'" in name or "'var'" in name:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if "'bn'" in name:   # bias, mean
            return rng.normal(0, 0.3, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def block_case():
    x = np.random.default_rng(4).normal(size=(1, 6, 5, 256)).astype(
        np.float32)
    ref = jax_resnet.FusedBottleneckBlock(64, jnp.float32)
    return x, _block_variables(ref, x, seed=5)


def test_fused_bottleneck_block_matches_reference(block_case):
    x, variables = block_case
    fused_ref = jax_resnet.FusedBottleneckBlock(64, jnp.float32)
    plain_ref = jax_resnet.BottleneckBlock(64, 1, False, jnp.float32)
    want_fused = np.asarray(fused_ref.apply(variables, jnp.asarray(x), False))
    want_plain = np.asarray(plain_ref.apply(variables, jnp.asarray(x), False))
    state = convert.flax_to_torch(variables)
    for port in (FusedBottleneckBlock(64), BottleneckBlock(256, 64, 1, False)):
        port.load_state_dict(state, strict=True)
        with torch.inference_mode():
            got = port.eval()(torch.from_numpy(x)).numpy()
        # float32; 1x1 and 3x3 sums over up to 576 products in another
        # order than XLA's.
        np.testing.assert_allclose(got, want_fused, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, want_plain, atol=1e-5, rtol=1e-5)


def test_fused_bottleneck_block_calls_the_wrapper(block_case, monkeypatch):
    """The block reaches the kernel through the module attribute, so the
    chip smoke's oracle can swap in the plain version."""
    x, variables = block_case
    calls = []

    def spy(*args):
        calls.append([tuple(t.shape) for t in args])
        return fbn.bottleneck_fwd_reference(*args)

    monkeypatch.setattr(fbn, "bottleneck_fwd", spy)
    block = FusedBottleneckBlock(64)
    block.load_state_dict(convert.flax_to_torch(variables))
    with torch.inference_mode():
        block.eval()(torch.from_numpy(x))
    assert calls == [[(1, 6, 5, 256), (256, 64), (3, 3, 64, 64), (64, 256),
                      (256,), (256,), (64,), (64,), (64,), (64,)]]
