"""The fused basic block's forward (``block_fwd``, the plain version on the
CPU) against the reference's ``block_fwd`` (Pallas in interpret mode) on
the same numpy inputs, at C = 16 and 32 and on a ragged plane whose tiles
of pixels span images on the card. The CUDA kernel is held against the same
plain version there (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.ops import fused_block as jax_fb
from tpu_resnet_torch.ops import fused_block as fb

SHAPES = ((4, 8, 8, 16), (4, 8, 8, 32), (2, 7, 5, 16))
IDS = ("c16", "c32", "ragged")


def _inputs(shape, seed):
    """x, w1, w2 (scaled by 1/sqrt(fan-in)), s1, b1, s2, b2 (scales in
    [0.5, 1.5), biases of both signs)."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    std = (9 * c) ** -0.5
    f32 = np.float32
    return ((rng.normal(size=shape) * 2 + 1).astype(f32),
            (rng.normal(size=(3, 3, c, c)) * std).astype(f32),
            (rng.normal(size=(3, 3, c, c)) * std).astype(f32),
            rng.uniform(0.5, 1.5, c).astype(f32),
            rng.normal(0, 0.5, c).astype(f32),
            rng.uniform(0.5, 1.5, c).astype(f32),
            rng.normal(0, 0.5, c).astype(f32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_block_fwd_matches_reference(shape, dtype):
    a = _inputs(shape, seed=shape[-1] + shape[1])
    x = torch.from_numpy(a[0]).to(getattr(torch, dtype))
    got = fb.block_fwd(x, *map(torch.from_numpy, a[1:]))
    want = jax_fb.block_fwd(jnp.asarray(a[0]).astype(getattr(jnp, dtype)),
                            *map(jnp.asarray, a[1:]), interpret=True)
    assert got.dtype == x.dtype and got.shape == shape
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        # The convs sum 9*C products in another order than XLA's.
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    else:
        # f32 math stored in bfloat16: a sum-order difference moves the
        # stored value by one ulp (2^-8 relative) at most.
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=2 ** -7)
