"""The folded blocks' gradients are the live-BN backward passes with the
folds as BN (γ, β, μ, 1/σ) = (s, b, 0, 1) and no batch-wide correction:
v − 0 and v·1 are exact, and with the correction sums at 0 the passes'
dc1 = γ2·i2·(dz2 − T1/n − ẑ2·T2/n) and dx = gy + γ1·i1·(dz1 − …) are s2·dz2
and gy + s1·dz1. On the CPU, at small widths, a ragged plane among them:
the live plain passes so run against ``block_bwd_reference`` and
``bottleneck_bwd_reference`` bit for bit; the folded gradient's two plain
steps, the second from the first's handoff (dc1; p2, c1, dmid), against the
same oracles bit for bit; and the step wrappers' refusals of a missing or
malformed handoff. The CUDA kernels of the steps are held against the same
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from tpu_resnet_torch.ops import fused_block as fb
from tpu_resnet_torch.ops import fused_bottleneck as fbn

BLOCK_SHAPES = ((2, 8, 8, 16), (2, 8, 8, 32), (2, 4, 4, 64), (3, 7, 5, 16))
BLOCK_IDS = ("c16", "c32", "c64", "ragged")
BOTTLENECK_SHAPES = ((2, 8, 8, 256), (1, 5, 7, 256), (1, 4, 4, 512))
BOTTLENECK_IDS = ("f64", "f64-ragged", "f128")
DTYPES = (torch.float32, torch.bfloat16)


def _block_args(shape, dtype, seed):
    """x (in ``dtype``), gy, w1, w2 and the folds s1, b1, s2, b2."""
    rng = np.random.default_rng(seed)
    c = shape[-1]

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return (t(rng.normal(size=shape) * 2 + 0.5).to(dtype),
            t(rng.normal(size=shape)),
            t(rng.normal(size=(3, 3, c, c)) * (9 * c) ** -0.5),
            t(rng.normal(size=(3, 3, c, c)) * (9 * c) ** -0.5),
            t(rng.uniform(0.5, 1.5, c)), t(rng.uniform(-0.5, 0.5, c)),
            t(rng.uniform(0.5, 1.5, c)), t(rng.uniform(-0.5, 0.5, c)))


def _bottleneck_args(shape, dtype, seed):
    """x (in ``dtype``), gy, w1, w2, w3 and the folds s1, b1 .. s3, b3."""
    rng = np.random.default_rng(seed)
    c4 = shape[-1]
    f = c4 // 4

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    def sb(n):
        return t(rng.uniform(0.5, 1.5, n)), t(rng.uniform(-0.5, 0.5, n))

    return (t(rng.normal(size=shape) * 2 + 0.5).to(dtype),
            t(rng.normal(size=shape)),
            t(rng.normal(size=(c4, f)) * c4 ** -0.5),
            t(rng.normal(size=(3, 3, f, f)) * (9 * f) ** -0.5),
            t(rng.normal(size=(f, c4)) * f ** -0.5), *sb(c4), *sb(f), *sb(f))


def _equal(got, want, names):
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


BLOCK_NAMES = ("dx", "dw1", "dw2", "ds1", "db1", "ds2", "db2")
BOTTLENECK_NAMES = ("dx", "dw1", "dw2", "dw3", "ds1", "db1", "ds2", "db2",
                    "ds3", "db3")


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=BLOCK_IDS)
def test_block_live_passes_on_the_folds_are_the_folded_gradient(shape,
                                                                 dtype):
    """The three live passes with (g, b, m, i) = (s, b, 0, 1) and T1 = T2
    = U1 = U2 = 0: (T1, T2) = (db2, ds2), (U1, U2) = (db1, ds1), dc1 =
    s2·dz2 and dx = gy + s1·dz1, ``block_bwd_reference``'s bit for bit."""
    x, gy, w1, w2, s1, b1, s2, b2 = _block_args(shape, dtype, shape[-1])
    zero, one = torch.zeros_like(s1), torch.ones_like(s1)
    vecs = (s1, b1, s2, b2, zero, one, zero, one)
    t1, t2, dw2, dz2, z2hat = fb.train_bwd_pass1_reference(x, gy, w1, w2,
                                                           *vecs)
    u1, u2, dw1, dz1 = fb.train_bwd_pass2_reference(
        x, gy, w1, w2, *vecs, zero, zero, dz2=dz2, z2hat=z2hat)
    dx = fb.train_bwd_pass3_reference(x, gy, w1, w2, *vecs, zero, zero, zero,
                                      zero, dz1=dz1)
    want = fb.block_bwd_reference(x, gy, w1, w2, s1, b1, s2, b2)
    _equal((dx, dw1, dw2, u2, u1, t2, t1), want, BLOCK_NAMES)
    # The handed-over dc1 is s2·dz2, pass 1's dz2 scaled.
    dc1 = fb.folded_bwd1_reference(x, gy, w1, w2, s1, b1, s2, b2)[3]
    assert torch.equal(dc1, dz2 * s2)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=BLOCK_IDS)
def test_block_folded_steps_equal_the_recompute_chain(shape, dtype):
    """Step 1's sums, dw2 and dc1, and step 2 from that dc1, give bit for
    bit what ``block_bwd_reference`` (the chain recomputed from x) gives;
    the wrappers on the CPU run these plain steps, and ``block_bwd``
    its oracle."""
    args = _block_args(shape, dtype, shape[-1] + 1)
    db2, ds2, dw2, dc1 = fb.folded_bwd1(*args)
    assert dc1.dtype == torch.float32 and dc1.is_contiguous()
    assert dc1.shape == args[0].shape
    db1, ds1, dw1, dx = fb.folded_bwd2(*args, dc1=dc1)
    want = fb.block_bwd_reference(*args)
    _equal((dx, dw1, dw2, ds1, db1, ds2, db2), want, BLOCK_NAMES)
    _equal(fb.block_bwd(*args), want, BLOCK_NAMES)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", BOTTLENECK_SHAPES, ids=BOTTLENECK_IDS)
def test_bottleneck_live_passes_on_the_folds_are_the_folded_gradient(
        shape, dtype):
    """The four live passes with (g, be, μ, i) = (s, b, 0, 1) and every
    correction sum 0: (T_ia, T_ib) = (db_i, ds_i), dmid = s3·dm3, dc1 =
    s2·dm2 and dx = gy + s1·dm1, ``bottleneck_bwd_reference``'s bit for
    bit."""
    x, gy, w1, w2, w3, s1, b1, s2, b2, s3, b3 = _bottleneck_args(
        shape, dtype, shape[-1] + shape[1])
    vecs = [t for s, b in ((s1, b1), (s2, b2), (s3, b3))
            for t in (s, b, torch.zeros_like(s), torch.ones_like(s))]
    base = (x, gy, w1, w2, w3, *vecs)
    zf, z4f = torch.zeros_like(s2), torch.zeros_like(s1)
    t3a, t3b, dw3, p2, mid, dm3 = fbn.train_bwd_pass1_reference(*base)
    t2a, t2b, dw2, dmid = fbn.train_bwd_pass2_reference(
        *base, zf, zf, p2=p2, mid=mid, dm3=dm3)
    t1a, t1b, dw1, dc1 = fbn.train_bwd_pass3_reference(
        *base, zf, zf, zf, zf, dmid=dmid)
    dx = fbn.train_bwd_pass4_reference(*base, zf, zf, zf, zf, z4f, z4f,
                                       dc1=dc1)
    want = fbn.bottleneck_bwd_reference(x, gy, w1, w2, w3, s1, b1, s2, b2,
                                        s3, b3)
    _equal((dx, dw1, dw2, dw3, t1b, t1a, t2b, t2a, t3b, t3a), want,
           BOTTLENECK_NAMES)
    # The handed-over dmid is s3·dm3, pass 1's dm3 scaled; p2 is pass 1's,
    # c1 the chain's.
    *_, p2_folded, c1, dmid_folded = fbn.folded_bwd1_reference(
        x, gy, w1, w2, w3, s1, b1, s2, b2, s3, b3)
    assert torch.equal(dmid_folded, dm3 * s3) and torch.equal(dmid, dm3 * s3)
    assert torch.equal(p2_folded, p2)
    assert torch.equal(c1, fbn._chain(x, w1, *vecs[:8])[3])


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", BOTTLENECK_SHAPES, ids=BOTTLENECK_IDS)
def test_bottleneck_folded_steps_equal_the_recompute_chain(shape, dtype):
    """Step 1's sums, dW3, p2, c1 and dmid, and step 2 from p2, c1 and
    dmid, give bit for bit what ``bottleneck_bwd_reference`` (the chain
    recomputed from x) gives; the wrappers on the CPU run these plain
    steps, and ``bottleneck_bwd`` its oracle."""
    args = _bottleneck_args(shape, dtype, shape[-1] + shape[1] + 1)
    db3, ds3, dw3, p2, c1, dmid = fbn.folded_bwd1(*args)
    f = shape[-1] // 4
    for t in (p2, c1, dmid):
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert t.shape == (*shape[:3], f)
    db2, ds2, dw2, db1, ds1, dw1, dx = fbn.folded_bwd2(*args, p2=p2, c1=c1,
                                                       dmid=dmid)
    want = fbn.bottleneck_bwd_reference(*args)
    _equal((dx, dw1, dw2, dw3, ds1, db1, ds2, db2, ds3, db3), want,
           BOTTLENECK_NAMES)
    _equal(fbn.bottleneck_bwd(*args), want, BOTTLENECK_NAMES)


def _bad(t, what):
    return {"shape": t[..., :t.shape[-1] // 2], "dtype": t.double(),
            "device": torch.empty(t.shape, device="meta"),
            "strided": t.transpose(1, 2).contiguous().transpose(1, 2)}[what]


@pytest.mark.parametrize("what", ["missing", "shape", "dtype", "device",
                                  "strided"])
@pytest.mark.parametrize("kind", ["block", "bottleneck"])
def test_step_wrappers_refuse_a_missing_or_malformed_handoff(kind, what):
    """No path recomputes dc1 (block) or p2, c1 and dmid (bottleneck): without
    one, or with one of the wrong shape, type or device, or strided, step
    2 raises."""
    if kind == "block":
        args = _block_args((2, 5, 6, 16), torch.float32, 3)
        good = {"dc1": fb.folded_bwd1(*args)[3]}
        step2 = fb.folded_bwd2
    else:
        args = _bottleneck_args((1, 5, 6, 256), torch.float32, 3)
        good = dict(zip(("p2", "c1", "dmid"), fbn.folded_bwd1(*args)[3:]))
        step2 = fbn.folded_bwd2
    step2(*args, **good)   # the well-formed handoffs pass
    for name, t in good.items():
        others = {k: v for k, v in good.items() if k != name}
        if what == "missing":
            with pytest.raises(TypeError, match=name):
                step2(*args, **others)
            continue
        with pytest.raises(ValueError, match=f"{name} must be float32"):
            step2(*args, **others, **{name: _bad(t, what)})
