"""The fused basic block's training kernels hand their results on instead
of recomputing the chain from x, as the reference's ``block_train_fwd``
and ``_train_bwd_calls`` do: the stats hand c1 to the training forward,
pass 1 hands dz2 and ẑ2 to pass 2, pass 2 hands dz1 to pass 3. On the CPU,
at C = 16 and 32 (and 64 for the forward) and on a ragged plane: the plain
versions with the handoffs against the recompute-from-x chain bit for bit,
the wrappers against the reference's forward and passes (Pallas in
interpret mode, batch tile 2) and the port's backward against ``jax.vjp``
of the reference's custom-VJP block, and the wrappers' refusals of a
missing or malformed handoff. The CUDA kernels are held against the same
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_train import EPS, _close
from tpu_resnet.ops import fused_block as jax_fb
from tpu_resnet_torch.ops import fused_block as fb

SUM = (0, 1, 2)
# [B, H, W, C]: the two widths on a square plane, and a ragged plane.
SHAPES = ((4, 8, 8, 16), (4, 8, 8, 32), (2, 7, 5, 16))
IDS = ("c16", "c32", "ragged")


def _inputs(shape, seed):
    """x (shifted, so BN1 has work to do), gy, w1, w2, γ1, β1, γ2, β2."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    f32 = np.float32
    return ((rng.normal(size=shape) * 2 + 1).astype(f32),
            rng.normal(size=shape).astype(f32),
            (rng.normal(size=(3, 3, c, c)) * 0.2).astype(f32),
            (rng.normal(size=(3, 3, c, c)) * 0.2).astype(f32),
            rng.uniform(0.5, 1.5, c).astype(f32),
            rng.uniform(-0.3, 0.3, c).astype(f32),
            rng.uniform(0.5, 1.5, c).astype(f32),
            rng.uniform(-0.3, 0.3, c).astype(f32))


def _base(shape, seed):
    """x, gy, the weights and the eight BN vectors (moments from the port's
    training forward), pass 1's sums and its handoff {dz2, z2hat}."""
    x, gy, w1, w2, g1, b1, g2, b2 = map(torch.from_numpy,
                                        _inputs(shape, seed))
    _, (m1, v1, m2, v2) = fb.block_train_fwd(x, w1, w2, g1, b1, g2, b2)
    i1, i2 = torch.rsqrt(v1 + EPS), torch.rsqrt(v2 + EPS)
    base = (x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2)
    t1, t2, _, dz2, z2hat = fb.train_bwd_pass1_reference(*base)
    return base, (t1, t2), {"dz2": dz2, "z2hat": z2hat}


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_handed_over_passes_equal_the_recompute_chain(shape):
    """Pass 1's dz2 and ẑ2, pass 2 from them, its dz1 and pass 3 from it
    give bit for bit what the chain recomputed from x gives for every
    output of the three passes."""
    base, t, h1 = _base(shape, seed=shape[-1] + 3)
    x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2 = base
    _, _, _, z2, z2hat, r2 = fb._recompute(x, w1, g1, b1, g2, b2, m1, i1,
                                           m2, i2)
    dz2 = fb._dz2(z2, gy, w2)
    want = (dz2.sum(SUM), (dz2 * z2hat).sum(SUM), fb._wgrad(r2, gy), dz2,
            z2hat)
    got = fb.train_bwd_pass1_reference(*base)
    for name, g, w in zip(("t1", "t2", "dw2", "dz2", "z2hat"), got, want):
        assert torch.equal(g, w), name
    for name in ("dz2", "z2hat"):
        assert h1[name].is_contiguous() and h1[name].dtype == torch.float32

    r = fb._pass2_chain(*base, *t)
    u1, u2, dw1, dz1 = fb.train_bwd_pass2_reference(*base, *t, **h1)
    want = (r["dz1"].sum(SUM), (r["dz1"] * r["z1hat"]).sum(SUM),
            fb._wgrad(r["r1"], r["dc1"]), r["dz1"])
    for name, got, w in zip(("u1", "u2", "dw1", "dz1"),
                            (u1, u2, dw1, dz1), want):
        assert torch.equal(got, w), name
    assert dz1.is_contiguous() and dz1.dtype == torch.float32

    dx = fb.train_bwd_pass3_reference(*base, *t, u1, u2, dz1=dz1)
    n = fb._n(x)
    want = gy + g1 * i1 * (r["dz1"] - u1 / n - r["z1hat"] * (u2 / n))
    assert dx.dtype == x.dtype and torch.equal(dx, want)


# The forward's handoff at the three widths and the ragged plane.
FWD_SHAPES = ((4, 8, 8, 16), (4, 8, 8, 32), (2, 4, 4, 64), (2, 7, 5, 16))
FWD_IDS = ("c16", "c32", "c64", "ragged")


def _folds(shape, seed):
    """x, w1, w2 and the folds s1, b1, s2, b2 of the port's training
    forward (its own batch moments)."""
    x, _, w1, w2, g1, b1, g2, b2 = map(torch.from_numpy, _inputs(shape, seed))
    _, (m1, v1, m2, v2) = fb.block_train_fwd(x, w1, w2, g1, b1, g2, b2)
    return (x, w1, w2, *fb._fold(g1, b1, m1, v1, EPS),
            *fb._fold(g2, b2, m2, v2, EPS))


@pytest.mark.parametrize("shape", FWD_SHAPES, ids=FWD_IDS)
def test_stats_c1_equals_the_recompute_chain(shape):
    """The plain stats' c1 is bit for bit the c1 of the chain recomputed
    from x with the folds as BN (γ, β, μ, 1/σ) = (s, b, 0, 1), ẑ2 = (c1 −
    0)·1, and its sums are c1's."""
    x, w1, _, s1, b1, s2, b2 = _folds(shape, seed=shape[-1] + 11)
    zero, one = torch.zeros_like(s1), torch.ones_like(s1)
    want = fb._recompute(x, w1, s1, b1, s2, b2, zero, one, zero, one)[4]
    total, squares, c1 = fb.block_stats_reference(x, w1, s1, b1)
    assert c1.dtype == torch.float32 and c1.is_contiguous()
    assert torch.equal(c1, want)
    assert torch.equal(total, want.sum(SUM))
    assert torch.equal(squares, (want * want).sum(SUM))
    got = fb.block_stats(x, w1, s1, b1)   # the wrapper on the CPU
    for g, w in zip(got, (total, squares, c1)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=FWD_IDS)
def test_block_fwd_from_c1_equals_block_fwd_from_x(shape, dtype):
    """The forward from the stats' c1 gives bit for bit what the forward
    from x gives, plain and through the wrapper."""
    x, w1, w2, s1, b1, s2, b2 = _folds(shape, seed=shape[-1] + 12)
    x = x.to(dtype)
    c1 = fb.block_stats(x, w1, s1, b1)[2]
    want = fb.block_fwd_reference(x, w1, w2, s1, b1, s2, b2)
    got = fb.block_fwd_reference(x, w1, w2, s1, b1, s2, b2, c1=c1)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(fb.block_fwd(x, w1, w2, s1, b1, s2, b2, c1=c1), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=FWD_IDS)
def test_train_fwd_through_the_handoff_matches_reference(shape, dtype):
    """``block_train_fwd`` (the stats' c1 handed to the forward) against
    the reference's ``block_train_fwd`` in interpret mode, batch tile 2:
    the four moments and y within the tolerances of
    tests/test_torch_fused_train.py."""
    x, _, *params = _inputs(shape, seed=shape[-1] + 13)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want_y, want_m = jax_fb.block_train_fwd(
        jx, *map(jnp.asarray, params), EPS, batch_tile=2, interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got_y, got_m = fb.block_train_fwd(tx, *map(torch.from_numpy, params))
    for name, g, w in zip(("mean1", "var1", "mean2", "var2"), got_m, want_m):
        _close(g, w, name, atol=1e-5, rtol=1e-5)
    if dtype == "float32":
        _close(got_y, want_y, "y", atol=1e-5, rtol=1e-5)
    else:
        # One bf16 ulp of the reference's value, plus 1e-5 where x + out
        # cancels (as tests/test_torch_fused_train.py holds it).
        want = np.asarray(jnp.asarray(want_y, jnp.float32), np.float64)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        got = got_y.double().numpy()
        assert (np.abs(got - want) <= ulp + 1e-5).all()


@pytest.mark.parametrize("what", ["not_a_tensor", "shape", "dtype",
                                  "device", "strided"])
def test_block_fwd_refuses_a_malformed_c1(what):
    """``c1=`` must be the stats' c1 of this x: the whole stats tuple, or a
    c1 of the wrong shape, type, device or layout, raises."""
    x, w1, w2, s1, b1, s2, b2 = _folds((2, 6, 6, 16), seed=14)
    stats = fb.block_stats(x, w1, s1, b1)
    c1 = stats[2]
    fb.block_fwd(x, w1, w2, s1, b1, s2, b2, c1=c1)   # the handoff passes
    bad = {"not_a_tensor": stats, "shape": c1[..., :8],
           "dtype": c1.double(),
           "device": torch.empty(c1.shape, device="meta"),
           "strided": c1.transpose(1, 2)}[what]
    with pytest.raises(ValueError, match="c1 must be float32"):
        fb.block_fwd(x, w1, w2, s1, b1, s2, b2, c1=bad)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_handed_over_dz1_magnitudes_bound_it(shape):
    """The scale the card's tolerance may hold dz1 to: Σ|terms| of each
    element, never below the element itself, zero where [z1 > 0] is."""
    base, t, h1 = _base(shape, seed=shape[-1] + 4)
    dz1 = fb.train_bwd_pass2_reference(*base, *t, **h1)[3]
    scale = fb.train_bwd_pass2_reference(*base, *t, **h1,
                                         magnitudes=True)[3]
    assert scale.shape == dz1.shape and scale.is_contiguous()
    assert bool((scale * (1 + 1e-6) >= dz1.abs()).all())
    assert float(scale.max()) > 0
    z1 = fb._pass2_chain(*base, *t)["z1"]
    assert bool((scale[z1 <= 0] == 0).all())


@pytest.fixture(scope="module", params=SHAPES, ids=IDS)
def reference(request):
    """Inputs, the reference's moments and the outputs of its three
    backward passes (``_train_bwd_calls`` in interpret mode)."""
    shape = request.param
    x, gy, *params = _inputs(shape, seed=shape[-1] + 5)
    jp = list(map(jnp.asarray, params))
    _, moments = jax_fb.block_train_fwd(jnp.asarray(x), *jp, EPS,
                                        batch_tile=2, interpret=True)
    dx, dw1, dw2, u2, u1, t2, t1 = jax_fb._train_bwd_calls(
        jnp.asarray(x), jnp.asarray(gy), *jp, moments, EPS, batch_tile=2,
        interpret=True)
    return (x, gy, params, moments,
            dict(dx=dx, dw1=dw1, dw2=dw2, u1=u1, u2=u2, t1=t1, t2=t2))


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_handed_over_wrappers_match_reference_passes(reference):
    """The wrappers chained through the handoffs (the plain versions on the
    CPU), later passes on the reference's sums, against
    ``_train_bwd_calls``' passes."""
    x, gy, params, moments, ref = reference
    w1, w2, g1, b1, g2, b2 = map(_t, params)
    m1, v1, m2, v2 = map(_t, moments)
    i1, i2 = torch.rsqrt(v1 + EPS), torch.rsqrt(v2 + EPS)
    base = (_t(x), _t(gy), w1, w2, g1, b1, g2, b2, m1, i1, m2, i2)
    t = (_t(ref["t1"]), _t(ref["t2"]))
    t1, t2, dw2, dz2, z2hat = fb.block_bwd1(*base)
    u1, u2, dw1, dz1 = fb.block_bwd2(*base, *t, dz2=dz2, z2hat=z2hat)
    dx = fb.block_bwd3(*base, *t, _t(ref["u1"]), _t(ref["u2"]), dz1=dz1)
    for name, got in (("t1", t1), ("t2", t2), ("dw2", dw2), ("u1", u1),
                      ("u2", u2), ("dw1", dw1), ("dx", dx)):
        _close(got, ref[name], name)


def test_train_bwd_matches_jax_vjp(reference):
    """``block_train_bwd`` (three passes, dz2 and ẑ2 handed from 1 to 2,
    dz1 from 2 to 3) on the
    port's own moments against ``jax.vjp`` of the reference's
    ``block_train_apply``: all seven gradients, the moments' cotangent
    dropped."""
    x, gy, params, _, _ = reference
    (_, moments), vjp = jax.vjp(
        lambda *a: jax_fb.block_train_apply(*a, EPS, 2, True),
        *map(jnp.asarray, (x, *params)))
    want = vjp((jnp.asarray(gy), tuple(jnp.zeros_like(m) for m in moments)))
    args = list(map(torch.from_numpy, (x, *params)))
    _, got_m = fb.block_train_fwd(*args)
    got = fb.block_train_bwd(args[0], torch.from_numpy(gy), *args[1:], got_m)
    names = ("dx", "dw1", "dw2", "dgamma1", "dbeta1", "dgamma2", "dbeta2")
    for name, g, w in zip(names, got, want):
        _close(g, w, name)


@pytest.mark.parametrize("what", ["missing", "shape", "dtype", "device",
                                  "strided"])
def test_block_bwd3_refuses_a_missing_or_malformed_dz1(what):
    """No path recomputes dz1: without it, or with one of the wrong shape,
    type, device or layout, ``block_bwd3`` raises."""
    base, t, h1 = _base((2, 6, 6, 16), seed=9)
    u1, u2, _, dz1 = fb.train_bwd_pass2_reference(*base, *t, **h1)
    args = (*base, *t, u1, u2)
    fb.block_bwd3(*args, dz1=dz1)   # the well-formed handoff passes
    if what == "missing":
        with pytest.raises(TypeError, match="dz1"):
            fb.block_bwd3(*args)
        return
    bad = {"shape": dz1[..., :8], "dtype": dz1.double(),
           "device": torch.empty(dz1.shape, device="meta"),
           "strided": dz1.transpose(1, 2)}[what]
    with pytest.raises(ValueError, match="dz1 must be float32"):
        fb.block_bwd3(*args, dz1=bad)


@pytest.mark.parametrize("what", ["missing", "shape", "dtype", "device",
                                  "strided"])
@pytest.mark.parametrize("name", ["dz2", "z2hat"])
def test_block_bwd2_refuses_a_missing_or_malformed_handoff(name, what):
    """No path recomputes dz2 or ẑ2: without either, or with one of the
    wrong shape, type, device or layout, ``block_bwd2`` raises."""
    base, t, h1 = _base((2, 6, 6, 16), seed=10)
    fb.block_bwd2(*base, *t, **h1)   # the well-formed handoff passes
    good = h1[name]
    if what == "missing":
        del h1[name]
        with pytest.raises(TypeError, match=name):
            fb.block_bwd2(*base, *t, **h1)
        return
    h1[name] = {"shape": good[..., :8], "dtype": good.double(),
                "device": torch.empty(good.shape, device="meta"),
                "strided": good.transpose(1, 2)}[what]
    with pytest.raises(ValueError, match=f"{name} must be float32"):
        fb.block_bwd2(*base, *t, **h1)
