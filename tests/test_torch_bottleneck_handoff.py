"""The fused bottleneck's backward passes 1 -> 2 -> 3 -> 4 hand over what
they wrote (p2, mid and dm3, then dmid, then dc1) instead of recomputing
the chain from x, as the reference's ``_train_bwd_calls`` does. On the CPU, on the cases of
tests/test_torch_bottleneck_train.py: the plain passes with the handoffs
against the recompute-from-x chain (``_bwd_chain``) bit for bit, the
wrappers against the reference's passes (Pallas in interpret mode) and the
port's backward against ``jax.vjp`` of the reference's custom-VJP block, and
the wrappers' refusals of a missing or malformed handoff. The CUDA kernels
are held against the same plain passes on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bottleneck_train import CASES, EPS, IDS, _close, _inputs
from tpu_resnet.ops import fused_bottleneck as jax_fbn
from tpu_resnet_torch.ops import fused_bottleneck as fbn
from tpu_resnet_torch.ops.fused_block import _n, _wgrad

SUM = (0, 1, 2)


def _base(f, bhw, seed):
    """x, gy, the weights and the twelve BN vectors (moments from the
    port's training forward), pass 1's sums and its handoffs {p2, mid,
    dm3}."""
    x, gy, w1, w2, w3, g1, be1, g2, be2, g3, be3 = map(
        torch.from_numpy, _inputs(f, bhw, seed))
    _, (m1, v1, m2, v2, m3, v3) = fbn.bottleneck_train_fwd(
        x, w1, w2, w3, g1, be1, g2, be2, g3, be3)
    i1, i2, i3 = (torch.rsqrt(v + EPS) for v in (v1, v2, v3))
    base = (x, gy, w1, w2, w3, g1, be1, m1, i1, g2, be2, m2, i2, g3, be3,
            m3, i3)
    t3a, t3b, _, p2, mid, dm3 = fbn.train_bwd_pass1_reference(*base)
    return base, (t3a, t3b), {"p2": p2, "mid": mid, "dm3": dm3}


@pytest.mark.parametrize("f, bhw, row_tile", CASES, ids=IDS)
def test_handed_over_passes_equal_the_recompute_chain(f, bhw, row_tile):
    """Pass 1's p2, mid and dm3, and passes 2, 3 and 4 from them, dmid and
    dc1, give bit for bit what the chain recomputed from x gives for every
    output of every pass."""
    base, t3, h1 = _base(f, bhw, seed=f + 3)
    x, gy, w1, w2, w3, *vecs = base
    g1, i1 = vecs[0], vecs[3]
    r = fbn._bwd_chain(x, gy, w1, w2, w3, vecs)
    for name, got in h1.items():
        assert torch.equal(got, r[name]), name
        assert got.is_contiguous(), name
    t2a, t2b, dw2, dmid = fbn.train_bwd_pass2_reference(*base, *t3, **h1)
    r = fbn._bwd_chain(x, gy, w1, w2, w3, vecs, t3)
    want = (r["dm2"].sum(SUM), (r["dm2"] * r["chat"]).sum(SUM),
            _wgrad(r["p2"], r["dmid"]), r["dmid"])
    for name, got, w in zip(("t2a", "t2b", "dw2", "dmid"),
                            (t2a, t2b, dw2, dmid), want):
        assert torch.equal(got, w), name
    assert dmid.is_contiguous()

    t1a, t1b, dw1, dc1 = fbn.train_bwd_pass3_reference(*base, *t3, t2a, t2b,
                                                       dmid=dmid)
    r = fbn._bwd_chain(x, gy, w1, w2, w3, vecs, (*t3, t2a, t2b))
    want = (r["dm1"].sum(SUM), (r["dm1"] * r["x1hat"]).sum(SUM),
            torch.einsum("bhwc,bhwf->cf", r["p1"], r["dc1"]), r["dc1"])
    for name, got, w in zip(("t1a", "t1b", "dw1", "dc1"),
                            (t1a, t1b, dw1, dc1), want):
        assert torch.equal(got, w), name
    assert dc1.is_contiguous()

    dx = fbn.train_bwd_pass4_reference(*base, *t3, t2a, t2b, t1a, t1b,
                                       dc1=dc1)
    n = _n(x)
    want = r["gy"] + g1 * i1 * (r["dm1"] - t1a / n - r["x1hat"] * (t1b / n))
    assert dx.dtype == x.dtype and torch.equal(dx, want)


@pytest.mark.parametrize("f, bhw, row_tile", CASES, ids=IDS)
def test_handed_over_magnitudes_bound_the_tensors(f, bhw, row_tile):
    """The scales the card's tolerance holds p2, mid, dm3, dmid and dc1 to:
    Σ|terms| of each element, never below the element itself."""
    base, t3, h1 = _base(f, bhw, seed=f + 4)
    scale1 = fbn.train_bwd_pass1_reference(*base, magnitudes=True)[3:]
    *t2, _, dmid = fbn.train_bwd_pass2_reference(*base, *t3, **h1)
    scale2 = fbn.train_bwd_pass2_reference(*base, *t3, **h1,
                                           magnitudes=True)[3]
    dc1 = fbn.train_bwd_pass3_reference(*base, *t3, *t2, dmid=dmid)[3]
    scale3 = fbn.train_bwd_pass3_reference(*base, *t3, *t2, dmid=dmid,
                                           magnitudes=True)[3]
    for name, t, s in (*zip(h1, h1.values(), scale1), ("dmid", dmid, scale2),
                       ("dc1", dc1, scale3)):
        assert s.shape == t.shape, name
        assert bool((s * (1 + 1e-6) >= t.abs()).all()), name
        assert float(s.max()) > 0, name


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def reference(request):
    """Inputs, the reference's moments and the outputs of its four backward
    passes (``_train_bwd_calls`` in interpret mode)."""
    f, bhw, row_tile = request.param
    x, gy, *params = _inputs(f, bhw, seed=f + 5)
    jp = list(map(jnp.asarray, params))
    _, moments = jax_fbn.bottleneck_train_fwd(
        jnp.asarray(x), *jp, EPS, batch_tile=1, row_tile=row_tile,
        interpret=True)
    outs = jax_fbn._train_bwd_calls(
        jnp.asarray(x), jnp.asarray(gy), *jp, moments, EPS, batch_tile=1,
        row_tile=row_tile, interpret=True)
    names = ("dx", "dw1", "dw2", "dw3", "t1b", "t1a", "t2b", "t2a", "t3b",
             "t3a")
    return x, gy, params, moments, dict(zip(names, outs))


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_handed_over_wrappers_match_reference_passes(reference):
    """The wrappers chained through their handoffs (the plain versions on
    the CPU), later passes on the reference's sums, against
    ``_train_bwd_calls``' passes."""
    x, gy, params, moments, ref = reference
    w1, w2, w3, g1, be1, g2, be2, g3, be3 = map(_t, params)
    m1, v1, m2, v2, m3, v3 = map(_t, moments)
    i1, i2, i3 = (torch.rsqrt(v + EPS) for v in (v1, v2, v3))
    base = (_t(x), _t(gy), w1, w2, w3, g1, be1, m1, i1, g2, be2, m2, i2, g3,
            be3, m3, i3)
    sums = [_t(ref[k]) for k in ("t3a", "t3b", "t2a", "t2b", "t1a", "t1b")]
    t3a, t3b, dw3, p2, mid, dm3 = fbn.bottleneck_bwd1(*base)
    t2a, t2b, dw2, dmid = fbn.bottleneck_bwd2(*base, *sums[:2], p2=p2,
                                              mid=mid, dm3=dm3)
    t1a, t1b, dw1, dc1 = fbn.bottleneck_bwd3(*base, *sums[:4], dmid=dmid)
    dx = fbn.bottleneck_bwd4(*base, *sums, dc1=dc1)
    for name, got in (("t3a", t3a), ("t3b", t3b), ("dw3", dw3), ("t2a", t2a),
                      ("t2b", t2b), ("dw2", dw2), ("t1a", t1a),
                      ("t1b", t1b), ("dw1", dw1), ("dx", dx)):
        _close(got, ref[name], name, atol=1e-4, rtol=1e-4)


def test_train_bwd_matches_jax_vjp(reference):
    """``bottleneck_train_bwd`` (four passes, three handoffs) on the port's
    own moments against ``jax.vjp`` of the reference's
    ``bottleneck_train_apply``: all ten gradients, the moments' cotangent
    dropped."""
    x, gy, params, _, _ = reference
    f = params[0].shape[1]
    row_tile = dict((c[0], c[2]) for c in CASES)[f]
    (_, moments), vjp = jax.vjp(
        lambda *a: jax_fbn.bottleneck_train_apply(*a, EPS, 1, row_tile,
                                                  True),
        *map(jnp.asarray, (x, *params)))
    want = vjp((jnp.asarray(gy), tuple(jnp.zeros_like(m) for m in moments)))
    args = list(map(torch.from_numpy, (x, *params)))
    _, got_m = fbn.bottleneck_train_fwd(*args)
    got = fbn.bottleneck_train_bwd(args[0], torch.from_numpy(gy), *args[1:],
                                   got_m)
    names = ("dx", "dw1", "dw2", "dw3", "dgamma1", "dbeta1", "dgamma2",
             "dbeta2", "dgamma3", "dbeta3")
    for name, g, w in zip(names, got, want):
        # Three chained BNs' correction sums, in float32.
        _close(g, w, name, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("what", ["missing", "shape", "dtype", "device"])
@pytest.mark.parametrize("kind", ["bottleneck_bwd2", "bottleneck_bwd3",
                                  "bottleneck_bwd4"])
def test_wrappers_refuse_a_missing_or_malformed_handoff(kind, what):
    """No path recomputes p2, mid, dm3, dmid or dc1: without one, or with
    one of the wrong shape, type or device, the wrapper raises."""
    base, t3, h1 = _base(64, (1, 3, 4), seed=9)
    *t2, _, dmid = fbn.train_bwd_pass2_reference(*base, *t3, **h1)
    *t1, _, dc1 = fbn.train_bwd_pass3_reference(*base, *t3, *t2, dmid=dmid)
    call, good = {
        "bottleneck_bwd2": (lambda **kw: fbn.bottleneck_bwd2(
            *base, *t3, **kw), h1),
        "bottleneck_bwd3": (lambda **kw: fbn.bottleneck_bwd3(
            *base, *t3, *t2, **kw), {"dmid": dmid}),
        "bottleneck_bwd4": (lambda **kw: fbn.bottleneck_bwd4(
            *base, *t3, *t2, *t1, **kw), {"dc1": dc1})}[kind]
    call(**good)   # the well-formed handoffs pass
    for name, t in good.items():
        others = {k: v for k, v in good.items() if k != name}
        if what == "missing":
            with pytest.raises(TypeError, match=name):
                call(**others)
            continue
        bad = {"shape": t[..., :32], "dtype": t.double(),
               "device": torch.empty(t.shape, device="meta")}[what]
        with pytest.raises(ValueError, match=f"{name} must be float32"):
            call(**others, **{name: bad})
