"""Fused-bottleneck training (ImageNet ResNet-50 with
``model.fused_blocks=true``) on the CPU: the port's live-BN fused bottleneck
(its wrappers, which take the plain versions for CPU tensors) against the
reference's ``fused_bottleneck`` with its Pallas kernels in interpret mode,
on the same numpy inputs; an independent float64 check of the plain backward
against autograd; ImageNet ResNet-50 at 64x64 in training mode and over two
train steps against the reference's fused model; the ImageNet training
augmentation; and the refusals that moved. The CUDA kernels are held against
the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_resnet.data import augment as ref_aug
from tpu_resnet.models import resnet as jax_resnet
from tpu_resnet.ops import fused_bottleneck as jax_fbn
from tpu_resnet.train import schedule as ref_sched
from tpu_resnet.train.state import TrainState as RefState
from tpu_resnet.train.state import build_optimizer as ref_build_optimizer
from tpu_resnet.train.step import make_train_step as ref_make_train_step
from tpu_resnet_torch import convert
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.data import augment as aug
from tpu_resnet_torch.models import imagenet_resnet_v2
from tpu_resnet_torch.models.resnet import FusedBottleneckBlock
from tpu_resnet_torch.ops import fused_bottleneck as fbn
from tpu_resnet_torch.ops import wgrad as wg
from tpu_resnet_torch.train import schedule as sched
from tpu_resnet_torch.train.loop import train
from tpu_resnet_torch.train.state import create_state
from tpu_resnet_torch.train.step import check_step_config, make_train_step

EPS = 1e-5
# (f, [B,H,W], row tile of the reference's kernels): three row tiles at
# f=64 (an odd number), one and two at the wider widths.
CASES = [(64, (2, 6, 5), 2), (128, (2, 8, 8), 4), (256, (2, 4, 4), 4)]
IDS = [f"f{f}" for f, _, _ in CASES]


def _inputs(f, bhw, seed):
    """x (shifted, so BN1 has work to do), gy, w1, w2, w3, γ1, β1, γ2, β2,
    γ3, β3."""
    rng = np.random.default_rng(seed)
    c4 = 4 * f
    f32 = np.float32
    return ((rng.normal(size=(*bhw, c4)) * 2 + 1).astype(f32),
            rng.normal(size=(*bhw, c4)).astype(f32),
            (rng.normal(size=(c4, f)) / np.sqrt(c4)).astype(f32),
            (rng.normal(size=(3, 3, f, f)) / np.sqrt(9 * f)).astype(f32),
            (rng.normal(size=(f, c4)) / np.sqrt(f)).astype(f32),
            *[a for n in (c4, f, f)
              for a in (rng.uniform(0.5, 1.5, n).astype(f32),
                        rng.uniform(-0.3, 0.3, n).astype(f32))])


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def _close(got, want, what, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=what)


@pytest.mark.parametrize("f, bhw, row_tile", CASES, ids=IDS)
def test_train_fwd_moments_match_reference(f, bhw, row_tile):
    """BN2's moments come from stats_a's sums, BN3's from stats_b's: the
    port's six moments and y against the reference's kernels."""
    x, _, *params = _inputs(f, bhw, seed=f)
    want_y, want_m = jax_fbn.bottleneck_train_fwd(
        jnp.asarray(x), *map(jnp.asarray, params), EPS, batch_tile=1,
        row_tile=row_tile, interpret=True)
    got_y, got_m = fbn.bottleneck_train_fwd(torch.from_numpy(x),
                                            *map(torch.from_numpy, params))
    for name, g, w in zip(("m1", "v1", "m2", "v2", "m3", "v3"), got_m,
                          want_m):
        _close(g, w, name)
    _close(got_y, want_y, "y")


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def passes(request):
    """Inputs, the reference's moments and the outputs of its four backward
    passes (``_train_bwd_calls`` in interpret mode)."""
    f, bhw, row_tile = request.param
    x, gy, *params = _inputs(f, bhw, seed=f + 1)
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


def test_train_bwd_passes_match_reference(passes):
    """Each pass on the reference's inputs (later passes on its sums)
    against the matching outputs of ``_train_bwd_calls``."""
    x, gy, params, moments, ref = passes
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    w1, w2, w3, g1, be1, g2, be2, g3, be3 = map(t, params)
    m1, v1, m2, v2, m3, v3 = map(t, moments)
    i1, i2, i3 = (torch.rsqrt(v + EPS) for v in (v1, v2, v3))
    base = (t(x), t(gy), w1, w2, w3, g1, be1, m1, i1, g2, be2, m2, i2, g3,
            be3, m3, i3)
    sums = [t(ref[k]) for k in ("t3a", "t3b", "t2a", "t2b", "t1a", "t1b")]
    # Each pass takes what the one before it handed over.
    outs = {1: fbn.bottleneck_bwd1(*base)}
    p2, mid, dm3 = outs[1][3:]
    outs[2] = fbn.bottleneck_bwd2(*base, *sums[:2], p2=p2, mid=mid, dm3=dm3)
    outs[3] = fbn.bottleneck_bwd3(*base, *sums[:4], dmid=outs[2][3])
    for k, names in ((1, ("t3a", "t3b", "dw3")), (2, ("t2a", "t2b", "dw2")),
                     (3, ("t1a", "t1b", "dw1"))):
        for name, got in zip(names, outs[k]):
            _close(got, ref[name], f"pass {k} {name}", atol=1e-4, rtol=1e-4)
    dx = fbn.bottleneck_bwd4(*base, *sums, dc1=outs[3][3])
    assert dx.dtype == torch.float32
    _close(dx, ref["dx"], "pass 4 dx", atol=1e-4, rtol=1e-4)


def test_weight_grad_products_match_reference(passes):
    """``wgrad.weight_grad`` on the CPU (its plain version, as its kernel's
    oracle), fed what passes 1-3 hand over, gives the reference's dw3, dw2
    and dw1, and launches nothing."""
    x, gy, params, moments, ref = passes
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    w1, w2, w3, g1, be1, g2, be2, g3, be3 = map(t, params)
    m1, v1, m2, v2, m3, v3 = map(t, moments)
    i1, i2, i3 = (torch.rsqrt(v + EPS) for v in (v1, v2, v3))
    base = (t(x), t(gy), w1, w2, w3, g1, be1, m1, i1, g2, be2, m2, i2, g3,
            be3, m3, i3)
    sums = [t(ref[k]) for k in ("t3a", "t3b", "t2a", "t2b")]
    p2, mid, dm3 = fbn.bottleneck_bwd1(*base)[3:]
    dmid = fbn.bottleneck_bwd2(*base, *sums[:2], p2=p2, mid=mid, dm3=dm3)[3]
    dc1 = fbn.bottleneck_bwd3(*base, *sums, dmid=dmid)[3]
    f = w1.shape[1]
    xt, gyt = base[:2]
    before = wg.launches
    got = {"dw3": wg.weight_grad("dw3", wg.BN_RELU, mid, gyt, f, 4 * f, xt,
                                 1, (g3, be3, m3, i3)),
           "dw2": wg.weight_grad("dw2", wg.SHIFTED, p2, dmid, f, f, xt, 9),
           "dw1": wg.weight_grad("dw1", wg.BN_RELU, xt, dc1, 4 * f, f, xt,
                                 1, (g1, be1, m1, i1))}
    assert wg.launches == before
    for name, g in got.items():
        _close(g.reshape(ref[name].shape), ref[name], name, atol=1e-4,
               rtol=1e-4)


@pytest.mark.parametrize("mode", ["rows", "shifted", "bn_relu"])
def test_weight_grad_plain_is_the_sum_over_pixels(mode):
    """``weight_grad_reference`` in each of the kernel's modes against the
    sum over pixels written out in float64 numpy: rows of A, A shifted by
    each 3x3 tap with zeros outside the image, relu(g·((v−μ)·i) + be)."""
    rng = np.random.default_rng(21)
    b, h, w, ka, nb = 2, 5, 3, 8, 4
    a = rng.normal(size=(b, h, w, ka)).astype(np.float32)
    bm = rng.normal(size=(b, h, w, nb)).astype(np.float32)
    bn = [rng.uniform(0.5, 1.5, ka), rng.normal(size=ka),
          rng.normal(size=ka), rng.uniform(0.5, 1.5, ka)]
    bn = [v.astype(np.float32) for v in bn]
    am = {"rows": wg.ROWS, "shifted": wg.SHIFTED,
          "bn_relu": wg.BN_RELU}[mode]
    got = wg.weight_grad_reference(
        am, torch.from_numpy(a), torch.from_numpy(bm),
        tuple(map(torch.from_numpy, bn)) if mode == "bn_relu" else ())
    a64, b64 = a.astype(np.float64), bm.astype(np.float64)
    if mode == "bn_relu":
        g, be, mu, i = (v.astype(np.float64) for v in bn)
        a64 = np.maximum(g * ((a64 - mu) * i) + be, 0.0)
    if mode == "shifted":
        pad = np.pad(a64, ((0, 0), (1, 1), (1, 1), (0, 0)))
        want = np.stack([np.einsum("bhwk,bhwn->kn",
                                   pad[:, dy:dy + h, dx:dx + w], b64)
                         for dy in range(3) for dx in range(3)])
    else:
        want = np.einsum("bhwk,bhwn->kn", a64, b64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), want.reshape(-1),
                               atol=1e-5, rtol=1e-5)


def _reference_stats_a(x, w1, g1, be1, mu1, i1):
    """The reference's ``_stats_a_kernel`` through ``pallas_call`` in
    interpret mode, as its ``bottleneck_train_fwd`` calls it."""
    f = w1.shape[-1]
    interpret, bt, ht, grid, full, kwargs = jax_fbn._plumb(x, 1, None, True,
                                                           f)
    b, h, wdt, c4 = x.shape
    center = jax_fbn._specs(bt, ht, wdt, c4, grid[1])[0]
    return pl.pallas_call(
        jax_fbn._stats_a_kernel, grid=grid,
        in_specs=[center, full(c4, f)] + [full(c4)] * 4,
        out_specs=[full(f), full(f)],
        out_shape=[jax.ShapeDtypeStruct((f,), jnp.float32)] * 2,
        interpret=interpret, **kwargs)(x, w1, g1, be1, mu1, i1)


def test_stats_a_rounds_bn1_as_the_reference():
    """(g1·(x−μ1))·i1 first, as the reference's ``_stats_a_kernel``: with x
    = 2^100, i1 = 2^100 and g1 = 2^-100 on a quarter of the channels, that
    order gives p1 = 2^100 and finite sums, where g1·((x−μ1)·i1), the
    order of the other passes, overflows."""
    f = 64
    x, _, w1, *_ = _inputs(f, (2, 4, 4), seed=9)
    rng = np.random.default_rng(10)
    g1, be1, mu1 = (rng.uniform(0.5, 1.5, 4 * f).astype(np.float32),
                    rng.uniform(-0.3, 0.3, 4 * f).astype(np.float32),
                    rng.normal(size=4 * f).astype(np.float32))
    i1 = rng.uniform(0.5, 1.5, 4 * f).astype(np.float32)
    big = np.arange(4 * f) % 4 == 0
    x[..., big], w1[big] = 2.0 ** 100, 2.0 ** -100
    g1[big], mu1[big], i1[big] = 2.0 ** -100, 0.0, 2.0 ** 100
    with np.errstate(over="ignore"):
        assert np.isinf(g1 * ((x - mu1) * i1)).any()
    args = (x, w1, g1, be1, mu1, i1)
    want = _reference_stats_a(*map(jnp.asarray, args))
    got = fbn.bottleneck_stats_a(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        assert np.isfinite(_np(w)).all()
        _close(g, w, "stats_a", atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("f, bhw, row_tile", CASES[:2], ids=IDS[:2])
def test_train_apply_grads_match_jax_grad(f, bhw, row_tile):
    """All ten gradients of the port's autograd Function against ``jax.vjp``
    of the reference's custom-VJP ``bottleneck_train_apply``; the moments'
    cotangent is dropped in both."""
    x, gy, *params = _inputs(f, bhw, seed=f + 2)
    jargs = [jnp.asarray(a) for a in (x, *params)]
    (y, moments), vjp = jax.vjp(
        lambda *a: jax_fbn.bottleneck_train_apply(*a, EPS, 1, row_tile, True),
        *jargs)
    want = vjp((jnp.asarray(gy), tuple(jnp.zeros_like(m) for m in moments)))
    targs = [torch.from_numpy(a).requires_grad_() for a in (x, *params)]
    got_y, got_m = fbn.bottleneck_train_apply(*targs)
    assert not any(m.requires_grad for m in got_m)
    _close(got_y, y, "y")
    got_y.backward(torch.from_numpy(gy))
    names = ("dx", "dw1", "dw2", "dw3", "dgamma1", "dbeta1", "dgamma2",
             "dbeta2", "dgamma3", "dbeta3")
    for name, a, w in zip(names, targs, want):
        # Three chained BNs' correction sums, in float32.
        _close(a.grad, w, name, atol=1e-4, rtol=1e-4)


def test_plain_backward_matches_autograd_in_float64():
    """Independent of the reference: the four plain passes against
    ``torch.autograd`` through the plain forward, in float64 (the three BN
    batch statistics' correction terms included)."""
    x, gy, *params = _inputs(16, (2, 4, 5), seed=5)
    args = [torch.from_numpy(a).double().requires_grad_()
            for a in (x, *params)]
    y, moments = fbn.bottleneck_train_fwd_reference(*args)
    want = torch.autograd.grad(y, args, torch.from_numpy(gy).double())
    x, *rest = (a.detach() for a in args)
    got = fbn.bottleneck_train_bwd_reference(
        x, torch.from_numpy(gy).double(), *rest,
        [m.detach() for m in moments])
    names = ("dx", "dw1", "dw2", "dw3", "dgamma1", "dbeta1", "dgamma2",
             "dbeta2", "dgamma3", "dbeta3")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-10, err_msg=name)


# ------------------------------------------------------------ model level
SIZE = 64    # 64x64 input: the fused stages at 16², 8² and 4²
BATCH = 2


@functools.lru_cache(maxsize=None)
def _reference_init():
    """The reference ResNet-50's variables at init, once per module (jitted:
    half the time of an eager init)."""
    model = jax_resnet.imagenet_resnet_v2(50, 1000, dtype=jnp.float32)
    return jax.device_get(jax.jit(lambda key: model.init(
        key, jnp.zeros((1, SIZE, SIZE, 3)), train=False))(
            jax.random.PRNGKey(0)))


def _reference_variables(seed, spread=0.5):
    """Seeded weights with the BN parameters and statistics off their init:
    scales and variances in 1 ± spread, biases and means of std 0.4·spread
    (the final dense bias too). Every leaf is a fresh copy."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        a = np.array(a, np.float32)
        if "'scale'" in name or "'var'" in name:
            return rng.uniform(1 - spread, 1 + spread,
                               a.shape).astype(np.float32)
        if "'bn'" in name or ("final_dense" in name and "'bias'" in name):
            return rng.normal(0, 0.4 * spread, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, _reference_init())


def _ref_model():
    return jax_resnet.imagenet_resnet_v2(50, 1000, dtype=jnp.float32,
                                         fused_blocks=True,
                                         fused_epilogue="on")


def _port_model(variables):
    model = imagenet_resnet_v2(50, 1000, dtype=torch.float32,
                               fused_blocks=True, fused_epilogue="on")
    model.load_state_dict(convert.flax_to_torch(variables), strict=True)
    return model


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32),
            rng.integers(0, 1000, BATCH).astype(np.int32))


def test_rn50_train_forward_matches_reference():
    """Logits and every updated running statistic of one training forward
    (10 fused bottlenecks, live moments)."""
    variables = _reference_variables(seed=1)
    x, _ = _batch(0)
    want, updates = _ref_model().apply(variables, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
    port = _port_model(variables)
    got = port(torch.from_numpy(x), train=True)
    assert got.requires_grad
    # float32 through 50 layers, stage 4's BN moments over 8 pixels: the
    # unfused port is as far from the reference's unfused model (3.1e-4).
    _close(got, want, "logits", atol=1e-3, rtol=1e-3)
    stats = convert.flax_to_torch({"batch_stats": jax.device_get(
        updates["batch_stats"])})
    buffers = dict(port.named_buffers())
    assert set(stats) == set(buffers)
    for name, value in stats.items():
        _close(buffers[name], value, name, atol=1e-5, rtol=1e-4)


CONTROL_FACTOR = 4.0   # as chip_smoke.py's fused train-step gate


def _worst_rel(got: dict, want: dict) -> float:
    """Largest normwise relative distance |got - want| / |want| over every
    tensor (the momentum buffers carry each parameter's gradient)."""
    assert set(got) == set(want)
    return max(float(np.linalg.norm(_np(got[n]) - _np(want[n]))
                     / max(np.linalg.norm(_np(want[n])), 1e-12))
               for n in want)


def test_rn50_train_steps_match_reference():
    """Two steps from one state (BN mildly off its init, a random momentum
    trace, a warm-up rate of 1e-5): every parameter, statistic and momentum
    buffer, and the step's metrics.

    ResNet-50's float32 gradient at this size is ill-conditioned: a
    backward mask [z > 0] flips wherever z lies within rounding of 0, and
    16 blocks of live BN carry each flip on. The first step's gradients of
    any two float32 implementations differ by 2-6% normwise per tensor (the
    reference's own fused and unfused models by 2%), so no elementwise
    limit holds. The port's unfused model (PyTorch convolutions and BN, no
    fused code) is the control: the fused port passes when its worst
    tensor, normwise, lies within CONTROL_FACTOR times the control's
    distance from the reference (as chip_smoke.py gates the fused train
    step), and so do the second step's loss and precision. The first
    step's loss and precision and both rates are within 1e-4 relative;
    grad_norm, which moves with those flips, within 3e-2."""
    overrides = ["model.fused_blocks=true", "model.fused_epilogue=on",
                 "optim.use_pallas_xent=on", f"data.image_size={SIZE}",
                 "optim.warmup_init_lr=0.00001"]
    cfg = load_config("imagenet", "", overrides)
    variables = _reference_variables(seed=4, spread=0.1)
    rng = np.random.default_rng(7)
    trace = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.01).astype(np.float32),
        jax.device_get(variables["params"]))

    schedule = ref_sched.build_schedule(cfg.optim, cfg.train)
    tx = ref_build_optimizer(cfg.optim, schedule)
    state = RefState.create(variables["params"], variables["batch_stats"], tx)
    state = state.replace(opt_state=(state.opt_state[0]._replace(
        trace=jax.tree_util.tree_map(jnp.asarray, trace)),
        *state.opt_state[1:]))
    ref_step = jax.jit(ref_make_train_step(_ref_model(), cfg.optim, schedule,
                                           1000))
    port_step = make_train_step(cfg.optim, sched.build_schedule(
        cfg.optim, cfg.train), 1000)
    ports = {}
    for fused in (True, False):
        model = imagenet_resnet_v2(50, 1000, dtype=torch.float32,
                                   fused_blocks=fused, fused_epilogue="on")
        model.load_state_dict(convert.flax_to_torch(variables), strict=True)
        ports[fused] = create_state(model, cfg.optim)
        ports[fused].load_momentum_buffers(
            convert.flax_opt_state_to_torch(trace))

    metric_err = {True: 0.0, False: 0.0}
    for i in range(2):
        x, y = _batch(12 + i)
        state, want = ref_step(state, jnp.asarray(x), jnp.asarray(y))
        for fused, port_state in ports.items():
            got = port_step(port_state, torch.from_numpy(x),
                            torch.from_numpy(y))
            # The first step's forward is well conditioned; its gradient,
            # and so the second step, are not.
            exact = ("loss", "precision", "learning_rate") if i == 0 else (
                "learning_rate",)
            for key in exact:
                _close(float(got[key]), float(want[key]),
                       f"step {i} {key} fused={fused}", rtol=1e-4)
            _close(float(got["grad_norm"]), float(want["grad_norm"]),
                   f"step {i} grad_norm fused={fused}", rtol=3e-2)
            for key in {"loss", "precision"} - set(exact):
                metric_err[fused] = max(metric_err[fused], abs(
                    float(got[key]) - float(want[key])) / max(
                        abs(float(want[key])), 1e-6))
    want = convert.flax_to_torch(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    want.update({f"momentum {n}": v for n, v in convert.flax_opt_state_to_torch(
        jax.device_get(state.opt_state[0].trace)).items()})
    worst = {}
    for fused, port_state in ports.items():
        got = dict(port_state.model.state_dict())
        got.update({f"momentum {n}": v
                    for n, v in port_state.momentum_buffers().items()})
        worst[fused] = _worst_rel(got, want)
    assert worst[True] <= CONTROL_FACTOR * max(worst[False], 1e-6), worst
    assert metric_err[True] <= CONTROL_FACTOR * max(metric_err[False],
                                                    1e-5), metric_err


# ------------------------------------------------------------ input, gates
def test_imagenet_train_augment_matches_reference():
    """The pure part (flip, [0, 1], VGG means) given the reference's own
    flip mask, and the whole augmentation from the same key: the port
    draws the reference's flips."""
    images = np.random.default_rng(3).integers(0, 256, (4, 8, 6, 3),
                                               dtype=np.uint8)
    rng = jax.random.PRNGKey(5)
    want = ref_aug.imagenet_train_augment(rng, jnp.asarray(images))
    flip = np.array(jax.random.bernoulli(rng, 0.5, (4, 1, 1, 1)))[:, 0, 0, 0]
    assert 0 < flip.sum() < 4   # both branches
    got = aug.flip_mean_subtract(torch.from_numpy(images),
                                 torch.from_numpy(flip))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = aug.get_train_augment("imagenet")(
        torch.from_numpy(images), np.asarray(rng))
    assert drawn.shape == (4, 8, 6, 3) and drawn.dtype == torch.float32
    np.testing.assert_array_equal(drawn.numpy(), np.asarray(want))


def test_check_step_config_accepts_imagenet():
    check_step_config(load_config("imagenet", "", [
        "model.fused_blocks=true", "model.fused_epilogue=on",
        "optim.use_pallas_xent=on"]))


def test_train_on_imagenet_refuses_for_its_input_pipeline(tmp_path):
    """ImageNet training goes through the input pipeline, which refuses a
    data dir without shards with the reference's FileNotFoundError."""
    cfg = load_config("imagenet", "", [
        "model.resnet_size=18", "optim.use_pallas_xent=on",
        "data.image_size=32", f"data.data_dir={tmp_path / 'no_shards'}",
        f"train.train_dir={tmp_path}"])
    with pytest.raises(FileNotFoundError, match="no ImageNet shards match"):
        train(cfg, device="cpu")


def test_fused_bottleneck_block_trains_through_plain_versions_on_cpu():
    """On the CPU the block's training forward takes the plain versions (no
    launch counted), matches the unfused block and updates all three
    running statistics."""
    from tpu_resnet_torch.models.resnet import BottleneckBlock
    gen = torch.Generator().manual_seed(0)
    fused = FusedBottleneckBlock(64)
    for p in fused.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.1 + (
            1.0 if p.dim() == 1 else 0.0)
    plain = BottleneckBlock(256, 64, 1, False)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 4, 4, 256, generator=gen)
    counts = [fbn.launches, fbn.stats_a_launches, fbn.bwd1_launches]
    y = fused(x, train=True)
    y.sum().backward()
    assert [fbn.launches, fbn.stats_a_launches, fbn.bwd1_launches] == counts
    _close(y, plain(x, train=True), "y", atol=1e-4, rtol=1e-4)
    for name, buf in fused.named_buffers():
        _close(buf, dict(plain.named_buffers())[name], name, atol=1e-5,
               rtol=1e-4)
    assert fused.preact.running_mean.abs().sum() > 0
