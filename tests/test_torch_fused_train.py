"""Fused-block training (``model.fused_blocks=true`` in ``train``) on the
CPU: the port's live-BN fused block (its wrappers, which take the plain
versions for CPU tensors) against the reference's ``fused_block`` with its
Pallas kernels in interpret mode (batch tile 2, as tests/test_fused_block.py
runs them), on the same numpy inputs; an independent float64 check of the
plain backward against autograd; the CIFAR ResNet-14 (one fused block per
stage) in training mode and over two train steps against the reference's
fused model; and checkpoints moving between fused and unfused models.
The CUDA kernels are held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.models.resnet import cifar_resnet_v2 as ref_cifar
from tpu_resnet.ops import fused_block as jax_fb
from tpu_resnet.train import schedule as ref_sched
from tpu_resnet.train.state import TrainState as RefState
from tpu_resnet.train.state import build_optimizer as ref_build_optimizer
from tpu_resnet.train.step import make_train_step as ref_make_train_step
from tpu_resnet_torch import convert
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.models import cifar_resnet_v2
from tpu_resnet_torch.ops import fused_block as fb
from tpu_resnet_torch.train import checkpoint
from tpu_resnet_torch.train import schedule as sched
from tpu_resnet_torch.train.loop import train
from tpu_resnet_torch.train.state import create_state
from tpu_resnet_torch.train.step import make_train_step

EPS = 1e-5


def _inputs(c, seed, b=4, hw=8):
    """x (shifted, so BN1 has work to do), gy, w1, w2, γ1, β1, γ2, β2."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return ((rng.normal(size=(b, hw, hw, c)) * 2 + 1).astype(f32),
            rng.normal(size=(b, hw, hw, c)).astype(f32),
            (rng.normal(size=(3, 3, c, c)) * 0.2).astype(f32),
            (rng.normal(size=(3, 3, c, c)) * 0.2).astype(f32),
            rng.uniform(0.5, 1.5, c).astype(f32),
            rng.uniform(-0.3, 0.3, c).astype(f32),
            rng.uniform(0.5, 1.5, c).astype(f32),
            rng.uniform(-0.3, 0.3, c).astype(f32))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def _close(got, want, what, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [16, 32])
def test_block_train_fwd_matches_reference(c, dtype):
    x, _, *params = _inputs(c, seed=c)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want_y, want_m = jax_fb.block_train_fwd(
        jx, *map(jnp.asarray, params), EPS, batch_tile=2, interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got_y, got_m = fb.block_train_fwd(tx, *map(torch.from_numpy, params))
    assert got_y.dtype == tx.dtype and got_y.shape == tx.shape
    for name, g, w in zip(("mean1", "var1", "mean2", "var2"), got_m, want_m):
        _close(g, w, name, atol=1e-5, rtol=1e-5)
    if dtype == "float32":
        _close(got_y, want_y, "y", atol=1e-5, rtol=1e-5)
    else:
        # Both round to bf16 an f32 value that differs by the f32
        # tolerance (another summation order): one bf16 ulp of the
        # reference's value, plus that 1e-5 where x + out cancels.
        want = _np(want_y)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert (np.abs(_np(got_y) - want) <= ulp + 1e-5).all()


def _jax_passes(c, seed):
    """Inputs, the reference's moments and its three passes' outputs."""
    x, gy, *params = _inputs(c, seed)
    jp = list(map(jnp.asarray, params))
    _, moments = jax_fb.block_train_fwd(jnp.asarray(x), *jp, EPS,
                                        batch_tile=2, interpret=True)
    dx, dw1, dw2, u2, u1, t2, t1 = jax_fb._train_bwd_calls(
        jnp.asarray(x), jnp.asarray(gy), *jp, moments, EPS, batch_tile=2,
        interpret=True)
    return (x, gy, params, [np.asarray(m) for m in moments],
            dict(dx=dx, dw1=dw1, dw2=dw2, u1=u1, u2=u2, t1=t1, t2=t2))


@pytest.mark.parametrize("c", [16, 32])
def test_train_bwd_passes_match_reference(c):
    """Each pass on the reference's inputs (pass 2 on its T and on pass 1's
    dz2 and ẑ2, pass 3 on its T and U and on pass 2's dz1) against the
    matching output of ``_train_bwd_calls``."""
    x, gy, params, moments, ref = _jax_passes(c, seed=c + 1)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    m1, v1, m2, v2 = map(t, moments)
    i1, i2 = torch.rsqrt(v1 + EPS), torch.rsqrt(v2 + EPS)
    g1, b1, g2, b2 = map(t, params[2:])
    args = (t(x), t(gy), t(params[0]), t(params[1]), g1, b1, g2, b2, m1, i1,
            m2, i2)
    t1, t2, dw2, dz2, z2hat = fb.block_bwd1(*args)
    for name, got in (("t1", t1), ("t2", t2), ("dw2", dw2)):
        _close(got, ref[name], f"pass 1 {name}")
    ref_t = (t(ref["t1"]), t(ref["t2"]))
    u1, u2, dw1, dz1 = fb.block_bwd2(*args, *ref_t, dz2=dz2, z2hat=z2hat)
    for name, got in (("u1", u1), ("u2", u2), ("dw1", dw1)):
        _close(got, ref[name], f"pass 2 {name}")
    assert dz1.shape == args[0].shape and dz1.dtype == torch.float32
    dx = fb.block_bwd3(*args, *ref_t, t(ref["u1"]), t(ref["u2"]), dz1=dz1)
    assert dx.dtype == torch.float32
    _close(dx, ref["dx"], "pass 3 dx")


@pytest.mark.parametrize("c", [16, 32])
def test_block_train_apply_grads_match_reference(c):
    """All seven gradients of the port's autograd Function against
    ``jax.vjp`` of the reference's custom-VJP ``block_train_apply``; the
    moments' cotangent is dropped in both."""
    x, gy, *params = _inputs(c, seed=c + 2)
    jargs = [jnp.asarray(a) for a in (x, *params)]
    (y, moments), vjp = jax.vjp(
        lambda *a: jax_fb.block_train_apply(*a, EPS, 2, True), *jargs)
    want = vjp((jnp.asarray(gy), tuple(jnp.zeros_like(m) for m in moments)))

    targs = [torch.from_numpy(a).requires_grad_() for a in (x, *params)]
    got_y, got_m = fb.block_train_apply(*targs)
    assert not any(m.requires_grad for m in got_m)
    _close(got_y, y, "y", atol=1e-5, rtol=1e-5)
    got_y.backward(torch.from_numpy(gy))
    names = ("dx", "dw1", "dw2", "dgamma1", "dbeta1", "dgamma2", "dbeta2")
    for name, a, w in zip(names, targs, want):
        _close(a.grad, w, name)


def test_plain_backward_matches_autograd_in_float64():
    """Independent of the reference: the three plain passes against
    ``torch.autograd`` through the plain forward, in float64 (the BN batch
    statistics' correction terms included)."""
    x, gy, *params = _inputs(16, seed=5)
    args = [torch.from_numpy(a).double().requires_grad_()
            for a in (x, *params)]
    y, moments = fb.block_train_fwd_reference(*args)
    want = torch.autograd.grad(y, args, torch.from_numpy(gy).double())
    x, w1, w2, g1, b1, g2, b2 = (a.detach() for a in args)
    got = fb.block_train_bwd_reference(x, torch.from_numpy(gy).double(), w1,
                                       w2, g1, b1, g2, b2,
                                       [m.detach() for m in moments])
    names = ("dx", "dw1", "dw2", "dgamma1", "dbeta1", "dgamma2", "dbeta2")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-10, err_msg=name)


# ------------------------------------------------------------ model level
SIZE = 14   # n = 2: each stage is a projection block0 and one fused block


def _reference_variables(seed=1):
    model = ref_cifar(SIZE, 10, dtype=jnp.float32)
    variables = jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, a):   # BN parameters and statistics off their init
        name = jax.tree_util.keystr(path)
        a = np.asarray(a, np.float32)
        if "'scale'" in name or "'var'" in name:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if "'bn'" in name or ("final_dense" in name and "'bias'" in name):
            return rng.normal(0, 0.2, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _port_model(variables):
    model = cifar_resnet_v2(SIZE, 10, dtype=torch.float32, fused_blocks=True,
                            fused_epilogue="on")
    model.load_state_dict(convert.flax_to_torch(variables), strict=True)
    return model


def _batch(seed, b=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, b).astype(np.int32))


def test_fused_model_train_forward_matches_reference():
    variables = _reference_variables()
    x, _ = _batch(0)
    ref = ref_cifar(SIZE, 10, dtype=jnp.float32, fused_blocks=True,
                    fused_epilogue="on")
    want, updates = ref.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    port = _port_model(variables)
    got = port(torch.from_numpy(x), train=True)
    assert got.requires_grad
    _close(got, want, "logits", atol=1e-5, rtol=1e-5)
    stats = convert.flax_to_torch({"batch_stats": jax.device_get(
        updates["batch_stats"])})
    buffers = dict(port.named_buffers())
    assert set(stats) == set(buffers)
    for name, value in stats.items():
        _close(buffers[name], value, name, atol=1e-5, rtol=1e-5)


def test_fused_train_steps_match_reference():
    """Two steps from one state (BN moved off its init, a random momentum
    trace): every parameter, statistic and momentum buffer."""
    cfg = load_config("cifar10", "", [
        "model.fused_blocks=true", "model.fused_epilogue=on",
        "optim.use_pallas_xent=on", f"model.resnet_size={SIZE}"])
    variables = _reference_variables(seed=4)
    rng = np.random.default_rng(7)
    trace = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.01).astype(np.float32),
        jax.device_get(variables["params"]))

    ref_model = ref_cifar(SIZE, 10, dtype=jnp.float32, fused_blocks=True,
                          fused_epilogue="on")
    schedule = ref_sched.build_schedule(cfg.optim, cfg.train)
    tx = ref_build_optimizer(cfg.optim, schedule)
    state = RefState.create(variables["params"], variables["batch_stats"], tx)
    state = state.replace(opt_state=(state.opt_state[0]._replace(
        trace=jax.tree_util.tree_map(jnp.asarray, trace)),
        *state.opt_state[1:]))
    ref_step = jax.jit(ref_make_train_step(ref_model, cfg.optim, schedule,
                                           10))
    port_state = create_state(_port_model(variables), cfg.optim)
    port_state.load_momentum_buffers(convert.flax_opt_state_to_torch(trace))
    port_step = make_train_step(cfg.optim, sched.build_schedule(
        cfg.optim, cfg.train), 10)

    for i in range(2):
        x, y = _batch(12 + i)
        state, want = ref_step(state, jnp.asarray(x), jnp.asarray(y))
        got = port_step(port_state, torch.from_numpy(x), torch.from_numpy(y))
        for key in ("loss", "precision", "learning_rate", "grad_norm"):
            _close(float(got[key]), float(want[key]), f"step {i} {key}")
    want = convert.flax_to_torch(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    got = port_state.model.state_dict()
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], name)
    want_m = convert.flax_opt_state_to_torch(jax.device_get(
        state.opt_state[0].trace))
    got_m = port_state.momentum_buffers()
    assert set(got_m) == set(want_m)
    for name in want_m:
        _close(got_m[name], want_m[name], f"momentum {name}")


def _loop_cfg(train_dir, fused, steps):
    return load_config("smoke", "", [
        f"model.fused_blocks={str(fused).lower()}", "model.resnet_size=14",
        "optim.use_pallas_xent=on", "model.fused_epilogue=on",
        "data.synthetic_learnable=true", "data.synthetic_train_examples=64",
        "train.global_batch_size=8", "train.log_every=1",
        "train.checkpoint_every=3", f"train.train_steps={steps}",
        f"train.train_dir={train_dir}"])


@pytest.mark.parametrize("first", [True, False], ids=["fused_first",
                                                      "unfused_first"])
def test_checkpoint_moves_between_fused_and_unfused(tmp_path, first):
    """A checkpoint written by one form restores into the other (same
    names) and training goes on from its step."""
    train(_loop_cfg(tmp_path, first, 3), device="cpu")
    saved = checkpoint.restore(str(tmp_path), 3)
    state = train(_loop_cfg(tmp_path, not first, 5), device="cpu")
    assert state.step == 5
    other = cifar_resnet_v2(SIZE, 10, fused_blocks=not first)
    assert set(saved["params"]) | set(saved["batch_stats"]) == set(
        other.state_dict())
    assert checkpoint.all_steps_in(str(tmp_path))[-1] == 5
