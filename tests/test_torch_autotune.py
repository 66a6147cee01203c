"""The port's autotune harness (``tpu_resnet_torch/ops/autotune.py``), the
residual-add epilogue (``ep.scale_bias_relu_add``) and the ``auto``
policies of the train path, against the reference (``tpu_resnet/ops/
autotune.py``, ``tpu_resnet/ops/epilogue.py`` with its Pallas kernels in
interpret mode). On the CPU the wrappers take their plain versions and
``auto`` probes nothing; the probes themselves run here on CPU tensors."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.ops import autotune as ref_autotune
from tpu_resnet.ops import epilogue as ref_ep
from tpu_resnet.programs import spell_shape
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.models import build_model
from tpu_resnet_torch.ops import autotune
from tpu_resnet_torch.ops import epilogue as ep
from tpu_resnet_torch.ops import softmax_xent as sx
from tpu_resnet_torch.train import loop
from tpu_resnet_torch.train.step import make_train_step


@pytest.fixture(autouse=True)
def _fresh_tables():
    autotune.reset()
    ref_autotune.reset()
    yield
    autotune.reset()
    ref_autotune.reset()


@pytest.mark.parametrize("dims", [(128, 10), (128, 32, 32, 16), (1,),
                                  (np.int64(8), 7.0)])
def test_shape_key_spelling_matches_reference(dims):
    assert autotune.shape_key(*dims) == spell_shape(*dims)


def _timer(times):
    """A stand-in for ``_timed_us``: the plain arm first, then the
    kernel arm, as ``probe`` times them in both packages."""
    seq = iter(times)
    return lambda fn, args, iters: next(seq)


def test_timed_us_on_cpu_is_host_time_and_not_flagged():
    """On CPU tensors ``timed_us`` times the host and flags nothing;
    ``_timed_us`` (the probe's timer) is its time alone."""
    x = torch.ones(64)
    us, host_paced = autotune.timed_us(torch.exp, (x,), 3)
    assert us > 0 and host_paced is False
    assert autotune._timed_us(torch.exp, (x,), 3) > 0


@pytest.mark.parametrize("plain_us, kernel_us, threshold", [
    (10.0, 5.0, 1.0), (5.0, 10.0, 1.0), (7.0, 7.0, 1.0),
    (10.3, 10.0, 1.05), (10.6, 10.0, 1.05)],
    ids=["kernel_wins", "plain_wins", "tie", "under_threshold",
         "over_threshold"])
def test_decisions_match_reference(monkeypatch, plain_us, kernel_us,
                                   threshold):
    """Given the same two times, the port decides as the reference does
    (``speedup >= threshold``; an exact tie keeps the kernel in both)."""
    monkeypatch.setattr(autotune, "_timed_us", _timer([plain_us, kernel_us]))
    monkeypatch.setattr(ref_autotune, "_timed_us",
                        _timer([plain_us, kernel_us]))
    got = autotune.probe("op", "8x8", None, None, (), threshold=threshold)
    want = ref_autotune.probe("op", "8x8", None, None, (),
                              threshold=threshold)
    assert got.to_dict() == want.to_dict()
    assert got.use_pallas == (got.speedup >= threshold)
    assert autotune.use_kernel("op", "8x8") == got.use_pallas


def test_unprobed_shapes_take_the_default_and_probes_are_cached(
        monkeypatch):
    assert autotune.use_kernel("op", "1x2") is False
    assert autotune.use_kernel("op", "1x2", default=True) is True
    monkeypatch.setattr(autotune, "_timed_us", _timer([4.0, 2.0, 1.0, 9.0]))
    first = autotune.probe("op", "1x2", None, None, ())
    assert autotune.probe("op", "1x2", None, None, ()) is first
    again = autotune.probe("op", "1x2", None, None, (), force=True)
    assert first.use_pallas and not again.use_pallas


def test_a_raising_kernel_candidate_propagates():
    def broken(*args):
        raise RuntimeError("CUDA error 209 at launch")

    x = torch.ones(4)
    with pytest.raises(RuntimeError, match="209"):
        autotune.probe("op", "4", broken, lambda t: t * 2, (x,), iters=2)
    assert autotune.decision("op", "4") is None


def test_timing_runs_each_arm_warm_plus_iters_times():
    calls = {"kernel": 0, "plain": 0}

    def arm(name):
        def fn(t):
            calls[name] += 1
            return t + 1
        return fn

    d = autotune.probe("op", "3", arm("kernel"), arm("plain"),
                       (torch.ones(3),), iters=5)
    assert calls == {"kernel": 6, "plain": 6}
    assert d.pallas_us > 0 and d.xla_us > 0 and d.error is None


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_autotune_json_round_trips_between_packages(tmp_path, monkeypatch,
                                                    writer):
    for mod in (autotune, ref_autotune):
        monkeypatch.setattr(mod, "_timed_us", _timer([3.0, 2.0]))
    src, dst = ((autotune, ref_autotune) if writer == "port"
                else (ref_autotune, autotune))
    src.probe(ep.OP_SBR, "128x32x32x16", None, None, ())
    path = src.dump(str(tmp_path))
    with open(path) as f:
        payload = json.load(f)
    assert payload["format"] == 1
    assert dst.load(path) == 1
    assert dst.decisions() == src.decisions()
    assert (autotune.use_kernel(ep.OP_SBR, "128x32x32x16")
            and ref_autotune.use_pallas(ep.OP_SBR, "128x32x32x16"))
    assert autotune.load(str(tmp_path / "missing.json")) == 0


def _configs():
    return [("cifar10", []), ("cifar100", []),
            ("imagenet", ["model.resnet_size=18"]),
            ("imagenet", ["model.resnet_size=50"]),
            ("cifar10", ["model.width_multiplier=2",
                         "model.resnet_size=28"])]


@pytest.mark.parametrize("preset, overrides", _configs())
@pytest.mark.parametrize("batch", [128, 7])
def test_model_epilogue_shapes_match_reference(preset, overrides, batch):
    got = ep.model_epilogue_shapes(load_config(preset, "", overrides), batch)
    want = ref_ep.model_epilogue_shapes(
        ref_load_config(preset, "", overrides), batch)
    assert got == [tuple(s) for s in want]


def test_model_epilogue_shapes_are_the_models_sites():
    """Every BN+ReLU site of the CIFAR ResNet under ``auto`` runs at one of
    the probed shapes (a site at another shape would stay unprobed)."""
    cfg = load_config("cifar10", "", ["model.resnet_size=8",
                                      "model.fused_epilogue=auto"])
    seen = set()
    model = build_model(cfg)
    for m in model.modules():
        if hasattr(m, "folded"):
            m.register_forward_pre_hook(
                lambda mod, args: seen.add(tuple(args[0].shape)))
    model(torch.zeros(4, 32, 32, 3), train=True)
    assert seen == set(ep.model_epilogue_shapes(cfg, 4))


def _add_args(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    s = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    jx = [jnp.asarray(x, dtype), jnp.asarray(s), jnp.asarray(b),
          jnp.asarray(r, dtype)]
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx = [torch.tensor(x).to(tdt), torch.tensor(s), torch.tensor(b),
          torch.tensor(r).to(tdt)]
    return jx, [t.requires_grad_(True) for t in tx]


# (forward, gradients) atol = rtol. float32: XLA may contract x*s+b into an
# FMA and sums ds, db in another order; bfloat16: one stored ulp (2^-8) of
# y, dx and dr, and ds, db summed from bfloat16 products.
ADD_TOL = {jnp.float32: (1e-6, 1e-5), jnp.bfloat16: (1e-2, 1e-2)}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(6, 5, 5, 8), (3, 4, 4, 16),
                                   (2, 3, 3, 136)])
def test_scale_bias_relu_add_matches_reference_kernel(shape, dtype):
    """Value and all four gradients of sum(y²) against the reference's
    Pallas ``_sbr_add_kernel`` in interpret mode."""
    jargs, targs = _add_args(shape, dtype)
    want = ref_ep.scale_bias_relu_add(*jargs, None, True)
    want_g = jax.grad(lambda *a: jnp.sum(jnp.square(
        ref_ep.scale_bias_relu_add(*a, None, True).astype(jnp.float32))),
        argnums=(0, 1, 2, 3))(*jargs)
    before = ep.add_launches
    got = ep.scale_bias_relu_add(*targs)
    torch.square(got.float()).sum().backward()
    assert ep.add_launches == before   # CPU: the plain version
    assert got.dtype == targs[0].dtype
    fwd_tol, grad_tol = ADD_TOL[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=fwd_tol, rtol=fwd_tol)
    for t, w in zip(targs, want_g):
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=grad_tol, rtol=grad_tol)
    # dr is the cotangent itself: 2y, in y's dtype.
    assert torch.equal(targs[3].grad, (2 * got.float()).to(got.dtype))


def test_add_reference_equals_the_cpu_path_bit_for_bit():
    _, targs = _add_args((4, 3, 3, 16), jnp.float32, seed=3)
    a = ep.scale_bias_relu_add(*targs)
    b = ep.scale_bias_relu_add_reference(*targs)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="residual must match"):
        ep.scale_bias_relu_add(targs[0], targs[1], targs[2],
                               targs[3].detach().double())


def test_auto_dispatch_follows_the_decisions(monkeypatch):
    _, (x, s, b, r) = _add_args((2, 4, 4, 8), jnp.float32)
    called = []
    for name in ("scale_bias_relu", "scale_bias_relu_reference",
                 "scale_bias_relu_add", "scale_bias_relu_add_reference"):
        fn = getattr(ep, name)
        monkeypatch.setattr(ep, name, lambda *a, _n=name, _f=fn:
                            called.append(_n) or _f(*a))
    ep.scale_bias_relu_auto(x, s, b)
    ep.scale_bias_relu_add_auto(x, s, b, r)
    key = ep.sbr_key(x.shape)
    for op in (ep.OP_SBR, ep.OP_SBR_ADD):
        autotune._record(autotune.Decision(op, key, 1.0, 2.0, 2.0, True))
    ep.scale_bias_relu_auto(x, s, b)
    ep.scale_bias_relu_add_auto(x, s, b, r)
    assert called == ["scale_bias_relu_reference",
                      "scale_bias_relu_add_reference", "scale_bias_relu",
                      "scale_bias_relu_add"]


def test_probes_run_on_cpu_tensors():
    decisions = ep.probe_epilogue((2, 4, 4, 8), iters=2, device="cpu")
    assert [d.op for d in decisions] == [ep.OP_SBR, ep.OP_SBR_ADD]
    assert all(d.key == "2x4x4x8" and np.isfinite(d.speedup)
               for d in decisions)
    cfg = load_config("cifar10", "", ["model.resnet_size=8"])
    model_decisions = ep.probe_model_epilogues(cfg, 2, iters=1,
                                               device="cpu")
    assert [d.key for d in model_decisions] == [
        ep.sbr_key(s) for s in ep.model_epilogue_shapes(cfg, 2)]
    xent = sx.ensure_xent_probe(8, 10, iters=2, device="cpu")
    assert xent.op == sx.OP_XENT and xent.key == "8x10"
    assert sx.ensure_xent_probe(8, 10, device="cpu") is xent


def test_xent_reference_is_the_mean_loss():
    rng = np.random.default_rng(1)
    logits = torch.tensor(rng.standard_normal((6, 10)), dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, 10, 6))
    torch.testing.assert_close(sx.softmax_xent_reference(logits, labels),
                               sx.softmax_xent_mean(logits, labels),
                               atol=1e-6, rtol=1e-6)


def test_xent_auto_takes_the_plain_chain_off_cuda():
    cfg = load_config("cifar10")
    assert cfg.optim.use_pallas_xent == "auto"
    make_train_step(cfg.optim, lambda step: 0.1, 10, device="cpu",
                    xent_probe_batch=128)
    assert autotune.decisions() == {}


def _cpu_run(tmp_path, name, *overrides):
    """Three float32 steps of CIFAR-10 ResNet-8 on synthetic data from the
    ``cifar10`` preset's defaults plus ``overrides``."""
    cfg = load_config("cifar10", "", [
        "data.dataset=synthetic", "data.synthetic_train_examples=64",
        "model.resnet_size=8", "model.compute_dtype=float32",
        "train.global_batch_size=16", "train.train_steps=3",
        "train.log_every=1", f"train.train_dir={tmp_path / name}",
        *overrides])
    state = loop.train(cfg, device="cpu")
    with open(tmp_path / name / "metrics.jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f]
    return losses, state.model.state_dict()


def test_cifar10_preset_defaults_train_on_cpu(tmp_path):
    """``train --preset cifar10`` with no override (``use_pallas_xent=auto``,
    ``device_resident=auto``) equals the ``off``/``off`` run bit for bit;
    ``fused_epilogue=auto`` equals ``on`` bit for bit (both fold, and
    nothing is probed on the CPU) and ``off`` within 1e-5 (folded against
    unfolded BN arithmetic in float32)."""
    default, s_default = _cpu_run(tmp_path, "default")
    off, s_off = _cpu_run(tmp_path, "off", "optim.use_pallas_xent=off",
                          "model.fused_epilogue=off")
    auto, s_auto = _cpu_run(tmp_path, "auto", "model.fused_epilogue=auto")
    on, s_on = _cpu_run(tmp_path, "on", "model.fused_epilogue=on")
    assert default == off and len(off) == 3
    for k in s_off:
        assert torch.equal(s_default[k], s_off[k]), k
        assert torch.equal(s_auto[k], s_on[k]), k
    assert auto == on
    np.testing.assert_allclose(auto, off, rtol=1e-5)
    assert autotune.decisions() == {}
    assert not (tmp_path / "auto" / autotune.AUTOTUNE_FILE).exists()
