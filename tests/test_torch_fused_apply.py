"""Gradients through the folded-BN (eval-mode) fused blocks on the CPU: the
port's ``block_apply``/``bottleneck_apply`` (their wrappers take the plain
versions for CPU tensors) against ``jax.vjp`` of the reference's custom-VJP
``block_apply``/``bottleneck_apply`` with the Pallas kernels in interpret
mode, on the same numpy inputs; both plain backwards against float64
autograd of the plain forwards; the eval-mode fused CIFAR ResNet-14 and
ImageNet ResNet-50 at 64x64 differentiated in the input and every
parameter against ``jax.grad`` of the reference models; and the two A/B
tools at a tiny shape. The CUDA kernels are held against the same plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.models import resnet as jax_resnet
from tpu_resnet.ops import fused_block as jax_fb
from tpu_resnet.ops import fused_bottleneck as jax_fbn
from tpu_resnet_torch import convert
from tpu_resnet_torch.models import cifar_resnet_v2, imagenet_resnet_v2
from tpu_resnet_torch.ops import fused_block as fb
from tpu_resnet_torch.ops import fused_bottleneck as fbn
from tpu_resnet_torch.tools import fused_block_ab, fused_bottleneck_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_NAMES = ("dx", "dw1", "dw2", "ds1", "db1", "ds2", "db2")
BOTTLENECK_NAMES = ("dx", "dw1", "dw2", "dw3", "ds1", "db1", "ds2", "db2",
                    "ds3", "db3")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def _close(got, want, what, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _folded(rng, *widths):
    """A folded (scale in [0.5, 1.5), bias of both signs) pair per width."""
    return [a for n in widths
            for a in (rng.uniform(0.5, 1.5, n).astype(np.float32),
                      rng.uniform(-0.3, 0.3, n).astype(np.float32))]


def _block_inputs(c, seed, b=4, hw=8):
    """x, gy, w1, w2, s1, b1, s2, b2."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=(b, hw, hw, c)).astype(f32),
            rng.normal(size=(b, hw, hw, c)).astype(f32),
            (rng.normal(size=(3, 3, c, c)) / np.sqrt(9 * c)).astype(f32),
            (rng.normal(size=(3, 3, c, c)) / np.sqrt(9 * c)).astype(f32),
            *_folded(rng, c, c))


def _bottleneck_inputs(f, bhw, seed):
    """x, gy, w1, w2, w3, s1, b1, s2, b2, s3, b3."""
    rng = np.random.default_rng(seed)
    c4 = 4 * f
    f32 = np.float32
    return (rng.normal(size=(*bhw, c4)).astype(f32),
            rng.normal(size=(*bhw, c4)).astype(f32),
            (rng.normal(size=(c4, f)) / np.sqrt(c4)).astype(f32),
            (rng.normal(size=(3, 3, f, f)) / np.sqrt(9 * f)).astype(f32),
            (rng.normal(size=(f, c4)) / np.sqrt(f)).astype(f32),
            *_folded(rng, c4, f, f))


def _vjp_and_port(jax_apply, port_apply, port_bwd, x, gy, params):
    """(the reference's VJP, the port's plain backward called directly, the
    port's autograd gradients) for cotangent gy."""
    jargs = [jnp.asarray(a) for a in (x, *params)]
    y, vjp = jax.vjp(jax_apply, *jargs)
    want = vjp(jnp.asarray(gy))
    t = [torch.from_numpy(a) for a in (x, *params)]
    direct = port_bwd(t[0], torch.from_numpy(gy), *t[1:])
    leaves = [a.clone().requires_grad_() for a in t]
    got_y = port_apply(*leaves)
    _close(got_y, y, "y", atol=1e-5, rtol=1e-5)
    got_y.backward(torch.from_numpy(gy))
    return want, direct, [a.grad for a in leaves]


@pytest.mark.parametrize("c", [16, 32, 64])
def test_block_apply_grads_match_reference(c):
    """All seven gradients: ``block_bwd_reference`` and ``block_apply``'s
    autograd against ``jax.vjp`` of the reference's ``block_apply`` (batch
    tile 2, interpret mode)."""
    x, gy, *params = _block_inputs(c, seed=c)
    want, direct, grads = _vjp_and_port(
        lambda *a: jax_fb.block_apply(*a, 2, True, 2), fb.block_apply,
        fb.block_bwd_reference, x, gy, params)
    for name, d, g, w in zip(BLOCK_NAMES, direct, grads, want):
        assert d.dtype == g.dtype == torch.float32, name
        _close(d, w, f"block_bwd_reference {name}")
        _close(g, w, f"block_apply {name}")


@pytest.mark.parametrize("f, bhw", [(64, (2, 8, 8)), (128, (2, 4, 6)),
                                    (256, (2, 4, 4))],
                         ids=["f64", "f128", "f256"])
def test_bottleneck_apply_grads_match_reference(f, bhw):
    """All ten gradients: ``bottleneck_bwd_reference`` and
    ``bottleneck_apply``'s autograd against ``jax.vjp`` of the reference's
    ``bottleneck_apply`` (batch tile 2, row tile 4, interpret mode: two row
    bands and their halos at H=8)."""
    x, gy, *params = _bottleneck_inputs(f, bhw, seed=f + 1)
    want, direct, grads = _vjp_and_port(
        lambda *a: jax_fbn.bottleneck_apply(*a, 2, 4, True),
        fbn.bottleneck_apply, fbn.bottleneck_bwd_reference, x, gy, params)
    for i, (name, d, g, w) in enumerate(zip(BOTTLENECK_NAMES, direct, grads,
                                            want)):
        assert d.dtype == g.dtype == torch.float32, name
        # A parameter gradient sums B·H·W products of operands that carry
        # float32 rounding from the chain's 4f- and 9f-term products: where
        # its terms cancel, an entry is far below the tensor's scale and the
        # relative tolerance does not hold. Its atol is 1e-5 of the tensor's
        # largest entry.
        atol = 1e-5 if i == 0 else 1e-5 * float(np.abs(_np(w)).max())
        _close(d, w, f"bottleneck_bwd_reference {name}", atol=atol)
        _close(g, w, f"bottleneck_apply {name}", atol=atol)


@pytest.mark.parametrize("kind", ["block", "bottleneck"])
def test_plain_backwards_match_autograd_in_float64(kind):
    """Independent of the reference: each plain backward against
    ``torch.autograd`` through its plain forward, in float64."""
    if kind == "block":
        x, gy, *params = _block_inputs(16, seed=3, b=2, hw=5)
        fwd, bwd, names = (fb.block_fwd_reference, fb.block_bwd_reference,
                           BLOCK_NAMES)
    else:
        x, gy, *params = _bottleneck_inputs(16, (2, 5, 4), seed=4)
        fwd, bwd, names = (fbn.bottleneck_fwd_reference,
                           fbn.bottleneck_bwd_reference, BOTTLENECK_NAMES)
    args = [torch.from_numpy(a).double().requires_grad_()
            for a in (x, *params)]
    gy64 = torch.from_numpy(gy).double()
    want = torch.autograd.grad(fwd(*args), args, gy64)
    got = bwd(args[0].detach(), gy64, *(a.detach() for a in args[1:]))
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-10, err_msg=name)


def test_apply_keeps_x_dtype_and_counts_no_launch_on_cpu():
    """bfloat16 x: dx comes back in bfloat16, the parameter gradients in
    float32; a CPU tensor launches no kernel."""
    x, gy, *params = _block_inputs(16, seed=9, b=2, hw=4)
    before = fb.bwd_launches
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()] + [
        torch.from_numpy(p).requires_grad_() for p in params]
    fb.block_apply(*leaves).backward(torch.from_numpy(gy).to(torch.bfloat16))
    assert leaves[0].grad.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 for p in leaves[1:])
    assert fb.bwd_launches == before


def test_kbnrelu_identity_reproduces_the_folded_p1():
    """The kernel's dW1 recomputes p1 with the live-BN rounding
    relu(g·((v − μ)·i) + β); with (g, β, μ, i) = (s1, b1, 0, 1) that is
    relu(x·s1 + b1) bit for bit, since v − 0 and ·1 are exact."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4096,)).astype(np.float32) * 8)
    s = torch.from_numpy(rng.uniform(0.1, 3, 4096).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(4096,)).astype(np.float32))
    live = torch.clamp_min(s * ((x - torch.zeros_like(s))
                                * torch.ones_like(s)) + b, 0.0)
    assert torch.equal(live, torch.clamp_min(x * s + b, 0.0))


# ------------------------------------------------------------ model level
def _spread(variables, seed, spread):
    """The BN parameters and statistics off their init: scales and
    variances in 1 ± spread, biases and means of std 0.4·spread (the final
    dense bias too). Every leaf is a fresh copy."""
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

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _ref_grads(ref_model, variables, x, cotangent) -> dict:
    """The reference's gradients of Σ logits·cotangent in eval mode, by the
    port's parameter names, plus the input's under "input"."""
    def loss(params, xx):
        logits = ref_model.apply({"params": params,
                                  "batch_stats": variables["batch_stats"]},
                                 xx, train=False)
        return jnp.sum(logits * jnp.asarray(cotangent))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"],
                                                     jnp.asarray(x))
    want = convert.flax_to_torch(jax.device_get({"params": gp}))
    want["input"] = np.asarray(gx)
    return want


def _port_grads(port_model, x, cotangent) -> dict:
    """The same gradients of the port's model, by parameter name."""
    xt = torch.from_numpy(x).requires_grad_()
    logits = port_model.eval()(xt, train=False)
    (logits * torch.from_numpy(cotangent)).sum().backward()
    got = {n: p.grad for n, p in port_model.named_parameters()}
    got["input"] = xt.grad
    assert all(g is not None for g in got.values())
    return got


CIFAR_SIZE = 14   # one fused block per stage


def test_eval_mode_fused_cifar_model_grads_match_reference():
    """The eval-mode fused CIFAR ResNet-14 (3 fused blocks, 7 sbr sites)
    differentiated in the images and every parameter, against ``jax.grad``
    of the reference's fused model in eval mode (its blocks through
    ``block_apply``), elementwise."""
    ref = jax_resnet.cifar_resnet_v2(CIFAR_SIZE, 10, dtype=jnp.float32,
                                     fused_blocks=True, fused_epilogue="on")
    variables = _spread(jax.device_get(ref.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)),
        seed=1, spread=0.5)
    port = cifar_resnet_v2(CIFAR_SIZE, 10, dtype=torch.float32,
                           fused_blocks=True, fused_epilogue="on")
    port.load_state_dict(convert.flax_to_torch(variables), strict=True)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    cot = rng.normal(size=(4, 10)).astype(np.float32)
    want = _ref_grads(ref, variables, x, cot)
    got = _port_grads(port, x, cot)
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], name)


IMAGENET_SIZE = 64   # the fused stages at 16², 8² and 4²
CONTROL_FACTOR = 4.0  # as chip_smoke.py's and the train tests' gate


@functools.lru_cache(maxsize=None)
def _rn50_init():
    model = jax_resnet.imagenet_resnet_v2(50, 1000, dtype=jnp.float32)
    return jax.device_get(jax.jit(lambda key: model.init(
        key, jnp.zeros((1, IMAGENET_SIZE, IMAGENET_SIZE, 3)), train=False))(
            jax.random.PRNGKey(0)))


def _worst_rel(got: dict, want: dict) -> float:
    return max(float(np.linalg.norm(_np(got[n]) - _np(want[n]))
                     / max(np.linalg.norm(_np(want[n])), 1e-12))
               for n in want)


def test_eval_mode_fused_rn50_grads_match_reference():
    """ImageNet ResNet-50 at 64x64, B=2, eval mode: the gradient in the
    images and every parameter through the 10 fused bottlenecks against
    ``jax.grad`` of the reference's fused model (its bottlenecks through
    ``bottleneck_apply``). Backward masks recomputed from conv outputs flip
    where a pre-activation lies within rounding of 0, so, as the train-step
    test, the port's unfused model (no fused code) is the control: the
    fused port's worst tensor, normwise, lies within CONTROL_FACTOR times
    the control's distance from the reference, and within 1e-3 in any
    case."""
    ref = jax_resnet.imagenet_resnet_v2(50, 1000, dtype=jnp.float32,
                                        fused_blocks=True,
                                        fused_epilogue="on")
    variables = _spread(_rn50_init(), seed=3, spread=0.1)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, IMAGENET_SIZE, IMAGENET_SIZE, 3)).astype(
        np.float32)
    cot = rng.normal(size=(2, 1000)).astype(np.float32)
    want = _ref_grads(ref, variables, x, cot)
    worst = {}
    for fused in (True, False):
        port = imagenet_resnet_v2(50, 1000, dtype=torch.float32,
                                  fused_blocks=fused, fused_epilogue="on")
        port.load_state_dict(convert.flax_to_torch(variables), strict=True)
        got = _port_grads(port, x, cot)
        assert set(got) == set(want)
        worst[fused] = _worst_rel(got, want)
    assert worst[True] <= max(CONTROL_FACTOR * worst[False], 1e-3), worst


# ------------------------------------------------------------ the A/B tools
@pytest.mark.parametrize("tool, argv, key", [
    (fused_block_ab, ["--dtype", "float32"], "b4_8x8x16"),
    (fused_bottleneck_ab, ["--shapes", "2,6,64", "--dtype", "float32"],
     "b2_6x6x256_f64")], ids=["block", "bottleneck"])
def test_ab_tools_run_all_four_arms_on_cpu(tool, argv, key, tmp_path,
                                           monkeypatch):
    """Each twin at a tiny shape on the CPU, as the reference's tool tests
    run theirs: the four arms report positive times in the reference's
    JSON layout."""
    if tool is fused_block_ab:
        monkeypatch.setattr(tool, "SHAPES", [(4, 8, 8, 16)])
    out = tmp_path / "ab.json"
    assert tool.main(["--device", "cpu", "--length", "2", "--reps", "1",
                      "--out", str(out), *argv]) == 0
    got = json.loads(out.read_text())
    assert got["device"] == "cpu" and got["length"] == 2
    entry = got["by_shape"][key]
    assert "error" not in entry, entry
    for arm in ("fwd", "fwd_bwd", "train_fwd_live_bn",
                "train_fwd_bwd_live_bn"):
        assert entry[arm]["pallas_us_per_block"] > 0, arm
        assert entry[arm]["xla_us_per_block"] > 0, arm
        assert entry[arm]["speedup"] > 0, arm
        # CPU times are the host's own: no device spin to outrun.
        assert entry[arm]["pallas_host_paced"] is False, arm
        assert entry[arm]["xla_host_paced"] is False, arm


def test_ab_tool_exits_1_when_a_shape_fails(tmp_path, monkeypatch):
    """A shape the kernels refuse (C=8) is recorded with its error, the
    other shapes still run, and the tool exits 1."""
    monkeypatch.setattr(fused_block_ab, "SHAPES", [(2, 4, 4, 8),
                                                   (2, 4, 4, 16)])
    out = tmp_path / "ab.json"
    assert fused_block_ab.main(["--device", "cpu", "--length", "1",
                                "--reps", "1", "--out", str(out)]) == 1
    got = json.loads(out.read_text())["by_shape"]
    assert "C in (16, 32, 64, 128, 256)" in got["b2_4x4x8"]["error"]
    assert "error" not in got["b2_4x4x16"]


# ------------------------------------------------------------ chip_smoke.py
def test_chip_smoke_puts_its_own_directory_on_the_path(tmp_path):
    """Run from another directory in isolated mode (no script directory, no
    working directory on sys.path), loading chip_smoke.py makes the port
    importable; ``main`` is not run."""
    code = ("import runpy, sys; runpy.run_path(sys.argv[1], run_name='x'); "
            "import tpu_resnet_torch; print(tpu_resnet_torch.__file__)")
    out = subprocess.run(
        [sys.executable, "-I", "-c", code,
         os.path.join(REPO, "chip_smoke.py")], cwd=tmp_path,
        capture_output=True, text=True, timeout=120, check=True).stdout
    assert out.strip().startswith(os.path.join(REPO, "tpu_resnet_torch"))
