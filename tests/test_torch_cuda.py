"""The port's CUDA kernels against their plain versions on the card. These
need a CUDA card and skip without one; on a GPU machine run

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import itertools

import pytest
import torch

from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.device import resolve_device
from tpu_resnet_torch.models import build_model, init_weights
from tpu_resnet_torch.ops import autotune
from tpu_resnet_torch.ops import epilogue as ep
from tpu_resnet_torch.ops import fused_block as fb
from tpu_resnet_torch.ops import fused_bottleneck as fbn
from tpu_resnet_torch.ops import softmax_xent as sx
from tpu_resnet_torch.ops import wgrad as wg
from tpu_resnet_torch.train import schedule as sched_lib
from tpu_resnet_torch.train.loop import build_state, build_step, make_loop_step
from tpu_resnet_torch.train.step import make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")   # TF32 off for the float32 oracle


def _inputs(shape, dtype, gen):
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = [torch.randn(3, 3, c, c, generator=gen, device="cuda")
         * (9 * c) ** -0.5 for _ in range(2)]
    sb = [torch.rand(c, generator=gen, device="cuda") + 0.5,
          torch.randn(c, generator=gen, device="cuda") * 0.5,
          torch.rand(c, generator=gen, device="cuda") + 0.5,
          torch.randn(c, generator=gen, device="cuda") * 0.5]
    return x, w, sb


# The three CIFAR stages and the ImageNet ResNet-18/34 stages at C = 128
# and 256 at B = 1 and 16 (the serve buckets: the small tile plan) and 128
# (the train step: the tile plan), odd batches, and ragged planes whose
# tiles span images.
_FWD_SHAPES = ([(b, hw, hw, c) for b in (1, 16, 128)
                for hw, c in ((32, 16), (16, 32), (8, 64), (28, 128),
                              (14, 256))]
               + [(3, 32, 32, 16), (5, 16, 16, 32), (2, 8, 8, 64),
                  (1, 7, 5, 16), (16, 7, 5, 16), (3, 7, 5, 128),
                  (2, 5, 3, 256)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _FWD_SHAPES)
def test_block_fwd_kernel_matches_plain(cuda, shape, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, (w1, w2), (s1, b1, s2, b2) = _inputs(shape, dtype, gen)
    before = fb.launches
    got = fb.block_fwd(x, w1, w2, s1, b1, s2, b2)
    want = fb.block_fwd_reference(x, w1, w2, s1, b1, s2, b2)
    torch.cuda.synchronize()
    assert fb.launches == before + 1
    # f32: another summation order than cuDNN; bf16: one stored ulp.
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# The three CIFAR train shapes (the tile plan), a B=16 serve shape (the
# small plan), an odd batch and a ragged plane whose tiles span images.
_C1_SHAPES = [(128, 32, 32, 16), (128, 16, 16, 32), (128, 8, 8, 64),
              (16, 16, 16, 32), (3, 16, 16, 32), (5, 7, 5, 16),
              (128, 28, 28, 128), (128, 14, 14, 256), (16, 14, 14, 256),
              (3, 7, 5, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _C1_SHAPES)
def test_block_fwd_from_c1_equals_block_fwd_from_x(cuda, shape, dtype):
    """The training forward: block_fwd from block_stats' c1 (one launch)
    gives bit for bit what block_fwd from x (two launches) gives, since
    both take one plan and the stats' c1 is the first launch's."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    x, (w1, w2), (s1, b1, s2, b2) = _inputs(shape, dtype, gen)
    before = (fb.launches, fb.stats_launches)
    c1 = fb.block_stats(x, w1, s1, b1)[2]
    got = fb.block_fwd(x, w1, w2, s1, b1, s2, b2, c1=c1)
    want = fb.block_fwd(x, w1, w2, s1, b1, s2, b2)
    torch.cuda.synchronize()
    assert (fb.launches, fb.stats_launches) == (before[0] + 2, before[1] + 1)
    assert got.dtype == dtype and torch.equal(got, want)


def _profiled_launches(fn, sessions: int = 2) -> dict:
    """{kernel name: launches a call of ``fn``}, the most seen per name
    over ``sessions`` profiler sessions of two calls: on an H100 the
    profiler has been seen to drop a launch now and then (0.5 a call for a
    kernel launched once a call, one session in some 250), never to add
    one."""
    from tpu_resnet_torch.tools.profiling import device_profile
    seen = {}
    for _ in range(sessions):
        for k in device_profile(fn, iters=2)["kernels"]:
            seen[k["name"]] = max(seen.get(k["name"], 0.0),
                                  k["launches_per_call"])
    return seen


# Every BN+ReLU site shape of the four paths: the ImageNet ResNet-50 step
# (B=128, 224²) and its B=16 serve forward, the CIFAR ResNet-50 steps
# (B=128, unfused and fused) and the B=16 serve forward; then ragged ones:
# C = 8 and 24, pixel counts off every chunk, a single pixel.
_SBR_SITES = [(b, *hwc) for b in (16, 128) for hwc in (
    (56, 56, 64), (56, 56, 256), (56, 56, 128), (28, 28, 128), (28, 28, 512),
    (28, 28, 256), (14, 14, 256), (14, 14, 1024), (14, 14, 512), (7, 7, 512),
    (7, 7, 2048), (32, 32, 16), (16, 16, 32), (8, 8, 64))]
_SBR_RAGGED = [(3, 5, 7, 24), (1, 1, 1, 8), (5, 7, 9, 8), (2, 33, 1, 24),
               (129, 3, 1, 64), (1, 1, 1, 2048)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _SBR_SITES + _SBR_RAGGED)
def test_sbr_kernel_matches_plain(cuda, shape, dtype):
    """Bit for bit the plain version (the same roundings, no FMA), one
    launch a call and no other kernel."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    s = torch.rand(c, generator=gen, device="cuda") + 0.5
    b = torch.randn(c, generator=gen, device="cuda") * 0.5
    before = ep.launches
    got = ep.scale_bias_relu(x, s, b)
    want = ep.scale_bias_relu_reference(x, s, b)
    torch.cuda.synchronize()
    assert ep.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, want)
    kernels = _profiled_launches(lambda: ep.scale_bias_relu(x, s, b))
    assert [k for k in kernels if "sbr_kernel" not in k] == [], kernels
    assert sum(kernels.values()) == 1, kernels


def _bottleneck_inputs(shape, dtype, gen):
    c4 = shape[-1]
    f = c4 // 4
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w1 = torch.randn(c4, f, generator=gen, device="cuda") * c4 ** -0.5
    w2 = torch.randn(3, 3, f, f, generator=gen, device="cuda") * (9 * f) ** -0.5
    w3 = torch.randn(f, c4, generator=gen, device="cuda") * f ** -0.5
    sb = []
    for n in (c4, f, f):
        sb += [torch.rand(n, generator=gen, device="cuda") + 0.5,
               torch.randn(n, generator=gen, device="cuda") * 0.5]
    return (x, w1, w2, w3, *sb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 56, 56, 256), (2, 28, 28, 512),
                                   (2, 14, 14, 1024), (1, 9, 5, 256),
                                   (3, 7, 7, 512), (3, 9, 5, 1024),
                                   (16, 28, 28, 512), (16, 14, 14, 1024)])
def test_bottleneck_fwd_kernel_matches_plain(cuda, shape, dtype):
    """The three ResNet-50 stage shapes at B=2, pixel counts that are not a
    multiple of the 64-pixel tile (45, 147, 135), and B=16 at stages 2 and
    3 (16·14² = 49 tiles of 64 for 132 SMs: the 32-pixel tiles); two calls
    bit for bit equal."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    args = _bottleneck_inputs(shape, dtype, gen)
    before = fbn.launches
    got, again = fbn.bottleneck_fwd(*args), fbn.bottleneck_fwd(*args)
    want = fbn.bottleneck_fwd_reference(*args)
    torch.cuda.synchronize()
    assert fbn.launches == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    # f32: another summation order than cuBLAS/cuDNN; bf16: one stored ulp.
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 32, 32, 16), (128, 16, 16, 32),
                                   (128, 8, 8, 64), (128, 56, 56, 256),
                                   (128, 7, 7, 2048), (3, 5, 7, 24),
                                   (1, 1, 1, 8)])
def test_sbr_bwd_kernel_matches_plain(cuda, shape, dtype):
    """The three CIFAR train shapes, two ImageNet ones (the widest plane
    and the widest C: 64 channel slices), a ragged one (C/N not a power of
    two) and a single pixel; one launch a call, two calls bit for bit
    equal."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    x, _, (s, b, _, _) = _inputs(shape, dtype, gen)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    x.view(-1)[:64] = 0   # with b = 0 there: pre-activation exactly 0
    b[:] = torch.where(torch.arange(b.numel(), device="cuda") % 2 == 0, 0.0,
                       b)
    before = ep.bwd_launches
    dx, ds, db = ep.scale_bias_relu_bwd(x, s, b, g)
    want = ep.scale_bias_relu_bwd_reference(x, s, b, g)
    torch.cuda.synchronize()
    assert ep.bwd_launches == before + 1
    assert dx.dtype == dtype and ds.dtype == db.dtype == torch.float32
    # dx: one rounding of the same product; ds/db: f32 sums in another order.
    assert torch.equal(dx, want[0])
    gm = torch.where(x.float() * s + b > 0, g.float(), 0.0)
    for got, ref, terms in ((ds, want[1], gm * x.float()), (db, want[2], gm)):
        scale = terms.abs().sum(dim=(0, 1, 2))
        assert bool(((got - ref).abs() <= 1e-5 * scale + 1e-6).all())
    del want, gm
    again = ep.scale_bias_relu_bwd(x, s, b, g)
    assert all(torch.equal(p, q) for p, q in zip((dx, ds, db), again))
    # One kernel launch a call, and no other kernel.
    from tpu_resnet_torch.tools.profiling import device_profile
    kernels = device_profile(lambda: ep.scale_bias_relu_bwd(x, s, b, g),
                             iters=2)["kernels"]
    assert [k["name"] for k in kernels if "sbr_bwd" not in k["name"]] == []
    assert sum(k["launches_per_call"] for k in kernels) == 1


@pytest.mark.parametrize("labels_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("shape", [(128, 10), (128, 100), (128, 1000),
                                   (5, 33), (1, 1), (3, 1030), (2, 2052)])
def test_xent_kernels_match_plain(cuda, shape, labels_dtype):
    """int32 and int64 labels, one out of range; the backward with a
    seeded cotangent and with the mean's, one value at stride 0; rows of
    more than 1024 classes go chunk by chunk (scalar and 16-byte loads)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, c = shape
    logits = torch.randn(shape, generator=gen, device="cuda") * 3
    labels = torch.randint(0, c, (b,), generator=gen, device="cuda",
                           dtype=labels_dtype)
    labels[0] = c + 2   # gathers 0
    g = torch.rand(b, generator=gen, device="cuda")
    g_mean = torch.full((), 1.0 / b, device="cuda").expand(b)
    before = (sx.fwd_launches, sx.bwd_launches)
    loss = sx.softmax_xent_per_example(logits, labels)
    dx = sx.softmax_xent_bwd(logits, labels, g)
    dx_mean = sx.softmax_xent_bwd(logits, labels, g_mean)
    torch.cuda.synchronize()
    assert (sx.fwd_launches, sx.bwd_launches) == (before[0] + 1,
                                                  before[1] + 2)
    torch.testing.assert_close(
        loss, sx.softmax_xent_per_example_reference(logits, labels),
        atol=1e-5, rtol=1e-5)
    for got, cot in ((dx, g), (dx_mean, g_mean)):
        torch.testing.assert_close(
            got, sx.softmax_xent_bwd_reference(logits, labels, cot),
            atol=1e-5, rtol=1e-5)


class _NoKernel(torch.autograd.Function):
    """A per-example loss that launches nothing: the mean's own kernels
    alone."""

    @staticmethod
    def forward(ctx, logits):
        ctx.shape = logits.shape
        return logits.new_empty(logits.shape[0])

    @staticmethod
    def backward(ctx, g):
        return g.new_empty(ctx.shape)


def test_xent_autograd_runs_both_kernels(cuda):
    """The mean loss and its gradient launch the pair once each, and
    beside them only what the mean launches with a loss that launches
    nothing: no label copy, no copy of the broadcast cotangent."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    logits = torch.randn(16, 10, generator=gen, device="cuda",
                         requires_grad=True)
    labels = torch.randint(0, 10, (16,), generator=gen, device="cuda",
                           dtype=torch.int32)
    before = (sx.fwd_launches, sx.bwd_launches)
    sx.softmax_xent_mean(logits, labels).backward()
    want = sx.softmax_xent_bwd_reference(
        logits.detach(), labels, torch.full((16,), 1 / 16, device="cuda"))
    assert (sx.fwd_launches, sx.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    torch.testing.assert_close(logits.grad, want, atol=1e-6, rtol=1e-5)

    def launches(loss_fn):
        return _profiled_launches(lambda: torch.autograd.grad(
            loss_fn().mean(), logits))

    for lab in (labels, labels.long()):
        got = launches(lambda: sx.softmax_xent_per_example(logits, lab))
        mean_only = launches(lambda: _NoKernel.apply(logits))
        pair = {k: n for k, n in got.items() if "xent_" in k}
        assert sorted(pair.values()) == [1, 1], got
        assert sum(got.values()) == 2 + sum(mean_only.values()), (
            got, mean_only)


def test_train_step_kernels_match_plain(cuda, monkeypatch):
    """One float32 step of a CIFAR ResNet-14 (13 BN sites) through the
    kernels and one through the plain versions, from one seeded state."""
    cfg = load_config("smoke", "", [
        "model.resnet_size=14", "model.fused_epilogue=on",
        "optim.use_pallas_xent=on", "train.global_batch_size=32"])
    step = make_train_step(cfg.optim, sched_lib.build_schedule(
        cfg.optim, cfg.train), 10)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(32, 32, 32, 3, generator=gen, device="cuda")
    y = torch.randint(0, 10, (32,), generator=gen, device="cuda",
                      dtype=torch.int32)
    kernel_state, plain_state = build_state(cfg, cuda), build_state(cfg, cuda)
    before = (ep.launches, ep.bwd_launches, sx.fwd_launches, sx.bwd_launches)
    got = step(kernel_state, x, y)
    torch.cuda.synchronize()
    assert (ep.launches, ep.bwd_launches, sx.fwd_launches,
            sx.bwd_launches) == (before[0] + 13, before[1] + 13,
                                 before[2] + 1, before[3] + 1)
    monkeypatch.setattr(ep, "scale_bias_relu", ep.scale_bias_relu_reference)
    monkeypatch.setattr(sx, "softmax_xent_per_example",
                        sx.softmax_xent_per_example_reference)
    want = step(plain_state, x, y)
    for key in ("loss", "precision", "grad_norm"):
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=1e-5)
    for (name, a), b in zip(kernel_state.model.state_dict().items(),
                            plain_state.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4, msg=name)
    for name, buf in kernel_state.momentum_buffers().items():
        torch.testing.assert_close(buf, plain_state.momentum_buffers()[name],
                                   atol=1e-5, rtol=1e-4, msg=name)


def test_kernels_reject_strided_input(cuda):
    gen = torch.Generator(device="cuda").manual_seed(2)
    x, (w1, w2), (s1, b1, s2, b2) = _inputs((2, 8, 8, 16), torch.float32,
                                            gen)
    strided = x.permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ep.scale_bias_relu(strided, s1, b1)
    with pytest.raises(ValueError, match="contiguous"):
        ep.scale_bias_relu_bwd(x, s1, b1, strided)
    with pytest.raises(ValueError, match="contiguous"):
        sx.softmax_xent_per_example(
            torch.randn(10, 8, device="cuda").t(),
            torch.zeros(8, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        fb.block_fwd(strided, w1, w2, s1, b1, s2, b2)
    args = list(_bottleneck_inputs((2, 8, 8, 256), torch.float32, gen))
    args[0] = args[0].permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fbn.bottleneck_fwd(*args)


# ------------------------------------------- the fused block's training
_VEC_NAMES = ("g1", "b1", "g2", "b2", "m1", "i1", "m2", "i2")


def _block_train_inputs(shape, dtype, gen):
    """x, gy, w1, w2 and the eight BN vectors on a coarse dyadic grid, as
    chip_smoke.py draws them: conv1's output and convT(gy, w2) are exact in
    float32 in any summation order, so kernel and plain version share their
    masks [z > 0]."""
    c = shape[-1]

    def grid(size, lo, hi, step):
        return torch.randint(lo, hi + 1, size, generator=gen,
                             device="cuda").float() * step

    vec = {"g1": grid((c,), 4, 12, 1 / 8), "b1": grid((c,), -4, 4, 1 / 8),
           "g2": grid((c,), 4, 12, 1 / 8), "b2": grid((c,), -4, 4, 1 / 8),
           "m1": grid((c,), -4, 4, 1 / 8), "i1": 2.0 ** grid((c,), -1, 1, 1),
           "m2": grid((c,), -8, 8, 1 / 8), "i2": 2.0 ** grid((c,), -2, 0, 1)}
    return (grid(shape, -8, 8, 0.25).to(dtype), grid(shape, -16, 16, 0.125),
            grid((3, 3, c, c), -4, 4, 1 / 32),
            grid((3, 3, c, c), -4, 4, 1 / 32),
            tuple(vec[k] for k in _VEC_NAMES))


def _sums_close(got, want, scale):
    """float32 sums in another order: within 1e-5 * Σ|terms| + 1e-6."""
    for g, w, s in zip(got, want, scale):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert bool(((g - w).abs() <= 1e-5 * s + 1e-6).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 32, 32, 16), (3, 16, 16, 32),
                                   (5, 8, 8, 64), (2, 7, 5, 16),
                                   (7, 7, 5, 16), (128, 32, 32, 16),
                                   (128, 16, 16, 32), (128, 8, 8, 64),
                                   (3, 7, 5, 128), (2, 9, 5, 256),
                                   (128, 28, 28, 128), (128, 14, 14, 256)])
def test_block_train_kernels_match_plain(cuda, shape, dtype):
    """block_stats and the three backward passes at the three widths, a
    single image, odd batches and ragged planes (where the tiles of pixels
    span images; the stats on the small plan) and the three B=128 train
    shapes (the stats on the tile plan); each called twice, bit for bit
    equal. The stats' c1 against the plain c1 within block_fwd's float32
    tolerance; pass 1's dz2 and ẑ2 against the plain pass 1's, pass 2 from
    the plain pass 1's dz2 and ẑ2, its dz1 against the plain dz1, pass 3
    from the plain dz1 and from the kernel's own."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    x, gy, w1, w2, vecs = _block_train_inputs(shape, dtype, gen)
    with torch.backends.cudnn.flags(enabled=False):   # exact on the grid
        *t, _, dz2, z2hat = fb.train_bwd_pass1_reference(x, gy, w1, w2,
                                                         *vecs)
        handoff = {"dz2": dz2, "z2hat": z2hat}
        *u, _, dz1 = fb.train_bwd_pass2_reference(x, gy, w1, w2, *vecs, *t,
                                                  **handoff)
    cases = (("stats_launches", (x, w1, vecs[0], vecs[1]), {},
              fb.block_stats, fb.block_stats_reference),
             ("bwd1_launches", (x, gy, w1, w2, *vecs), {}, fb.block_bwd1,
              fb.train_bwd_pass1_reference),
             ("bwd2_launches", (x, gy, w1, w2, *vecs, *t), handoff,
              fb.block_bwd2, fb.train_bwd_pass2_reference))
    for counter, args, kw, kernel, plain in cases:
        before = getattr(fb, counter)
        got, again = kernel(*args, **kw), kernel(*args, **kw)
        with torch.backends.cudnn.flags(enabled=False):
            want = plain(*args, **kw)
            scale = plain(*args, **kw, magnitudes=True)
        torch.cuda.synchronize()
        assert getattr(fb, counter) == before + 2
        sums = 2 if counter == "stats_launches" else 3
        _sums_close(got[:sums], want[:sums], scale[:sums])
        assert all(torch.equal(p, q) for p, q in zip(got, again))
        # block_fwd's float32 tolerance: c1, dz2 and ẑ2 are float32.
        for g, w in zip(got[sums:], want[sums:]):
            assert g.dtype == torch.float32 and g.shape == x.shape
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    own_dz1 = got[3]
    # block_fwd's float32 tolerance: dz1 is float32 whatever x's dtype.
    assert own_dz1.dtype == torch.float32 and own_dz1.shape == x.shape
    torch.testing.assert_close(own_dz1, dz1, atol=1e-4, rtol=1e-4)
    before = fb.bwd3_launches
    args = (x, gy, w1, w2, *vecs, *t, *u)
    dx, again = (fb.block_bwd3(*args, dz1=dz1) for _ in range(2))
    dx_own = fb.block_bwd3(*args, dz1=own_dz1)
    with torch.backends.cudnn.flags(enabled=False):
        want = fb.train_bwd_pass3_reference(*args, dz1=dz1)
    torch.cuda.synchronize()
    assert fb.bwd3_launches == before + 3 and dx.dtype == dtype
    assert torch.equal(dx, again)
    # block_fwd's tolerance: f32 sums in another order; bf16 one ulp.
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(dx.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(dx_own.float(), want.float(), atol=tol,
                               rtol=tol)


def test_block_train_wrappers_reject_bad_input(cuda):
    gen = torch.Generator(device="cuda").manual_seed(9)
    x, gy, w1, w2, vecs = _block_train_inputs((2, 8, 8, 16), torch.float32,
                                              gen)
    strided = x.permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fb.block_stats(strided, w1, vecs[0], vecs[1])
    with pytest.raises(ValueError, match="contiguous"):
        fb.block_bwd1(x, gy.permute(0, 2, 1, 3), w1, w2, *vecs)
    with pytest.raises(ValueError, match="w2 must be float32"):
        fb.block_bwd1(x, gy, w1, w2[:, :, :8], *vecs)
    with pytest.raises(ValueError, match="t1 must be float32"):
        fb.block_bwd2(x, gy, w1, w2, *vecs, vecs[0][:8], vecs[0], dz2=gy,
                      z2hat=gy)
    for name in ("dz2", "z2hat"):
        with pytest.raises(ValueError, match=f"{name} must be float32"):
            fb.block_bwd2(x, gy, w1, w2, *vecs, *vecs[:2],
                          **{"dz2": gy, "z2hat": gy, name: gy[..., :8]})
    with pytest.raises(ValueError, match="gy must be float32"):
        fb.block_bwd3(x, gy.to(torch.bfloat16), w1, w2, *vecs, *vecs[:4],
                      dz1=gy)
    with pytest.raises(TypeError, match="dz1"):
        fb.block_bwd3(x, gy, w1, w2, *vecs, *vecs[:4])
    for bad in (gy.permute(0, 2, 1, 3), gy.double(), gy[..., :8], gy.cpu()):
        with pytest.raises(ValueError, match="dz1 must be float32"):
            fb.block_bwd3(x, gy, w1, w2, *vecs, *vecs[:4], dz1=bad)
    s1, b1, s2, b2 = vecs[:4]
    for bad in (gy.permute(0, 2, 1, 3), gy.double(), gy[..., :8], gy.cpu()):
        with pytest.raises(ValueError, match="c1 must be float32"):
            fb.block_fwd(x, w1, w2, s1, b1, s2, b2, c1=bad)
    with pytest.raises(ValueError, match="kernels for C"):
        fb.block_stats(torch.zeros(2, 8, 8, 24, device="cuda"),
                       torch.zeros(3, 3, 24, 24, device="cuda"),
                       torch.ones(24, device="cuda"),
                       torch.zeros(24, device="cuda"))


def test_fused_train_step_kernels_match_plain(cuda, monkeypatch):
    """One float32 step of a fused CIFAR ResNet-14 (3 fused blocks, 7 BN
    sites outside them) through the kernels, with the launch table, and one
    through the plain versions, from one seeded state."""
    cfg = load_config("smoke", "", [
        "model.resnet_size=14", "model.fused_blocks=true",
        "model.fused_epilogue=on", "optim.use_pallas_xent=on",
        "train.global_batch_size=32"])
    step = make_train_step(cfg.optim, sched_lib.build_schedule(
        cfg.optim, cfg.train), 10)
    gen = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn(32, 32, 32, 3, generator=gen, device="cuda")
    y = torch.randint(0, 10, (32,), generator=gen, device="cuda",
                      dtype=torch.int32)
    kernel_state, plain_state = build_state(cfg, cuda), build_state(cfg, cuda)
    names = ("launches", "stats_launches", "bwd1_launches", "bwd2_launches",
             "bwd3_launches")
    before = [getattr(fb, n) for n in names] + [
        ep.launches, ep.bwd_launches, sx.fwd_launches, sx.bwd_launches]
    got = step(kernel_state, x, y)
    torch.cuda.synchronize()
    after = [getattr(fb, n) for n in names] + [
        ep.launches, ep.bwd_launches, sx.fwd_launches, sx.bwd_launches]
    assert [a - b for a, b in zip(after, before)] == [3] * 5 + [7, 7, 1, 1]
    monkeypatch.setattr(fb, "block_train_apply",
                        fb.block_train_apply_reference)
    monkeypatch.setattr(ep, "scale_bias_relu", ep.scale_bias_relu_reference)
    monkeypatch.setattr(sx, "softmax_xent_per_example",
                        sx.softmax_xent_per_example_reference)
    want = step(plain_state, x, y)
    for key in ("loss", "precision", "grad_norm"):
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=1e-5)
    for (name, a), b in zip(kernel_state.model.state_dict().items(),
                            plain_state.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4, msg=name)
    for name, buf in kernel_state.momentum_buffers().items():
        torch.testing.assert_close(buf, plain_state.momentum_buffers()[name],
                                   atol=1e-5, rtol=1e-4, msg=name)


# ------------------------------------------- the fused bottleneck's training
def _bottleneck_train_inputs(shape, dtype, gen):
    """x, gy, w1, w2, w3 and the twelve BN vectors on a coarse dyadic grid,
    as chip_smoke.py draws them: gammas and 1/σ are powers of two, so c1,
    ĉ, mid and m̂ are exact in float32 in any summation order and kernel and
    plain version share their masks [m > 0]."""
    c4 = shape[-1]
    f = c4 // 4

    def grid(size, lo, hi, step):
        return torch.randint(lo, hi + 1, size, generator=gen,
                             device="cuda").float() * step

    def pow2(n, lo, hi):
        return 2.0 ** grid((n,), lo, hi, 1)

    vecs = (pow2(c4, -1, 0), grid((c4,), -4, 4, 1 / 16),
            grid((c4,), -2, 2, 1 / 4), pow2(c4, -1, 0),
            pow2(f, -1, 0), grid((f,), -4, 4, 1 / 16),
            grid((f,), -8, 8, 1 / 8), pow2(f, -3, -2),
            pow2(f, -1, 0), grid((f,), -4, 4, 1 / 16),
            grid((f,), -8, 8, 1 / 8), pow2(f, -1, 0))
    return (grid(shape, -8, 8, 1 / 4).to(dtype), grid(shape, -16, 16, 1 / 8),
            grid((c4, f), -4, 4, 1 / 32), grid((3, 3, f, f), -2, 2, 1 / 32),
            grid((f, c4), -4, 4, 1 / 32), vecs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 56, 56, 256), (2, 28, 28, 512),
                                   (2, 14, 14, 1024), (1, 9, 5, 256),
                                   (3, 7, 7, 1024)])
def test_bottleneck_train_kernels_match_plain(cuda, shape, dtype):
    """The two moment passes and the four backward passes at the three
    ResNet-50 stage shapes and two ragged ones (45 and 147 pixels, not a
    multiple of the 64-pixel tile); each called twice. Passes 2, 3
    and 4 take the plain pass 1's p2, mid and dm3, pass 2's dmid and pass
    3's dc1, which are held like the sums where a pass returns them; pass
    1's masks [m2 > 0] and [m3 > 0] equal the plain pass's."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    x, gy, w1, w2, w3, vecs = _bottleneck_train_inputs(shape, dtype, gen)
    base = (x, gy, w1, w2, w3, *vecs)
    with torch.backends.cudnn.flags(enabled=False):   # exact on the grid
        *t3, _, p2, mid, dm3 = fbn.train_bwd_pass1_reference(*base)
        *t2, _, dmid = fbn.train_bwd_pass2_reference(
            *base, *t3, p2=p2, mid=mid, dm3=dm3)
        *t1, _, dc1 = fbn.train_bwd_pass3_reference(*base, *t3, *t2,
                                                    dmid=dmid)
    cases = (("stats_a_launches", (x, w1, *vecs[:4]), {},
              fbn.bottleneck_stats_a, fbn.bottleneck_stats_a_reference),
             ("stats_b_launches", (x, w1, w2, *vecs[:8]), {},
              fbn.bottleneck_stats_b, fbn.bottleneck_stats_b_reference),
             ("bwd1_launches", base, {}, fbn.bottleneck_bwd1,
              fbn.train_bwd_pass1_reference),
             ("bwd2_launches", (*base, *t3),
              {"p2": p2, "mid": mid, "dm3": dm3}, fbn.bottleneck_bwd2,
              fbn.train_bwd_pass2_reference),
             ("bwd3_launches", (*base, *t3, *t2), {"dmid": dmid},
              fbn.bottleneck_bwd3, fbn.train_bwd_pass3_reference))
    for counter, args, kw, kernel, plain in cases:
        before = getattr(fbn, counter)
        got, again = kernel(*args, **kw), kernel(*args, **kw)
        with torch.backends.cudnn.flags(enabled=False):
            want = plain(*args, **kw)
            scale = plain(*args, **kw, magnitudes=True)
        torch.cuda.synchronize()
        assert getattr(fbn, counter) == before + 2, counter
        _sums_close(got, want, scale)
        assert all(torch.equal(p, q) for p, q in zip(got, again)), counter
        if counter == "bwd1_launches":
            g3, be3, mu3, i3 = vecs[8:]
            assert torch.equal(got[3] > 0, want[3] > 0)
            assert torch.equal(g3 * ((got[4] - mu3) * i3) + be3 > 0,
                               g3 * ((want[4] - mu3) * i3) + be3 > 0)
    before = fbn.bwd4_launches
    args = (*base, *t3, *t2, *t1)
    dx, again = (fbn.bottleneck_bwd4(*args, dc1=dc1) for _ in range(2))
    with torch.backends.cudnn.flags(enabled=False):
        want = fbn.train_bwd_pass4_reference(*args, dc1=dc1)
    torch.cuda.synchronize()
    assert fbn.bwd4_launches == before + 2 and dx.dtype == dtype
    assert torch.equal(dx, again)
    # bottleneck_fwd's tolerance: f32 sums in another order; bf16 one ulp.
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(dx.float(), want.float(), atol=tol, rtol=tol)


# (mode, A's shape [B,H,W,ka], nb, x's dtype): the four output tiles of
# csrc/bottleneck_wgrad.cu (64 or 128 along each side), 147 and 135 pixels
# (no multiple of the 16-pixel chunk), and a 7x7 image whose 3x3 taps fall
# off every edge.
WGRAD_CASES = [
    (wg.ROWS, (3, 7, 7, 64), 256, torch.float32),
    (wg.SHIFTED, (3, 7, 7, 64), 64, torch.float32),
    (wg.SHIFTED, (3, 9, 5, 128), 128, torch.float32),
    (wg.BN_RELU, (3, 7, 7, 256), 64, torch.float32),
    (wg.BN_RELU, (3, 7, 7, 256), 64, torch.bfloat16),
    (wg.BN_RELU, (3, 9, 5, 128), 512, torch.float32),
    (wg.BN_RELU, (3, 9, 5, 128), 512, torch.bfloat16),
    (wg.SHIFTED_BN_RELU, (3, 9, 5, 128), 128, torch.float32),
    (wg.SHIFTED_BN_RELU, (3, 9, 5, 128), 128, torch.bfloat16),
    (wg.SHIFTED_BN_RELU, (2, 7, 7, 256), 256, torch.float32)]


@pytest.mark.parametrize("mode, shape, nb, dtype", WGRAD_CASES)
def test_bottleneck_wgrad_kernel_matches_plain(cuda, mode, shape, nb, dtype):
    """``tr_bottleneck_wgrad`` in each of its four modes, with the pixels
    in the default number of splits, in one, and in more than the pixels
    fill (the last ones empty): within 1e-5·Σ|terms| + 1e-6 of the plain
    einsum or ``_wgrad``, two calls bit for bit equal. The shifted BN+ReLU
    mode with a BN (g, b, μ, i) and with a fold (s, b): SAME pads after the
    ReLU, so an out-of-image tap reads 0, not relu(b − g·μ·i)."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    ka = shape[-1]
    a = torch.randn(shape, generator=gen, device="cuda")
    if mode == wg.SHIFTED:
        a = a.clamp_min(0.0)   # p2
    a = a.to(dtype)
    bmat = torch.randn(*shape[:3], nb, generator=gen, device="cuda")
    bn = ((torch.rand(ka, generator=gen, device="cuda") + 0.5,
           torch.randn(ka, generator=gen, device="cuda") * 0.5,
           torch.randn(ka, generator=gen, device="cuda") * 0.5,
           torch.rand(ka, generator=gen, device="cuda") + 0.5)
          if mode in (wg.BN_RELU, wg.SHIFTED_BN_RELU) else ())
    if mode == wg.SHIFTED_BN_RELU and ka == 256:
        bn = bn[:2]   # a fold: μ = 0, i = 1
    taps = 9 if mode in (wg.SHIFTED, wg.SHIFTED_BN_RELU) else 1
    want = wg.weight_grad_reference(mode, a, bmat, bn)
    scale = wg.weight_grad_reference(mode, a, bmat, bn, magnitudes=True)
    for splits in (None, 1, 20):
        before = wg.launches
        got, again = (wg.weight_grad("wgrad", mode, a, bmat, ka, nb, a,
                                     taps, bn, splits=splits)
                      for _ in range(2))
        torch.cuda.synchronize()
        assert wg.launches == before + 2
        assert got.shape == (taps * ka * nb,) and torch.equal(got, again)
        _sums_close([got], [want], [scale])


def test_bottleneck_stats_a_keeps_the_reference_rounding(cuda):
    """``bottleneck_stats_a`` rounds BN1 as the reference's
    ``_stats_a_kernel``, (g1·(x−μ1))·i1 first: with x = 2^100, i1 = 2^100
    and g1 = 2^-100 on a quarter of the channels, that order gives p1 =
    2^100, and g1·((x−μ1)·i1), the other passes' order, overflows to inf.
    B=3 at 7x7: 147 pixels, no multiple of the 64-pixel tile."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    x, _, w1, _, _, vecs = _bottleneck_train_inputs((3, 7, 7, 256),
                                                    torch.float32, gen)
    g1, be1, mu1, i1 = (v.clone() for v in vecs[:4])
    big = torch.arange(256, device="cuda") % 4 == 0
    x[..., big] = 2.0 ** 100
    g1[big], mu1[big], i1[big] = 2.0 ** -100, 0.0, 2.0 ** 100
    w1[big] = 2.0 ** -100
    assert bool(torch.isinf(g1 * ((x - mu1) * i1)).any())
    for dtype in (torch.float32, torch.bfloat16):
        args = (x.to(dtype), w1, g1, be1, mu1, i1)
        got = fbn.bottleneck_stats_a(*args)
        want = fbn.bottleneck_stats_a_reference(*args)
        scale = fbn.bottleneck_stats_a_reference(*args, magnitudes=True)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(w).all()) for w in want)
        _sums_close(got, want, scale)


def test_bottleneck_train_wrappers_reject_bad_input(cuda):
    gen = torch.Generator(device="cuda").manual_seed(12)
    x, gy, w1, w2, w3, vecs = _bottleneck_train_inputs(
        (2, 8, 8, 256), torch.float32, gen)
    with pytest.raises(ValueError, match="contiguous"):
        fbn.bottleneck_stats_a(x.permute(0, 2, 1, 3), w1, *vecs[:4])
    with pytest.raises(ValueError, match="contiguous"):
        fbn.bottleneck_stats_b(x.permute(0, 2, 1, 3), w1, w2, *vecs[:8])
    with pytest.raises(ValueError, match="w3 must be float32"):
        fbn.bottleneck_bwd1(x, gy, w1, w2, w3[:, :8], *vecs)
    dc1 = torch.zeros(2, 8, 8, 64, device="cuda")
    with pytest.raises(ValueError, match="t3a must be float32"):
        fbn.bottleneck_bwd2(x, gy, w1, w2, w3, *vecs, vecs[0], vecs[4],
                            p2=dc1, mid=dc1, dm3=dc1)
    with pytest.raises(ValueError, match="mid must be float32"):
        fbn.bottleneck_bwd2(x, gy, w1, w2, w3, *vecs, *vecs[4:6], p2=dc1,
                            mid=dc1[..., :32], dm3=dc1)
    with pytest.raises(ValueError, match="contiguous"):
        fbn.bottleneck_bwd2(x, gy, w1, w2, w3, *vecs, *vecs[4:6], p2=dc1,
                            mid=dc1, dm3=dc1.permute(0, 2, 1, 3))
    with pytest.raises(ValueError, match="gy must be float32"):
        fbn.bottleneck_bwd4(x, gy.to(torch.bfloat16), w1, w2, w3, *vecs,
                            *vecs[4:8], *vecs[:2], dc1=dc1)
    with pytest.raises(ValueError, match="dc1 must be float32"):
        fbn.bottleneck_bwd4(x, gy, w1, w2, w3, *vecs, *vecs[4:8], *vecs[:2],
                            dc1=dc1[..., :32])
    with pytest.raises(ValueError, match="dmid must be float32"):
        fbn.bottleneck_bwd3(x, gy, w1, w2, w3, *vecs, *vecs[4:8],
                            dmid=dc1.double())
    with pytest.raises(ValueError, match="contiguous"):
        fbn.bottleneck_bwd3(x, gy, w1, w2, w3, *vecs, *vecs[4:8],
                            dmid=dc1.permute(0, 2, 1, 3))
    with pytest.raises(ValueError, match="kernels for f"):
        fbn.bottleneck_stats_a(torch.zeros(2, 8, 8, 128, device="cuda"),
                               torch.zeros(128, 32, device="cuda"),
                               *(torch.ones(128, device="cuda"),) * 4)


def test_imagenet_fused_train_step_launches(cuda):
    """One bf16 step of ImageNet ResNet-50 at 64x64 through the loop's step:
    each of the seven bottleneck kernels 10 times, the weight gradients
    30, a finite loss."""
    cfg = load_config("imagenet", "", [
        "model.fused_blocks=true", "model.fused_epilogue=on",
        "optim.use_pallas_xent=on", "train.global_batch_size=4",
        "data.image_size=64"])
    state = build_state(cfg, cuda)
    gen = torch.Generator(device="cuda").manual_seed(13)
    images = torch.randint(0, 256, (4, 64, 64, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    labels = torch.randint(0, 1000, (4,), generator=gen, device="cuda",
                           dtype=torch.int32)
    counters = [(fbn, n) for n in (
        "launches", "stats_a_launches", "stats_b_launches", "bwd1_launches",
        "bwd2_launches", "bwd3_launches", "bwd4_launches")] + [
        (wg, "launches")]
    before = [getattr(mod, n) for mod, n in counters]
    m = make_loop_step(cfg, cuda)(state, images, labels)
    torch.cuda.synchronize()
    assert [getattr(mod, n) - b for (mod, n), b in zip(counters, before)] == (
        [10] * 7 + [30])
    assert bool(torch.isfinite(m["loss"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 32, 32, 16), (16, 56, 56, 256),
                                   (3, 5, 7, 24), (1, 1, 1, 8)])
def test_sbr_add_kernel_matches_plain(cuda, shape, dtype):
    """tr_sbr_add: forward bit for bit (the plain version's roundings);
    backward dx bit for bit, dr == g, ds/db within sbr_bwd's limits."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    x, _, (s, b, _, _) = _inputs(shape, dtype, gen)
    r = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    before = ep.add_launches
    got = ep.scale_bias_relu_add(x, s, b, r)
    want = ep.scale_bias_relu_add_reference(x, s, b, r)
    torch.cuda.synchronize()
    assert ep.add_launches == before + 1
    assert got.dtype == dtype and torch.equal(got, want)
    grads = []
    for fn in (ep.scale_bias_relu_add, ep.scale_bias_relu_add_reference):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, s, b, r)]
        fn(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
    (dx, ds, db, dr), (wdx, wds, wdb, wdr) = grads
    assert torch.equal(dx, wdx) and torch.equal(dr, g) and torch.equal(wdr, g)
    gm = torch.where(x.float() * s + b > 0, g.float(), 0.0)
    for got_s, ref, terms in ((ds, wds, gm * x.float()), (db, wdb, gm)):
        scale = terms.abs().sum(dim=(0, 1, 2))
        assert bool(((got_s - ref).abs() <= 1e-5 * scale + 1e-6).all())


def test_probes_on_the_card(cuda):
    """probe_epilogue and the xent probe time both arms on the card: finite
    times, use_pallas == (speedup >= 1), iters + 1 kernel launches each."""
    autotune.reset()
    try:
        before = (ep.launches, ep.add_launches)
        decisions = ep.probe_epilogue((128, 16, 16, 32), torch.bfloat16,
                                      iters=4, force=True)
        torch.cuda.synchronize()
        assert (ep.launches - before[0], ep.add_launches - before[1]) == (
            5, 5)
        xent = sx.ensure_xent_probe(128, 10, iters=4)
        for d in (*decisions, xent):
            assert d.pallas_us > 0 and d.xla_us > 0
            assert d.use_pallas == (d.speedup >= 1.0)
    finally:
        autotune.reset()


def test_auto_step_launches_follow_the_decisions(cuda, tmp_path):
    """The loop's step under fused_epilogue=auto and use_pallas_xent=auto
    (CIFAR ResNet-8, B=16): the probes' launches are not counted, and a
    step launches sbr and sbr_bwd once per BN site whose shape chose the
    kernel, the xent pair once if it was chosen."""
    autotune.reset()
    try:
        cfg = load_config("cifar10", "", [
            "model.resnet_size=8", "model.fused_epilogue=auto",
            "train.global_batch_size=16", f"train.train_dir={tmp_path}"])
        state = build_state(cfg, cuda)
        counts = (ep.launches, ep.bwd_launches, sx.fwd_launches)
        step = build_step(cfg, cuda)
        assert (ep.launches, ep.bwd_launches, sx.fwd_launches) == counts
        assert (tmp_path / autotune.AUTOTUNE_FILE).exists()
        sites = {(16, 32, 32, 16): 3, (16, 16, 16, 32): 2, (16, 8, 8, 64): 2}
        kernel_sites = sum(n for shape, n in sites.items()
                           if autotune.use_kernel(ep.OP_SBR,
                                                  ep.sbr_key(shape)))
        xent = int(autotune.use_kernel(sx.OP_XENT, "16x10"))
        images = torch.randint(0, 256, (16, 32, 32, 3), device="cuda",
                               dtype=torch.uint8)
        labels = torch.randint(0, 10, (16,), device="cuda")
        m = step(state, images, labels)
        torch.cuda.synchronize()
        assert (ep.launches - counts[0], ep.bwd_launches - counts[1],
                sx.fwd_launches - counts[2]) == (kernel_sites, kernel_sites,
                                                 xent)
        assert bool(torch.isfinite(m["loss"]))
    finally:
        autotune.reset()


# ------------------------------------------- the folded blocks' gradients
def _bwd_close(got, again, want, scale, dtype):
    """Two calls bit-equal; dx within the forward's tolerance (f32 sums in
    another order; bf16 one ulp); sums and weight gradients within
    1e-5 * Σ|terms| + 1e-6."""
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    assert got[0].dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol,
                               rtol=tol)
    _sums_close(got[1:], want[1:], scale[1:])


def _launches_per_call(fn) -> float:
    """The port's kernel launches in one call of ``fn`` (PyTorch's own
    kernels, the weights' transposes and the like, left out)."""
    from tpu_resnet_torch.tools.profiling import device_profile
    kernels = device_profile(fn, iters=2)["kernels"]
    return sum(k["launches_per_call"] for k in kernels
               if "at::" not in k["name"])


def _mask_flips(handed, scale, product, plain_on) -> int:
    """Elements where a kernel's mask differs from the plain version's,
    read from the tensor it hands over (scale·product where its mask is on,
    0 where off: it lies nearer one of the two); counted where the product
    is more than 1e-6."""
    on = scale * product
    kernel_on = (handed - on).abs() < handed.abs()
    return int(((kernel_on != plain_on) & (on.abs() > 1e-6)).sum())


# The folded gradients' shapes: the three widths and a ragged plane, the
# grad phase's B=16 (the small tile plan, 32-pixel bottleneck tiles at 14²)
# and the A/B tools' B=128.
_BLOCK_BWD_SHAPES = ([(1, 32, 32, 16), (3, 16, 16, 32), (5, 8, 8, 64),
                      (2, 7, 5, 16), (2, 7, 5, 128), (3, 6, 6, 256)]
                     + [(b, hw, hw, c) for b in (16, 128)
                        for hw, c in ((32, 16), (16, 32), (8, 64), (28, 128),
                                      (14, 256))])
_BOTTLENECK_BWD_SHAPES = ([(2, 56, 56, 256), (2, 28, 28, 512),
                           (2, 14, 14, 1024), (1, 9, 5, 256)]
                          + [(b, hw, hw, c) for b in (16, 128)
                             for hw, c in ((56, 256), (28, 512),
                                           (14, 1024))])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _BLOCK_BWD_SHAPES)
def test_block_bwd_kernel_matches_plain(cuda, shape, dtype):
    """The folded block's gradient at the three widths, a ragged plane and
    the grad phase's and A/B tools' shapes, on the dyadic grid (the gammas
    and betas as the folded scales and biases, so c1 and the masks are
    exact); called twice, bit for bit equal, four launches a call (eight at
    C = 128 and 256: two weight gradients of two launches); step 1's mask
    [a2 > 0], read from its dc1, the plain version's everywhere."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    x, gy, w1, w2, vecs = _block_train_inputs(shape, dtype, gen)
    args = (x, gy, w1, w2, *vecs[:4])
    before = fb.bwd_launches
    got, again = fb.block_bwd(*args), fb.block_bwd(*args)
    with torch.backends.cudnn.flags(enabled=False):
        want = fb.block_bwd_reference(*args)
        scale = fb.block_bwd_reference(*args, magnitudes=True)
        s1, b1, s2, b2 = vecs[:4]
        a2 = fb._c1(x.float(), w1, s1, b1) * s2 + b2
        dr2 = fb._conv3x3_t(gy, w2)
    torch.cuda.synchronize()
    assert fb.bwd_launches == before + 2
    _bwd_close(got, again, want, scale, dtype)
    dc1 = fb.folded_bwd1(*args)[3]
    assert _mask_flips(dc1, s2, dr2, a2 > 0) == 0
    launches = 4 if shape[-1] in fb.TAP_CHANNELS else 8
    assert _launches_per_call(lambda: fb.block_bwd(*args)) == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _BOTTLENECK_BWD_SHAPES)
def test_bottleneck_bwd_kernel_matches_plain(cuda, shape, dtype):
    """The folded bottleneck's gradient at the three ResNet-50 stage shapes
    (B = 2, the grad phase's 16 and the A/B tools' 128) and a ragged one,
    on the dyadic grid: s1 = γ1, s2 = 1/σ2 (1/8 or 1/4, so mid stays
    exact), s3 = γ3 and the betas as biases; called twice, bit for bit
    equal, eleven launches a call (three weight gradients of two among
    them); step 1's mask [m3 > 0], read from its dmid, the plain
    version's everywhere."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    x, gy, w1, w2, w3, v = _bottleneck_train_inputs(shape, dtype, gen)
    args = (x, gy, w1, w2, w3, v[0], v[1], v[7], v[5], v[8], v[9])
    before = fbn.bwd_launches
    got, again = fbn.bottleneck_bwd(*args), fbn.bottleneck_bwd(*args)
    with torch.backends.cudnn.flags(enabled=False):
        want = fbn.bottleneck_bwd_reference(*args)
        scale = fbn.bottleneck_bwd_reference(*args, magnitudes=True)
        p2 = fbn._folded_chain(x, *args[2:3], *args[5:9])[-1]
        s3, b3 = args[9:]
        m3 = fbn._conv3x3(p2, w2) * s3 + b3
        dp3 = torch.einsum("bhwc,fc->bhwf", gy, w3)
    torch.cuda.synchronize()
    assert fbn.bwd_launches == before + 2
    _bwd_close(got, again, want, scale, dtype)
    dmid = fbn.folded_bwd1(*args)[5]
    assert _mask_flips(dmid, s3, dp3, m3 > 0) == 0
    del got, again, want, scale, p2, m3, dp3, dmid
    assert _launches_per_call(lambda: fbn.bottleneck_bwd(*args)) == 11


@pytest.mark.parametrize("preset, overrides, blocks", [
    ("cifar10", ["model.resnet_size=14"], 3),
    ("imagenet", ["data.image_size=64"], 10)], ids=["cifar10", "imagenet"])
def test_eval_mode_fused_model_grad_matches_plain(cuda, monkeypatch, preset,
                                                  overrides, blocks):
    """The regression of the eval path: the input gradient of an eval-mode
    fused model on the card goes through the gradient kernels (one launch
    per fused block) and equals the plain-version model's, normwise within
    1e-3. A fused block that cut the graph leaves the input unreachable."""
    cfg = load_config(preset, "", ["model.fused_blocks=true",
                                   "model.fused_epilogue=on",
                                   "model.compute_dtype=float32", *overrides])
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    size = cfg.data.resolved_image_size
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn(2, size, size, 3, generator=gen, device="cuda")
    cot = torch.randn(2, cfg.data.num_classes, generator=gen, device="cuda")

    def input_grad():
        leaf = x.clone().requires_grad_()
        return torch.autograd.grad((model(leaf) * cot).sum(), leaf)[0]

    mod = fb if preset == "cifar10" else fbn
    before = mod.bwd_launches
    got = input_grad()
    torch.cuda.synchronize()
    assert mod.bwd_launches == before + blocks
    monkeypatch.setattr(fb, "block_apply", fb.block_apply_reference)
    monkeypatch.setattr(fbn, "bottleneck_apply",
                        fbn.bottleneck_apply_reference)
    monkeypatch.setattr(ep, "scale_bias_relu", ep.scale_bias_relu_reference)
    want = input_grad()
    assert float((got - want).norm() / want.norm()) <= 1e-3


@pytest.mark.parametrize("synchronising", [False, True],
                         ids=["queued", "synchronising"])
def test_timed_us_flags_a_timing_the_spin_could_not_hold(cuda,
                                                         synchronising):
    """``autotune.timed_us`` reports device time behind its spin; a call
    that waits for the device (here a synchronise) cannot queue behind the
    spin, and its time is flagged host-paced."""
    x = torch.randn(1 << 20, device="cuda")

    def fn(t):
        y = t * 2
        if synchronising:
            torch.cuda.synchronize()
        return y

    us, host_paced = autotune.timed_us(fn, (x,), 4)
    assert us > 0 and host_paced is synchronising


# The decode stage on the card against its plain versions: max |d| per
# image and mean |d| over the batch (nvJPEG's IDCT and chroma upsampling
# are not libjpeg's; chip_smoke.py's STAGE_TOL), and tr_resize_crop alone
# against its plain version on the same decoded pixels.
_STAGE_TOL, _RESIZE_TOL = (28, 0.75), 1


def _fixture_jpegs():
    import os

    from tpu_resnet_torch.data import imagenet, tfrecord
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "imagenet")
    return [imagenet.parse_record(r)[0] for name in sorted(os.listdir(root))
            for r in tfrecord.read_records(os.path.join(root, name))]


def test_resize_crop_and_nvjpeg_stage_match_plain(cuda):
    import numpy as np

    from tpu_resnet_torch.data import jpeg as plain_jpeg
    from tpu_resnet_torch.ops import jpeg_decode as jd

    jpegs = _fixture_jpegs()
    rng = np.random.default_rng(0)
    draws = [(int(rng.integers(256, 513)), float(rng.random()),
              float(rng.random())) for _ in jpegs[:-4]]
    draws += [(256, -1.0, -1.0)] * 4    # the eval crop
    decoder = jd.NvJpegDecoder(cuda)
    try:
        before = jd.launches
        got = jd.decode_crop_batch(jpegs, draws, 224, cuda, decoder).cpu()
        assert jd.launches == before + 1
        want = jd.decode_crop_batch(jpegs, draws, 224, "cpu")
        diff = (got.int() - want.int()).abs()
        assert int(diff.max()) <= _STAGE_TOL[0]
        assert float(diff.float().mean()) <= _STAGE_TOL[1]
        # The kernel alone, on nvJPEG's pixels.
        infos = decoder.infos(jpegs)
        assert {s for _, s, _, _ in infos} >= {"4:2:0", "4:4:4", "grey"}
        src, offsets, sizes = decoder.decode_batch(jpegs)
        nbytes = [w * h * c for w, h, c in sizes]
        tables = jd.crop_table_batch([s[:2] for s in sizes], draws, 224)
        kernel = jd.resize_crop(src, *(torch.from_numpy(a).cuda() for a in (
            offsets, np.array(sizes, np.int32), *tables)))
        for j, (w, h, c) in enumerate(sizes):
            plain = jd.resize_crop_reference(
                src[offsets[j]:offsets[j] + nbytes[j]].view(h, w, c),
                tables[0][j], tables[1][j], tables[2][j])
            assert int((kernel[j].int() - plain.int()).abs().max()) <= \
                _RESIZE_TOL
        # A grey image decodes to its luma plane, as the plain decoder's.
        grey = next(j for j, i in enumerate(infos) if i[1] == "grey")
        w, h, _ = sizes[grey]
        luma = src[offsets[grey]:offsets[grey] + nbytes[grey]].view(h, w)
        assert int((luma.cpu().int() - torch.from_numpy(plain_jpeg.decode(
            jpegs[grey])[..., 0]).int()).abs().max()) <= 2
        with pytest.raises(RuntimeError, match="of junk: nvJPEG status"):
            decoder.infos([jpegs[0], b"\xff\xd8 not a jpeg"],
                          ["good", "junk"])
    finally:
        decoder.close()


def test_imagenet_engine_on_the_card_is_the_synchronous_decode(cuda):
    """Batches from two decode threads on their own streams, read while
    matrix products keep the card busy (the decode streams lag behind
    them), equal one thread's and a synchronous decode of the same
    order."""
    import os

    from tpu_resnet_torch.data import engine
    from tpu_resnet_torch.data.imagenet import ImageNetIterator

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "imagenet")

    def batches(workers):
        it = ImageNetIterator(root, 8, seed=4, shuffle_buffer=16,
                              image_size=224)
        eng = it.engine(device="cuda", workers=workers, ring_slots=3)
        a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
        out = []
        try:
            for _ in range(4):
                batch = next(eng)
                for _ in range(40):   # ~10 ms of products a batch
                    a = (a @ a).clamp_(-1, 1)
                out.append(tuple(t.cpu() for t in batch))
            return out
        finally:
            eng.close()

    one, two = batches(1), batches(2)
    for (ai, al), (bi, bl) in zip(one, two):
        assert torch.equal(ai, bi) and torch.equal(al, bl)
    it = ImageNetIterator(root, 8, seed=4, shuffle_buffer=16)
    order = list(itertools.islice(it.work_orders(), 4))[3]
    records = engine.read_order(order, it.files)
    stage = engine.DecodeStage(cuda, 224, 8)
    try:
        images, labels, _ = stage.batch(records, engine.order_draws(
            dict(train=True, seed=4, resize_min=256, resize_max=512,
                 eval_resize=256), 3, 8))
        torch.cuda.synchronize()
        assert torch.equal(images.cpu(), one[3][0])
        assert torch.equal(labels.cpu(), one[3][1])
    finally:
        stage.close()


# ------------------------------------------------ multi-step dispatch
def _resnet8_run(cuda, per_call, steps=10, chunk=4, overrides=()):
    """CIFAR ResNet-8, B=16, the loop's step on the resident split
    (synthetic data), ``steps`` steps in chunks of at most ``chunk``
    through a ChunkRunner at ``per_call``; returns (state, runner, every
    step's metrics)."""
    from tpu_resnet_torch.data.cifar import load_split
    from tpu_resnet_torch.data.device_data import ChunkRunner, DeviceDataset
    cfg = load_config("cifar10", "", [
        "data.dataset=synthetic", "data.synthetic_learnable=true",
        "data.synthetic_train_examples=256", "model.resnet_size=8",
        "model.fused_epilogue=on", "optim.use_pallas_xent=on",
        "train.global_batch_size=16", *overrides])
    ds = DeviceDataset(*load_split(cfg.data, train=True), 16, cuda)
    state = build_state(cfg, cuda)
    runner = ChunkRunner(make_loop_step(cfg, cuda), cuda, per_call, ds,
                         record_steps=True)
    while state.step < steps:
        c = min(chunk, per_call, steps - state.step,
                ds.steps_per_epoch - state.step % ds.steps_per_epoch)
        runner.run(state, state.step, c)
    torch.cuda.synchronize()
    return state, runner, runner.recorded


def _run_tensors(state, metrics):
    out = dict(state.model.state_dict())
    out.update({f"momentum {n}": b
                for n, b in state.momentum_buffers().items()})
    for i, m in enumerate(metrics):
        out.update({f"{k}@{i}": torch.as_tensor(v) for k, v in m.items()})
    return out


def test_graphed_step_equals_the_eager_step(cuda):
    """Ten steps in chunks of 4, 4, 2 as CUDA graph replays (two eager
    warm-up steps, then the capture) against ten eager steps: bit for bit
    where two eager runs are, else within 4x their normwise distance."""
    eager = _run_tensors(*_resnet8_run(cuda, 1)[::2])
    again = _run_tensors(*_resnet8_run(cuda, 1)[::2])
    state, runner, metrics = _resnet8_run(cuda, 4)
    assert runner.graph is not None and runner.replays == 8
    graphed = _run_tensors(state, metrics)
    assert set(graphed) == set(eager)

    def worst(a, b):
        return max(float((a[n].double() - b[n].double()).norm()
                         / max(float(b[n].double().norm()), 1e-30))
                   for n in b)

    control = worst(again, eager)
    if control == 0:
        for n in eager:
            assert torch.equal(graphed[n], eager[n]), n
    else:
        assert worst(graphed, eager) <= 4 * control


def test_launch_counters_count_replays(cuda):
    """A replay moves no Python counter: the runner adds the capture's
    increments once per replay, so ten graphed steps count what ten eager
    steps count (7 sbr, 7 sbr_bwd, 1 + 1 xent a step at ResNet-8)."""
    from tpu_resnet_torch.data.device_data import launch_counters
    counters = launch_counters()
    before = [getattr(m, a) for m, a in counters]
    _, runner, _ = _resnet8_run(cuda, 4)
    moved = {a if m is ep else f"{m.__name__.rsplit('.', 1)[1]}.{a}":
             getattr(m, a) - n for (m, a), n in zip(counters, before)
             if getattr(m, a) != n}
    assert moved == {"launches": 70, "bwd_launches": 70,
                     "softmax_xent.fwd_launches": 10,
                     "softmax_xent.bwd_launches": 10}, moved
    assert runner._increments


def test_sbr_bwd_tickets_are_zero_after_every_replay(cuda):
    """sbr_bwd's tickets for the capture stream exist before the capture
    (the warm-up made them) and every replay leaves them zero."""
    from tpu_resnet_torch.data.cifar import load_split
    from tpu_resnet_torch.data.device_data import ChunkRunner, DeviceDataset
    state, runner, _ = _resnet8_run(cuda, 4, steps=3, chunk=1)
    key = (torch.cuda.current_device(), runner._stream.cuda_stream)
    assert key in ep._bwd_tickets
    for _ in range(5):
        runner.run(state, state.step, 1)
        torch.cuda.synchronize()
        assert not ep._bwd_tickets[key].any()
    assert runner.replays == 6


def test_capture_of_an_unprobed_auto_shape_raises(cuda):
    """model.fused_epilogue=auto with no probe: the eager warm-up takes the
    plain version, the capture raises instead of freezing that choice."""
    autotune.reset()
    try:
        with pytest.raises(autotune.UnprobedUnderCapture,
                           match="steps_per_call=1"):
            _resnet8_run(cuda, 4, steps=4,
                         overrides=["model.fused_epilogue=auto"])
    finally:
        autotune.reset()


def test_sgd_update_replays_the_eager_update(cuda):
    """The explicit update with a tensor learning rate, captured and
    replayed, equals the eager update bit for bit."""
    from tpu_resnet_torch.train.state import create_state, sgd_update
    cfg = load_config("smoke", "", [])
    states = []
    for graphed in (False, True):
        model = init_weights(build_model(cfg), torch.Generator().manual_seed(
            0)).to("cuda")
        state = create_state(model, cfg.optim)
        lr = torch.tensor(0.1, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        grads = [[torch.randn(p.shape, generator=gen, device="cuda")
                  for p in model.parameters()] for _ in range(4)]
        slots = [torch.zeros_like(p) for p in model.parameters()]
        for p, g in zip(model.parameters(), slots):
            p.grad = g
        graph = None
        for i, gs in enumerate(grads):
            for slot, g in zip(slots, gs):
                slot.copy_(g)
            lr.fill_(0.1 / (i + 1))
            if not graphed or i < 2:
                sgd_update(state, lr)
                continue
            if graph is None:
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    sgd_update(state, lr)
            graph.replay()
        torch.cuda.synchronize()
        states.append(state)
    for (n, a), b in zip(states[0].model.state_dict().items(),
                         states[1].model.state_dict().values()):
        assert torch.equal(a, b), n
    ma, mb = states[0].momentum_buffers(), states[1].momentum_buffers()
    assert all(torch.equal(ma[n], mb[n]) for n in ma)


def test_double_buffered_h2d_on_the_card(cuda):
    """The double buffer's superbatches on the card equal the generator
    form's, a partial last stage included, read after the consumer's
    stream waited for their copy."""
    import numpy as np
    from tpu_resnet_torch.data import pipeline
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 255, (128, 32, 32, 3)).astype(np.uint8),
                rng.integers(0, 10, 128).astype(np.int32))
               for _ in range(19)]
    want = [(a.cpu(), b.cpu(), k) for a, b, k in
            pipeline.staged_superbatch_prefetch(iter(batches), cuda,
                                                stage=8)]
    db = pipeline.DoubleBufferedH2D(iter(batches), cuda, stage=8)
    got = [(a.cpu(), b.cpu(), k) for a, b, k in db]
    stats = db.stats()
    db.close()
    assert [k for *_, k in got] == [k for *_, k in want] == [8, 8, 3]
    for (a, b, _), (c, d, _) in zip(got, want):
        assert torch.equal(a, c) and torch.equal(b, d)
    assert stats["h2d_bytes_per_sec"] > 0


def test_graphed_train_takes_the_injected_nan_batch(cuda, tmp_path):
    """``resilience.inject_nan_at_step=5`` on the streamed, graphed loop:
    the float NaN batch of a uint8 stream runs as one eager step of the
    captured step's state (no recapture); the loop rolls back from step 6
    to checkpoint 4, where the reference rolls back, and finishes, as the
    eager loop (steps_per_call=1) does, at the same steps and with the same
    losses."""
    import json
    import math
    import os
    from tpu_resnet_torch.obs.spans import load_spans
    from tpu_resnet_torch.train.loop import train

    runs = {}
    for per_call in (1, 4):
        d = tmp_path / str(per_call)
        cfg = load_config("cifar10", "", [
            "data.dataset=synthetic", "data.synthetic_learnable=true",
            "data.synthetic_train_examples=256", "model.resnet_size=8",
            "model.fused_epilogue=on", "optim.use_pallas_xent=on",
            "data.device_resident=off", "data.transfer_stage=1",
            "train.global_batch_size=16", "train.train_steps=12",
            "train.log_every=2", "train.checkpoint_every=4",
            f"train.steps_per_call={per_call}", f"train.train_dir={d}",
            "resilience.inject_nan_at_step=5"])
        assert train(cfg, device="cuda").step == 12
        rollbacks = [(s["from_step"], s["to_step"]) for s in
                     load_spans(os.path.join(d, "events.jsonl"))
                     if s["span"] == "nan_rollback"]
        with open(d / "metrics.jsonl") as f:
            losses = [(r["step"], r["loss"]) for r in map(json.loads, f)]
        runs[per_call] = (rollbacks, losses)
        print(per_call, rollbacks, losses)
    (rb1, losses1), (rb4, losses4) = runs[1], runs[4]
    # The reference's rollback: the NaN batch of step 5 makes the loss at
    # the log boundary of step 6 NaN (every ReLU keeps the NaN), back to
    # checkpoint 4; the steps logged are the reference's.
    assert rb4 == rb1 == [(6, 4)]
    assert [s for s, _ in losses1] == [2, 4, 6, 8, 10, 12]
    assert [s for s, _ in losses4] == [s for s, _ in losses1]
    assert math.isfinite(losses4[-1][1])
    for (_, a), (_, b) in zip(losses4, losses1):
        assert a == b or (math.isnan(a) and math.isnan(b)) or abs(
            a - b) <= 1e-5 * max(1.0, abs(b))


def test_kernels_keep_a_nan(cuda):
    """Fault 7: every kernel with a ReLU (``sbr``, ``sbr_add``, the fused
    block's forward, stats, passes 1 and 2 at C = 64, 128, 256, the fused
    bottleneck's forward and first moment pass, and the weight gradient's
    BN+ReLU operand) on an input with NaNs at seeded places: NaN exactly
    where the plain version's output is, bit for bit its own clean output
    wherever the plain version's did not move, and within the plain
    version's rounding elsewhere (``tools/nan_check.py``)."""
    from tpu_resnet_torch.tools import nan_check
    rows = [nan_check.check(case) for case in nan_check.cases()]
    assert len(rows) == 20
    bad = [row for row in rows if not row["ok"]]
    assert not bad, bad


@pytest.mark.parametrize("window", ["0:4", "2:7"])
def test_profiled_graphed_window_keeps_the_run(cuda, tmp_path, window):
    """``train.profile_steps`` on the graphed fused loop (chunks of 4): a
    window over the first chunk (warm-up and capture inside it) or across
    chunks; the losses and the end checkpoint bit for bit an unprofiled
    run's; ``trace-export --device-trace`` lays the capture's kernels,
    the fused block's among them, inside the ``profiler_trace`` span."""
    import json
    from tpu_resnet_torch.obs import trace
    from tpu_resnet_torch.train import checkpoint
    from tpu_resnet_torch.train.loop import train

    runs = {}
    for spec in ("", window):
        d = tmp_path / (spec.replace(":", "_") or "plain")
        cfg = load_config("cifar10", "", [
            "data.dataset=synthetic", "data.synthetic_learnable=true",
            "data.synthetic_train_examples=256", "model.resnet_size=14",
            "model.fused_blocks=true", "model.fused_epilogue=on",
            "optim.use_pallas_xent=on", "train.global_batch_size=16",
            "train.train_steps=8", "train.log_every=4",
            "train.checkpoint_every=8", "train.steps_per_call=4",
            f"train.profile_steps={spec}", f"train.train_dir={d}"])
        assert train(cfg, device="cuda").step == 8
        with open(d / "metrics.jsonl") as f:
            losses = [(r["step"], r["loss"]) for r in map(json.loads, f)]
        runs[spec] = (d, losses, checkpoint.restore(str(d), 8))
    (_, plain, a), (d, losses, b) = runs[""], runs[window]
    assert losses == plain
    for part in ("params", "batch_stats", "opt_state"):
        for n, t in a[part].items():
            assert torch.equal(t, b[part][n]), n
    got = trace.build_trace(str(d), device_trace=True)
    assert got["metadata"]["device_trace"]["device"] == "cuda"
    (span,) = [e for e in got["traceEvents"]
               if e["name"] == "profiler_trace"]
    dev = [e for e in got["traceEvents"] if e.get("cat") == "device"]
    assert all(span["ts"] <= e["ts"] and e["ts"] + e["dur"] <=
               span["ts"] + span["dur"] + 0.1 for e in dev)
    names = {e["name"] for e in dev}
    assert any("block_fwd_" in n for n in names)
    assert any("sbr_bwd_kernel" in n for n in names)
    assert trace.validate_trace(got) == []


# ------------------------------------------------ data parallelism
def _chip_smoke():
    """``chip_smoke.py``'s data_parallel parts (its spawned ranks import
    it by name, from the repository root)."""
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def test_nccl_world1_graphed_run_is_bit_equal(cuda):
    """Part (a): the fused CIFAR ResNet-50 through ``train()``, graphed,
    with an NCCL group of one rank open (its all-reduce captured in the
    step's graph, under NCCL's default error handling) equals the run
    without a group bit for bit, with the same launches."""
    cs = _chip_smoke()
    counters = cs.kernel_counters()
    alone = cs.chunk_arm("cifar10_fused_train", counters, cs.CHUNK_PER_CALL,
                         None, profiled=False)
    out = cs.nccl_world1_part(counters, "test", alone)
    assert out["bit_equal"]
    assert out["launches_per_step"] == out["launches_per_step_no_group"]


def test_gloo_ranks_on_one_card_match_plain(cuda, tmp_path):
    """Parts (b) and (c): two gloo ranks on the card. The fused
    per-replica step at 64 rows a rank within the fused step gates of its
    plain versions, its launches the one-card step's; the synced 2-rank
    step against the 1-rank step; zero1 against replicated within 1e-6
    (each checked inside the ranks: a failure raises there). Then their
    ``train()`` runs: the ranks end bit for bit equal, rank 0 alone wrote
    the run's files, and the synced zero1 run is held against 1-rank
    ``train()`` (``dp_train_check``: a failure raises)."""
    cs = _chip_smoke()
    ranks = cs.spawn_ranks(cs.gloo_rank, str(tmp_path))
    assert len(ranks) == cs.DP_RANKS
    for r in ranks:
        assert r["b"]["batch"] == cs.TRAIN_BATCH // cs.DP_RANKS
        assert r["c"]["zero1_vs_replicated_err_over_limit"] <= 1
    runs = cs.dp_train_check(ranks, str(tmp_path), cs.kernel_counters())
    assert all(run["ranks_bit_equal"] for run in runs.values())


# ------------------------------------------------------------ serve arms
def _plain_model_path(monkeypatch):
    monkeypatch.setattr(fb, "block_apply", fb.block_apply_reference)
    monkeypatch.setattr(fbn, "bottleneck_apply",
                        fbn.bottleneck_apply_reference)
    monkeypatch.setattr(ep, "scale_bias_relu", ep.scale_bias_relu_reference)


@pytest.mark.parametrize("preset, overrides, per_forward", [
    ("cifar10", ["model.resnet_size=14"],
     {"sbr": 7, "block_fwd": 3, "bottleneck_fwd": 0}),
    ("imagenet", ["data.image_size=64"],
     {"sbr": 19, "block_fwd": 0, "bottleneck_fwd": 10}),
], ids=["cifar10", "imagenet"])
@pytest.mark.parametrize("quantize", ["off", "int8"])
def test_exported_fused_artifact_launches_the_kernels(
        cuda, monkeypatch, tmp_path, preset, overrides, per_forward,
        quantize):
    """A fused artifact exported and loaded on the card launches the
    kernels from inside the program, each its count a forward, and serves
    the live model's logits through the plain versions (float32, within
    1e-3 of the largest)."""
    from tpu_resnet_torch.export import load_inference, save_inference
    from tpu_resnet_torch.serve.infer import make_serve_infer, serve_model

    cfg = load_config(preset, "", [
        "model.fused_blocks=true", "model.fused_epilogue=on",
        "model.compute_dtype=float32", f"serve.quantize={quantize}",
        *overrides])
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    calibration = {"digest": "", "act_max": {"input": 2.5}}
    save_inference(cfg, model.to(cuda), str(tmp_path),
                   calibration=calibration)
    bundle = load_inference(str(tmp_path), cuda)
    size = cfg.data.resolved_image_size
    gen = torch.Generator(device="cuda").manual_seed(3)
    images = torch.randint(0, 256, (5, size, size, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    counters = {"sbr": (ep, "launches"), "block_fwd": (fb, "launches"),
                "bottleneck_fwd": (fbn, "launches")}
    before = {k: getattr(m, a) for k, (m, a) in counters.items()}
    for _ in range(2):
        got = bundle.logits(images)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert {k: getattr(m, a) - before[k] for k, (m, a) in
            counters.items()} == {k: 2 * n for k, n in per_forward.items()}
    _plain_model_path(monkeypatch)
    want = make_serve_infer(cfg, cuda)(
        serve_model(cfg, model, cuda, act_max=2.5), images)
    assert float((got - want).abs().max()) <= 1e-3 * float(
        want.abs().max())


def test_int8_arm_kernels_match_the_plain_versions(cuda, monkeypatch):
    """The live int8 arm of fused CIFAR ResNet-14 on the card: through the
    kernels (sbr and block_fwd launched) and through the plain versions on
    the same dequantized weights, within 1e-3 of the largest logit."""
    from tpu_resnet_torch.ops import quant
    from tpu_resnet_torch.serve.infer import make_serve_infer, serve_model

    cfg = load_config("cifar10", "", [
        "model.fused_blocks=true", "model.fused_epilogue=on",
        "model.compute_dtype=float32", "model.resnet_size=14",
        "serve.quantize=int8"])
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(1))
    served = serve_model(cfg, model, cuda, act_max=2.0)
    assert isinstance(served, quant.QuantizedModel)
    infer = make_serve_infer(cfg, cuda)
    gen = torch.Generator(device="cuda").manual_seed(4)
    images = torch.randint(0, 256, (16, 32, 32, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    before = (ep.launches, fb.launches)
    got = infer(served, images)
    torch.cuda.synchronize()
    assert (ep.launches - before[0], fb.launches - before[1]) == (7, 3)
    _plain_model_path(monkeypatch)
    want = infer(served, images)
    assert float((got - want).abs().max()) <= 1e-3 * float(
        want.abs().max())


def test_fleet_replicas_behind_the_router_launch_the_kernels(cuda, tmp_path):
    """Two in-process replicas of fused ImageNet ResNet-50 on the card
    behind the port's router, a process of its own (``route``): every
    answer through the router is 200, both replicas answer, and the
    ``bottleneck_fwd`` and ``sbr`` launches are 10 and 19 times the
    forwards the replicas' ``/metrics`` report (``chip_smoke.py``'s fleet
    phase, part (a))."""
    import json
    import signal
    import subprocess
    import sys
    import time
    import urllib.request

    import numpy as np

    from tpu_resnet_torch.hostenv import REPO_ROOT, child_env
    from tpu_resnet_torch.obs.server import parse_prometheus
    from tpu_resnet_torch.serve.router import read_route_port
    from tpu_resnet_torch.serve.server import PredictServer, write_discovery
    from tpu_resnet_torch.train import checkpoint

    d = str(tmp_path)
    over = ["model.fused_blocks=true", "model.fused_epilogue=on",
            "serve.host=127.0.0.1", "serve.port=0", "serve.max_batch=4",
            f"train.train_dir={d}"]
    cfg = load_config("imagenet", "", over)
    checkpoint.save(d, 1, init_weights(build_model(cfg),
                                       torch.Generator().manual_seed(0)))
    servers = []
    router = subprocess.Popen(
        [sys.executable, "-m", "tpu_resnet_torch", "route",
         f"route.discover_dir={d}", "route.host=127.0.0.1", "route.port=0",
         "route.probe_interval_secs=0.2"], env=child_env(), cwd=REPO_ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        for name in ("r0", "r1"):
            servers.append(PredictServer(load_config(
                "imagenet", "", over + [f"serve.replica_name={name}"]),
                device="cuda").start())
            write_discovery(d, servers[-1].port, name=name)

        def get(port, path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=30) as r:
                return r.read()

        deadline = time.monotonic() + 60
        while True:
            port = read_route_port(d)
            info = json.loads(get(port, "/info")) if port else {}
            if sum(r["state"] == "closed"
                   for r in info.get("replicas", [])) == 2:
                break
            assert time.monotonic() < deadline, info
            time.sleep(0.2)

        def batches():
            return sum(parse_prometheus(get(s.port, "/metrics").decode())[
                "tpu_resnet_serve_batches_total"] for s in servers)

        rng = np.random.default_rng(0)
        before, launches = batches(), (fbn.launches, ep.launches)
        answered = set()
        for i in range(12):
            im = rng.integers(0, 256, (1 + 3 * (i % 2), 224, 224, 3),
                              dtype=np.uint8)
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=im.tobytes(),
                headers={"Content-Type": "application/octet-stream",
                         "X-Shape": ",".join(map(str, im.shape))})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200
                answered.add(r.headers["X-Replica"])
                assert json.loads(r.read())["count"] == im.shape[0]
        forwards = batches() - before
        assert answered == {"r0", "r1"} and forwards > 0
        assert (fbn.launches - launches[0], ep.launches - launches[1]) == (
            10 * forwards, 19 * forwards)
    finally:
        router.send_signal(signal.SIGTERM)
        assert router.wait(timeout=30) == 0
        for s in servers:
            s.drain(timeout=30)
            s.close()
