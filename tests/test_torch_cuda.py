"""The port's CUDA kernels against their plain versions on the card. These
need a CUDA card and skip without one; on a GPU machine run

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 32, 32, 16), (5, 16, 16, 32),
                                   (2, 8, 8, 64), (1, 7, 5, 16)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 32, 32, 16), (3, 5, 7, 24)])
def test_sbr_kernel_matches_plain(cuda, shape, dtype):
    gen = torch.Generator(device="cuda").manual_seed(1)
    x, _, (s, b, _, _) = _inputs(shape, dtype, gen)
    before = ep.launches
    got = ep.scale_bias_relu(x, s, b)
    want = ep.scale_bias_relu_reference(x, s, b)
    torch.cuda.synchronize()
    assert ep.launches == before + 1
    # Same roundings as the plain version.
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


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
                                   (3, 7, 7, 512), (16, 28, 28, 512),
                                   (16, 14, 14, 1024)])
def test_bottleneck_fwd_kernel_matches_plain(cuda, shape, dtype):
    """The three ResNet-50 stage shapes at B=2 (bands of one row), ragged
    bands at odd sizes, and B=16 at stages 2 and 3 (bands of four and two
    rows on an H100)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    args = _bottleneck_inputs(shape, dtype, gen)
    before = fbn.launches
    got = fbn.bottleneck_fwd(*args)
    want = fbn.bottleneck_fwd_reference(*args)
    torch.cuda.synchronize()
    assert fbn.launches == before + 1
    # f32: another summation order than cuBLAS/cuDNN; bf16: one stored ulp.
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 32, 32, 16), (128, 16, 16, 32),
                                   (128, 8, 8, 64), (3, 5, 7, 24),
                                   (1, 1, 1, 8)])
def test_sbr_bwd_kernel_matches_plain(cuda, shape, dtype):
    """The three CIFAR train shapes, a ragged one (C/N not a power of two)
    and a single pixel."""
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
    again = ep.scale_bias_relu_bwd(x, s, b, g)
    assert all(torch.equal(p, q) for p, q in zip((dx, ds, db), again))


@pytest.mark.parametrize("shape", [(128, 10), (128, 100), (128, 1000),
                                   (5, 33), (1, 1)])
def test_xent_kernels_match_plain(cuda, shape):
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, c = shape
    logits = torch.randn(shape, generator=gen, device="cuda") * 3
    labels = torch.randint(0, c, (b,), generator=gen, device="cuda")
    g = torch.rand(b, generator=gen, device="cuda")
    before = (sx.fwd_launches, sx.bwd_launches)
    loss = sx.softmax_xent_per_example(logits, labels)
    dx = sx.softmax_xent_bwd(logits, labels, g)
    torch.cuda.synchronize()
    assert (sx.fwd_launches, sx.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    torch.testing.assert_close(
        loss, sx.softmax_xent_per_example_reference(logits, labels),
        atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(
        dx, sx.softmax_xent_bwd_reference(logits, labels, g),
        atol=1e-5, rtol=1e-5)


def test_xent_autograd_runs_both_kernels(cuda):
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
                                   (5, 8, 8, 64), (2, 7, 5, 16)])
def test_block_train_kernels_match_plain(cuda, shape, dtype):
    """block_stats and the three backward passes at the three widths, a
    single image, odd batches and a ragged plane; each called twice."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    x, gy, w1, w2, vecs = _block_train_inputs(shape, dtype, gen)
    with torch.backends.cudnn.flags(enabled=False):   # exact on the grid
        t = fb.train_bwd_pass1_reference(x, gy, w1, w2, *vecs)[:2]
        u = fb.train_bwd_pass2_reference(x, gy, w1, w2, *vecs, *t)[:2]
    cases = (("stats_launches", (x, w1, vecs[0], vecs[1]), fb.block_stats,
              fb.block_stats_reference),
             ("bwd1_launches", (x, gy, w1, w2, *vecs), fb.block_bwd1,
              fb.train_bwd_pass1_reference),
             ("bwd2_launches", (x, gy, w1, w2, *vecs, *t), fb.block_bwd2,
              fb.train_bwd_pass2_reference))
    for counter, args, kernel, plain in cases:
        before = getattr(fb, counter)
        got, again = kernel(*args), kernel(*args)
        with torch.backends.cudnn.flags(enabled=False):
            want = plain(*args)
            scale = plain(*args, magnitudes=True)
        torch.cuda.synchronize()
        assert getattr(fb, counter) == before + 2
        _sums_close(got, want, scale)
        assert all(torch.equal(p, q) for p, q in zip(got, again))
    before = fb.bwd3_launches
    dx, again = (fb.block_bwd3(x, gy, w1, w2, *vecs, *t, *u)
                 for _ in range(2))
    with torch.backends.cudnn.flags(enabled=False):
        want = fb.train_bwd_pass3_reference(x, gy, w1, w2, *vecs, *t, *u)
    torch.cuda.synchronize()
    assert fb.bwd3_launches == before + 2 and dx.dtype == dtype
    assert torch.equal(dx, again)
    # block_fwd's tolerance: f32 sums in another order; bf16 one ulp.
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(dx.float(), want.float(), atol=tol, rtol=tol)


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
        fb.block_bwd2(x, gy, w1, w2, *vecs, vecs[0][:8], vecs[0])
    with pytest.raises(ValueError, match="gy must be float32"):
        fb.block_bwd3(x, gy.to(torch.bfloat16), w1, w2, *vecs, *vecs[:4])
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
                                   (2, 14, 14, 1024), (1, 9, 5, 256)])
def test_bottleneck_train_kernels_match_plain(cuda, shape, dtype):
    """The two moment passes and the four backward passes at the three
    ResNet-50 stage shapes and a ragged one; each called twice."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    x, gy, w1, w2, w3, vecs = _bottleneck_train_inputs(shape, dtype, gen)
    base = (x, gy, w1, w2, w3, *vecs)
    with torch.backends.cudnn.flags(enabled=False):   # exact on the grid
        t3 = fbn.train_bwd_pass1_reference(*base)[:2]
        t2 = fbn.train_bwd_pass2_reference(*base, *t3)[:2]
        t1 = fbn.train_bwd_pass3_reference(*base, *t3, *t2)[:2]
    cases = (("stats_a_launches", (x, w1, *vecs[:4]), fbn.bottleneck_stats_a,
              fbn.bottleneck_stats_a_reference),
             ("stats_b_launches", (x, w1, w2, *vecs[:8]),
              fbn.bottleneck_stats_b, fbn.bottleneck_stats_b_reference),
             ("bwd1_launches", base, fbn.bottleneck_bwd1,
              fbn.train_bwd_pass1_reference),
             ("bwd2_launches", (*base, *t3), fbn.bottleneck_bwd2,
              fbn.train_bwd_pass2_reference),
             ("bwd3_launches", (*base, *t3, *t2), fbn.bottleneck_bwd3,
              fbn.train_bwd_pass3_reference))
    for counter, args, kernel, plain in cases:
        before = getattr(fbn, counter)
        got, again = kernel(*args), kernel(*args)
        with torch.backends.cudnn.flags(enabled=False):
            want = plain(*args)
            scale = plain(*args, magnitudes=True)
        torch.cuda.synchronize()
        assert getattr(fbn, counter) == before + 2, counter
        _sums_close(got, want, scale)
        assert all(torch.equal(p, q) for p, q in zip(got, again)), counter
    before = fbn.bwd4_launches
    args = (*base, *t3, *t2, *t1)
    dx, again = fbn.bottleneck_bwd4(*args), fbn.bottleneck_bwd4(*args)
    with torch.backends.cudnn.flags(enabled=False):
        want = fbn.train_bwd_pass4_reference(*args)
    torch.cuda.synchronize()
    assert fbn.bwd4_launches == before + 2 and dx.dtype == dtype
    assert torch.equal(dx, again)
    # bottleneck_fwd's tolerance: f32 sums in another order; bf16 one ulp.
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(dx.float(), want.float(), atol=tol, rtol=tol)


def test_bottleneck_train_wrappers_reject_bad_input(cuda):
    gen = torch.Generator(device="cuda").manual_seed(12)
    x, gy, w1, w2, w3, vecs = _bottleneck_train_inputs(
        (2, 8, 8, 256), torch.float32, gen)
    with pytest.raises(ValueError, match="contiguous"):
        fbn.bottleneck_stats_a(x.permute(0, 2, 1, 3), w1, *vecs[:4])
    with pytest.raises(ValueError, match="w3 must be float32"):
        fbn.bottleneck_bwd1(x, gy, w1, w2, w3[:, :8], *vecs)
    with pytest.raises(ValueError, match="t3a must be float32"):
        fbn.bottleneck_bwd2(x, gy, w1, w2, w3, *vecs, vecs[0], vecs[4])
    with pytest.raises(ValueError, match="gy must be float32"):
        fbn.bottleneck_bwd4(x, gy.to(torch.bfloat16), w1, w2, w3, *vecs,
                            *vecs[4:8], *vecs[:2])
    with pytest.raises(ValueError, match="kernels for f"):
        fbn.bottleneck_stats_a(torch.zeros(2, 8, 8, 128, device="cuda"),
                               torch.zeros(128, 32, device="cuda"),
                               *(torch.ones(128, device="cuda"),) * 4)


def test_imagenet_fused_train_step_launches(cuda):
    """One bf16 step of ImageNet ResNet-50 at 64x64 through the loop's step:
    each of the seven bottleneck kernels 10 times, a finite loss."""
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
    names = ("launches", "stats_a_launches", "stats_b_launches",
             "bwd1_launches", "bwd2_launches", "bwd3_launches",
             "bwd4_launches")
    before = [getattr(fbn, n) for n in names]
    m = make_loop_step(cfg, cuda)(state, images, labels)
    torch.cuda.synchronize()
    assert [getattr(fbn, n) - b for n, b in zip(names, before)] == [10] * 7
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 32, 32, 16), (3, 16, 16, 32),
                                   (5, 8, 8, 64), (2, 7, 5, 16)])
def test_block_bwd_kernel_matches_plain(cuda, shape, dtype):
    """The folded block's gradient at the three widths and a ragged plane,
    on the dyadic grid (the gammas and betas as the folded scales and
    biases, so c1 and the masks are exact); called twice."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    x, gy, w1, w2, vecs = _block_train_inputs(shape, dtype, gen)
    args = (x, gy, w1, w2, *vecs[:4])
    before = fb.bwd_launches
    got, again = fb.block_bwd(*args), fb.block_bwd(*args)
    with torch.backends.cudnn.flags(enabled=False):
        want = fb.block_bwd_reference(*args)
        scale = fb.block_bwd_reference(*args, magnitudes=True)
    torch.cuda.synchronize()
    assert fb.bwd_launches == before + 2
    _bwd_close(got, again, want, scale, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 56, 56, 256), (2, 28, 28, 512),
                                   (2, 14, 14, 1024), (1, 9, 5, 256)])
def test_bottleneck_bwd_kernel_matches_plain(cuda, shape, dtype):
    """The folded bottleneck's gradient at the three ResNet-50 stage shapes
    and a ragged one, on the dyadic grid: s1 = γ1, s2 = 1/σ2 (1/8 or 1/4,
    so mid stays exact), s3 = γ3 and the betas as biases; called twice."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    x, gy, w1, w2, w3, v = _bottleneck_train_inputs(shape, dtype, gen)
    args = (x, gy, w1, w2, w3, v[0], v[1], v[7], v[5], v[8], v[9])
    before = fbn.bwd_launches
    got, again = fbn.bottleneck_bwd(*args), fbn.bottleneck_bwd(*args)
    with torch.backends.cudnn.flags(enabled=False):
        want = fbn.bottleneck_bwd_reference(*args)
        scale = fbn.bottleneck_bwd_reference(*args, magnitudes=True)
    torch.cuda.synchronize()
    assert fbn.bwd_launches == before + 2
    _bwd_close(got, again, want, scale, dtype)


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
