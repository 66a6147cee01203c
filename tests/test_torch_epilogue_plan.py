"""The BN+ReLU epilogue's launch plan on the CPU: ``sbr_plan`` and the
kernel's index map (``_vectors`` below, the map of ``tr_sbr`` in
``csrc/epilogue.cu`` written out) cover every 16-byte vector of x exactly
once, at small ragged shapes (enumerated) and at the ResNet-50 site shapes
(counted); the wrapper's refusals; and the cross-entropy wrappers' int64
labels and broadcast cotangent against the reference. The kernels
themselves are held against their plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.ops import softmax_xent as jax_sx
from tpu_resnet_torch.ops import epilogue as ep
from tpu_resnet_torch.ops import softmax_xent as sx

H100_SMS = 132
DTYPES = [torch.float32, torch.bfloat16]


def _vpp(c, dtype):
    return c * torch.tensor([], dtype=dtype).element_size() // 16


def _vectors(plan, pixels, block, thread):
    """The (pixel, vector) pairs that ``tr_sbr``'s thread ``thread`` (= r ·
    vs + v) of block ``block`` (= bx · slices + slice) loads and stores
    under ``plan``, in its order."""
    bx, slice_ = divmod(block, plan.slices)
    r, v = divmod(thread, plan.vs)
    rows = plan.threads // plan.vs
    chunk = rows * plan.unroll
    for p0 in range(bx * chunk + r, pixels, plan.nbx * chunk):
        for u in range(plan.unroll):
            if p0 + u * rows >= pixels:
                break
            yield p0 + u * rows, slice_ * plan.vs + v


def _check_plan(plan, shape, dtype, sms):
    """What every plan keeps: slices that tile a pixel's vectors, whole
    rows of threads within a block's 256, a kernel variant that exists,
    and at most SBR_WAVES waves of SBR_BLOCKS_PER_SM blocks an SM."""
    vpp = _vpp(shape[-1], dtype)
    assert plan.vs * plan.slices == vpp
    assert plan.threads % plan.vs == 0
    assert plan.vs <= plan.threads <= ep.SBR_THREADS
    assert plan.unroll in ep.SBR_UNROLLS
    wave = sms * ep.SBR_BLOCKS_PER_SM
    assert 1 <= plan.nbx <= 65535
    assert plan.nbx * plan.slices <= max(
        plan.slices, -(-wave * ep.SBR_WAVES // plan.slices) * plan.slices)


# C in {8, 16, 24, 64, 2048}; pixel counts that are not a multiple of a
# chunk (rows * unroll), a single pixel; a small SM count makes each block
# stride over several chunks.
_SMALL = [((b, h, w, c), sms)
          for c in (8, 16, 24, 64, 2048)
          for (b, h, w) in ((1, 1, 1), (3, 5, 7), (2, 9, 9), (1, 33, 1))
          for sms in (H100_SMS, 3)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape, sms", _SMALL)
def test_sbr_index_map_covers_each_vector_once(shape, sms, dtype):
    plan = ep.sbr_plan(shape, dtype, sms)
    _check_plan(plan, shape, dtype, sms)
    pixels, vpp = int(np.prod(shape[:-1])), _vpp(shape[-1], dtype)
    seen = np.zeros((pixels, vpp), np.int64)
    for block in range(plan.nbx * plan.slices):
        for thread in range(plan.threads):
            steps = list(_vectors(plan, pixels, block, thread))
            # A thread keeps one vector (its s and b) over all its pixels.
            assert len({v for _, v in steps}) <= 1
            for p, v in steps:
                seen[p, v] += 1
    assert (seen == 1).all()


def _site_shapes():
    """The 14 BN+ReLU site shapes of the four paths' models (ResNet-50 on
    ImageNet at 224² and on CIFAR-10), at B=16 and B=128."""
    hwc = [(56, 56, 64), (56, 56, 256), (56, 56, 128), (28, 28, 128),
           (28, 28, 512), (28, 28, 256), (14, 14, 256), (14, 14, 1024),
           (14, 14, 512), (7, 7, 512), (7, 7, 2048),
           (32, 32, 16), (16, 16, 32), (8, 8, 64)]
    return [(b, *s) for b in (16, 128) for s in hwc]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", _site_shapes())
def test_sbr_plan_counts_each_vector_once_at_the_sites(shape, dtype):
    """Counted, not enumerated: a block's threads (r, v) at steps u cover
    the offsets u*rows + r of a chunk once each; the blocks bx, bx + nbx,
    ... of a slice visit every chunk once; the chunks tile the pixels."""
    plan = ep.sbr_plan(shape, dtype, H100_SMS)
    _check_plan(plan, shape, dtype, H100_SMS)
    pixels = int(np.prod(shape[:-1]))
    rows = plan.threads // plan.vs
    chunk = rows * plan.unroll
    offsets = np.add.outer(np.arange(plan.unroll) * rows,
                           np.arange(rows)).ravel()
    assert np.array_equal(np.sort(offsets), np.arange(chunk))
    chunks = -(-pixels // chunk)
    visits = np.zeros(chunks, np.int64)
    for bx in range(plan.nbx):
        visits[bx::plan.nbx] += 1
    assert (visits == 1).all()
    sizes = np.minimum(chunk, pixels - np.arange(chunks) * chunk)
    assert sizes.min() > 0 and sizes.sum() * plan.vs * plan.slices == (
        pixels * _vpp(shape[-1], dtype))
    # The SMs fill: a block on every SM where the tensor has that many
    # chunks of one vector a thread, and a full wave where it has that
    # many chunks; four vectors a thread at B=128 on the ImageNet planes of
    # 28² and more (PERF.md §6).
    most = -(-pixels // (ep.SBR_MIN_THREADS // plan.vs or 1)) * plan.slices
    assert plan.nbx * plan.slices >= min(H100_SMS, most)
    assert plan.nbx * plan.slices >= min(
        chunks * plan.slices, H100_SMS * ep.SBR_BLOCKS_PER_SM)
    if shape[0] == 128 and shape[1] >= 28 and shape[3] >= 64:
        assert plan.unroll == 4


def test_sbr_index_map_matches_a_hand_worked_plan():
    """(1, 1, 3, 16) bf16: two vectors a pixel, one slice of both, one
    vector in flight, the fewest threads (32 rows of 2); thread 3 is vector
    1 of pixel 1."""
    plan = ep.sbr_plan((1, 1, 3, 16), torch.bfloat16, H100_SMS)
    assert plan == ep.SbrPlan(vs=2, slices=1, threads=64, unroll=1, nbx=1)
    assert list(_vectors(plan, 3, 0, 3)) == [(1, 1)]
    assert list(_vectors(plan, 3, 0, 6)) == []


@pytest.mark.parametrize("bad", ["rank", "dtype", "int_dtype", "channels",
                                 "scale_shape", "bias_shape", "scale_dtype",
                                 "scale_device", "bias_device"])
def test_sbr_wrapper_refusals(bad):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 3, 3, 16)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.5, 1.5, 16).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    if bad == "rank":
        x = x[0]
    elif bad == "dtype":
        x = x.half()
    elif bad == "int_dtype":
        x = x.int()
    elif bad == "channels":
        x, s, b = x[..., :12].contiguous(), s[:12], b[:12]
    elif bad == "scale_shape":
        s = s[:8]
    elif bad == "bias_shape":
        b = torch.cat([b, b])
    elif bad == "scale_dtype":
        s = s.double()
    elif bad == "scale_device":
        s = s.to("meta")
    else:
        b = b.to("meta")
    before = ep.launches
    with pytest.raises(ValueError):
        ep.scale_bias_relu(x, s, b)
    assert ep.launches == before


# ------------------------------------------------------ cross-entropy
def _xent_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    b, c = shape
    return ((rng.normal(size=shape) * 3).astype(np.float32),
            rng.integers(0, c, b).astype(np.int32),
            rng.uniform(size=b).astype(np.float32))


@pytest.mark.parametrize("shape", [(16, 10), (8, 100), (8, 1000)])
def test_xent_mean_gradient_with_int64_labels_matches_reference(shape):
    """The mean loss's gradient with int64 labels, one out of range (it
    gathers 0), against the reference's custom VJP in interpret mode."""
    x, y, _ = _xent_inputs(shape, seed=10)
    y[1] = shape[1] + 3
    want = jax.grad(lambda a: jax_sx.softmax_xent_mean(
        a, jnp.asarray(y), interpret=True))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    sx.softmax_xent_mean(t, torch.from_numpy(y).long()).backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("shape", [(128, 10), (5, 33), (1, 1)])
def test_xent_wrappers_take_strided_labels_and_a_broadcast_cotangent(shape):
    """int64 and strided labels and a stride-0 cotangent give what int32
    labels and a contiguous cotangent give (the kernels read both as they
    lie)."""
    x, y, g = _xent_inputs(shape, seed=11)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    strided = torch.stack([yt.long(), yt.long()], 1)[:, 0]
    assert strided.stride(0) == 2
    loss = sx.softmax_xent_per_example(xt, yt)
    for lab in (yt.long(), strided):
        assert torch.equal(sx.softmax_xent_per_example(xt, lab), loss)
    one = torch.tensor(float(g[0]))
    broadcast = one.expand(shape[0])
    assert broadcast.stride(0) == 0
    want = sx.softmax_xent_bwd(xt, yt, torch.full((shape[0],), float(g[0])))
    assert torch.equal(sx.softmax_xent_bwd(xt, strided, broadcast), want)
