"""The port's CUDA kernels against their plain versions on the card. These
need a CUDA card and skip without one; on a GPU machine run

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from tpu_resnet_torch.device import resolve_device
from tpu_resnet_torch.ops import epilogue as ep
from tpu_resnet_torch.ops import fused_block as fb
from tpu_resnet_torch.ops import fused_bottleneck as fbn

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


def test_kernels_reject_strided_input(cuda):
    gen = torch.Generator(device="cuda").manual_seed(2)
    x, (w1, w2), (s1, b1, s2, b2) = _inputs((2, 8, 8, 16), torch.float32,
                                            gen)
    strided = x.permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ep.scale_bias_relu(strided, s1, b1)
    with pytest.raises(ValueError, match="contiguous"):
        fb.block_fwd(strided, w1, w2, s1, b1, s2, b2)
    args = list(_bottleneck_inputs((2, 8, 8, 256), torch.float32, gen))
    args[0] = args[0].permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fbn.bottleneck_fwd(*args)
