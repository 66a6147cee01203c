"""The ResNet-v2 bottleneck block as one fused kernel, forward with folded BN:

    y = x + W3 · relu(s3 * conv3x3(relu(s2 * (W1 · relu(s1 * x + b1)) + b2))
                      + b3)

for stride 1 and an identity shortcut, the 3x3 SAME, all arithmetic in
float32 and y stored in x's dtype, as in
``tpu_resnet/ops/fused_bottleneck.py::_fwd_kernel``. x and y are NHWC
[B,H,W,4f]; the 1x1 kernels are matrices, W1 [4f,f] and W3 [f,4f], the 3x3
is HWIO [3,3,f,f], all float32; the folded BN scale/bias pairs are float32
[4f], [f], [f].

:func:`bottleneck_fwd` launches the CUDA kernel (``csrc/fused_bottleneck.cu``)
for a CUDA tensor and raises if it cannot; for a CPU tensor it computes the
plain version, :func:`bottleneck_fwd_reference`. ``launches`` counts the
kernel launches.
"""

from __future__ import annotations

import torch

from tpu_resnet_torch.ops import _build
from tpu_resnet_torch.ops.epilogue import scale_bias_relu_math
from tpu_resnet_torch.ops.fused_block import _conv3x3

launches = 0  # kernel launches by bottleneck_fwd (CUDA tensors only)

WIDTHS = (64, 128, 256)  # the kernel's compiled bottleneck widths f
_SMEM_LIMIT = 232448     # bytes of shared memory one H100 block may use
_THREADS, _KC = 256, 32  # csrc/fused_bottleneck.cu kThreads, kKC


def _fold_bn(g, be, mean, inv):
    """Inference BN as an affine, with ``inv`` = rsqrt(var + eps): (scale,
    bias), rounded as the reference's bottleneck fold rounds them."""
    return g * inv, be - mean * g * inv


def bottleneck_fwd_reference(x, w1, w2, w3, s1, b1, s2, b2, s3, b3):
    """Plain PyTorch version (float32 einsum and ``F.conv2d``): the CPU path,
    the tests' and the chip smoke's oracle."""
    xf = x.float()
    p1 = scale_bias_relu_math(xf, s1, b1)
    c1 = torch.einsum("bhwc,cf->bhwf", p1, w1.float())
    p2 = scale_bias_relu_math(c1, s2, b2)
    p3 = scale_bias_relu_math(_conv3x3(p2, w2.float()), s3, b3)
    r = torch.einsum("bhwf,fc->bhwc", p3, w3.float())
    return (xf + r).to(x.dtype)


def smem_bytes(w: int, f: int, rows: int) -> int:
    """Shared memory the kernel takes for a band of ``rows`` output rows of
    width ``w``: p2 with its halo, p3 (or the reduce's two staged chunks of
    relu(s1*x+b1)), and two staged weight chunks, all float32."""
    bm = 4 * _THREADS * 8 // f
    return 4 * ((rows + 2) * (w + 2) * f + max(rows * w * f, 2 * bm * _KC)
                + 2 * _KC * f)


def _check(x, w1, w2, w3, s1, b1, s2, b2, s3, b3) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B,H,W,4f], got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    f = w1.shape[-1] if w1.dim() == 2 else -1
    c4 = x.shape[-1]
    if c4 != 4 * f:
        raise ValueError(f"x has {c4} channels, w1 {tuple(w1.shape)}: "
                         f"need x [B,H,W,4f] and w1 [4f,f]")
    for name, t, shape in (("w1", w1, (c4, f)), ("w2", w2, (3, 3, f, f)),
                           ("w3", w3, (f, c4)), ("s1", s1, (c4,)),
                           ("b1", b1, (c4,)), ("s2", s2, (f,)),
                           ("b2", b2, (f,)), ("s3", s3, (f,)),
                           ("b3", b3, (f,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {list(shape)}, got "
                             f"{t.dtype} {list(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def bottleneck_fwd(x, w1, w2, w3, s1, b1, s2, b2, s3, b3) -> torch.Tensor:
    """Fused v2 bottleneck forward: x [B,H,W,4f] float32/bfloat16; w1 [4f,f],
    w2 [3,3,f,f], w3 [f,4f] float32; s1, b1 [4f], s2, b2, s3, b3 [f] float32
    (folded BN). On CUDA, f must be one of :data:`WIDTHS`. Returns the block
    output in x's dtype."""
    global launches
    args = (x, w1, w2, w3, s1, b1, s2, b2, s3, b3)
    _check(*args)
    if x.device.type == "cpu":
        return bottleneck_fwd_reference(*args)
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck_fwd runs on cpu or cuda, not "
                         f"{x.device}")
    b, h, w, c4 = x.shape
    f = c4 // 4
    if f not in WIDTHS:
        raise ValueError(f"fused bottleneck has kernels for f in {WIDTHS}, "
                         f"got {f}")
    if smem_bytes(w, f, 1) > _SMEM_LIMIT:
        raise ValueError(f"fused bottleneck at width {w}, f={f} needs "
                         f"{smem_bytes(w, f, 1)} bytes of shared memory, "
                         f"more than {_SMEM_LIMIT}")
    names = ("x", "w1", "w2", "w3", "s1", "b1", "s2", "b2", "s3", "b3")
    for name, t in zip(names, args):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    y = torch.empty_like(x)
    fn = _build.library("fused_bottleneck").tr_bottleneck_fwd
    err = fn(*(t.data_ptr() for t in args), y.data_ptr(), b, h, w, f,
             _build.DTYPE_CODES[x.dtype], x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bottleneck_fwd")
    launches += 1
    return y
