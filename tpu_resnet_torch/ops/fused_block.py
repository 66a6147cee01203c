"""The ResNet-v2 basic block as one fused kernel, forward with folded BN:

    y = x + conv2(relu(s2 * conv1(relu(s1 * x + b1)) + b2))

for stride 1 and equal in/out channels, 3x3 SAME convs, all arithmetic in
float32 and y stored in x's dtype, as in
``tpu_resnet/ops/fused_block.py::_block_kernel``. x and y are NHWC, the
weights HWIO [3,3,C,C] float32, the folded BN scale/bias float32 [C].

:func:`block_fwd` launches the CUDA kernel (``csrc/fused_block.cu``) for
a CUDA tensor and raises if it cannot; for a CPU tensor it computes the
plain version, :func:`block_fwd_reference`. ``launches`` counts the kernel
launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_resnet_torch.ops import _build
from tpu_resnet_torch.ops.epilogue import scale_bias_relu_math

launches = 0  # kernel launches by block_fwd (CUDA tensors only)

CHANNELS = (16, 32, 64)  # the kernel's compiled widths
_SMEM_LIMIT = 232448     # bytes of shared memory one H100 block may use


def _fold(gamma, beta, mean, var, eps):
    """Inference BN as an affine: (scale, bias)."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def _conv3x3(x_nhwc: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x_nhwc.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1)


def block_fwd_reference(x, w1, w2, s1, b1, s2, b2) -> torch.Tensor:
    """Plain PyTorch version (``F.conv2d`` in float32): the CPU path, the
    tests' and the chip smoke's oracle."""
    xf = x.float()
    mid = _conv3x3(scale_bias_relu_math(xf, s1, b1), w1.float())
    out = _conv3x3(scale_bias_relu_math(mid, s2, b2), w2.float())
    return (xf + out).to(x.dtype)


def smem_bytes(h: int, w: int, c: int) -> int:
    """Shared memory the kernel takes for one image: two zero-haloed f32
    planes with a pixel stride of C+1 words."""
    return 2 * (h + 2) * (w + 2) * (c + 1) * 4


def _check(x, w1, w2, s1, b1, s2, b2) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B,H,W,C], got shape {tuple(x.shape)}")
    _, h, w, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if c not in CHANNELS:
        raise ValueError(f"fused block has kernels for C in {CHANNELS}, "
                         f"got {c}")
    if smem_bytes(h, w, c) > _SMEM_LIMIT:
        raise ValueError(f"fused block at {h}x{w}x{c} needs "
                         f"{smem_bytes(h, w, c)} bytes of shared memory, "
                         f"more than {_SMEM_LIMIT}")
    for name, t, shape in (("w1", w1, (3, 3, c, c)), ("w2", w2, (3, 3, c, c)),
                           ("s1", s1, (c,)), ("b1", b1, (c,)),
                           ("s2", s2, (c,)), ("b2", b2, (c,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {list(shape)}, got "
                             f"{t.dtype} {list(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def block_fwd(x, w1, w2, s1, b1, s2, b2) -> torch.Tensor:
    """Fused v2 basic-block forward: x [B,H,W,C] float32/bfloat16 with C in
    :data:`CHANNELS`; w1, w2 [3,3,C,C] float32; s1, b1, s2, b2 [C] float32
    (folded BN). Returns x + conv2(relu(sb2(conv1(relu(sb1(x)))))) in x's
    dtype."""
    global launches
    _check(x, w1, w2, s1, b1, s2, b2)
    if x.device.type == "cpu":
        return block_fwd_reference(x, w1, w2, s1, b1, s2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"block_fwd runs on cpu or cuda, not {x.device}")
    args = (x, w1, w2, s1, b1, s2, b2)
    for name, t in zip(("x", "w1", "w2", "s1", "b1", "s2", "b2"), args):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w1.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("w1 and w2 must be 16-byte aligned")
    b, h, w, c = x.shape
    y = torch.empty_like(x)
    fn = _build.library("fused_block").tr_block_fwd
    err = fn(*(t.data_ptr() for t in args), y.data_ptr(), b, h, w, c,
             _build.DTYPE_CODES[x.dtype], x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "block_fwd")
    launches += 1
    return y
