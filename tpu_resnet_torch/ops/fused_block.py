"""The ResNet-v2 basic block as fused kernels: the forward with folded BN
and its gradient, and the training forward and backward with live batch
statistics.

Forward with folded BN (``tpu_resnet/ops/fused_block.py::_block_kernel``):

    y = x + conv2(relu(s2 * conv1(relu(s1 * x + b1)) + b2))

for stride 1 and equal in/out channels, 3x3 SAME convs, all arithmetic in
float32 and y stored in x's dtype. x and y are NHWC, the weights HWIO
[3,3,C,C] float32, the folded BN scale/bias float32 [C]. :func:`block_fwd`
launches the CUDA kernel (``csrc/fused_block.cu``) for a CUDA tensor and
raises if it cannot; for a CPU tensor it computes the plain version,
:func:`block_fwd_reference`. ``launches`` counts the kernel launches.

Its gradient (``_block_bwd_kernel``, ``csrc/fused_block_train.cu``
``tr_block_bwd``): :func:`block_bwd` → (dx, dw1, dw2, ds1, db1, ds2, db2)
from x, gy (float32) and the parameters, recomputing the chain; one pass,
no batch-wide sum before dx, since folded BN has none.
:func:`block_apply` is the differentiable folded block (the reference's
custom-VJP ``block_apply``): forward :func:`block_fwd`, backward
:func:`block_bwd`, saving only x and the parameters.

Training (port of the reference's ``block_train_fwd`` and
``_train_bwd_calls``, ``csrc/fused_block_train.cu``):

- :func:`block_train_fwd`: BN1's moments of x in plain PyTorch (mean and
  the two-pass biased variance), folded; :func:`block_stats` gives the sums
  of conv1's output c1, finished into BN2's moments (single-pass variance
  clamped at 0); then :func:`block_fwd` with both folds. Returns ``(y,
  (mean1, var1, mean2, var2))``.
- the backward, three passes from x, gy (float32) and the saved moments:
  :func:`block_bwd1` → (T1, T2, dw2), :func:`block_bwd2` → (U1, U2, dw1),
  :func:`block_bwd3` → dx; dγ2 = T2, dβ2 = T1, dγ1 = U2, dβ1 = U1.
- :func:`block_train_apply` is differentiable in x, both weights and the
  four BN parameters; the moments it returns get no gradient (the running
  statistics' EMA is stop-gradient).

Each wrapper launches its kernel for CUDA tensors, computes its plain
version (``*_reference``) for CPU tensors and raises otherwise, and counts
its launches (``stats_launches``, ``bwd1_launches``, ``bwd2_launches``,
``bwd3_launches``, ``bwd_launches``). The plain versions keep float64
inputs in float64 (the gradient check); every other input computes in
float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tpu_resnet_torch.ops import _build
from tpu_resnet_torch.ops.epilogue import scale_bias_relu_math

launches = 0       # kernel launches by block_fwd (CUDA tensors only)
stats_launches = 0  # block_stats calls (two launches each: sums, their sum)
bwd1_launches = 0   # block_bwd1 calls (two launches each)
bwd2_launches = 0   # block_bwd2 calls (two launches each)
bwd3_launches = 0   # block_bwd3 launches
bwd_launches = 0    # block_bwd calls (two launches each)

CHANNELS = (16, 32, 64)  # the kernels' compiled widths
_SMEM_LIMIT = 232448     # bytes of shared memory one H100 block may use
EPS = 1e-5
_SUM_DIMS = (0, 1, 2)


def _fold(gamma, beta, mean, var, eps):
    """Inference BN as an affine: (scale, bias)."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def _fp(t: torch.Tensor) -> torch.Tensor:
    """float32, or float64 for a float64 tensor."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _conv3x3(x_nhwc: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x_nhwc.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1)


def _conv3x3_t(d: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """The transposed SAME 3x3 conv: taps over the spatially flipped,
    IO-swapped weights (the gradient of :func:`_conv3x3` in its input)."""
    return _conv3x3(d, w_hwio.flip(0, 1).transpose(2, 3))


def _wgrad(r: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """dw[ky,kx,ci,co] = Σ over (b,y,x) of r_pad[b,y+ky,x+kx,ci]·d[b,y,x,co]
    (the gradient of :func:`_conv3x3` in its weights, HWIO)."""
    _, h, w, _ = r.shape
    rp = F.pad(r, (0, 0, 1, 1, 1, 1))
    return torch.stack([
        torch.einsum("bhwi,bhwo->io", rp[:, ky:ky + h, kx:kx + w], d)
        for ky in range(3) for kx in range(3)]).unflatten(0, (3, 3))


def _n(x) -> float:
    """B*H*W: the pixels each channel's batch statistic is taken over."""
    return float(x.shape[0] * x.shape[1] * x.shape[2])


def _mag(magnitudes: bool):
    return torch.abs if magnitudes else (lambda t: t)


def block_fwd_reference(x, w1, w2, s1, b1, s2, b2) -> torch.Tensor:
    """Plain PyTorch version (``F.conv2d`` in float32): the CPU path, the
    tests' and the chip smoke's oracle."""
    xf = _fp(x)
    mid = _conv3x3(scale_bias_relu_math(xf, s1, b1), w1.to(xf.dtype))
    out = _conv3x3(scale_bias_relu_math(mid, s2, b2), w2.to(xf.dtype))
    return (xf + out).to(x.dtype)


def smem_bytes(h: int, w: int, c: int, kind: str = "block_fwd") -> int:
    """Shared memory one image takes in a kernel: zero-haloed f32 planes
    with a pixel stride of C+1 words (two for block_fwd and the backward
    passes, one for block_stats), block_bwd1 and block_bwd one unpadded
    plane more, and at least the 32 KB of the channel-sum reduction."""
    plane = (h + 2) * (w + 2) * (c + 1) * 4
    if kind == "block_fwd":
        return 2 * plane
    extra = (h * w * (c + 1) * 4 if kind in ("block_bwd1", "block_bwd")
             else 0)
    return max((1 if kind == "block_stats" else 2) * plane + extra,
               2 * 512 * 8 * 4)


def _check_x(x, kind: str) -> int:
    if x.dim() != 4:
        raise ValueError(f"{kind}: x must be [B,H,W,C], got shape "
                         f"{tuple(x.shape)}")
    _, h, w, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kind}: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if c not in CHANNELS:
        raise ValueError(f"fused block has kernels for C in {CHANNELS}, "
                         f"got {c}")
    need = smem_bytes(h, w, c, kind)
    if need > _SMEM_LIMIT:
        raise ValueError(f"{kind} at {h}x{w}x{c} needs {need} bytes of "
                         f"shared memory, more than {_SMEM_LIMIT}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kind} runs on cpu or cuda, not {x.device}")
    return c


def _check_f32(kind: str, x, **tensors) -> None:
    """Each named tensor float32 on x's device with its shape: [3,3,C,C]
    for weights, x's shape for gy, else [C]."""
    c = x.shape[-1]
    for name, t in tensors.items():
        shape = ((3, 3, c, c) if name in ("w1", "w2")
                 else tuple(x.shape) if name == "gy" else (c,))
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{kind}: {name} must be float32 {list(shape)}, "
                             f"got {t.dtype} {list(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{kind}: {name} is on {t.device}, x on "
                             f"{x.device}")


def _launch(kind: str, library: str, symbol: str, x, *tensors) -> None:
    """CUDA-side checks, then the C entry point ``symbol`` of ``library``
    with the tensors' pointers and x's shape, dtype, device and stream."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{kind}: every tensor must be contiguous")
        if t.shape[:2] == (3, 3) and t.data_ptr() % 16:
            raise ValueError(f"{kind}: w1 and w2 must be 16-byte aligned")
    b, h, w, c = x.shape
    fn = getattr(_build.library(library), symbol)
    err = fn(*(t.data_ptr() for t in tensors), b, h, w, c,
             _build.DTYPE_CODES[x.dtype], x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, kind)


def _sums_out(x, extra: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(partial rows [B, 2C+extra], their sum [2C+extra]) on x's device."""
    b, c = x.shape[0], x.shape[-1]
    return (torch.empty(b, 2 * c + extra, dtype=torch.float32,
                        device=x.device),
            torch.empty(2 * c + extra, dtype=torch.float32, device=x.device))


def block_fwd(x, w1, w2, s1, b1, s2, b2) -> torch.Tensor:
    """Fused v2 basic-block forward: x [B,H,W,C] float32/bfloat16 with C in
    :data:`CHANNELS`; w1, w2 [3,3,C,C] float32; s1, b1, s2, b2 [C] float32
    (folded BN). Returns x + conv2(relu(sb2(conv1(relu(sb1(x)))))) in x's
    dtype."""
    global launches
    _check_x(x, "block_fwd")
    _check_f32("block_fwd", x, w1=w1, w2=w2, s1=s1, b1=b1, s2=s2, b2=b2)
    if x.device.type == "cpu":
        return block_fwd_reference(x, w1, w2, s1, b1, s2, b2)
    y = torch.empty_like(x)
    _launch("block_fwd", "fused_block", "tr_block_fwd", x, x, w1, w2, s1,
            b1, s2, b2, y)
    launches += 1
    return y


# ------------------------------------------------------- its gradient
def block_bwd_reference(x, gy, w1, w2, s1, b1, s2, b2, *,
                        magnitudes: bool = False):
    """Plain version of :func:`block_bwd`, the reference's
    ``_block_bwd_kernel``: (dx in x's dtype, dw1, dw2, ds1, db1, ds2, db2).
    ``magnitudes``: each sum and weight gradient of |term| instead (the
    scale of the card's tolerance)."""
    f = _mag(magnitudes)
    xf = _fp(x)
    gyf = _fp(gy)
    w1f, w2f = w1.to(xf.dtype), w2.to(xf.dtype)
    a1 = xf * s1 + b1
    r1 = torch.clamp_min(a1, 0.0)
    c1 = _conv3x3(r1, w1f)
    a2 = c1 * s2 + b2
    r2 = torch.clamp_min(a2, 0.0)
    da2 = torch.where(a2 > 0, _conv3x3_t(gyf, w2f), 0.0)
    dc1 = da2 * s2
    da1 = torch.where(a1 > 0, _conv3x3_t(dc1, w1f), 0.0)
    dx = (gyf + da1 * s1).to(x.dtype)
    return (dx, _wgrad(r1, f(dc1)), _wgrad(r2, f(gyf)),
            (f(da1) * f(xf)).sum(_SUM_DIMS), f(da1).sum(_SUM_DIMS),
            (f(da2) * f(c1)).sum(_SUM_DIMS), f(da2).sum(_SUM_DIMS))


def block_bwd(x, gy, w1, w2, s1, b1, s2, b2):
    """The gradient of :func:`block_fwd` given gy = dL/dy: (dx in x's dtype,
    dw1, dw2 [3,3,C,C], ds1, db1, ds2, db2 [C] float32). Arguments as
    :func:`block_fwd`; gy [B,H,W,C] is taken in float32 (exact from
    bfloat16)."""
    global bwd_launches
    gy = _fp(gy).contiguous()
    c = _check_x(x, "block_bwd")
    _check_f32("block_bwd", x, gy=gy, w1=w1, w2=w2, s1=s1, b1=b1, s2=s2,
               b2=b2)
    if x.device.type == "cpu":
        return block_bwd_reference(x, gy, w1, w2, s1, b1, s2, b2)
    part, out = _sums_out(x, 2 * c + 18 * c * c)
    dx = torch.empty_like(x)
    _launch("block_bwd", "fused_block_train", "tr_block_bwd", x, x, gy, w1,
            w2, s1, b1, s2, b2, part, out, dx)
    bwd_launches += 1
    k = 4 * c + 9 * c * c
    return (dx, out[4 * c:k].view(3, 3, c, c), out[k:].view(3, 3, c, c),
            out[:c], out[c:2 * c], out[2 * c:3 * c], out[3 * c:4 * c])


class _BlockApply(torch.autograd.Function):
    """The folded-BN block with the reference's custom VJP; ``plain``
    picks the plain versions on any device (the chip smoke's oracle), else
    the kernels."""

    @staticmethod
    def forward(ctx, x, w1, w2, s1, b1, s2, b2, plain: bool):
        ctx.save_for_backward(x, w1, w2, s1, b1, s2, b2)
        ctx.plain = plain
        fwd = block_fwd_reference if plain else block_fwd
        return fwd(x, w1, w2, s1, b1, s2, b2)

    @staticmethod
    def backward(ctx, gy):
        bwd = block_bwd_reference if ctx.plain else block_bwd
        x, *params = ctx.saved_tensors
        return (*bwd(x, gy, *params), None)


def block_apply(x, w1, w2, s1, b1, s2, b2):
    """Differentiable fused block with folded BN: :func:`block_fwd`, and
    :func:`block_bwd` for its gradient in x and all six parameters."""
    return _BlockApply.apply(x, w1, w2, s1, b1, s2, b2, False)


def block_apply_reference(x, w1, w2, s1, b1, s2, b2):
    """:func:`block_apply` through the plain versions on any device."""
    return _BlockApply.apply(x, w1, w2, s1, b1, s2, b2, True)


# ------------------------------------------------------- conv1's moments
def block_stats_reference(x, w1, s1, b1, *, magnitudes: bool = False):
    """Plain version of :func:`block_stats`: (Σc1, Σc1²) over (B, H, W),
    c1 = conv3x3(relu(s1·x + b1), w1). ``magnitudes``: Σ|c1| in place of
    Σc1 (the scale of the card's tolerance on the sums)."""
    xf = _fp(x)
    c1 = _conv3x3(scale_bias_relu_math(xf, s1, b1), w1.to(xf.dtype))
    return _mag(magnitudes)(c1).sum(_SUM_DIMS), (c1 * c1).sum(_SUM_DIMS)


def block_stats(x, w1, s1, b1):
    """(Σc1, Σc1²) float32 [C] of conv1's output c1 = conv3x3(relu(s1·x +
    b1), w1), recomputed and never stored (the reference's
    ``_stats_kernel``). x [B,H,W,C] float32/bfloat16; w1 [3,3,C,C], s1, b1
    [C] float32."""
    global stats_launches
    c = _check_x(x, "block_stats")
    _check_f32("block_stats", x, w1=w1, s1=s1, b1=b1)
    if x.device.type == "cpu":
        return block_stats_reference(x, w1, s1, b1)
    part, out = _sums_out(x, 0)
    _launch("block_stats", "fused_block_train", "tr_block_stats",
            x, x, w1, s1, b1, part, out)
    stats_launches += 1
    return out[:c], out[c:]


def _finish_moments(s, ss, n):
    """Mean and single-pass biased variance from the sums; the variance is
    clamped at 0, where float32 cancellation can push it below."""
    mean = s / n
    return mean, torch.clamp_min(ss / n - mean * mean, 0.0)


def c1_moments(x, w1, s1, b1):
    """BN2's batch moments (mean, var) of c1 from :func:`block_stats`, as
    the reference's ``_c1_moments``."""
    return _finish_moments(*block_stats(x, w1, s1, b1), _n(x))


def c1_moments_reference(x, w1, s1, b1):
    """Plain version of :func:`c1_moments`."""
    return _finish_moments(*block_stats_reference(x, w1, s1, b1), _n(x))


# ------------------------------------------------------- the forward
def _train_fwd(moments2, fwd, x, w1, w2, g1, b1, g2, b2, eps):
    xf = _fp(x)
    mean1 = xf.mean(dim=_SUM_DIMS)
    var1 = xf.var(dim=_SUM_DIMS, correction=0)
    s1, sb1 = _fold(g1, b1, mean1, var1, eps)
    mean2, var2 = moments2(x, w1, s1, sb1)
    s2, sb2 = _fold(g2, b2, mean2, var2, eps)
    return fwd(x, w1, w2, s1, sb1, s2, sb2), (mean1, var1, mean2, var2)


def block_train_fwd(x, w1, w2, g1, b1, g2, b2, eps: float = EPS):
    """Fused v2 basic block with live batch statistics (training BN, biased
    variance): ``(y, (mean1, var1, mean2, var2))``. x [B,H,W,C]
    float32/bfloat16; w1, w2 [3,3,C,C], gammas and betas [C] float32."""
    return _train_fwd(c1_moments, block_fwd, x, w1, w2, g1, b1, g2, b2, eps)


def block_train_fwd_reference(x, w1, w2, g1, b1, g2, b2, eps: float = EPS):
    """Plain version of :func:`block_train_fwd`."""
    return _train_fwd(c1_moments_reference, block_fwd_reference, x, w1, w2,
                      g1, b1, g2, b2, eps)


# ------------------------------------------------------- the backward
def _recompute(x, w1, g1, b1, g2, b2, m1, i1, m2, i2):
    """The forward chain from the block input and the saved moments (i =
    1/σ), as the reference's ``_recompute_train``."""
    xf = _fp(x)
    z1hat = (xf - m1) * i1
    z1 = g1 * z1hat + b1
    r1 = torch.clamp_min(z1, 0.0)
    c1 = _conv3x3(r1, w1.to(xf.dtype))
    z2hat = (c1 - m2) * i2
    z2 = g2 * z2hat + b2
    return z1, z1hat, r1, z2, z2hat, torch.clamp_min(z2, 0.0)


def _dz2(z2, gy, w2):
    return torch.where(z2 > 0, _conv3x3_t(gy, w2.to(gy.dtype)), 0.0)


def _dc1(z2, z2hat, gy, w2, g2, i2, t1, t2, n):
    return g2 * i2 * (_dz2(z2, gy, w2) - t1 / n - z2hat * (t2 / n))


def train_bwd_pass1_reference(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2,
                              *, magnitudes: bool = False):
    """Plain version of :func:`block_bwd1`: (T1 = Σdz2, T2 = Σdz2·ẑ2,
    dw2 = Σ r2-patchᵀ·gy). ``magnitudes``: each sum of |term| instead."""
    f = _mag(magnitudes)
    _, _, _, z2, z2hat, r2 = _recompute(x, w1, g1, b1, g2, b2, m1, i1, m2,
                                        i2)
    gyf = _fp(gy)
    dz2 = f(_dz2(z2, gyf, w2))
    return (dz2.sum(_SUM_DIMS), (dz2 * f(z2hat)).sum(_SUM_DIMS),
            _wgrad(r2, f(gyf)))


def _dz1(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2, t1, t2):
    z1, z1hat, r1, z2, z2hat, _ = _recompute(x, w1, g1, b1, g2, b2, m1, i1,
                                             m2, i2)
    gyf = _fp(gy)
    dc1 = _dc1(z2, z2hat, gyf, w2, g2, i2, t1, t2, _n(x))
    dz1 = torch.where(z1 > 0, _conv3x3_t(dc1, w1.to(dc1.dtype)), 0.0)
    return dz1, z1hat, r1, dc1, gyf


def train_bwd_pass2_reference(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2,
                              t1, t2, *, magnitudes: bool = False):
    """Plain version of :func:`block_bwd2`: (U1 = Σdz1, U2 = Σdz1·ẑ1,
    dw1 = Σ r1-patchᵀ·dc1). ``magnitudes``: each sum of |term| instead."""
    f = _mag(magnitudes)
    dz1, z1hat, r1, dc1, _ = _dz1(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2,
                                  i2, t1, t2)
    return (f(dz1).sum(_SUM_DIMS), (f(dz1) * f(z1hat)).sum(_SUM_DIMS),
            _wgrad(r1, f(dc1)))


def train_bwd_pass3_reference(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2,
                              t1, t2, u1, u2):
    """Plain version of :func:`block_bwd3`: dx in x's dtype."""
    dz1, z1hat, _, _, gyf = _dz1(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2,
                                 i2, t1, t2)
    n = _n(x)
    return (gyf + g1 * i1 * (dz1 - u1 / n - z1hat * (u2 / n))).to(x.dtype)


_VECS = ("g1", "b1", "g2", "b2", "m1", "i1", "m2", "i2", "t1", "t2", "u1",
         "u2")


def _check_bwd(kind, x, gy, w1, w2, vecs) -> int:
    c = _check_x(x, kind)
    _check_f32(kind, x, gy=gy, w1=w1, w2=w2, **dict(zip(_VECS, vecs)))
    return c


def block_bwd1(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2):
    """Backward pass 1 (the reference's ``_train_bwd_calls`` pass1): (T1,
    T2 [C], dw2 [3,3,C,C]) float32. x [B,H,W,C] float32/bfloat16, gy the
    same shape in float32, the weights and the eight BN vectors float32;
    m, i are the saved means and 1/σ."""
    global bwd1_launches
    vecs = (g1, b1, g2, b2, m1, i1, m2, i2)
    c = _check_bwd("block_bwd1", x, gy, w1, w2, vecs)
    if x.device.type == "cpu":
        return train_bwd_pass1_reference(x, gy, w1, w2, *vecs)
    part, out = _sums_out(x, 9 * c * c)
    _launch("block_bwd1", "fused_block_train", "tr_block_bwd1",
            x, x, gy, w1, w2, *vecs, part,
            out)
    bwd1_launches += 1
    return out[:c], out[c:2 * c], out[2 * c:].view(3, 3, c, c)


def block_bwd2(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2, t1, t2):
    """Backward pass 2: (U1, U2 [C], dw1 [3,3,C,C]) float32, given pass
    1's T1, T2; arguments as :func:`block_bwd1`."""
    global bwd2_launches
    vecs = (g1, b1, g2, b2, m1, i1, m2, i2, t1, t2)
    c = _check_bwd("block_bwd2", x, gy, w1, w2, vecs)
    if x.device.type == "cpu":
        return train_bwd_pass2_reference(x, gy, w1, w2, *vecs)
    part, out = _sums_out(x, 9 * c * c)
    _launch("block_bwd2", "fused_block_train", "tr_block_bwd2",
            x, x, gy, w1, w2, *vecs, part,
            out)
    bwd2_launches += 1
    return out[:c], out[c:2 * c], out[2 * c:].view(3, 3, c, c)


def block_bwd3(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2, t1, t2, u1,
               u2):
    """Backward pass 3: dx in x's dtype, given T1, T2 and pass 2's U1,
    U2; arguments as :func:`block_bwd1`."""
    global bwd3_launches
    vecs = (g1, b1, g2, b2, m1, i1, m2, i2, t1, t2, u1, u2)
    _check_bwd("block_bwd3", x, gy, w1, w2, vecs)
    if x.device.type == "cpu":
        return train_bwd_pass3_reference(x, gy, w1, w2, *vecs)
    dx = torch.empty_like(x)
    _launch("block_bwd3", "fused_block_train", "tr_block_bwd3",
            x, x, gy, w1, w2, *vecs, dx)
    bwd3_launches += 1
    return dx


def _train_bwd(passes, x, gy, w1, w2, g1, b1, g2, b2, moments, eps):
    p1, p2, p3 = passes
    m1, v1, m2, v2 = moments
    i1, i2 = torch.rsqrt(v1 + eps), torch.rsqrt(v2 + eps)
    gyf = _fp(gy).contiguous()
    vecs = (g1, b1, g2, b2, m1, i1, m2, i2)
    t1, t2, dw2 = p1(x, gyf, w1, w2, *vecs)
    u1, u2, dw1 = p2(x, gyf, w1, w2, *vecs, t1, t2)
    dx = p3(x, gyf, w1, w2, *vecs, t1, t2, u1, u2)
    # dγ2 = T2, dβ2 = T1, dγ1 = U2, dβ1 = U1: the correction sums.
    return dx, dw1, dw2, u2, u1, t2, t1


def block_train_bwd(x, gy, w1, w2, g1, b1, g2, b2, moments,
                    eps: float = EPS):
    """The three passes: (dx, dw1, dw2, dγ1, dβ1, dγ2, dβ2) given gy =
    dL/dy and the forward's moments."""
    return _train_bwd((block_bwd1, block_bwd2, block_bwd3), x, gy, w1, w2,
                      g1, b1, g2, b2, moments, eps)


def block_train_bwd_reference(x, gy, w1, w2, g1, b1, g2, b2, moments,
                              eps: float = EPS):
    """Plain version of :func:`block_train_bwd`."""
    return _train_bwd((train_bwd_pass1_reference, train_bwd_pass2_reference,
                       train_bwd_pass3_reference), x, gy, w1, w2, g1, b1, g2,
                      b2, moments, eps)


class _BlockTrain(torch.autograd.Function):
    """The live-BN block with the reference's custom VJP; ``plain`` picks
    the plain versions on any device (the chip smoke's oracle), else the
    kernels."""

    @staticmethod
    def forward(ctx, x, w1, w2, g1, b1, g2, b2, eps: float, plain: bool):
        fwd = block_train_fwd_reference if plain else block_train_fwd
        y, moments = fwd(x, w1, w2, g1, b1, g2, b2, eps)
        ctx.save_for_backward(x, w1, w2, g1, b1, g2, b2, *moments)
        ctx.eps, ctx.plain = eps, plain
        ctx.mark_non_differentiable(*moments)
        return (y, *moments)

    @staticmethod
    def backward(ctx, gy, *_moment_grads):
        x, w1, w2, g1, b1, g2, b2, *moments = ctx.saved_tensors
        bwd = block_train_bwd_reference if ctx.plain else block_train_bwd
        return (*bwd(x, gy, w1, w2, g1, b1, g2, b2, moments, ctx.eps),
                None, None)


def block_train_apply(x, w1, w2, g1, b1, g2, b2, eps: float = EPS):
    """Differentiable live-BN fused block: ``(y, (mean1, var1, mean2,
    var2))``, through the kernels on CUDA and the plain versions on the
    CPU."""
    y, *moments = _BlockTrain.apply(x, w1, w2, g1, b1, g2, b2, eps, False)
    return y, tuple(moments)


def block_train_apply_reference(x, w1, w2, g1, b1, g2, b2,
                                eps: float = EPS):
    """:func:`block_train_apply` through the plain versions on any device."""
    y, *moments = _BlockTrain.apply(x, w1, w2, g1, b1, g2, b2, eps, True)
    return y, tuple(moments)
