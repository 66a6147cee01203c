"""The ResNet-v2 basic block as fused kernels: the forward with folded BN
and its gradient, and the training forward and backward with live batch
statistics.

Forward with folded BN (``tpu_resnet/ops/fused_block.py::_block_kernel``):

    y = x + conv2(relu(s2 * conv1(relu(s1 * x + b1)) + b2))

for stride 1 and equal in/out channels, 3x3 SAME convs, all arithmetic in
float32 and y stored in x's dtype. x and y are NHWC, the weights HWIO
[3,3,C,C] float32, the folded BN scale/bias float32 [C]. :func:`block_fwd`
launches the CUDA kernel (``csrc/fused_block_tc.cu``: from x two launches,
r2 to a scratch, then conv2 and the residual; given ``c1=``, the training
forward's, one launch, conv2 over relu(s2·c1 + b2) and the residual) for a
CUDA tensor and raises if it cannot; for a CPU tensor it computes the plain
version, :func:`block_fwd_reference`. ``launches`` counts its calls on the
card.

Its gradient (``_block_bwd_kernel``): :func:`block_bwd` → (dx, dw1, dw2,
ds1, db1, ds2, db2) from x, gy (float32) and the parameters, in two steps
that are the live-BN passes 1 and 2 below with the folds as BN (γ, β, μ,
1/σ) = (s, b, 0, 1) and no batch-wide correction (``csrc/fused_block_tc.cu``
modes 5 and 6): :func:`folded_bwd1` → (db2, ds2, dw2, dc1 = s2·da2),
:func:`folded_bwd2` (``dc1=``, step 1's) → (db1, ds1, dw1, dx = gy +
s1·da1). :func:`block_apply` is the differentiable folded block (the
reference's custom-VJP ``block_apply``): forward :func:`block_fwd`,
backward :func:`block_bwd`, saving only x and the parameters.

Training (port of the reference's ``block_train_fwd`` and
``_train_bwd_calls``; ``csrc/fused_block_tc.cu``):

- :func:`block_train_fwd`: BN1's moments of x in plain PyTorch (mean and
  the two-pass biased variance), folded; :func:`block_stats` gives the sums
  of conv1's output c1, finished into BN2's moments (single-pass variance
  clamped at 0), and c1 itself; then :func:`block_fwd` with both folds from
  that c1 (``c1=``), which runs conv2 alone: c1 is computed once, where the
  reference's ``_block_kernel`` computes it again. Returns ``(y, (mean1,
  var1, mean2, var2))``.
- the backward, three passes from x, gy (float32) and the saved moments:
  :func:`block_bwd1` → (T1, T2, dw2, dz2, ẑ2), :func:`block_bwd2`
  (``dz2=``, ``z2hat=``, pass 1's) → (U1, U2, dw1, dz1), :func:`block_bwd3`
  (``dz1=``, pass 2's) → dx; dγ2 = T2, dβ2 = T1, dγ1 = U2, dβ1 = U1. Each
  pass reads what the pass before it wrote instead of recomputing the chain
  from x, as the reference's passes do: c1 and the mask [z2 > 0] are
  computed once, in pass 1.
- :func:`block_train_apply` is differentiable in x, both weights and the
  four BN parameters; the moments it returns get no gradient (the running
  statistics' EMA is stop-gradient).

Each wrapper launches its kernel for CUDA tensors, computes its plain
version (``*_reference``) for CPU tensors and raises otherwise, and counts
its calls on the card (``stats_launches``, ``bwd1_launches``,
``bwd2_launches``, ``bwd3_launches``, ``bwd_launches``). The plain versions
keep float64 inputs in float64 (the gradient check); every other input
computes in float32.

Widths: the kernels take C in :data:`CHANNELS`. At C in
:data:`TAP_CHANNELS` the tile passes of passes 1 and 2 and of the folded
steps take their weight gradients themselves; at C = 128 and 256 (the
ImageNet ResNet-18/34 stages) they write their sums alone and each takes
one call of ``ops/wgrad.py`` for dw2 or dw1 (:func:`_wide_wgrad`, counted
in ``wgrad.launches``: two launches, the product on ``wgmma`` and the sum
of its splits). :func:`reference_fuses` is the
reference's plan test, which says where a model fuses a basic block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_resnet_torch.ops import _build, wgrad
from tpu_resnet_torch.ops.wgrad import shifted_reference as _shifted
from tpu_resnet_torch.ops.epilogue import scale_bias_relu_math

launches = 0        # block_fwd calls (CUDA tensors only; two launches each,
                    # one with c1=)
stats_launches = 0  # block_stats calls (two launches each: c1 and the
                    # tiles' sums, their sum)
bwd1_launches = 0   # block_bwd1 calls (two launches each; four at C = 128
                    # and 256, dw2 apart)
bwd2_launches = 0   # block_bwd2 calls (three launches each; five at C = 128
                    # and 256, dw1 apart)
bwd3_launches = 0   # block_bwd3 calls (one launch each)
bwd_launches = 0    # block_bwd calls (four launches each: its two steps;
                    # eight at C = 128 and 256, with two weight gradients)

CHANNELS = (16, 32, 64, 128, 256)  # the kernels' compiled widths
TAP_CHANNELS = (16, 32, 64)   # widths whose tile passes take dw themselves
EPS = 1e-5
# The reference's plan budget (tpu_resnet/ops/fused_block.py
# auto_batch_tile): a basic block fuses where both 3x3 weights and one batch
# row of four float32 slabs fit in it.
PLAN_BUDGET_BYTES = 10 * 2 ** 20
_SUM_DIMS = (0, 1, 2)


def reference_fuses(shape) -> bool:
    """Whether the reference fuses a stride-1 basic block whose input is
    ``shape`` (B, H, W, C): its ``auto_batch_tile`` finds a plan, i.e. the
    weights (2·9·C²·4 bytes) and one batch row (H·W·C·4 bytes, four
    slabs) fit in 10 MB. The reference's ``BlockLayer`` probes the stage
    shape that block0 leaves and keeps the stage unfused where no plan
    fits (the 7²×512 ImageNet stage: its weights alone are 18.9 MB). A copy
    of its arithmetic; the CUDA plans are the port's own."""
    _, h, w, c = shape
    weight_bytes = 2 * 9 * c * c * 4
    per_row = h * w * c * 4 * 4
    return PLAN_BUDGET_BYTES - weight_bytes >= per_row


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


def _n(x) -> float:
    """B*H*W: the pixels each channel's batch statistic is taken over."""
    return float(x.shape[0] * x.shape[1] * x.shape[2])


def _mag(magnitudes: bool):
    return torch.abs if magnitudes else (lambda t: t)


def _c1(xf, w1, s1, b1) -> torch.Tensor:
    """conv1's output c1 = conv3x3(relu(s1·x + b1), w1) of the float x."""
    return _conv3x3(scale_bias_relu_math(xf, s1, b1), w1.to(xf.dtype))


def block_fwd_reference(x, w1, w2, s1, b1, s2, b2, *, c1=None
                        ) -> torch.Tensor:
    """Plain PyTorch version (``F.conv2d`` in float32): the CPU path, the
    tests' and the chip smoke's oracle. ``c1``: conv1's output of the same
    x, w1, s1, b1 (:func:`block_stats_reference`'s), used in place of
    computing it."""
    xf = _fp(x)
    mid = _c1(xf, w1, s1, b1) if c1 is None else c1
    out = _conv3x3(scale_bias_relu_math(mid, s2, b2), w2.to(xf.dtype))
    return (xf + out).to(x.dtype)


def _check_x(x, kind: str) -> int:
    if x.dim() != 4:
        raise ValueError(f"{kind}: x must be [B,H,W,C], got shape "
                         f"{tuple(x.shape)}")
    c = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kind}: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if c not in CHANNELS:
        raise ValueError(f"fused block has kernels for C in {CHANNELS}, "
                         f"got {c}")
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


def block_fwd(x, w1, w2, s1, b1, s2, b2, *, c1=None) -> torch.Tensor:
    """Fused v2 basic-block forward: x [B,H,W,C] float32/bfloat16 with C in
    :data:`CHANNELS`; w1, w2 [3,3,C,C] float32; s1, b1, s2, b2 [C] float32
    (folded BN). Returns x + conv2(relu(sb2(conv1(relu(sb1(x)))))) in x's
    dtype. ``c1``: conv1's output of this x, w1, s1, b1, float32
    [B,H,W,C] contiguous (:func:`block_stats`'s, the training forward's
    handoff); then only conv2 runs, one launch on the card."""
    global launches
    _check_x(x, "block_fwd")
    _check_f32("block_fwd", x, w1=w1, w2=w2, s1=s1, b1=b1, s2=s2, b2=b2)
    if c1 is not None:
        _check_handoff("block_fwd", "c1", c1, x)
    if x.device.type == "cpu":
        return block_fwd_reference(x, w1, w2, s1, b1, s2, b2, c1=c1)
    y = torch.empty_like(x)
    # The folds go in BN's (g1, b1, g2, b2) places; from x, r2 is the first
    # launch's output, read by the second.
    handoff = {"c1": c1} if c1 is not None else {"r2": _f32_like(x)}
    _tc("block_fwd", x, w1=w1, w2=w2, g1=s1, b1=b1, g2=s2, b2=b2, y=y,
        **handoff)
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
    return (dx, _shifted(r1, f(dc1)), _shifted(r2, f(gyf)),
            (f(da1) * f(xf)).sum(_SUM_DIMS), f(da1).sum(_SUM_DIMS),
            (f(da2) * f(c1)).sum(_SUM_DIMS), f(da2).sum(_SUM_DIMS))


def folded_bwd1_reference(x, gy, w1, w2, s1, b1, s2, b2):
    """Plain version of :func:`folded_bwd1`: (db2 = Σda2, ds2 = Σda2·c1,
    dw2 = Σ r2-patchᵀ·gy, dc1 = s2·da2 [B,H,W,C] contiguous), da2 =
    convT(gy, w2)·[a2 > 0], a2 = c1·s2 + b2, each rounded as
    :func:`block_bwd_reference` rounds it."""
    xf, gyf = _fp(x), _fp(gy)
    c1 = _c1(xf, w1, s1, b1)
    a2 = c1 * s2 + b2
    da2 = torch.where(a2 > 0, _conv3x3_t(gyf, w2.to(xf.dtype)), 0.0)
    return (da2.sum(_SUM_DIMS), (da2 * c1).sum(_SUM_DIMS),
            _shifted(torch.clamp_min(a2, 0.0), gyf), (da2 * s2).contiguous())


def folded_bwd2_reference(x, gy, w1, w2, s1, b1, s2, b2, *, dc1):
    """Plain version of :func:`folded_bwd2`, from step 1's ``dc1``: (db1 =
    Σda1, ds1 = Σda1·x, dw1 = Σ r1-patchᵀ·dc1, dx = gy + da1·s1 in x's
    dtype), da1 = convT(dc1, w1)·[a1 > 0], a1 = x·s1 + b1."""
    xf = _fp(x)
    a1 = xf * s1 + b1
    da1 = torch.where(a1 > 0, _conv3x3_t(dc1, w1.to(xf.dtype)), 0.0)
    return (da1.sum(_SUM_DIMS), (da1 * xf).sum(_SUM_DIMS),
            _shifted(torch.clamp_min(a1, 0.0), dc1),
            (_fp(gy) + da1 * s1).to(x.dtype))


def _check_folded(kind, x, gy, w1, w2, s1, b1, s2, b2) -> int:
    c = _check_x(x, kind)
    _check_f32(kind, x, gy=gy, w1=w1, w2=w2, s1=s1, b1=b1, s2=s2, b2=b2)
    return c


def folded_bwd1(x, gy, w1, w2, s1, b1, s2, b2):
    """The folded gradient's step 1: (db2, ds2 [C], dw2 [3,3,C,C], dc1
    [B,H,W,C]) float32; dc1 is step 2's input. Arguments as
    :func:`block_bwd`, gy float32. On CUDA, two launches of
    ``csrc/fused_block_tc.cu`` (mode 5, :func:`block_bwd1`'s tile pass on
    the folds): c1, the convT of gy, da2, the sums, dw2 and dc1 over tiles
    of pixels on the tensor cores (:func:`block_fwd`'s plan), then the sum
    of the rows; at C = 128 and 256 the tile pass also writes c1 and takes
    no dw2, which :func:`_wide_wgrad` computes from that c1 (two more
    launches)."""
    c = _check_folded("folded_bwd1", x, gy, w1, w2, s1, b1, s2, b2)
    if x.device.type == "cpu":
        return folded_bwd1_reference(x, gy, w1, w2, s1, b1, s2, b2)
    out = torch.empty(_sums_len("folded_bwd1", c), dtype=torch.float32,
                      device=x.device)
    dc1 = _f32_like(x)
    wide = c not in TAP_CHANNELS
    c1 = {"z2hat": _f32_like(x)} if wide else {}
    _tc("folded_bwd1", x, gy=gy, w1=w1, w2=w2, g1=s1, b1=b1, g2=s2, b2=b2,
        dc1=dc1, out=out, **c1)
    dw2 = (_wide_wgrad("folded_bwd1", c1["z2hat"], gy, x, (s2, b2))
           if wide else None)
    return (*_split_sums(out, c, dw2), dc1)


def folded_bwd2(x, gy, w1, w2, s1, b1, s2, b2, *, dc1):
    """The folded gradient's step 2: (db1, ds1 [C], dw1 [3,3,C,C] float32,
    dx in x's dtype), given ``dc1=``, step 1's dc1 (required: no path
    recomputes it); arguments as :func:`folded_bwd1`. On CUDA, two launches
    of ``csrc/fused_block_tc.cu`` (mode 6, :func:`block_bwd2`'s tile pass on
    the folds): da1, the sums, dw1 and dx, then the sum of the rows; at C =
    128 and 256 the tile pass takes no dw1, which :func:`_wide_wgrad`
    computes from x and dc1 (two more launches)."""
    c = _check_folded("folded_bwd2", x, gy, w1, w2, s1, b1, s2, b2)
    _check_handoff("folded_bwd2", "dc1", dc1, x)
    if x.device.type == "cpu":
        return folded_bwd2_reference(x, gy, w1, w2, s1, b1, s2, b2, dc1=dc1)
    out = torch.empty(_sums_len("folded_bwd2", c), dtype=torch.float32,
                      device=x.device)
    dx = torch.empty_like(x)
    _tc("folded_bwd2", x, gy=gy, w1=w1, g1=s1, b1=b1, dc1=dc1, dx=dx,
        out=out)
    dw1 = (None if c in TAP_CHANNELS
           else _wide_wgrad("folded_bwd2", x, dc1, x, (s1, b1)))
    return (*_split_sums(out, c, dw1), dx)


def block_bwd(x, gy, w1, w2, s1, b1, s2, b2):
    """The gradient of :func:`block_fwd` given gy = dL/dy: (dx in x's dtype,
    dw1, dw2 [3,3,C,C], ds1, db1, ds2, db2 [C] float32). Arguments as
    :func:`block_fwd`; gy [B,H,W,C] is taken in float32 (exact from
    bfloat16). On CUDA :func:`folded_bwd1`, then :func:`folded_bwd2` on its
    dc1: four launches."""
    global bwd_launches
    gy = _fp(gy).contiguous()
    args = (x, gy, w1, w2, s1, b1, s2, b2)
    _check_folded("block_bwd", *args)
    if x.device.type == "cpu":
        return block_bwd_reference(*args)
    db2, ds2, dw2, dc1 = folded_bwd1(*args)
    db1, ds1, dw1, dx = folded_bwd2(*args, dc1=dc1)
    bwd_launches += 1
    return dx, dw1, dw2, ds1, db1, ds2, db2


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
    """Plain version of :func:`block_stats`: (Σc1, Σc1² over (B, H, W), c1
    [B,H,W,C] contiguous), c1 = conv3x3(relu(s1·x + b1), w1), as
    :func:`block_fwd_reference` computes it. ``magnitudes``: Σ|c1| in place
    of Σc1 (the scale of the card's tolerance on the sums)."""
    c1 = _c1(_fp(x), w1, s1, b1).contiguous()
    return (_mag(magnitudes)(c1).sum(_SUM_DIMS), (c1 * c1).sum(_SUM_DIMS),
            c1)


def block_stats(x, w1, s1, b1):
    """(Σc1, Σc1² float32 [C], c1 float32 [B,H,W,C]) of conv1's output c1 =
    conv3x3(relu(s1·x + b1), w1) (the reference's ``_stats_kernel``, which
    keeps no c1): c1 is the handoff to :func:`block_fwd`'s ``c1=``. x
    [B,H,W,C] float32/bfloat16; w1 [3,3,C,C], s1, b1 [C] float32. On CUDA,
    two launches of ``csrc/fused_block_tc.cu``: c1 and the tile sums over
    tiles of pixels on the tensor cores (the plan and the c1 of
    :func:`block_fwd`'s first launch), then the sum of the rows."""
    global stats_launches
    c = _check_x(x, "block_stats")
    _check_f32("block_stats", x, w1=w1, s1=s1, b1=b1)
    if x.device.type == "cpu":
        return block_stats_reference(x, w1, s1, b1)
    out = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    c1 = _f32_like(x)
    _tc("block_stats", x, w1=w1, g1=s1, b1=b1, c1=c1, out=out)
    stats_launches += 1
    return out[:c], out[c:], c1


def _finish_moments(s, ss, n):
    """Mean and single-pass biased variance from the sums; the variance is
    clamped at 0, where float32 cancellation can push it below."""
    mean = s / n
    return mean, torch.clamp_min(ss / n - mean * mean, 0.0)


def c1_moments(x, w1, s1, b1):
    """BN2's batch moments (mean, var) of c1 from :func:`block_stats`, as
    the reference's ``_c1_moments``, and c1 itself: (mean, var, c1)."""
    s, ss, c1 = block_stats(x, w1, s1, b1)
    return (*_finish_moments(s, ss, _n(x)), c1)


def c1_moments_reference(x, w1, s1, b1):
    """Plain version of :func:`c1_moments`."""
    s, ss, c1 = block_stats_reference(x, w1, s1, b1)
    return (*_finish_moments(s, ss, _n(x)), c1)


# ------------------------------------------------------- the forward
def _train_fwd(moments2, fwd, x, w1, w2, g1, b1, g2, b2, eps):
    xf = _fp(x)
    mean1 = xf.mean(dim=_SUM_DIMS)
    var1 = xf.var(dim=_SUM_DIMS, correction=0)
    s1, sb1 = _fold(g1, b1, mean1, var1, eps)
    mean2, var2, c1 = moments2(x, w1, s1, sb1)
    s2, sb2 = _fold(g2, b2, mean2, var2, eps)
    # The forward runs conv2 alone from the stats' c1, freed after it.
    y = fwd(x, w1, w2, s1, sb1, s2, sb2, c1=c1)
    del c1
    return y, (mean1, var1, mean2, var2)


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
def _bn1(x, g1, b1, m1, i1):
    """z1, ẑ1 = (x − m1)·i1 and r1 = relu(z1) from the block input."""
    xf = _fp(x)
    z1hat = (xf - m1) * i1
    z1 = g1 * z1hat + b1
    return z1, z1hat, torch.clamp_min(z1, 0.0)


def _recompute(x, w1, g1, b1, g2, b2, m1, i1, m2, i2):
    """The forward chain from the block input and the saved moments (i =
    1/σ), as the reference's ``_recompute_train``."""
    z1, z1hat, r1 = _bn1(x, g1, b1, m1, i1)
    c1 = _conv3x3(r1, w1.to(r1.dtype))
    z2hat = (c1 - m2) * i2
    z2 = g2 * z2hat + b2
    return z1, z1hat, r1, z2, z2hat, torch.clamp_min(z2, 0.0)


def _dz2(z2, gy, w2):
    return torch.where(z2 > 0, _conv3x3_t(gy, w2.to(gy.dtype)), 0.0)


def _dc1(dz2, z2hat, g2, i2, t1, t2, n):
    return g2 * i2 * (dz2 - t1 / n - z2hat * (t2 / n))


def train_bwd_pass1_reference(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2,
                              *, magnitudes: bool = False):
    """Plain version of :func:`block_bwd1`: (T1 = Σdz2, T2 = Σdz2·ẑ2,
    dw2 = Σ r2-patchᵀ·gy, dz2, ẑ2), dz2 = convT(gy, w2)·[z2 > 0] and ẑ2
    [B,H,W,C] contiguous for pass 2. ``magnitudes``: each sum of |term|
    instead (dz2 and ẑ2 as they are)."""
    f = _mag(magnitudes)
    _, _, _, z2, z2hat, r2 = _recompute(x, w1, g1, b1, g2, b2, m1, i1, m2,
                                        i2)
    gyf = _fp(gy)
    dz2 = _dz2(z2, gyf, w2)
    return (f(dz2).sum(_SUM_DIMS), (f(dz2) * f(z2hat)).sum(_SUM_DIMS),
            _shifted(r2, f(gyf)), dz2.contiguous(), z2hat.contiguous())


def _pass2_chain(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2, t1, t2
                 ) -> dict:
    """Pass 2's chain recomputed from x (the reference's pass2 body):
    z1, z1hat, r1, dc1 and dz1 = convT(dc1, w1)·[z1 > 0]."""
    z1, z1hat, r1, z2, z2hat, _ = _recompute(x, w1, g1, b1, g2, b2, m1, i1,
                                             m2, i2)
    dc1 = _dc1(_dz2(z2, _fp(gy), w2), z2hat, g2, i2, t1, t2, _n(x))
    dz1 = torch.where(z1 > 0, _conv3x3_t(dc1, w1.to(dc1.dtype)), 0.0)
    return {"z1": z1, "z1hat": z1hat, "r1": r1, "dc1": dc1, "dz1": dz1}


def train_bwd_pass2_reference(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2,
                              t1, t2, *, dz2, z2hat,
                              magnitudes: bool = False):
    """Plain version of :func:`block_bwd2`: (U1 = Σdz1, U2 = Σdz1·ẑ1,
    dw1 = Σ r1-patchᵀ·dc1, dz1 [B,H,W,C] contiguous), dz1 for pass 3, from
    pass 1's ``dz2`` and ``z2hat``: dc1 = γ2·i2·(dz2 − T1/n − ẑ2·T2/n),
    dz1 = convT(dc1, w1)·[z1 > 0]. ``magnitudes``: each sum of |term|
    instead, and for dz1 the sum of |term| of each element, convT(|dc1|,
    |w1|)·[z1 > 0]."""
    f = _mag(magnitudes)
    z1, z1hat, r1 = _bn1(x, g1, b1, m1, i1)
    dc1 = _dc1(dz2, z2hat, g2, i2, t1, t2, _n(x))
    wt = w1.to(dc1.dtype)
    dz1 = torch.where(z1 > 0, _conv3x3_t(dc1, wt), 0.0)
    out = dz1
    if magnitudes:
        out = torch.where(z1 > 0, _conv3x3_t(dc1.abs(), wt.abs()), 0.0)
    return (f(dz1).sum(_SUM_DIMS), (f(dz1) * f(z1hat)).sum(_SUM_DIMS),
            _shifted(r1, f(dc1)), out.contiguous())


def train_bwd_pass3_reference(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2,
                              t1, t2, u1, u2, *, dz1):
    """Plain version of :func:`block_bwd3`: dx in x's dtype from pass 2's
    dz1, with ẑ1 from x."""
    z1hat = (_fp(x) - m1) * i1
    n = _n(x)
    return (_fp(gy) + g1 * i1 * (dz1 - u1 / n - z1hat * (u2 / n))).to(x.dtype)


_VECS = ("g1", "b1", "g2", "b2", "m1", "i1", "m2", "i2", "t1", "t2", "u1",
         "u2")


def _check_bwd(kind, x, gy, w1, w2, vecs) -> int:
    c = _check_x(x, kind)
    _check_f32(kind, x, gy=gy, w1=w1, w2=w2, **dict(zip(_VECS, vecs)))
    return c


def _check_handoff(kind, name, t, x, channels=None) -> None:
    """The tensor the pass before hands over: float32 [B,H,W,channels]
    (x's channels unless given), contiguous, on x's device."""
    shape = (*x.shape[:3], channels or x.shape[-1])
    if (not isinstance(t, torch.Tensor) or tuple(t.shape) != shape
            or t.dtype != torch.float32 or t.device != x.device
            or not t.is_contiguous()):
        got = (f"{t.dtype} {list(t.shape)} on {t.device}"
               f"{'' if t.is_contiguous() else ', strided'}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"{kind}: {name} must be float32 {list(shape)}, "
                         f"contiguous, on {x.device} (the previous pass's "
                         f"output), got {got}")


_TC_PTRS = ("x", "gy", "w1", "w2", *_VECS, "dz2", "z2hat", "dc1", "dz1",
            "dx", "r2", "y", "c1", "part", "out")   # tr_block_tc's order
_TC_MODES = {"block_fwd": 0, "block_bwd1": 1, "block_bwd2": 2,
             "block_bwd3": 3, "block_stats": 4, "folded_bwd1": 5,
             "folded_bwd2": 6}
_TC_PART_ROWS = 512  # most blocks (rows of partial sums) of a pass's tiles
# Pixels per tile by C: the tile plan's, and the small plan's (block_fwd,
# the stats and the folded steps take it where the tile plan fills under 3/4
# of the SMs).
_TC_PIXELS = {16: 256, 32: 128, 64: 64, 128: 32, 256: 32}
_TC_SMALL_PIXELS = {16: 64, 32: 32, 64: 16, 128: 16, 256: 16}


def _sums_len(kind, c) -> int:
    """Floats of a kind's sums out of ``tr_block_tc`` (and of each row of
    partial sums): [S1, S2], then the weight gradient at the tap widths."""
    return 2 * c + (9 * c * c if kind != "block_stats"
                    and c in TAP_CHANNELS else 0)


def _f32_like(x) -> torch.Tensor:
    """An uninitialised float32 tensor of x's shape on x's device."""
    return torch.empty(x.shape, dtype=torch.float32, device=x.device)


def _tc(kind, x, **tensors) -> None:
    """One call of ``csrc/fused_block_tc.cu`` on the named tensors; the
    stats, passes 1 and 2 and the folded steps get the scratch for their
    rows of partial sums (tiles of the small plan's pixels where it runs,
    for the kinds that take :func:`block_fwd`'s plan)."""
    b, h, w, c = x.shape
    rows = 0
    if kind not in ("block_fwd", "block_bwd3"):
        pixels = (_TC_PIXELS[c] if kind in ("block_bwd1", "block_bwd2")
                  else _TC_SMALL_PIXELS[c])
        rows = min(_TC_PART_ROWS, -(-b * h * w // pixels))
        tensors["part"] = torch.empty(rows * _sums_len(kind, c),
                                      dtype=torch.float32, device=x.device)
    ptrs = _build.pointers(kind, _TC_PTRS, {"x": x, **tensors})
    err = _build.library("fused_block_tc").tr_block_tc(
        _TC_MODES[kind], ptrs, b, h, w, c, rows, _build.DTYPE_CODES[x.dtype],
        x.device.index, _build.stream(x))
    _build.check(err, kind)


def _split_sums(out, c, dw=None):
    """[S1, S2, dw] flat → (S1, S2 [C], dw [3,3,C,C]); ``dw``: the weight
    gradient computed apart (:func:`_wide_wgrad`), out then [S1, S2]."""
    if dw is None:
        dw = out[2 * c:].view(3, 3, c, c)
    return out[:c], out[c:2 * c], dw


def _wide_wgrad(kind, a, d, x, bn):
    """dw [3,3,C,C] = Σ over the pixels p of r(p + tap)ᵀ·d(p), r =
    relu(g·((a − m)·i) + b) zero outside the image (SAME pads r): the
    weight gradient of a pass at a width outside :data:`TAP_CHANNELS`, on
    :func:`wgrad.weight_grad`'s shifted BN+ReLU mode (TF32×3 ``wgmma``,
    split-K added in order). ``bn``: (g, b, m, i), or (g, b) for m = 0, i =
    1. dw1 takes x with BN1 (the folds) against dc1, dw2 pass 1's ẑ2 (the
    folded step's c1) with (γ2, β2) (the folds) against gy, each rounded as
    the tile pass rounds r1 and r2."""
    c = x.shape[-1]
    if x.numel() == 0:
        return torch.zeros(3, 3, c, c, dtype=torch.float32, device=x.device)
    return wgrad.weight_grad(kind, wgrad.SHIFTED_BN_RELU, a, d, c, c, x, 9,
                             bn).view(3, 3, c, c)


def block_bwd1(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2):
    """Backward pass 1 (the reference's ``_train_bwd_calls`` pass1): (T1,
    T2 [C], dw2 [3,3,C,C], dz2, ẑ2 [B,H,W,C]) float32; dz2 and ẑ2 are pass
    2's inputs. x [B,H,W,C] float32/bfloat16, gy the same shape in float32,
    the weights and the eight BN vectors float32; m, i are the saved means
    and 1/σ. On CUDA, two launches of ``csrc/fused_block_tc.cu``: c1, ẑ2,
    the convT of gy, dz2, the tile sums and dw2 over tiles of pixels on the
    tensor cores, then the sum of the rows; at C = 128 and 256 the tile pass
    takes no dw2, which :func:`_wide_wgrad` computes from its ẑ2 (two more
    launches)."""
    global bwd1_launches
    vecs = (g1, b1, g2, b2, m1, i1, m2, i2)
    c = _check_bwd("block_bwd1", x, gy, w1, w2, vecs)
    if x.device.type == "cpu":
        return train_bwd_pass1_reference(x, gy, w1, w2, *vecs)
    out = torch.empty(_sums_len("block_bwd1", c), dtype=torch.float32,
                      device=x.device)
    dz2, z2hat = _f32_like(x), _f32_like(x)
    _tc("block_bwd1", x, gy=gy, w1=w1, w2=w2, **dict(zip(_VECS, vecs)),
        dz2=dz2, z2hat=z2hat, out=out)
    dw2 = (None if c in TAP_CHANNELS
           else _wide_wgrad("block_bwd1", z2hat, gy, x, (g2, b2)))
    bwd1_launches += 1
    return (*_split_sums(out, c, dw2), dz2, z2hat)


def block_bwd2(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2, t1, t2, *,
               dz2, z2hat):
    """Backward pass 2: (U1, U2 [C], dw1 [3,3,C,C], dz1 [B,H,W,C]) float32,
    given pass 1's T1, T2 and ``dz2=``, ``z2hat=``, pass 1's dz2 and ẑ2
    (required: no path recomputes them); arguments as :func:`block_bwd1`.
    dz1 is pass 3's input. On CUDA, three launches of
    ``csrc/fused_block_tc.cu``: dc1 (elementwise from dz2 and ẑ2) into a
    scratch, then dz1 (the convT of dc1 on the tensor cores), the tile sums
    and dw1, then the sum of the rows; at C = 128 and 256 the tile pass
    takes no dw1, which :func:`_wide_wgrad` computes from x and that dc1
    (two more launches)."""
    global bwd2_launches
    vecs = (g1, b1, g2, b2, m1, i1, m2, i2, t1, t2)
    c = _check_bwd("block_bwd2", x, gy, w1, w2, vecs)
    _check_handoff("block_bwd2", "dz2", dz2, x)
    _check_handoff("block_bwd2", "z2hat", z2hat, x)
    if x.device.type == "cpu":
        return train_bwd_pass2_reference(x, gy, w1, w2, *vecs, dz2=dz2,
                                         z2hat=z2hat)
    out = torch.empty(_sums_len("block_bwd2", c), dtype=torch.float32,
                      device=x.device)
    dz1, dc1 = _f32_like(x), _f32_like(x)
    _tc("block_bwd2", x, w1=w1, **dict(zip(_VECS, vecs)), dz2=dz2,
        z2hat=z2hat, dc1=dc1, dz1=dz1, out=out)
    dw1 = (None if c in TAP_CHANNELS
           else _wide_wgrad("block_bwd2", x, dc1, x, (g1, b1, m1, i1)))
    bwd2_launches += 1
    return (*_split_sums(out, c, dw1), dz1)


def block_bwd3(x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2, t1, t2, u1,
               u2, *, dz1):
    """Backward pass 3: dx in x's dtype, given T1, T2, pass 2's U1, U2 and
    ``dz1=``, pass 2's dz1 (required: no path recomputes it); arguments as
    :func:`block_bwd1`. On CUDA one elementwise launch of
    ``csrc/fused_block_tc.cu``, no product."""
    global bwd3_launches
    vecs = (g1, b1, g2, b2, m1, i1, m2, i2, t1, t2, u1, u2)
    _check_bwd("block_bwd3", x, gy, w1, w2, vecs)
    _check_handoff("block_bwd3", "dz1", dz1, x)
    if x.device.type == "cpu":
        return train_bwd_pass3_reference(x, gy, w1, w2, *vecs, dz1=dz1)
    dx = torch.empty_like(x)
    _tc("block_bwd3", x, gy=gy, **dict(zip(_VECS, vecs)), dz1=dz1, dx=dx)
    bwd3_launches += 1
    return dx


def _train_bwd(passes, x, gy, w1, w2, g1, b1, g2, b2, moments, eps):
    p1, p2, p3 = passes
    m1, v1, m2, v2 = moments
    i1, i2 = torch.rsqrt(v1 + eps), torch.rsqrt(v2 + eps)
    gyf = _fp(gy).contiguous()
    vecs = (g1, b1, g2, b2, m1, i1, m2, i2)
    t1, t2, dw2, dz2, z2hat = p1(x, gyf, w1, w2, *vecs)
    u1, u2, dw1, dz1 = p2(x, gyf, w1, w2, *vecs, t1, t2, dz2=dz2,
                          z2hat=z2hat)
    del dz2, z2hat   # pass 1's handoff: freed before pass 3
    dx = p3(x, gyf, w1, w2, *vecs, t1, t2, u1, u2, dz1=dz1)
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
