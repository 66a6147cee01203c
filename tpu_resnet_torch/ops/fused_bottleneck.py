"""The ResNet-v2 bottleneck block as fused kernels: the forward with folded
BN and its gradient, and the training forward and backward with live batch
statistics.

Forward with folded BN (``tpu_resnet/ops/fused_bottleneck.py::_fwd_kernel``):

    y = x + W3 · relu(s3 * conv3x3(relu(s2 * (W1 · relu(s1 * x + b1)) + b2))
                      + b3)

for stride 1 and an identity shortcut, the 3x3 SAME, all arithmetic in
float32 and y stored in x's dtype. x and y are NHWC [B,H,W,4f]; the 1x1
kernels are matrices, W1 [4f,f] and W3 [f,4f], the 3x3 is HWIO [3,3,f,f], all
float32; the folded BN scale/bias pairs are float32 [4f], [f], [f].
:func:`bottleneck_fwd` launches ``csrc/fused_bottleneck_tc.cu`` twice: p2
into a [B,H,W,f] float32 scratch, then the 3x3, p3 and the expand with the
residual, on the tensor cores.

Its gradient (``_bwd_kernel``): :func:`bottleneck_bwd` → (dx, dw1, dw2,
dw3, ds1, db1, ds2, db2, ds3, db3) from x, gy (float32) and the
parameters, in two steps that are the live-BN passes below with the folds
as BN (γ, β, μ, 1/σ) = (s, b, 0, 1) and no batch-wide correction
(``csrc/fused_bottleneck_tc.cu`` modes 7 and 8, the weight gradients
``csrc/bottleneck_wgrad.cu``'s): :func:`folded_bwd1` → (db3, ds3, dW3, p2,
c1, dmid = s3·dm3), :func:`folded_bwd2` (``p2=, c1=, dmid=``, step 1's) →
(db2, ds2, dw2, db1, ds1, dW1, dx); dc1 = s2·dm2 and dx = gy + s1·dm1 come
out of one tile pass. :func:`bottleneck_apply` is the differentiable folded
bottleneck (the reference's custom-VJP ``bottleneck_apply``), saving only
x and the parameters.

Training (port of the reference's ``bottleneck_train_fwd`` and
``_train_bwd_calls``: the two moment passes and the four backward passes in
``csrc/fused_bottleneck_tc.cu``, their weight gradients in
``csrc/bottleneck_wgrad.cu``; all products on the tensor cores):

- :func:`bottleneck_train_fwd`: BN1's moments of x in plain PyTorch (mean and
  the two-pass biased variance); :func:`bottleneck_stats_a` gives the sums of
  the 1x1 reduce's output c1, finished into BN2's moments, and
  :func:`bottleneck_stats_b` those of the 3x3's output mid, finished into
  BN3's (single-pass variances clamped at 0); then :func:`bottleneck_fwd`
  with the three folds, which recomputes p2 on the folded chain, as the
  reference does. Returns ``(y, (m1, v1, m2, v2, m3, v3))``.
- the backward, four passes from x, gy (float32) and the saved moments:
  :func:`bottleneck_bwd1` → (T3a, T3b, dw3, p2, mid, dm3),
  :func:`bottleneck_bwd2` (``p2=, mid=, dm3=``) → (T2a, T2b, dw2, dmid),
  :func:`bottleneck_bwd3` (``dmid=``) → (T1a, T1b, dw1, dc1),
  :func:`bottleneck_bwd4` (``dc1=``) → dx; dγ_i = T_i b, dβ_i = T_i a.
  Each pass reads what the pass before it wrote, where the reference
  recomputes the chain from x: pass 2 takes pass 1's p2, mid and dm3, pass 3
  pass 2's dmid, pass 4 pass 3's dc1 ([B,H,W,f] float32 each).
- :func:`bottleneck_train_apply` is differentiable in x, the three weights
  and the six BN parameters; the moments it returns get no gradient.

Each wrapper launches its kernel for CUDA tensors, computes its plain version
(``*_reference``) for CPU tensors and raises otherwise, and counts its
launches (``launches``, ``stats_a_launches``, ``stats_b_launches``,
``bwd1_launches`` .. ``bwd4_launches``, ``bwd_launches``; the weight
gradients of passes 1-3 and of :func:`bottleneck_bwd` are ``ops/wgrad.py``'s,
counted there). The plain versions keep float64 inputs in float64 (the
gradient check); every other input computes in float32.
"""

from __future__ import annotations

import torch

from tpu_resnet_torch.ops import _build, _library, wgrad
from tpu_resnet_torch.ops.epilogue import scale_bias_relu_math
from tpu_resnet_torch.ops.fused_block import (_check_handoff, _conv3x3,
                                              _conv3x3_t, _finish_moments,
                                              _fp, _mag, _n)
from tpu_resnet_torch.ops.wgrad import shifted_reference as _shifted

launches = 0  # bottleneck_fwd calls on CUDA tensors (two launches each)
stats_a_launches = 0  # bottleneck_stats_a calls (two launches each)
stats_b_launches = 0  # bottleneck_stats_b calls (three launches each)
bwd1_launches = 0     # bottleneck_bwd1 calls (five launches each)
bwd2_launches = 0     # bottleneck_bwd2 calls (five launches each)
bwd3_launches = 0     # bottleneck_bwd3 calls (four launches each)
bwd4_launches = 0     # bottleneck_bwd4 calls (one launch each)
bwd_launches = 0      # bottleneck_bwd calls (eleven launches each: its
                      # two steps, three weight gradients among them)

WIDTHS = (64, 128, 256)  # the kernels' compiled bottleneck widths f


def _fold_bn(g, be, mean, inv):
    """Inference BN as an affine, with ``inv`` = rsqrt(var + eps): (scale,
    bias), rounded as the reference's bottleneck fold rounds them."""
    return g * inv, be - mean * g * inv


def bottleneck_fwd_reference(x, w1, w2, w3, s1, b1, s2, b2, s3, b3):
    """Plain PyTorch version (float32 einsum and ``F.conv2d``): the CPU path,
    the tests' and the chip smoke's oracle."""
    xf = _fp(x)
    p1 = scale_bias_relu_math(xf, s1, b1)
    c1 = torch.einsum("bhwc,cf->bhwf", p1, w1.to(xf.dtype))
    p2 = scale_bias_relu_math(c1, s2, b2)
    p3 = scale_bias_relu_math(_conv3x3(p2, w2.to(xf.dtype)), s3, b3)
    r = torch.einsum("bhwf,fc->bhwc", p3, w3.to(xf.dtype))
    return (xf + r).to(x.dtype)


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
    (folded BN). On CUDA, f must be one of :data:`WIDTHS`; two launches of
    ``csrc/fused_bottleneck_tc.cu``: p2 = relu(s2·(relu(s1·x + b1)·W1) + b2)
    into a [B,H,W,f] float32 scratch, then the 3x3 over p2 (zero outside
    the image, no halo), p3 and x + p3·W3, on the tensor cores. Returns the
    block output in x's dtype. While tracing, the
    ``tpu_resnet_torch::bottleneck_fwd`` op, whose body is this launch
    (``ops/_library.py``)."""
    if torch.compiler.is_compiling():
        return _library.bottleneck_fwd(x, w1, w2, w3, s1, b1, s2, b2, s3, b3)
    return _bottleneck_fwd_launch(x, w1, w2, w3, s1, b1, s2, b2, s3, b3)


def _bottleneck_fwd_launch(x, w1, w2, w3, s1, b1, s2, b2, s3,
                           b3) -> torch.Tensor:
    global launches
    args = (x, w1, w2, w3, s1, b1, s2, b2, s3, b3)
    _check(*args)
    if x.device.type == "cpu":
        return bottleneck_fwd_reference(*args)
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck_fwd runs on cpu or cuda, not "
                         f"{x.device}")
    f = x.shape[-1] // 4
    if f not in WIDTHS:
        raise ValueError(f"fused bottleneck has kernels for f in {WIDTHS}, "
                         f"got {f}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    # The folds in the places of the live BNs' gammas and betas.
    _tc("bottleneck_fwd", x, w1=w1, w2=w2, w3=w3, g1=s1, be1=b1, g2=s2,
        be2=b2, g3=s3, be3=b3, p2=_scratch(x), y=y)
    launches += 1
    return y


# ------------------------------------------------------- training: plain
EPS = 1e-5
_SUM_DIMS = (0, 1, 2)
# The BN vectors in the kernels' order: BN1's four are [4f], the rest [f].
_VECS = ("g1", "be1", "mu1", "i1", "g2", "be2", "mu2", "i2", "g3", "be3",
         "mu3", "i3")
_TS = ("t3a", "t3b", "t2a", "t2b", "t1a", "t1b")


def _chain(x, w1, g1, be1, mu1, i1, g2, be2, mu2, i2):
    """The chain up to p2 from x and the moments (i = 1/σ), unfolded, as the
    reference's ``_chain_train``: (x̂1, m1, p1, ĉ, m2, p2)."""
    xf = _fp(x)
    x1hat = (xf - mu1) * i1
    m1 = g1 * x1hat + be1
    p1 = torch.clamp_min(m1, 0.0)
    c1 = torch.einsum("bhwc,cf->bhwf", p1, w1.to(xf.dtype))
    chat = (c1 - mu2) * i2
    m2 = g2 * chat + be2
    return x1hat, m1, p1, chat, m2, torch.clamp_min(m2, 0.0)


def bottleneck_stats_a_reference(x, w1, g1, be1, mu1, i1, *,
                                 magnitudes: bool = False):
    """Plain version of :func:`bottleneck_stats_a`: (Σc1, Σc1²) over (B, H,
    W), c1 = relu(g1·(x−μ1)·i1 + be1)·W1, rounded as the reference's
    ``_stats_a_kernel``. ``magnitudes``: Σ|c1| in place of Σc1."""
    xf = _fp(x)
    p1 = torch.clamp_min(g1 * (xf - mu1) * i1 + be1, 0.0)
    c1 = torch.einsum("bhwc,cf->bhwf", p1, w1.to(xf.dtype))
    return _mag(magnitudes)(c1).sum(_SUM_DIMS), (c1 * c1).sum(_SUM_DIMS)


def bottleneck_stats_b_reference(x, w1, w2, g1, be1, mu1, i1, g2, be2, mu2,
                                 i2, *, magnitudes: bool = False):
    """Plain version of :func:`bottleneck_stats_b`: (Σmid, Σmid²), mid =
    conv3x3(p2, w2). ``magnitudes``: Σ|mid| in place of Σmid."""
    p2 = _chain(x, w1, g1, be1, mu1, i1, g2, be2, mu2, i2)[-1]
    mid = _conv3x3(p2, w2.to(p2.dtype))
    return _mag(magnitudes)(mid).sum(_SUM_DIMS), (mid * mid).sum(_SUM_DIMS)


def _bwd_chain(x, gy, w1, w2, w3, vecs, t=()) -> dict:
    """The chain through mid (raw), p3 and dm3, and as far down the backward
    as the correction sums ``t`` (T3a, T3b[, T2a, T2b]) reach: dmid and dm2,
    then dc1 and dm1, as the reference's ``_train_bwd_calls`` computes
    them."""
    g1, be1, mu1, i1, g2, be2, mu2, i2, g3, be3, mu3, i3 = vecs
    r = dict(zip(("x1hat", "m1", "p1", "chat", "m2", "p2"),
                 _chain(x, w1, g1, be1, mu1, i1, g2, be2, mu2, i2)))
    gyf = r["gy"] = _fp(gy)
    n = _n(x)
    r["mid"] = _conv3x3(r["p2"], w2.to(gyf.dtype))
    r["mhat"] = (r["mid"] - mu3) * i3
    m3 = g3 * r["mhat"] + be3
    r["p3"] = torch.clamp_min(m3, 0.0)
    r["dm3"] = torch.where(m3 > 0, torch.einsum(
        "bhwc,fc->bhwf", gyf, w3.to(gyf.dtype)), 0.0)
    if len(t) >= 2:
        r["dmid"] = g3 * i3 * (r["dm3"] - t[0] / n - r["mhat"] * (t[1] / n))
        r["dm2"] = torch.where(r["m2"] > 0, _conv3x3_t(
            r["dmid"], w2.to(gyf.dtype)), 0.0)
    if len(t) >= 4:
        r["dc1"] = g2 * i2 * (r["dm2"] - t[2] / n - r["chat"] * (t[3] / n))
        r["dm1"] = torch.where(r["m1"] > 0, torch.einsum(
            "bhwf,cf->bhwc", r["dc1"], w1.to(gyf.dtype)), 0.0)
    return r


def train_bwd_pass1_reference(x, gy, w1, w2, w3, *vecs,
                              magnitudes: bool = False):
    """Plain version of :func:`bottleneck_bwd1`: (T3a = Σdm3, T3b =
    Σdm3·m̂, dw3 = Σ p3ᵀ·gy, and for pass 2 p2, mid (raw, before BN3) and
    dm3, [B,H,W,f] contiguous). ``magnitudes``: each sum of |term|
    instead, and each handed tensor's Σ|terms|."""
    f = _mag(magnitudes)
    r = _bwd_chain(x, gy, w1, w2, w3, vecs)
    dm3 = f(r["dm3"])
    sums = (dm3.sum(_SUM_DIMS), (dm3 * f(r["mhat"])).sum(_SUM_DIMS),
            torch.einsum("bhwf,bhwc->fc", f(r["p3"]), f(r["gy"])))
    p2, mid, dm3 = r["p2"], r["mid"], r["dm3"]
    if magnitudes:
        g2, be2, mu2, i2 = vecs[4:8]
        w1a, w2a, w3a = (w.to(r["gy"].dtype).abs() for w in (w1, w2, w3))
        c1 = torch.einsum("bhwc,cf->bhwf", r["p1"], w1a)
        p2 = (g2 * i2).abs() * (c1 + mu2.abs()) + be2.abs()
        mid = _conv3x3(r["p2"].abs(), w2a)
        dm3 = torch.where(r["p3"] > 0, torch.einsum(
            "bhwc,fc->bhwf", r["gy"].abs(), w3a), 0.0)
    return (*sums, p2.contiguous(), mid.contiguous(), dm3.contiguous())


def _corrected_magnitude(gi, dm_mag, ta, tb, hat, n):
    """Σ|terms| of g·i·(dm − Ta/n − v̂·(Tb/n)), given dm's own Σ|terms|:
    the scale the card's tolerance holds dmid and dc1 to."""
    return gi.abs() * (dm_mag + ta.abs() / n + hat.abs() * (tb.abs() / n))


def train_bwd_pass2_reference(x, gy, w1, w2, w3, *vecs_t, p2, mid, dm3,
                              magnitudes: bool = False):
    """Plain version of :func:`bottleneck_bwd2`, given T3a, T3b after the
    twelve vectors and pass 1's p2, mid and dm3: (T2a = Σdm2, T2b = Σdm2·ĉ,
    dw2 = Σ p2-patchᵀ·dmid, dmid [B,H,W,f], contiguous), dmid for pass 3;
    ĉ and the masks [m2 > 0] from x, as the kernel. ``magnitudes``: each
    sum of |term|, and dmid's Σ|terms|."""
    g1, be1, mu1, i1, g2, be2, mu2, i2, g3, be3, mu3, i3 = vecs_t[:12]
    t3a, t3b = vecs_t[12:14]
    f = _mag(magnitudes)
    n = _n(x)
    mhat = (mid - mu3) * i3
    dmid = g3 * i3 * (dm3 - t3a / n - mhat * (t3b / n))
    _, _, _, chat, m2, _ = _chain(x, w1, g1, be1, mu1, i1, g2, be2, mu2, i2)
    dm2 = f(torch.where(m2 > 0, _conv3x3_t(dmid, w2.to(dmid.dtype)), 0.0))
    out = (dm2.sum(_SUM_DIMS), (dm2 * f(chat)).sum(_SUM_DIMS),
           _shifted(f(p2), f(dmid)))
    if magnitudes:
        gyf = _fp(gy)
        dm3 = torch.where(g3 * mhat + be3 > 0, torch.einsum(
            "bhwc,fc->bhwf", gyf.abs(), w3.to(gyf.dtype).abs()), 0.0)
        dmid = _corrected_magnitude(g3 * i3, dm3, t3a, t3b, mhat, n)
    return (*out, dmid.contiguous())


def train_bwd_pass3_reference(x, gy, w1, w2, w3, *vecs_t, dmid,
                              magnitudes: bool = False):
    """Plain version of :func:`bottleneck_bwd3`, given T3a, T3b, T2a, T2b
    and pass 2's dmid: (T1a = Σdm1, T1b = Σdm1·x̂1, dw1 = Σ p1ᵀ·dc1, dc1
    [B,H,W,f], contiguous), dc1 for pass 4; c1 and the masks from x, as the kernel.
    ``magnitudes``: each sum of |term|, and dc1's Σ|terms|."""
    g1, be1, mu1, i1, g2, be2, mu2, i2 = vecs_t[:8]
    t2a, t2b = vecs_t[14:16]
    f = _mag(magnitudes)
    x1hat, m1, p1, chat, m2, _ = _chain(x, w1, g1, be1, mu1, i1, g2, be2,
                                        mu2, i2)
    n = _n(x)
    w2f = w2.to(dmid.dtype)
    dm2 = torch.where(m2 > 0, _conv3x3_t(dmid, w2f), 0.0)
    dc1 = g2 * i2 * (dm2 - t2a / n - chat * (t2b / n))
    dm1 = f(torch.where(m1 > 0, torch.einsum(
        "bhwf,cf->bhwc", dc1, w1.to(dc1.dtype)), 0.0))
    out = (dm1.sum(_SUM_DIMS), (dm1 * f(x1hat)).sum(_SUM_DIMS),
           torch.einsum("bhwc,bhwf->cf", f(p1), f(dc1)))
    if magnitudes:
        dm2 = torch.where(m2 > 0, _conv3x3_t(dmid.abs(), w2f.abs()), 0.0)
        dc1 = _corrected_magnitude(g2 * i2, dm2, t2a, t2b, chat, n)
    return (*out, dc1.contiguous())


def train_bwd_pass4_reference(x, gy, w1, w2, w3, *vecs_t, dc1):
    """Plain version of :func:`bottleneck_bwd4`, given T3a .. T1b and pass
    3's dc1: dx in x's dtype."""
    g1, be1, mu1, i1 = vecs_t[:4]
    t1a, t1b = vecs_t[16:18]
    x1hat = (_fp(x) - mu1) * i1
    m1 = g1 * x1hat + be1
    dm1 = torch.where(m1 > 0, torch.einsum(
        "bhwf,cf->bhwc", dc1, w1.to(dc1.dtype)), 0.0)
    n = _n(x)
    return (_fp(gy) + g1 * i1 * (dm1 - t1a / n - x1hat * (t1b / n))
            ).to(x.dtype)


# ------------------------------------------------------- training: kernels
def _check_train(kind, x, gy, weights, vecs, ts=()) -> int:
    """Shapes, types and devices of a training kernel's arguments; returns
    f."""
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kind}: x must be float32 or bfloat16 [B,H,W,4f], "
                         f"got {x.dtype} {tuple(x.shape)}")
    c4 = x.shape[-1]
    f = c4 // 4
    if c4 != 4 * f or f < 1:
        raise ValueError(f"{kind}: x's channels {c4} are not 4f")
    shapes = {"w1": (c4, f), "w2": (3, 3, f, f), "w3": (f, c4),
              "gy": tuple(x.shape)}
    named = list(weights.items()) + list(zip(_VECS, vecs)) + list(zip(_TS, ts))
    if gy is not None:
        named.append(("gy", gy))
    for name, t in named:
        shape = shapes.get(name, (c4,) if name in ("g1", "be1", "mu1", "i1",
                                                   "t1a", "t1b") else (f,))
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{kind}: {name} must be float32 {list(shape)}, "
                             f"got {t.dtype} {list(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{kind}: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kind} runs on cpu or cuda, not {x.device}")
    if x.device.type == "cuda" and f not in WIDTHS:
        raise ValueError(f"{kind} has kernels for f in {WIDTHS}, got {f}")
    return f


def _scratch(x):
    b, h, w, c4 = x.shape
    return torch.empty(b, h, w, c4 // 4, dtype=torch.float32,
                       device=x.device)


_TC_PTRS = ("x", "gy", "w1", "w2", "w2t", "w3t", "w1t", *_VECS, *_TS,
            "p2", "mid", "dm3", "dmid", "dc1", "dx", "part",
            "out", "w3", "y", "p3", "c1")   # tr_bottleneck_tc's order
_TC_PIXELS = 64          # csrc/fused_bottleneck_tc.cu: pixels per tile
_TC_PART_ROWS = 1024     # most blocks (rows of partial sums) a launch runs
# tr_bottleneck_tc's mode of each kernel, and the length of its sums in f.
_TC_MODES = {"bottleneck_fwd": (5, 0), "bottleneck_stats_a": (6, 2),
             "bottleneck_stats_b": (4, 2),
             "bottleneck_bwd1": (2, 2), "bottleneck_bwd2": (3, 2),
             "bottleneck_bwd3": (0, 8), "bottleneck_bwd4": (1, 0),
             "folded_bwd1": (7, 2), "folded_bwd2": (8, 10)}


def _tc(kind, x, **tensors):
    """One call of ``csrc/fused_bottleneck_tc.cu`` (its tile launches and
    the sum of their rows): returns its sums ([Σc1, Σc1²] 2f, [Σmid, Σmid²]
    2f, [T3a, T3b] 2f, [T2a, T2b] 2f, [T1a, T1b] 8f; folded [db3, ds3] 2f,
    [db1, ds1, db2, ds2] 10f) or, for fwd and bwd4, None. The folded steps
    may take 32-pixel tiles, as the forward does."""
    b, h, w, c4 = x.shape
    mode, per_f = _TC_MODES[kind]
    out, rows = None, 0
    if per_f:
        pixels = _TC_PIXELS // 2 if kind.startswith("folded") else _TC_PIXELS
        rows = min(_TC_PART_ROWS, -(-b * h * w // pixels))
        tensors["part"] = torch.empty(rows * per_f * c4 // 4,
                                      dtype=torch.float32, device=x.device)
        out = tensors["out"] = torch.empty(per_f * c4 // 4,
                                           dtype=torch.float32,
                                           device=x.device)
    ptrs = _build.pointers(kind, _TC_PTRS, {"x": x, **tensors})
    err = _build.library("fused_bottleneck_tc").tr_bottleneck_tc(
        mode, ptrs, b, h, w, c4 // 4, rows, _build.DTYPE_CODES[x.dtype],
        x.device.index, _build.stream(x))
    _build.check(err, kind)
    return out


def bottleneck_stats_a(x, w1, g1, be1, mu1, i1):
    """(Σc1, Σc1²) float32 [f] of the 1x1 reduce's output c1 = relu(g1·(x−
    μ1)·i1 + be1)·W1, recomputed and never stored (the reference's
    ``_stats_a_kernel``, and its rounding: (g1·(x−μ1))·i1 first). x
    [B,H,W,4f] float32/bfloat16; w1 [4f,f], g1, be1, μ1, i1 (= 1/σ1) [4f]
    float32. On CUDA, two launches of ``csrc/fused_bottleneck_tc.cu``: c1
    and the tile sums on the tensor cores, then the sum of their rows."""
    global stats_a_launches
    vecs = (g1, be1, mu1, i1)
    kind = "bottleneck_stats_a"
    f = _check_train(kind, x, None, {"w1": w1}, vecs)
    if x.device.type == "cpu":
        return bottleneck_stats_a_reference(x, w1, *vecs)
    out = _tc(kind, x, w1=w1, **dict(zip(_VECS, vecs)))
    stats_a_launches += 1
    return out[:f], out[f:]


def bottleneck_stats_b(x, w1, w2, g1, be1, mu1, i1, g2, be2, mu2, i2):
    """(Σmid, Σmid²) float32 [f] of the 3x3's output mid = conv3x3(p2, w2)
    (the reference's ``_stats_b_kernel``); BN2's vectors are [f]. On CUDA,
    three launches of ``csrc/fused_bottleneck_tc.cu``: p2 into a [B,H,W,f]
    float32 scratch (the code of :func:`bottleneck_bwd1`'s p2), the 3x3 over
    p2 (zero outside the image, no halo) and the tile sums on the tensor
    cores, then the sum of their rows."""
    global stats_b_launches
    vecs = (g1, be1, mu1, i1, g2, be2, mu2, i2)
    kind = "bottleneck_stats_b"
    f = _check_train(kind, x, None, {"w1": w1, "w2": w2}, vecs)
    if x.device.type == "cpu":
        return bottleneck_stats_b_reference(x, w1, w2, *vecs)
    out = _tc(kind, x, w1=w1, w2=w2, p2=_scratch(x),
              **dict(zip(_VECS, vecs)))
    stats_b_launches += 1
    return out[:f], out[f:]


def _bwd_tensors(w1, w2, w3, vecs, ts):
    """The backward kernels' weights (and their transposed forms), vectors
    and correction sums, by their pointer names."""
    return {"w1": w1, "w2": w2, "w3t": w3.t().contiguous(),
            "w2t": w2.flip(0, 1).transpose(2, 3).contiguous(),
            "w1t": w1.t().contiguous(), **dict(zip(_VECS, vecs)),
            **dict(zip(_TS, ts))}


def bottleneck_bwd1(x, gy, w1, w2, w3, *vecs):
    """Backward pass 1 (the reference's ``_train_bwd_calls`` pass1): (T3a,
    T3b [f], dw3 [f,4f], p2, mid, dm3 [B,H,W,f]) float32; p2, mid (before
    BN3) and dm3 are pass 2's inputs. x [B,H,W,4f] float32/bfloat16, gy its
    shape in float32, w1 [4f,f], w2 [3,3,f,f], w3 [f,4f] and the twelve BN
    vectors g1, be1, μ1, i1 [4f], g2, be2, μ2, i2, g3, be3, μ3, i3 [f]
    float32 (μ, i: the saved means and 1/σ). On CUDA, five launches: the p2
    pass and the mid/dm3 pass of ``csrc/fused_bottleneck_tc.cu`` (c1, the
    3x3 and gy·W3ᵀ on the tensor cores), the sum of its rows, then dw3
    (:func:`wgrad.weight_grad`, p3 from mid, and its sum)."""
    global bwd1_launches
    kind = "bottleneck_bwd1"
    ws = {"w1": w1, "w2": w2, "w3": w3}
    f = _check_train(kind, x, gy, ws, vecs)
    if x.device.type == "cpu":
        return train_bwd_pass1_reference(x, gy, w1, w2, w3, *vecs)
    p2, mid, dm3 = _scratch(x), _scratch(x), _scratch(x)
    out = _tc(kind, x, gy=gy, p2=p2, mid=mid, dm3=dm3,
              **_bwd_tensors(w1, w2, w3, vecs, ()))
    # p3 = relu(g3·((mid − μ3)·i3) + be3), rounded as the tile pass rounds
    # m3.
    dw3 = wgrad.weight_grad(kind, wgrad.BN_RELU, mid, gy, f, 4 * f, x, 1,
                            vecs[8:])
    bwd1_launches += 1
    return out[:f], out[f:], dw3.view(f, 4 * f), p2, mid, dm3


def bottleneck_bwd2(x, gy, w1, w2, w3, *vecs_t, p2, mid, dm3):
    """Backward pass 2: (T2a, T2b [f], dw2 [3,3,f,f], dmid [B,H,W,f])
    float32, given pass 1's T3a, T3b after the vectors and ``p2=``,
    ``mid=``, ``dm3=``, pass 1's tensors (required: no path recomputes
    them); arguments as :func:`bottleneck_bwd1`. dmid is pass 3's input. On
    CUDA, five launches of which ``csrc/fused_bottleneck_tc.cu`` runs three:
    dmid, the tile pass (c1 from x, convT of dmid, dm2 and the sums, on the
    tensor cores) and the sum of its rows; then dw2
    (:func:`wgrad.weight_grad` on p2 and dmid, and its sum)."""
    global bwd2_launches
    kind = "bottleneck_bwd2"
    vecs, ts = vecs_t[:12], vecs_t[12:]
    f = _check_train(kind, x, gy, {"w1": w1, "w2": w2, "w3": w3}, vecs, ts)
    if len(ts) != 2:
        raise ValueError(f"{kind}: needs T3a, T3b after the twelve vectors")
    for name, t in (("p2", p2), ("mid", mid), ("dm3", dm3)):
        _check_handoff(kind, name, t, x, f)
    if x.device.type == "cpu":
        return train_bwd_pass2_reference(x, gy, w1, w2, w3, *vecs_t, p2=p2,
                                         mid=mid, dm3=dm3)
    dmid = _scratch(x)
    out = _tc(kind, x, mid=mid, dm3=dm3, dmid=dmid,
              **_bwd_tensors(w1, w2, w3, vecs, ts))
    dw2 = wgrad.weight_grad(kind, wgrad.SHIFTED, p2, dmid, f, f, x, 9)
    bwd2_launches += 1
    return out[:f], out[f:], dw2.view(3, 3, f, f), dmid


def bottleneck_bwd3(x, gy, w1, w2, w3, *vecs_t, dmid):
    """Backward pass 3: (T1a, T1b [4f], dw1 [4f,f], dc1 [B,H,W,f]) float32,
    given T3a, T3b, T2a, T2b and ``dmid=``, pass 2's dmid (required: no
    path recomputes it); arguments as :func:`bottleneck_bwd1`. dc1 is pass
    4's input. On CUDA: one pass of ``csrc/fused_bottleneck_tc.cu`` (c1 from
    x, convT of dmid, dc1, dc1·W1ᵀ and the sums, on the tensor cores), the
    sum of its rows, then dw1 (:func:`wgrad.weight_grad` and its sum): four
    launches."""
    global bwd3_launches
    kind = "bottleneck_bwd3"
    vecs, ts = vecs_t[:12], vecs_t[12:]
    f = _check_train(kind, x, gy, {"w1": w1, "w2": w2, "w3": w3}, vecs, ts)
    if len(ts) != 4:
        raise ValueError(f"{kind}: needs T3a .. T2b after the twelve vectors")
    _check_handoff(kind, "dmid", dmid, x, f)
    if x.device.type == "cpu":
        return train_bwd_pass3_reference(x, gy, w1, w2, w3, *vecs_t,
                                         dmid=dmid)
    dc1 = _scratch(x)
    out = _tc(kind, x, dmid=dmid, dc1=dc1,
              **_bwd_tensors(w1, w2, w3, vecs, ts))
    dw1 = wgrad.weight_grad(kind, wgrad.BN_RELU, x, dc1, 4 * f, f, x, 1,
                            vecs[:4])
    bwd3_launches += 1
    return out[:4 * f], out[4 * f:], dw1.view(4 * f, f), dc1


def bottleneck_bwd4(x, gy, w1, w2, w3, *vecs_t, dc1):
    """Backward pass 4: dx in x's dtype, given T3a .. T1b and ``dc1=``, pass
    3's dc1 (required: no path recomputes it); arguments as
    :func:`bottleneck_bwd1`. On CUDA one launch of
    ``csrc/fused_bottleneck_tc.cu``: dc1·W1ᵀ on the tensor cores, then
    dx."""
    global bwd4_launches
    kind = "bottleneck_bwd4"
    vecs, ts = vecs_t[:12], vecs_t[12:]
    f = _check_train(kind, x, gy, {"w1": w1, "w2": w2, "w3": w3}, vecs, ts)
    if len(ts) != 6:
        raise ValueError(f"{kind}: needs T3a .. T1b after the twelve vectors")
    _check_handoff(kind, "dc1", dc1, x, f)
    if x.device.type == "cpu":
        return train_bwd_pass4_reference(x, gy, w1, w2, w3, *vecs_t, dc1=dc1)
    dx = torch.empty_like(x)
    _tc(kind, x, gy=gy, dc1=dc1, dx=dx,
        **_bwd_tensors(w1, w2, w3, vecs, ts))
    bwd4_launches += 1
    return dx


# ------------------------------------------------------- training: the block
def _train_fwd(stats_a, stats_b, fwd, x, w1, w2, w3, g1, be1, g2, be2, g3,
               be3, eps):
    xf = _fp(x)
    n = _n(x)
    mu1 = xf.mean(dim=_SUM_DIMS)
    v1 = xf.var(dim=_SUM_DIMS, correction=0)
    i1 = torch.rsqrt(v1 + eps)
    mu2, v2 = _finish_moments(*stats_a(x, w1, g1, be1, mu1, i1), n)
    i2 = torch.rsqrt(v2 + eps)
    mu3, v3 = _finish_moments(*stats_b(x, w1, w2, g1, be1, mu1, i1, g2, be2,
                                       mu2, i2), n)
    i3 = torch.rsqrt(v3 + eps)
    folds = (*_fold_bn(g1, be1, mu1, i1), *_fold_bn(g2, be2, mu2, i2),
             *_fold_bn(g3, be3, mu3, i3))
    return fwd(x, w1, w2, w3, *folds), (mu1, v1, mu2, v2, mu3, v3)


def bottleneck_train_fwd(x, w1, w2, w3, g1, be1, g2, be2, g3, be3,
                         eps: float = EPS):
    """Fused v2 bottleneck with live batch statistics (training BN, biased
    variance): ``(y, (m1, v1, m2, v2, m3, v3))``. x [B,H,W,4f]
    float32/bfloat16; w1 [4f,f], w2 [3,3,f,f], w3 [f,4f], g1, be1 [4f], the
    other gammas and betas [f], float32."""
    return _train_fwd(bottleneck_stats_a, bottleneck_stats_b, bottleneck_fwd,
                      x, w1, w2, w3, g1, be1, g2, be2, g3, be3, eps)


def bottleneck_train_fwd_reference(x, w1, w2, w3, g1, be1, g2, be2, g3, be3,
                                   eps: float = EPS):
    """Plain version of :func:`bottleneck_train_fwd` (differentiable, and in
    float64 for float64 inputs)."""
    return _train_fwd(bottleneck_stats_a_reference,
                      bottleneck_stats_b_reference, bottleneck_fwd_reference,
                      x, w1, w2, w3, g1, be1, g2, be2, g3, be3, eps)


def _train_bwd(passes, x, gy, w1, w2, w3, g1, be1, g2, be2, g3, be3, moments,
               eps):
    """The four passes in order, each handing the next what it wrote: p2,
    mid, dm3 (pass 1 to 2), dmid (2 to 3), dc1 (3 to 4), float32 [B,H,W,f]
    each, each dropped as soon as the pass that reads it has run. At most
    four are alive at once (p2, mid, dm3 and dmid while pass 2 runs): 4 ×
    103 MB more than the recomputing passes held, at 56² and B=128."""
    pass1, pass2, pass3, pass4 = passes
    mu1, v1, mu2, v2, mu3, v3 = moments
    i1, i2, i3 = (torch.rsqrt(v + eps) for v in (v1, v2, v3))
    gyf = _fp(gy).contiguous()
    args = (x, gyf, w1, w2, w3, g1, be1, mu1, i1, g2, be2, mu2, i2, g3, be3,
            mu3, i3)
    t3a, t3b, dw3, p2, mid, dm3 = pass1(*args)
    t2a, t2b, dw2, dmid = pass2(*args, t3a, t3b, p2=p2, mid=mid, dm3=dm3)
    del p2, mid, dm3
    t1a, t1b, dw1, dc1 = pass3(*args, t3a, t3b, t2a, t2b, dmid=dmid)
    del dmid
    dx = pass4(*args, t3a, t3b, t2a, t2b, t1a, t1b, dc1=dc1)
    # dγ_i = T_i b, dβ_i = T_i a: the correction sums.
    return dx, dw1, dw2, dw3, t1b, t1a, t2b, t2a, t3b, t3a


def bottleneck_train_bwd(x, gy, w1, w2, w3, g1, be1, g2, be2, g3, be3,
                         moments, eps: float = EPS):
    """The four passes: (dx, dw1, dw2, dw3, dγ1, dβ1, dγ2, dβ2, dγ3, dβ3)
    given gy = dL/dy and the forward's moments."""
    return _train_bwd((bottleneck_bwd1, bottleneck_bwd2, bottleneck_bwd3,
                       bottleneck_bwd4), x, gy, w1, w2, w3, g1, be1, g2, be2,
                      g3, be3, moments, eps)


def bottleneck_train_bwd_reference(x, gy, w1, w2, w3, g1, be1, g2, be2, g3,
                                   be3, moments, eps: float = EPS):
    """Plain version of :func:`bottleneck_train_bwd`."""
    return _train_bwd((train_bwd_pass1_reference, train_bwd_pass2_reference,
                       train_bwd_pass3_reference, train_bwd_pass4_reference),
                      x, gy, w1, w2, w3, g1, be1, g2, be2, g3, be3, moments,
                      eps)


class _BottleneckTrain(torch.autograd.Function):
    """The live-BN bottleneck with the reference's custom VJP; ``plain``
    picks the plain versions on any device (the chip smoke's oracle), else
    the kernels."""

    @staticmethod
    def forward(ctx, x, w1, w2, w3, g1, be1, g2, be2, g3, be3, eps: float,
                plain: bool):
        fwd = bottleneck_train_fwd_reference if plain else bottleneck_train_fwd
        y, moments = fwd(x, w1, w2, w3, g1, be1, g2, be2, g3, be3, eps)
        ctx.save_for_backward(x, w1, w2, w3, g1, be1, g2, be2, g3, be3,
                              *moments)
        ctx.eps, ctx.plain = eps, plain
        ctx.mark_non_differentiable(*moments)
        return (y, *moments)

    @staticmethod
    def backward(ctx, gy, *_moment_grads):
        *params, m1, v1, m2, v2, m3, v3 = ctx.saved_tensors
        bwd = (bottleneck_train_bwd_reference if ctx.plain
               else bottleneck_train_bwd)
        return (*bwd(*params[:1], gy, *params[1:], (m1, v1, m2, v2, m3, v3),
                     ctx.eps), None, None)


def bottleneck_train_apply(x, w1, w2, w3, g1, be1, g2, be2, g3, be3,
                           eps: float = EPS):
    """Differentiable live-BN fused bottleneck: ``(y, (m1, v1, m2, v2, m3,
    v3))``, through the kernels on CUDA and the plain versions on the CPU.
    gy is carried in float32; dx comes back in x's dtype."""
    y, *moments = _BottleneckTrain.apply(x, w1, w2, w3, g1, be1, g2, be2, g3,
                                         be3, eps, False)
    return y, tuple(moments)


def bottleneck_train_apply_reference(x, w1, w2, w3, g1, be1, g2, be2, g3, be3,
                                     eps: float = EPS):
    """:func:`bottleneck_train_apply` through the plain versions on any
    device."""
    y, *moments = _BottleneckTrain.apply(x, w1, w2, w3, g1, be1, g2, be2, g3,
                                         be3, eps, True)
    return y, tuple(moments)


# ------------------------------------------------------- folded: gradient
def _folded_chain(x, w1, s1, b1, s2, b2):
    """The folded chain up to p2 from x, in float32 (float64 for float64
    x): (x, m1, p1, c1, m2, p2)."""
    xf = _fp(x)
    m1 = xf * s1 + b1
    p1 = torch.clamp_min(m1, 0.0)
    c1 = torch.einsum("bhwc,cf->bhwf", p1, w1.to(xf.dtype))
    m2 = c1 * s2 + b2
    return xf, m1, p1, c1, m2, torch.clamp_min(m2, 0.0)


def bottleneck_bwd_reference(x, gy, w1, w2, w3, s1, b1, s2, b2, s3, b3, *,
                             magnitudes: bool = False):
    """Plain version of :func:`bottleneck_bwd`, the reference's
    ``_bwd_kernel``: (dx in x's dtype, dw1 [4f,f], dw2 [3,3,f,f], dw3 [f,4f],
    ds1, db1, ds2, db2, ds3, db3). ``magnitudes``: each sum and weight
    gradient of |term| instead."""
    f = _mag(magnitudes)
    xf, m1, p1, c1, m2, p2 = _folded_chain(x, w1, s1, b1, s2, b2)
    gyf = _fp(gy)
    w1f, w2f, w3f = (w.to(xf.dtype) for w in (w1, w2, w3))
    mid = _conv3x3(p2, w2f)
    m3 = mid * s3 + b3
    p3 = torch.clamp_min(m3, 0.0)
    dm3 = torch.where(m3 > 0, torch.einsum("bhwc,fc->bhwf", gyf, w3f), 0.0)
    dmid = dm3 * s3
    dm2 = torch.where(m2 > 0, _conv3x3_t(dmid, w2f), 0.0)
    dc1 = dm2 * s2
    dm1 = torch.where(m1 > 0, torch.einsum("bhwf,cf->bhwc", dc1, w1f), 0.0)
    dx = (gyf + dm1 * s1).to(x.dtype)
    return (dx, torch.einsum("bhwc,bhwf->cf", p1, f(dc1)),
            _shifted(p2, f(dmid)), torch.einsum("bhwf,bhwc->fc", p3, f(gyf)),
            *[t for dm, v in ((dm1, xf), (dm2, c1), (dm3, mid))
              for t in ((f(dm) * f(v)).sum(_SUM_DIMS), f(dm).sum(_SUM_DIMS))])


def folded_bwd1_reference(x, gy, w1, w2, w3, s1, b1, s2, b2, s3, b3):
    """Plain version of :func:`folded_bwd1`: (db3 = Σdm3, ds3 = Σdm3·mid,
    dW3 = Σ p3ᵀ·gy, and for step 2 p2, c1 and dmid = s3·dm3, [B,H,W,f]
    contiguous), dm3 = (gy·W3ᵀ)·[m3 > 0], m3 = mid·s3 + b3, each rounded as
    :func:`bottleneck_bwd_reference` rounds it."""
    gyf = _fp(gy)
    *_, c1, _, p2 = _folded_chain(x, w1, s1, b1, s2, b2)
    mid = _conv3x3(p2, w2.to(gyf.dtype))
    m3 = mid * s3 + b3
    dm3 = torch.where(m3 > 0, torch.einsum("bhwc,fc->bhwf", gyf,
                                           w3.to(gyf.dtype)), 0.0)
    return (dm3.sum(_SUM_DIMS), (dm3 * mid).sum(_SUM_DIMS),
            torch.einsum("bhwf,bhwc->fc", torch.clamp_min(m3, 0.0), gyf),
            p2.contiguous(), c1.contiguous(), (dm3 * s3).contiguous())


def folded_bwd2_reference(x, gy, w1, w2, w3, s1, b1, s2, b2, s3, b3, *, p2,
                          c1, dmid):
    """Plain version of :func:`folded_bwd2`, from step 1's ``p2``, ``c1``
    and ``dmid``: (db2 = Σdm2, ds2 = Σdm2·c1, dw2 = Σ p2-patchᵀ·dmid, db1 =
    Σdm1, ds1 = Σdm1·x, dW1 = Σ p1ᵀ·dc1, dx = gy + dm1·s1 in x's dtype),
    m2 = c1·s2 + b2, dm2 = convT(dmid, w2)·[m2 > 0], dc1 = dm2·s2, dm1 =
    (dc1·W1ᵀ)·[m1 > 0], m1 = x·s1 + b1."""
    xf = _fp(x)
    m1 = xf * s1 + b1
    p1 = torch.clamp_min(m1, 0.0)
    m2 = c1 * s2 + b2
    dm2 = torch.where(m2 > 0, _conv3x3_t(dmid, w2.to(xf.dtype)), 0.0)
    dc1 = dm2 * s2
    dm1 = torch.where(m1 > 0, torch.einsum("bhwf,cf->bhwc", dc1,
                                           w1.to(xf.dtype)), 0.0)
    return (dm2.sum(_SUM_DIMS), (dm2 * c1).sum(_SUM_DIMS), _shifted(p2, dmid),
            dm1.sum(_SUM_DIMS), (dm1 * xf).sum(_SUM_DIMS),
            torch.einsum("bhwc,bhwf->cf", p1, dc1),
            (_fp(gy) + dm1 * s1).to(x.dtype))


def _check_folded(kind, x, gy, args) -> int:
    """The forward's checks of ``args`` (x, the weights and the folds), gy
    of x's shape in float32 on its device, and a compiled width on CUDA;
    returns f."""
    _check(x, *args)
    if (tuple(gy.shape) != tuple(x.shape) or gy.dtype != torch.float32
            or gy.device != x.device):
        raise ValueError(f"{kind}: gy must be float32 {list(x.shape)} on "
                         f"{x.device}, got {gy.dtype} {list(gy.shape)} on "
                         f"{gy.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kind} runs on cpu or cuda, not {x.device}")
    f = x.shape[-1] // 4
    if x.device.type == "cuda" and f not in WIDTHS:
        raise ValueError(f"{kind} has kernels for f in {WIDTHS}, got {f}")
    return f


def folded_bwd1(x, gy, w1, w2, w3, s1, b1, s2, b2, s3, b3):
    """The folded gradient's step 1: (db3, ds3 [f], dW3 [f,4f], p2, c1, dmid
    [B,H,W,f]) float32; p2, c1 and dmid are step 2's inputs. Arguments as
    :func:`bottleneck_bwd`, gy float32. On CUDA, five launches: the p2 pass
    of :func:`bottleneck_fwd`, writing c1 too, the tile pass of
    ``csrc/fused_bottleneck_tc.cu`` mode 7 (mid, gy·W3ᵀ, dm3, the sums and
    dmid on the tensor cores; p3 to a scratch), the sum of its rows, then
    dW3 (:func:`wgrad.weight_grad` on p3's rows, and its sum)."""
    kind = "folded_bwd1"
    args = (w1, w2, w3, s1, b1, s2, b2, s3, b3)
    f = _check_folded(kind, x, gy, args)
    if x.device.type == "cpu":
        return folded_bwd1_reference(x, gy, *args)
    p2, c1, p3, dmid = (_scratch(x) for _ in range(4))
    out = _tc(kind, x, gy=gy, w1=w1, w2=w2, w3t=w3.t().contiguous(), g1=s1,
              be1=b1, g2=s2, be2=b2, g3=s3, be3=b3, p2=p2, c1=c1, p3=p3,
              dmid=dmid)
    dw3 = wgrad.weight_grad(kind, wgrad.ROWS, p3, gy, f, 4 * f, x, 1)
    del p3
    return out[:f], out[f:], dw3.view(f, 4 * f), p2, c1, dmid


def folded_bwd2(x, gy, w1, w2, w3, s1, b1, s2, b2, s3, b3, *, p2, c1,
                dmid):
    """The folded gradient's step 2: (db2, ds2 [f], dw2 [3,3,f,f], db1,
    ds1 [4f], dW1 [4f,f] float32, dx in x's dtype), given ``p2=``, ``c1=``
    and ``dmid=``, step 1's (required: no path recomputes them); arguments
    as :func:`folded_bwd1`. On CUDA, six launches: the tile pass of
    ``csrc/fused_bottleneck_tc.cu`` mode 8 (the convT of dmid, dm2, dc1 to
    a scratch, dc1·W1ᵀ, dm1, the sums and dx on the tensor cores), the sum
    of its rows, then dw2 on p2 and dmid and dW1 on x and dc1
    (:func:`wgrad.weight_grad` and their sums)."""
    kind = "folded_bwd2"
    args = (w1, w2, w3, s1, b1, s2, b2, s3, b3)
    f = _check_folded(kind, x, gy, args)
    for name, t in (("p2", p2), ("c1", c1), ("dmid", dmid)):
        _check_handoff(kind, name, t, x, f)
    if x.device.type == "cpu":
        return folded_bwd2_reference(x, gy, *args, p2=p2, c1=c1, dmid=dmid)
    dc1, dx = _scratch(x), torch.empty_like(x)
    out = _tc(kind, x, gy=gy, w1t=w1.t().contiguous(),
              w2t=w2.flip(0, 1).transpose(2, 3).contiguous(), g1=s1, be1=b1,
              g2=s2, be2=b2, c1=c1, dmid=dmid, dc1=dc1, dx=dx)
    dw2 = wgrad.weight_grad(kind, wgrad.SHIFTED, p2, dmid, f, f, x, 9)
    # p1 = relu(s1·((x − 0)·1) + b1): relu(x·s1 + b1) bit for bit.
    dw1 = wgrad.weight_grad(kind, wgrad.BN_RELU, x, dc1, 4 * f, f, x, 1,
                            (s1, b1, torch.zeros_like(s1),
                             torch.ones_like(s1)))
    return (out[8 * f:9 * f], out[9 * f:], dw2.view(3, 3, f, f),
            out[:4 * f], out[4 * f:8 * f], dw1.view(4 * f, f), dx)


def bottleneck_bwd(x, gy, w1, w2, w3, s1, b1, s2, b2, s3, b3):
    """The gradient of :func:`bottleneck_fwd` given gy = dL/dy: (dx in x's
    dtype, dw1 [4f,f], dw2 [3,3,f,f], dw3 [f,4f], ds1, db1 [4f], ds2, db2,
    ds3, db3 [f], float32). Arguments as :func:`bottleneck_fwd`; gy is taken
    in float32 (exact from bfloat16). On CUDA :func:`folded_bwd1`, then
    :func:`folded_bwd2` on its p2, c1 and dmid: eleven launches."""
    global bwd_launches
    gy = _fp(gy).contiguous()
    args = (w1, w2, w3, s1, b1, s2, b2, s3, b3)
    _check_folded("bottleneck_bwd", x, gy, args)
    if x.device.type == "cpu":
        return bottleneck_bwd_reference(x, gy, *args)
    db3, ds3, dw3, p2, c1, dmid = folded_bwd1(x, gy, *args)
    db2, ds2, dw2, db1, ds1, dw1, dx = folded_bwd2(x, gy, *args, p2=p2,
                                                   c1=c1, dmid=dmid)
    bwd_launches += 1
    return dx, dw1, dw2, dw3, ds1, db1, ds2, db2, ds3, db3


class _BottleneckApply(torch.autograd.Function):
    """The folded-BN bottleneck with the reference's custom VJP; ``plain``
    picks the plain versions on any device (the chip smoke's oracle), else
    the kernels."""

    @staticmethod
    def forward(ctx, x, w1, w2, w3, s1, b1, s2, b2, s3, b3, plain: bool):
        ctx.save_for_backward(x, w1, w2, w3, s1, b1, s2, b2, s3, b3)
        ctx.plain = plain
        fwd = bottleneck_fwd_reference if plain else bottleneck_fwd
        return fwd(x, w1, w2, w3, s1, b1, s2, b2, s3, b3)

    @staticmethod
    def backward(ctx, gy):
        bwd = bottleneck_bwd_reference if ctx.plain else bottleneck_bwd
        x, *params = ctx.saved_tensors
        return (*bwd(x, gy, *params), None)


def bottleneck_apply(x, w1, w2, w3, s1, b1, s2, b2, s3, b3):
    """Differentiable fused bottleneck with folded BN: :func:`bottleneck_fwd`,
    and :func:`bottleneck_bwd` for its gradient in x and all nine
    parameters."""
    return _BottleneckApply.apply(x, w1, w2, w3, s1, b1, s2, b2, s3, b3,
                                  False)


def bottleneck_apply_reference(x, w1, w2, w3, s1, b1, s2, b2, s3, b3):
    """:func:`bottleneck_apply` through the plain versions on any device."""
    return _BottleneckApply.apply(x, w1, w2, w3, s1, b1, s2, b2, s3, b3,
                                  True)
