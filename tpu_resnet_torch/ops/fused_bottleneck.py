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
:func:`bottleneck_fwd` launches ``csrc/fused_bottleneck.cu``.

Its gradient (``_bwd_kernel``; mode 6 of ``csrc/fused_bottleneck_train.cu``
``tr_bottleneck_train``, then ``tr_bottleneck_wgrad``):
:func:`bottleneck_bwd` → (dx, dw1, dw2, dw3, ds1, db1, ds2, db2, ds3, db3)
from x, gy (float32) and the parameters, in one row pass (folded BN has no
batch-wide sum before dx) and the three weight-gradient products.
:func:`bottleneck_apply` is the differentiable folded bottleneck (the
reference's custom-VJP ``bottleneck_apply``), saving only x and the
parameters.

Training (port of the reference's ``bottleneck_train_fwd`` and
``_train_bwd_calls``, ``csrc/fused_bottleneck_train.cu``):

- :func:`bottleneck_train_fwd`: BN1's moments of x in plain PyTorch (mean and
  the two-pass biased variance); :func:`bottleneck_stats_a` gives the sums of
  the 1x1 reduce's output c1, finished into BN2's moments, and
  :func:`bottleneck_stats_b` those of the 3x3's output mid, finished into
  BN3's (single-pass variances clamped at 0); then :func:`bottleneck_fwd`
  with the three folds. Returns ``(y, (m1, v1, m2, v2, m3, v3))``.
- the backward, four passes from x, gy (float32) and the saved moments:
  :func:`bottleneck_bwd1` → (T3a, T3b, dw3), :func:`bottleneck_bwd2` → (T2a,
  T2b, dw2), :func:`bottleneck_bwd3` → (T1a, T1b, dw1), :func:`bottleneck_bwd4`
  → dx; dγ_i = T_i b, dβ_i = T_i a.
- :func:`bottleneck_train_apply` is differentiable in x, the three weights
  and the six BN parameters; the moments it returns get no gradient.

Each wrapper launches its kernel for CUDA tensors, computes its plain version
(``*_reference``) for CPU tensors and raises otherwise, and counts its
launches (``launches``, ``stats_a_launches``, ``stats_b_launches``,
``bwd1_launches`` .. ``bwd4_launches``, ``bwd_launches``). The plain
versions keep float64 inputs in float64 (the gradient check); every other
input computes in
float32.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_resnet_torch.ops import _build
from tpu_resnet_torch.ops.epilogue import scale_bias_relu_math
from tpu_resnet_torch.ops.fused_block import (_conv3x3, _conv3x3_t,
                                              _finish_moments, _fp, _mag, _n,
                                              _wgrad)

launches = 0  # kernel launches by bottleneck_fwd (CUDA tensors only)
stats_a_launches = 0  # bottleneck_stats_a calls (two launches each)
stats_b_launches = 0  # bottleneck_stats_b calls (two launches each)
bwd1_launches = 0     # bottleneck_bwd1 calls (four launches each)
bwd2_launches = 0     # bottleneck_bwd2 calls (four launches each)
bwd3_launches = 0     # bottleneck_bwd3 calls (four launches each)
bwd4_launches = 0     # bottleneck_bwd4 launches
bwd_launches = 0      # bottleneck_bwd calls (eight launches each)

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
    xf = _fp(x)
    p1 = scale_bias_relu_math(xf, s1, b1)
    c1 = torch.einsum("bhwc,cf->bhwf", p1, w1.to(xf.dtype))
    p2 = scale_bias_relu_math(c1, s2, b2)
    p3 = scale_bias_relu_math(_conv3x3(p2, w2.to(xf.dtype)), s3, b3)
    r = torch.einsum("bhwf,fc->bhwc", p3, w3.to(xf.dtype))
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
    """The chain through p3 and dm3, and as far down the backward as the
    correction sums ``t`` (T3a, T3b[, T2a, T2b]) reach: dmid and dm2, then
    dc1 and dm1, as the reference's ``_train_bwd_calls`` computes them."""
    g1, be1, mu1, i1, g2, be2, mu2, i2, g3, be3, mu3, i3 = vecs
    r = dict(zip(("x1hat", "m1", "p1", "chat", "m2", "p2"),
                 _chain(x, w1, g1, be1, mu1, i1, g2, be2, mu2, i2)))
    gyf = r["gy"] = _fp(gy)
    n = _n(x)
    r["mhat"] = (_conv3x3(r["p2"], w2.to(gyf.dtype)) - mu3) * i3
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
    Σdm3·m̂, dw3 = Σ p3ᵀ·gy). ``magnitudes``: each sum of |term| instead."""
    f = _mag(magnitudes)
    r = _bwd_chain(x, gy, w1, w2, w3, vecs)
    dm3 = f(r["dm3"])
    return (dm3.sum(_SUM_DIMS), (dm3 * f(r["mhat"])).sum(_SUM_DIMS),
            torch.einsum("bhwf,bhwc->fc", f(r["p3"]), f(r["gy"])))


def train_bwd_pass2_reference(x, gy, w1, w2, w3, *vecs_t,
                              magnitudes: bool = False):
    """Plain version of :func:`bottleneck_bwd2`, given T3a, T3b after the
    twelve vectors: (T2a = Σdm2, T2b = Σdm2·ĉ, dw2 = Σ p2-patchᵀ·dmid)."""
    f = _mag(magnitudes)
    r = _bwd_chain(x, gy, w1, w2, w3, vecs_t[:12], vecs_t[12:])
    dm2 = f(r["dm2"])
    return (dm2.sum(_SUM_DIMS), (dm2 * f(r["chat"])).sum(_SUM_DIMS),
            _wgrad(f(r["p2"]), f(r["dmid"])))


def train_bwd_pass3_reference(x, gy, w1, w2, w3, *vecs_t,
                              magnitudes: bool = False):
    """Plain version of :func:`bottleneck_bwd3`, given T3a, T3b, T2a, T2b:
    (T1a = Σdm1, T1b = Σdm1·x̂1, dw1 = Σ p1ᵀ·dc1)."""
    f = _mag(magnitudes)
    r = _bwd_chain(x, gy, w1, w2, w3, vecs_t[:12], vecs_t[12:])
    dm1 = f(r["dm1"])
    return (dm1.sum(_SUM_DIMS), (dm1 * f(r["x1hat"])).sum(_SUM_DIMS),
            torch.einsum("bhwc,bhwf->cf", f(r["p1"]), f(r["dc1"])))


def train_bwd_pass4_reference(x, gy, w1, w2, w3, *vecs_t):
    """Plain version of :func:`bottleneck_bwd4`, given T3a .. T1b: dx in x's
    dtype."""
    g1, i1 = vecs_t[0], vecs_t[3]
    t1a, t1b = vecs_t[16:18]
    r = _bwd_chain(x, gy, w1, w2, w3, vecs_t[:12], vecs_t[12:16])
    n = _n(x)
    return (r["gy"] + g1 * i1 * (r["dm1"] - t1a / n - r["x1hat"] * (t1b / n))
            ).to(x.dtype)


# ------------------------------------------------------- training: kernels
_PTRS = ("x", "gy", "w1", "w2", "w2t", "w3t", "w1t", *_VECS, *_TS, "part",
         "out", "s0", "s1", "dx", "s2", "s3")  # tr_bottleneck_train's order
_WGRAD_BLOCKS = 528   # blocks a weight-gradient launch aims at (4 per SM)


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


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _pointers(kind, names, tensors):
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kind}: {name} must be contiguous and 16-byte "
                             f"aligned")
    return (ctypes.c_void_p * len(names))(*(
        tensors[n].data_ptr() if n in tensors else None for n in names))


def _rows(kind, mode, row_len, x, **tensors):
    """One row-kernel launch (and the sum of its rows): the ``row_len`` sums
    of mode ``mode``, or None when it has none."""
    b, h, w, c4 = x.shape
    out = None
    if row_len:
        tensors["part"] = torch.empty(b * h * row_len, dtype=torch.float32,
                                      device=x.device)
        out = tensors["out"] = torch.empty(row_len, dtype=torch.float32,
                                           device=x.device)
    ptrs = _pointers(kind, _PTRS, {"x": x, **tensors})
    err = _build.library("fused_bottleneck_train").tr_bottleneck_train(
        mode, ptrs, b, h, w, c4 // 4, _build.DTYPE_CODES[x.dtype],
        x.device.index, _stream(x))
    _build.check(err, kind)
    return out


def _weight_grad(kind, amode, a, bmat, ka, nb, x, taps, bn1=()):
    """Σ over the B·H·W pixels of Aᵀ·bmat ([taps·ka·nb] float32), A by
    ``amode`` (csrc ``tr_bottleneck_wgrad``), the pixels in a number of
    chunks fixed by the shapes, added in order."""
    b, h, w, _ = x.shape
    p = b * h * w
    tiles = taps * (ka // 64) * (nb // 64)
    splits = max(1, min(-(-_WGRAD_BLOCKS // tiles), -(-p // 256)))
    part = torch.empty(splits * taps * ka * nb, dtype=torch.float32,
                       device=x.device)
    out = torch.empty(taps * ka * nb, dtype=torch.float32, device=x.device)
    names = ("a", "b", "g1", "be1", "mu1", "i1", "part", "out")
    ptrs = _pointers(kind, names, {
        "a": a, "b": bmat, "part": part, "out": out,
        **dict(zip(names[2:6], bn1))})
    err = _build.library("fused_bottleneck_train").tr_bottleneck_wgrad(
        amode, ptrs, p, ka, nb, h, w, splits, _build.DTYPE_CODES[a.dtype],
        x.device.index, _stream(x))
    _build.check(err, kind)
    return out


def _scratch(x):
    b, h, w, c4 = x.shape
    return torch.empty(b, h, w, c4 // 4, dtype=torch.float32,
                       device=x.device)


def bottleneck_stats_a(x, w1, g1, be1, mu1, i1):
    """(Σc1, Σc1²) float32 [f] of the 1x1 reduce's output c1 = relu(g1·(x−
    μ1)·i1 + be1)·W1, recomputed and never stored (the reference's
    ``_stats_a_kernel``). x [B,H,W,4f] float32/bfloat16; w1 [4f,f], g1, be1,
    μ1, i1 (= 1/σ1) [4f] float32."""
    global stats_a_launches
    vecs = (g1, be1, mu1, i1)
    f = _check_train("bottleneck_stats_a", x, None, {"w1": w1}, vecs)
    if x.device.type == "cpu":
        return bottleneck_stats_a_reference(x, w1, *vecs)
    out = _rows("bottleneck_stats_a", 0, 2 * f, x, w1=w1,
                **dict(zip(_VECS, vecs)))
    stats_a_launches += 1
    return out[:f], out[f:]


def bottleneck_stats_b(x, w1, w2, g1, be1, mu1, i1, g2, be2, mu2, i2):
    """(Σmid, Σmid²) float32 [f] of the 3x3's output mid = conv3x3(p2, w2),
    recomputed with a one-row halo (the reference's ``_stats_b_kernel``);
    BN2's vectors are [f]."""
    global stats_b_launches
    vecs = (g1, be1, mu1, i1, g2, be2, mu2, i2)
    f = _check_train("bottleneck_stats_b", x, None, {"w1": w1, "w2": w2},
                     vecs)
    if x.device.type == "cpu":
        return bottleneck_stats_b_reference(x, w1, w2, *vecs)
    out = _rows("bottleneck_stats_b", 1, 2 * f, x, w1=w1, w2=w2,
                **dict(zip(_VECS, vecs)))
    stats_b_launches += 1
    return out[:f], out[f:]


def _bwd_tensors(w1, w2, w3, vecs, ts):
    """The row kernel's weights (and their transposed forms) and vectors."""
    return {"w1": w1, "w2": w2, "w3t": w3.t().contiguous(),
            "w2t": w2.flip(0, 1).transpose(2, 3).contiguous(),
            "w1t": w1.t().contiguous(), **dict(zip(_VECS, vecs)),
            **dict(zip(_TS, ts))}


def bottleneck_bwd1(x, gy, w1, w2, w3, *vecs):
    """Backward pass 1 (the reference's ``_train_bwd_calls`` pass1): (T3a,
    T3b [f], dw3 [f,4f]) float32. x [B,H,W,4f] float32/bfloat16, gy its
    shape in float32, w1 [4f,f], w2 [3,3,f,f], w3 [f,4f] and the twelve BN
    vectors g1, be1, μ1, i1 [4f], g2, be2, μ2, i2, g3, be3, μ3, i3 [f]
    float32 (μ, i: the saved means and 1/σ)."""
    global bwd1_launches
    kind = "bottleneck_bwd1"
    ws = {"w1": w1, "w2": w2, "w3": w3}
    f = _check_train(kind, x, gy, ws, vecs)
    if x.device.type == "cpu":
        return train_bwd_pass1_reference(x, gy, w1, w2, w3, *vecs)
    p3 = _scratch(x)
    out = _rows(kind, 2, 2 * f, x, gy=gy, s0=p3,
                **_bwd_tensors(w1, w2, w3, vecs, ()))
    dw3 = _weight_grad(kind, 0, p3, gy, f, 4 * f, x, 1)
    bwd1_launches += 1
    return out[:f], out[f:], dw3.view(f, 4 * f)


def bottleneck_bwd2(x, gy, w1, w2, w3, *vecs_t):
    """Backward pass 2: (T2a, T2b [f], dw2 [3,3,f,f]) float32, given pass
    1's T3a, T3b after the vectors; arguments as :func:`bottleneck_bwd1`."""
    global bwd2_launches
    kind = "bottleneck_bwd2"
    vecs, ts = vecs_t[:12], vecs_t[12:]
    f = _check_train(kind, x, gy, {"w1": w1, "w2": w2, "w3": w3}, vecs, ts)
    if len(ts) != 2:
        raise ValueError(f"{kind}: needs T3a, T3b after the twelve vectors")
    if x.device.type == "cpu":
        return train_bwd_pass2_reference(x, gy, w1, w2, w3, *vecs_t)
    p2, dmid = _scratch(x), _scratch(x)
    out = _rows(kind, 3, 2 * f, x, gy=gy, s0=p2, s1=dmid,
                **_bwd_tensors(w1, w2, w3, vecs, ts))
    dw2 = _weight_grad(kind, 1, p2, dmid, f, f, x, 9)
    bwd2_launches += 1
    return out[:f], out[f:], dw2.view(3, 3, f, f)


def bottleneck_bwd3(x, gy, w1, w2, w3, *vecs_t):
    """Backward pass 3: (T1a, T1b [4f], dw1 [4f,f]) float32, given T3a, T3b,
    T2a, T2b; arguments as :func:`bottleneck_bwd1`."""
    global bwd3_launches
    kind = "bottleneck_bwd3"
    vecs, ts = vecs_t[:12], vecs_t[12:]
    f = _check_train(kind, x, gy, {"w1": w1, "w2": w2, "w3": w3}, vecs, ts)
    if len(ts) != 4:
        raise ValueError(f"{kind}: needs T3a .. T2b after the twelve vectors")
    if x.device.type == "cpu":
        return train_bwd_pass3_reference(x, gy, w1, w2, w3, *vecs_t)
    dc1 = _scratch(x)
    out = _rows(kind, 4, 8 * f, x, gy=gy, s0=dc1,
                **_bwd_tensors(w1, w2, w3, vecs, ts))
    dw1 = _weight_grad(kind, 2, x, dc1, 4 * f, f, x, 1, vecs[:4])
    bwd3_launches += 1
    return out[:4 * f], out[4 * f:], dw1.view(4 * f, f)


def bottleneck_bwd4(x, gy, w1, w2, w3, *vecs_t):
    """Backward pass 4: dx in x's dtype, given T3a .. T1b; arguments as
    :func:`bottleneck_bwd1`."""
    global bwd4_launches
    kind = "bottleneck_bwd4"
    vecs, ts = vecs_t[:12], vecs_t[12:]
    _check_train(kind, x, gy, {"w1": w1, "w2": w2, "w3": w3}, vecs, ts)
    if len(ts) != 6:
        raise ValueError(f"{kind}: needs T3a .. T1b after the twelve vectors")
    if x.device.type == "cpu":
        return train_bwd_pass4_reference(x, gy, w1, w2, w3, *vecs_t)
    dx = torch.empty_like(x)
    _rows(kind, 5, 0, x, gy=gy, dx=dx, **_bwd_tensors(w1, w2, w3, vecs, ts))
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
    p1, p2, p3, p4 = passes
    mu1, v1, mu2, v2, mu3, v3 = moments
    i1, i2, i3 = (torch.rsqrt(v + eps) for v in (v1, v2, v3))
    gyf = _fp(gy).contiguous()
    args = (x, gyf, w1, w2, w3, g1, be1, mu1, i1, g2, be2, mu2, i2, g3, be3,
            mu3, i3)
    t3a, t3b, dw3 = p1(*args)
    t2a, t2b, dw2 = p2(*args, t3a, t3b)
    t1a, t1b, dw1 = p3(*args, t3a, t3b, t2a, t2b)
    dx = p4(*args, t3a, t3b, t2a, t2b, t1a, t1b)
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
def bottleneck_bwd_reference(x, gy, w1, w2, w3, s1, b1, s2, b2, s3, b3, *,
                             magnitudes: bool = False):
    """Plain version of :func:`bottleneck_bwd`, the reference's
    ``_bwd_kernel``: (dx in x's dtype, dw1 [4f,f], dw2 [3,3,f,f], dw3 [f,4f],
    ds1, db1, ds2, db2, ds3, db3). ``magnitudes``: each sum and weight
    gradient of |term| instead."""
    f = _mag(magnitudes)
    xf = _fp(x)
    gyf = _fp(gy)
    w1f, w2f, w3f = (w.to(xf.dtype) for w in (w1, w2, w3))
    m1 = xf * s1 + b1
    p1 = torch.clamp_min(m1, 0.0)
    c1 = torch.einsum("bhwc,cf->bhwf", p1, w1f)
    m2 = c1 * s2 + b2
    p2 = torch.clamp_min(m2, 0.0)
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
            _wgrad(p2, f(dmid)), torch.einsum("bhwf,bhwc->fc", p3, f(gyf)),
            *[t for dm, v in ((dm1, xf), (dm2, c1), (dm3, mid))
              for t in ((f(dm) * f(v)).sum(_SUM_DIMS), f(dm).sum(_SUM_DIMS))])


def bottleneck_bwd(x, gy, w1, w2, w3, s1, b1, s2, b2, s3, b3):
    """The gradient of :func:`bottleneck_fwd` given gy = dL/dy: (dx in x's
    dtype, dw1 [4f,f], dw2 [3,3,f,f], dw3 [f,4f], ds1, db1 [4f], ds2, db2,
    ds3, db3 [f], float32). Arguments as :func:`bottleneck_fwd`; gy is taken
    in float32 (exact from bfloat16)."""
    global bwd_launches
    kind = "bottleneck_bwd"
    gy = _fp(gy).contiguous()
    args = (x, w1, w2, w3, s1, b1, s2, b2, s3, b3)
    _check(*args)
    if tuple(gy.shape) != tuple(x.shape) or gy.device != x.device:
        raise ValueError(f"{kind}: gy must be {list(x.shape)} on {x.device}, "
                         f"got {list(gy.shape)} on {gy.device}")
    if x.device.type == "cpu":
        return bottleneck_bwd_reference(x, gy, *args[1:])
    if x.device.type != "cuda":
        raise ValueError(f"{kind} runs on cpu or cuda, not {x.device}")
    f = x.shape[-1] // 4
    if f not in WIDTHS:
        raise ValueError(f"{kind} has kernels for f in {WIDTHS}, got {f}")
    p2, dmid, p3, dc1 = (_scratch(x) for _ in range(4))
    dx = torch.empty_like(x)
    # The folded vectors in the places of the live modes' gammas and betas.
    out = _rows(kind, 6, 12 * f, x, gy=gy, s0=p2, s1=dmid, s2=p3, s3=dc1,
                dx=dx, g1=s1, be1=b1, g2=s2, be2=b2, g3=s3, be3=b3,
                **_bwd_tensors(w1, w2, w3, (), ()))
    dw3 = _weight_grad(kind, 0, p3, gy, f, 4 * f, x, 1)
    dw2 = _weight_grad(kind, 1, p2, dmid, f, f, x, 9)
    # p1 = relu(g*((x - 0)*1) + be) with (g, be) = (s1, b1): relu(x*s1 + b1)
    # bit for bit.
    dw1 = _weight_grad(kind, 2, x, dc1, 4 * f, f, x, 1,
                       (s1, b1, torch.zeros_like(s1), torch.ones_like(s1)))
    bwd_launches += 1
    return (dx, dw1.view(4 * f, f), dw2.view(3, 3, f, f), dw3.view(f, 4 * f),
            out[4 * f:8 * f], out[:4 * f], out[9 * f:10 * f],
            out[8 * f:9 * f], out[11 * f:], out[10 * f:11 * f])


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
