"""The weight gradients of the fused blocks' passes on the tensor cores:
Σ over the B·H·W pixels of Aᵀ·B, A taken from a [B,H,W,ka] map by one of
four modes, B [B,H,W,nb] (``csrc/bottleneck_wgrad.cu`` ``tr_bottleneck_wgrad``,
library ``bottleneck_wgrad``: TF32×3 ``wgmma``, the pixels split into
chunks whose partial sums are added in order).

The fused bottleneck's passes 1-3 and its folded gradient take dw3, dw2 and
dw1 here (``ops/fused_bottleneck.py``), the fused basic block's passes 1 and
2 and its folded steps dw2 and dw1 at the widths whose tile passes take no
weight gradient (``ops/fused_block.py`` ``_wide_wgrad``).
:func:`weight_grad` launches the kernel for CUDA tensors, computes its plain
version :func:`weight_grad_reference` for CPU tensors and raises
otherwise; ``launches`` counts its calls on the card (two launches each:
the product and the sum of its splits).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_resnet_torch.ops import _build

launches = 0   # weight_grad calls on CUDA tensors (two launches each)

# Blocks a launch aims at (two waves of one block per SM on an H100's 132),
# and the fewest pixels a split takes.
_BLOCKS = 264
_MIN_PIXELS = 64
# The A operand: rows of a float32 matrix, a float32 map shifted by the 9
# taps of a 3x3 (SAME zero fill), relu(g·((v − μ)·i) + be) of v, or that
# relu shifted by the 9 taps, zero outside the image (SAME pads after the
# ReLU).
ROWS, SHIFTED, BN_RELU, SHIFTED_BN_RELU = 0, 1, 2, 3
_NAMES = ("a", "b", "g1", "be1", "mu1", "i1", "part", "out")  # its order


def shifted_reference(r: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """dw[ky,kx,ci,co] = Σ over (b,y,x) of r_pad[b,y+ky,x+kx,ci]·d[b,y,x,co]:
    the gradient of a SAME 3x3 convolution of r in its HWIO weights."""
    _, h, w, _ = r.shape
    rp = F.pad(r, (0, 0, 1, 1, 1, 1))
    return torch.stack([
        torch.einsum("bhwi,bhwo->io", rp[:, ky:ky + h, kx:kx + w], d)
        for ky in range(3) for kx in range(3)]).unflatten(0, (3, 3))


def weight_grad_reference(amode, a, bmat, bn=(), *,
                          magnitudes: bool = False):
    """Plain version of :func:`weight_grad`: Σ over the B·H·W pixels of
    Aᵀ·bmat, flat [taps·ka·nb] (the 3x3's [3,3,ka,nb] HWIO for the shifted
    modes, its 9 taps; [ka,nb] else), with A of ``a`` [B,H,W,ka] by
    ``amode`` and bmat [B,H,W,nb]: :func:`shifted_reference` or one einsum,
    float32 (float64 for float64 inputs). ``bn``: (g, be, μ, i), or (g, be)
    for μ = 0, i = 1 (a fold). ``magnitudes``: of |A| and |bmat|."""
    f = torch.abs if magnitudes else (lambda t: t)
    af, bf = (t.to(torch.promote_types(t.dtype, torch.float32))
              for t in (a, bmat))
    if amode in (BN_RELU, SHIFTED_BN_RELU):
        g, be, mu, i = (*bn, 0.0, 1.0)[:4]
        af = torch.clamp_min(g * ((af - mu) * i) + be, 0.0)
    if amode in (SHIFTED, SHIFTED_BN_RELU):
        return shifted_reference(f(af), f(bf)).reshape(-1)
    return torch.einsum("bhwk,bhwn->kn", f(af), f(bf)).reshape(-1)


def weight_grad(kind, amode, a, bmat, ka, nb, x, taps, bn=(), splits=None):
    """Σ over the B·H·W pixels of Aᵀ·bmat ([taps·ka·nb] float32), A by
    ``amode``, on the kernel for CUDA tensors: the pixels of x's [B,H,W]
    in ``splits`` chunks (by default a number fixed by the shapes), added
    in order; :func:`weight_grad_reference` for CPU tensors. ``bn`` as
    :func:`weight_grad_reference` takes it; ``kind`` names the caller in
    errors."""
    global launches
    if a.device.type == "cpu":
        return weight_grad_reference(amode, a, bmat, bn)
    if a.device.type != "cuda":
        raise ValueError(f"{kind} runs on cpu or cuda, not {a.device}")
    b, h, w, _ = x.shape
    p = b * h * w
    if splits is None:
        tiles = taps * (ka // (128 if ka % 128 == 0 else 64)) * (
            nb // (128 if nb % 128 == 0 else 64))
        splits = max(1, min(_BLOCKS // tiles, -(-p // _MIN_PIXELS)))
    part = torch.empty(splits * taps * ka * nb, dtype=torch.float32,
                       device=x.device)
    out = torch.empty(taps * ka * nb, dtype=torch.float32, device=x.device)
    ptrs = _build.pointers(kind, _NAMES, {
        "a": a, "b": bmat, "part": part, "out": out,
        **dict(zip(_NAMES[2:6], bn))})
    err = _build.library("bottleneck_wgrad").tr_bottleneck_wgrad(
        amode, ptrs, p, ka, nb, h, w, splits, _build.DTYPE_CODES[a.dtype],
        x.device.index, _build.stream(x))
    _build.check(err, kind)
    launches += 1
    return out
