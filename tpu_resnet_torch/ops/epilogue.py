"""Fused BN+ReLU conv epilogue: ``relu(x * scale + bias)`` over NHWC, and
its backward.

``scale``/``bias`` are the folded BN affine (scale = gamma/sqrt(var+eps),
bias = beta - mean*scale). The math runs in float32 and the result is
stored in x's dtype, as in ``tpu_resnet/ops/epilogue.py::_sbr_kernel``.

:func:`scale_bias_relu` is differentiable. Its forward launches the CUDA
kernel ``tr_sbr`` and its backward :func:`scale_bias_relu_bwd`, the kernel
``tr_sbr_bwd`` (``csrc/epilogue.cu``), which is the reference's custom VJP
(``_sbr_bwd_kernel``): only x, scale and bias are saved, and the ReLU mask
is recomputed from x with the forward's roundings. A CUDA tensor goes to
the kernels or the call raises; a CPU tensor takes the plain versions,
:func:`scale_bias_relu_reference` (differentiable through the same
backward in plain PyTorch) and :func:`scale_bias_relu_bwd_reference`.
``launches`` and ``bwd_launches`` count the kernel launches, so a run can
show that its path went through the kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_resnet_torch.ops import _build

launches = 0      # tr_sbr launches (CUDA tensors only)
bwd_launches = 0  # tr_sbr_bwd calls (two launches each: sums, then their sum)
_BWD_MAX_BLOCKS = 4 * 132   # partial-sum rows of one backward call


def scale_bias_relu_math(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """The epilogue math on float32 values (shared by the fused block's
    plain version, which applies it between its convs)."""
    return torch.clamp_min(x * scale + bias, 0.0)


def _sbr_plain(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    return scale_bias_relu_math(x.float(), scale, bias).to(x.dtype)


def scale_bias_relu_bwd_reference(x: torch.Tensor, scale: torch.Tensor,
                                  bias: torch.Tensor, g: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch backward: (dx in x's dtype, ds, db float32 [C]) with
    the strict mask ``x*scale + bias > 0``."""
    xf = x.float()
    gm = torch.where(xf * scale + bias > 0, g.float(), 0.0)
    dims = tuple(range(x.dim() - 1))
    return ((gm * scale).to(x.dtype), (gm * xf).sum(dims), gm.sum(dims))


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> int:
    if x.dim() != 4:
        raise ValueError(f"x must be [B,H,W,C], got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{c}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if c % 8:
        raise ValueError(f"channels must be a multiple of 8, got {c}")
    return c


def _check_cuda(what: str, **tensors: torch.Tensor) -> None:
    """Contiguity and 16-byte alignment of the kernels' vector accesses."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.dim() == 4 and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _sbr_kernel(x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """The forward: CPU → plain version, CUDA → ``tr_sbr``, else raise."""
    global launches
    c = _check(x, scale, bias)
    if x.device.type == "cpu":
        return _sbr_plain(x, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"scale_bias_relu runs on cpu or cuda, not "
                         f"{x.device}")
    _check_cuda("scale_bias_relu", x=x, scale=scale, bias=bias)
    y = torch.empty_like(x)
    fn = _build.library("epilogue").tr_sbr
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
             x.numel(), c, _build.DTYPE_CODES[x.dtype],
             x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "scale_bias_relu")
    launches += 1
    return y


def scale_bias_relu_bwd(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, g: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`scale_bias_relu` given ``g = dL/dy`` (x's shape
    and dtype): ``(dx, ds, db)``, dx in x's dtype, ds/db float32 [C]."""
    global bwd_launches
    c = _check(x, scale, bias)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must match x ({x.dtype} {tuple(x.shape)} on "
                         f"{x.device}), got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")
    if x.device.type == "cpu":
        return scale_bias_relu_bwd_reference(x, scale, bias, g)
    if x.device.type != "cuda":
        raise ValueError(f"scale_bias_relu_bwd runs on cpu or cuda, not "
                         f"{x.device}")
    _check_cuda("scale_bias_relu_bwd", x=x, g=g, scale=scale, bias=bias)
    pixels = x.numel() // c
    nblocks = max(1, min(_BWD_MAX_BLOCKS, -(-pixels // 256)))
    dx = torch.empty_like(x)
    part = torch.empty(2, nblocks, c, dtype=torch.float32, device=x.device)
    sums = torch.empty(2, c, dtype=torch.float32, device=x.device)
    fn = _build.library("epilogue").tr_sbr_bwd
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), g.data_ptr(),
             dx.data_ptr(), part.data_ptr(), sums.data_ptr(), x.numel(), c,
             nblocks, _build.DTYPE_CODES[x.dtype], x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "scale_bias_relu_bwd")
    bwd_launches += 1
    return dx, sums[0], sums[1]


class _ScaleBiasRelu(torch.autograd.Function):
    """relu(x*s+b) with the reference's custom VJP; ``plain`` picks the
    plain versions on any device (the chip smoke's oracle), else the
    kernels."""

    @staticmethod
    def forward(ctx, x, scale, bias, plain: bool):
        ctx.save_for_backward(x, scale, bias)
        ctx.plain = plain
        return (_sbr_plain if plain else _sbr_kernel)(x, scale, bias)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        bwd = (scale_bias_relu_bwd_reference if ctx.plain
               else scale_bias_relu_bwd)
        dx, ds, db = bwd(x, scale, bias, g.contiguous())
        return dx, ds, db, None


def scale_bias_relu(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """``relu(x * scale + bias)``: x [B,H,W,C] float32/bfloat16, C a
    multiple of 8; scale, bias float32 [C]. Returns x's dtype.
    Differentiable in all three (kernels on CUDA, plain on the CPU)."""
    return _ScaleBiasRelu.apply(x, scale, bias, False)


def scale_bias_relu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version on any device, differentiable through
    :func:`scale_bias_relu_bwd_reference`: the CPU path, the tests' and the
    chip smoke's oracle."""
    return _ScaleBiasRelu.apply(x, scale, bias, True)
