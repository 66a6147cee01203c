"""Fused BN+ReLU conv epilogue: ``relu(x * scale + bias)`` over NHWC.

``scale``/``bias`` are the folded BN affine (scale = gamma/sqrt(var+eps),
bias = beta - mean*scale). The math runs in float32 and the result is
stored in x's dtype, as in ``tpu_resnet/ops/epilogue.py::_sbr_kernel``.

:func:`scale_bias_relu` launches the CUDA kernel (``csrc/epilogue.cu``)
for a CUDA tensor and raises if it cannot; for a CPU tensor it computes
the plain version, :func:`scale_bias_relu_reference`. ``launches`` counts
the kernel launches, so a run can show that its path went through the
kernel.
"""

from __future__ import annotations

import torch

from tpu_resnet_torch.ops import _build

launches = 0  # kernel launches by scale_bias_relu (CUDA tensors only)


def scale_bias_relu_math(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """The epilogue math on float32 values (shared by the fused block's
    plain version, which applies it between its convs)."""
    return torch.clamp_min(x * scale + bias, 0.0)


def scale_bias_relu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the CPU path, the tests' and the chip
    smoke's oracle."""
    return scale_bias_relu_math(x.float(), scale, bias).to(x.dtype)


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


def scale_bias_relu(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """``relu(x * scale + bias)``: x [B,H,W,C] float32/bfloat16, C a
    multiple of 8; scale, bias float32 [C]. Returns x's dtype."""
    global launches
    c = _check(x, scale, bias)
    if x.device.type == "cpu":
        return scale_bias_relu_reference(x, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"scale_bias_relu runs on cpu or cuda, not "
                         f"{x.device}")
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    y = torch.empty_like(x)
    fn = _build.library("epilogue").tr_sbr
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
             x.numel(), c, _build.DTYPE_CODES[x.dtype],
             x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "scale_bias_relu")
    launches += 1
    return y
