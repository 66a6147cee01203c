"""Pre-activation ResNet-v2 (CIFAR 6n+2 generator), eval mode, in PyTorch.

Port of ``tpu_resnet/models/resnet.py``. Module and parameter names follow
the reference's variable tree (``convert.flax_to_torch`` maps one onto the
other), so a block means the same thing in both packages:

- parameters are float32; convolutions and the dense layer compute in
  ``dtype`` (bfloat16 by default) and the logits come back in float32;
- BN+ReLU sites run as plain BN (``epilogue="off"``) or as the fused
  scale-bias-ReLU kernel (``"on"``, ``ops/epilogue.py``);
- with ``fused_blocks`` every stride-1 identity block runs as the fused
  block kernel (``ops/fused_block.py``); each stage's block0, the
  stride/projection block, stays on ``F.conv2d``.

Activations are NHWC tensors (channels_last storage) throughout, as at the
reference's public functions. Only eval exists here: ``train=True`` raises.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_resnet_torch.ops import epilogue as ep
from tpu_resnet_torch.ops import fused_block as fb

_BATCH_NORM_EPSILON = 1e-5
EPILOGUES = ("off", "on")


def _conv_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int,
               padding: int) -> torch.Tensor:
    """``F.conv2d`` over an NHWC tensor (given to cuDNN as a channels_last
    NCHW view), weights cast to x's dtype; returns contiguous NHWC."""
    w = weight.to(x.dtype).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


class BatchNormRelu(nn.Module):
    """BN (float32 parameters and running statistics) then ReLU.

    ``epilogue="off"`` is flax's inference BN: (x - mean) * gamma *
    rsqrt(var + eps) + beta in float32, cast to x's dtype. ``"on"`` folds
    the statistics into a scale/bias and runs the fused epilogue kernel."""

    def __init__(self, features: int, epilogue: str = "off"):
        super().__init__()
        if epilogue not in EPILOGUES:
            raise ValueError(f"epilogue must be one of {EPILOGUES}, got "
                             f"{epilogue!r}")
        self.epilogue = epilogue
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def folded(self):
        """(scale, bias) of the inference BN."""
        return fb._fold(self.weight, self.bias, self.running_mean,
                        self.running_var, _BATCH_NORM_EPSILON)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.epilogue == "on":
            return ep.scale_bias_relu(x, *self.folded())
        mul = self.weight * torch.rsqrt(self.running_var + _BATCH_NORM_EPSILON)
        y = (x.float() - self.running_mean) * mul + self.bias
        return torch.relu(y.to(x.dtype))


class ConvFixedPadding(nn.Module):
    """Bias-free conv; for a stride above 1 the padding depends only on the
    kernel size (reference ``fixed_padding``), for stride 1 it is SAME.
    Odd kernels only: both rules then pad (k-1)//2 on each side."""

    def __init__(self, in_features: int, filters: int, kernel_size: int,
                 strides: int):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError(f"odd kernel sizes only, got {kernel_size}")
        self.strides = strides
        self.padding = (kernel_size - 1) // 2
        self.weight = nn.Parameter(torch.empty(
            filters, in_features, kernel_size, kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(x, self.weight, self.strides, self.padding)


class BuildingBlock(nn.Module):
    """Basic 3x3+3x3 pre-activation block; the projection convolves the
    pre-activated input."""

    def __init__(self, in_features: int, filters: int, strides: int,
                 use_projection: bool, epilogue: str = "off"):
        super().__init__()
        self.preact = BatchNormRelu(in_features, epilogue)
        self.proj = (ConvFixedPadding(in_features, filters, 1, strides)
                     if use_projection else None)
        self.conv1 = ConvFixedPadding(in_features, filters, 3, strides)
        self.bnrelu1 = BatchNormRelu(filters, epilogue)
        self.conv2 = ConvFixedPadding(filters, filters, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.preact(x)
        if self.proj is not None:
            shortcut = self.proj(x)
        x = self.conv2(self.bnrelu1(self.conv1(x)))
        return x + shortcut


class FusedBuildingBlock(nn.Module):
    """A stride-1 identity :class:`BuildingBlock` run as the fused block
    kernel: running statistics folded to scale/bias, weights handed over
    in the kernel's HWIO layout. Same parameters, same names."""

    def __init__(self, filters: int):
        super().__init__()
        self.preact = BatchNormRelu(filters)
        self.conv1 = ConvFixedPadding(filters, filters, 3, 1)
        self.bnrelu1 = BatchNormRelu(filters)
        self.conv2 = ConvFixedPadding(filters, filters, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s1, b1 = self.preact.folded()
        s2, b2 = self.bnrelu1.folded()
        w1 = self.conv1.weight.permute(2, 3, 1, 0).contiguous()
        w2 = self.conv2.weight.permute(2, 3, 1, 0).contiguous()
        return fb.block_fwd(x, w1, w2, s1, b1, s2, b2)


class BlockLayer(nn.Module):
    """A stage: block0 strides and projects; blocks 1.. are stride-1
    identity blocks, fused when ``fused``."""

    def __init__(self, in_features: int, filters: int, blocks: int,
                 strides: int, fused: bool = False, epilogue: str = "off"):
        super().__init__()
        self.add_module("block0", BuildingBlock(in_features, filters, strides,
                                                True, epilogue))
        for i in range(1, blocks):
            self.add_module(f"block{i}", FusedBuildingBlock(filters) if fused
                            else BuildingBlock(filters, filters, 1, False,
                                               epilogue))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


class ResNetV2(nn.Module):
    """Pre-activation ResNet-v2 with the CIFAR stem (3x3/1 conv, no
    max-pool) over NHWC inputs."""

    def __init__(self, stage_filters: Sequence[int],
                 stage_blocks: Sequence[int], stage_strides: Sequence[int],
                 num_classes: int, stem_filters: int = 16,
                 dtype: torch.dtype = torch.bfloat16,
                 fused_blocks: bool = False, fused_epilogue: str = "off"):
        super().__init__()
        self.dtype = dtype
        self.initial_conv = ConvFixedPadding(3, stem_filters, 3, 1)
        prev = stem_filters
        for i, (f, b, s) in enumerate(zip(stage_filters, stage_blocks,
                                          stage_strides)):
            self.add_module(f"block_layer{i + 1}", BlockLayer(
                prev, f, b, s, fused_blocks, fused_epilogue))
            prev = f
        self.final_bnrelu = BatchNormRelu(prev, fused_epilogue)
        self.final_dense = nn.Linear(prev, num_classes)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """x float [B,H,W,3] → logits float32 [B,num_classes]."""
        if train:
            raise NotImplementedError("train=True: training is a later "
                                      "slice of the port; eval only")
        x = self.initial_conv(x.to(self.dtype))
        for name, layer in self.named_children():
            if name.startswith("block_layer"):
                x = layer(x)
        x = self.final_bnrelu(x)
        # Global spatial mean (accumulated in float32, as jnp.mean does for
        # bfloat16), then the dense layer in the compute dtype.
        x = x.float().mean(dim=(1, 2)).to(self.dtype)
        x = F.linear(x, self.final_dense.weight.to(self.dtype),
                     self.final_dense.bias.to(self.dtype))
        return x.float()


def cifar_resnet_v2(resnet_size: int, num_classes: int,
                    width_multiplier: int = 1,
                    dtype: torch.dtype = torch.bfloat16,
                    fused_blocks: bool = False,
                    fused_epilogue: str = "off") -> ResNetV2:
    """6n+2 CIFAR ResNet-v2 ('ResNet-50' on CIFAR: n=8, stages 16/32/64).
    With ``width_multiplier`` > 1 the Wide-ResNet 6n+4 depth is accepted."""
    if resnet_size % 6 == 2:
        n = (resnet_size - 2) // 6
    elif resnet_size % 6 == 4 and width_multiplier > 1:
        n = (resnet_size - 4) // 6
    else:
        raise ValueError(f"resnet_size must be 6n+2 (or 6n+4 for wide), "
                         f"got {resnet_size}")
    if fused_blocks and width_multiplier > 1:
        raise ValueError("fused_blocks is only measured/tiled for "
                         "width_multiplier=1 (16/32/64-channel stages)")
    w = width_multiplier
    return ResNetV2(stage_filters=(16 * w, 32 * w, 64 * w),
                    stage_blocks=(n, n, n), stage_strides=(1, 2, 2),
                    num_classes=num_classes, stem_filters=16, dtype=dtype,
                    fused_blocks=fused_blocks, fused_epilogue=fused_epilogue)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation with the reference's distributions: convs
    variance_scaling(1.0, fan_in, truncated_normal), the dense kernel
    xavier-uniform with a zero bias, BN gamma 1, beta 0, mean 0, var 1.
    Draws on the CPU; move the model afterwards."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ConvFixedPadding):
                fan_in = m.weight[0].numel()
                # JAX's truncated_normal scales by the std of a unit normal
                # truncated to [-2, 2], so the result has variance 1/fan_in.
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNormRelu):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model
