"""Pre-activation ResNet-v2 (CIFAR 6n+2 and ImageNet 18-200 generators)
in PyTorch.

Port of ``tpu_resnet/models/resnet.py``. Module and parameter names follow
the reference's variable tree (``convert.flax_to_torch`` maps one onto the
other), so a block means the same thing in both packages:

- parameters are float32; convolutions and the dense layer compute in
  ``dtype`` (bfloat16 by default) and the logits come back in float32;
- BN+ReLU sites run as plain BN (``epilogue="off"``), as the fused
  scale-bias-ReLU kernel (``"on"``, ``ops/epilogue.py``), or fold the same
  way and take the kernel only at shapes where the timed A/B chose it
  (``"auto"``, ``ep.scale_bias_relu_auto``; an unprobed shape runs the
  plain version);
- with ``fused_blocks`` every stride-1 identity basic block of a stage
  where the reference finds a plan (``fb.reference_fuses`` of the stage
  shape that block0 leaves, from the model's ``image_size``: the CIFAR
  stages and ImageNet ResNet-18/34's 56²×64, 28²×128 and 14²×256 at 224²,
  not its 7²×512) runs as the fused block kernel (``ops/fused_block.py``)
  and every stride-1 identity bottleneck of width 64, 128 or 256 as the
  fused bottleneck kernel (``ops/fused_bottleneck.py``); each stage's
  block0, the stride/projection block, and the other stages stay on
  ``F.conv2d``, as in the reference.

Activations are NHWC tensors (channels_last storage) throughout, as at the
reference's public functions. ``forward(x, train=True)`` normalises with the
batch moments and updates the running statistics in place (flax's EMA,
momentum 0.997, biased variance). A fused basic block trains through the
live-BN fused kernels (``fb.block_train_apply``), a fused bottleneck
through the live-BN fused bottleneck kernels (``fbn.bottleneck_train_apply``).

Synced BN (``model.sync_bn=true``) across more than one rank: inside
:func:`synced_batch_norm` the plain BN sites take their moments over the
global batch, Σx and Σx² summed over the ranks in one differentiable
all-reduce per site (its backward all-reduces the two sums' cotangents),
in flax's E[x²] − E[x]² form; the running statistics then see the global
moments. Outside it (one rank, or per-replica BN) the moments are the
local batch's.

``remat`` recomputes each block's forward in the backward pass instead of
keeping its activations (``torch.utils.checkpoint``, the reference's
``nn.remat`` per block); the recompute leaves the running statistics as
the first forward set them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_resnet_torch.ops import epilogue as ep
from tpu_resnet_torch.ops import fused_block as fb
from tpu_resnet_torch.ops import fused_bottleneck as fbn

_BATCH_NORM_MOMENTUM = 0.997
# The rank count of the synced-BN moments, set by synced_batch_norm.
_sync_world = 1
_BATCH_NORM_EPSILON = 1e-5
EPILOGUES = ("off", "on", "auto")


def _conv_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int,
               padding: int) -> torch.Tensor:
    """``F.conv2d`` over an NHWC tensor (given to cuDNN as a channels_last
    NCHW view), weights cast to x's dtype; returns contiguous NHWC."""
    w = weight.to(x.dtype).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


@contextlib.contextmanager
def synced_batch_norm(world: int):
    """Within it, the plain BN sites of a training forward take their
    moments over ``world`` ranks' batches (the default process group)."""
    global _sync_world
    prev, _sync_world = _sync_world, int(world)
    try:
        yield
    finally:
        _sync_world = prev


def _check_local_moments() -> None:
    """The fused kernels take their moments over the batch they see."""
    if _sync_world > 1:
        raise ValueError(
            "model.fused_blocks on a multi-chip data axis requires "
            "model.sync_bn=false: the fused kernels take per-replica BN "
            "moments")


class BatchNormRelu(nn.Module):
    """BN (float32 parameters and running statistics) then ReLU.

    ``epilogue="off"`` is flax's ``nn.BatchNorm``: (x - mean) * gamma *
    rsqrt(var + eps) + beta in float32, cast to x's dtype. ``"on"`` folds
    the statistics into a scale/bias and runs the fused epilogue kernel,
    differentiable through its backward kernel; ``"auto"`` folds the same
    way and runs the kernel where ``autotune`` chose it for x's shape, the
    plain version elsewhere (reference ``BatchNormRelu``, :113-118).

    Training (reference ``models/resnet.py`` BatchNormRelu): batch moments
    in float32 over (B, H, W), variance ``max(E[x²] - E[x]², 0)``;
    gradients flow through both back to x. The running statistics update
    in place as ``ra = 0.997·ra + 0.003·batch`` (not ``nn.BatchNorm2d``'s
    momentum 0.1 and unbiased variance)."""

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
        self.frozen = False   # set while a remat recompute runs

    def folded(self):
        """(scale, bias) of the inference BN."""
        return fb._fold(self.weight, self.bias, self.running_mean,
                        self.running_var, _BATCH_NORM_EPSILON)

    def _batch_moments(self, x: torch.Tensor):
        xf = x.float()
        if _sync_world > 1:
            from tpu_resnet_torch.parallel.collectives import all_reduce_sum
            sums = all_reduce_sum(torch.cat([
                xf.sum(dim=(0, 1, 2)), torch.square(xf).sum(dim=(0, 1, 2))]))
            count = xf[..., 0].numel() * _sync_world
            mean, sq = (sums / count).chunk(2)
            var = torch.clamp_min(sq - torch.square(mean), 0.0)
        else:
            mean = xf.mean(dim=(0, 1, 2))
            var = torch.clamp_min(torch.square(xf).mean(dim=(0, 1, 2))
                                  - torch.square(mean), 0.0)
        self.update_running(mean, var)
        return mean, var

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """flax's EMA of the batch moments, in place (not while
        ``frozen``)."""
        if self.frozen:
            return
        m = _BATCH_NORM_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            mean, var = self._batch_moments(x)
        else:
            mean, var = self.running_mean, self.running_var
        if self.epilogue != "off":
            sbr = (ep.scale_bias_relu if self.epilogue == "on"
                   else ep.scale_bias_relu_auto)
            return sbr(x, *fb._fold(self.weight, self.bias, mean, var,
                                    _BATCH_NORM_EPSILON))
        mul = torch.rsqrt(var + _BATCH_NORM_EPSILON) * self.weight
        y = (x.float() - mean) * mul + self.bias
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shortcut = x
        x = self.preact(x, train)
        if self.proj is not None:
            shortcut = self.proj(x)
        x = self.conv2(self.bnrelu1(self.conv1(x), train))
        return x + shortcut


class FusedBuildingBlock(nn.Module):
    """A stride-1 identity :class:`BuildingBlock` run as the fused block
    kernels, weights handed over in their HWIO layout. Eval folds the
    running statistics to scale/bias (``fb.block_apply``: ``block_fwd``,
    and ``block_bwd`` when a gradient is taken); training
    normalises with the batch moments (``fb.block_train_apply``) and
    updates the running statistics from them, as the reference's
    FusedBuildingBlock does. Same parameters, same names."""

    def __init__(self, filters: int):
        super().__init__()
        self.preact = BatchNormRelu(filters)
        self.conv1 = ConvFixedPadding(filters, filters, 3, 1)
        self.bnrelu1 = BatchNormRelu(filters)
        self.conv2 = ConvFixedPadding(filters, filters, 3, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        w1 = self.conv1.weight.permute(2, 3, 1, 0).contiguous()
        w2 = self.conv2.weight.permute(2, 3, 1, 0).contiguous()
        if train:
            _check_local_moments()
            y, (m1, v1, m2, v2) = fb.block_train_apply(
                x, w1, w2, self.preact.weight, self.preact.bias,
                self.bnrelu1.weight, self.bnrelu1.bias, _BATCH_NORM_EPSILON)
            self.preact.update_running(m1, v1)
            self.bnrelu1.update_running(m2, v2)
            return y
        s1, b1 = self.preact.folded()
        s2, b2 = self.bnrelu1.folded()
        return fb.block_apply(x, w1, w2, s1, b1, s2, b2)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1(4f) pre-activation bottleneck. The stride is on the
    3x3 (v2); the projection, a 1x1 to 4f with the block's stride, convolves
    the pre-activated input."""

    def __init__(self, in_features: int, filters: int, strides: int,
                 use_projection: bool, epilogue: str = "off"):
        super().__init__()
        self.preact = BatchNormRelu(in_features, epilogue)
        self.proj = (ConvFixedPadding(in_features, 4 * filters, 1, strides)
                     if use_projection else None)
        self.conv1 = ConvFixedPadding(in_features, filters, 1, 1)
        self.bnrelu1 = BatchNormRelu(filters, epilogue)
        self.conv2 = ConvFixedPadding(filters, filters, 3, strides)
        self.bnrelu2 = BatchNormRelu(filters, epilogue)
        self.conv3 = ConvFixedPadding(filters, 4 * filters, 1, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shortcut = x
        x = self.preact(x, train)
        if self.proj is not None:
            shortcut = self.proj(x)
        x = self.bnrelu1(self.conv1(x), train)
        x = self.conv3(self.bnrelu2(self.conv2(x), train))
        return x + shortcut


class FusedBottleneckBlock(nn.Module):
    """A stride-1 identity :class:`BottleneckBlock` run as the fused
    bottleneck kernels, the 1x1 kernels handed over as matrices (w1 [4f,f],
    w3 [f,4f]) and the 3x3 as HWIO. Eval folds the running statistics with
    the bottleneck's own fold (``fbn.bottleneck_apply``: ``bottleneck_fwd``,
    and ``bottleneck_bwd`` when a gradient is taken); training normalises
    with the batch moments (``fbn.bottleneck_train_apply``) and updates the
    three running statistics from them, as the reference's
    FusedBottleneckBlock does. Same parameters, same names."""

    def __init__(self, filters: int):
        super().__init__()
        c4 = 4 * filters
        self.preact = BatchNormRelu(c4)
        self.conv1 = ConvFixedPadding(c4, filters, 1, 1)
        self.bnrelu1 = BatchNormRelu(filters)
        self.conv2 = ConvFixedPadding(filters, filters, 3, 1)
        self.bnrelu2 = BatchNormRelu(filters)
        self.conv3 = ConvFixedPadding(filters, c4, 1, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        w1 = self.conv1.weight[:, :, 0, 0].t().contiguous()
        w2 = self.conv2.weight.permute(2, 3, 1, 0).contiguous()
        w3 = self.conv3.weight[:, :, 0, 0].t().contiguous()
        bns = (self.preact, self.bnrelu1, self.bnrelu2)
        if train:
            _check_local_moments()
            y, moments = fbn.bottleneck_train_apply(
                x, w1, w2, w3, *(p for bn in bns for p in (bn.weight,
                                                           bn.bias)),
                _BATCH_NORM_EPSILON)
            for i, bn in enumerate(bns):
                bn.update_running(*moments[2 * i:2 * i + 2])
            return y
        folds = []
        for bn in bns:
            folds += fbn._fold_bn(bn.weight, bn.bias, bn.running_mean,
                                  torch.rsqrt(bn.running_var
                                              + _BATCH_NORM_EPSILON))
        return fbn.bottleneck_apply(x, w1, w2, w3, *folds)


@contextlib.contextmanager
def _frozen_running_stats(block: nn.Module):
    bns = [m for m in block.modules() if isinstance(m, BatchNormRelu)]
    for bn in bns:
        bn.frozen = True
    try:
        yield
    finally:
        for bn in bns:
            bn.frozen = False


def _remat_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x, train=True)`` under ``torch.utils.checkpoint``: the
    backward reruns the forward with the running statistics frozen, so they
    move once per step, as without remat."""
    calls = []

    def run(inp):
        calls.append(None)
        if len(calls) == 1:
            return block(inp, True)
        with _frozen_running_stats(block):
            return block(inp, True)

    return checkpoint(run, x, use_reentrant=False)


class BlockLayer(nn.Module):
    """A stage: block0 strides and projects; blocks 1.. are stride-1
    identity blocks, fused when ``fused`` where the reference fuses them:
    bottlenecks at the widths the fused kernel takes (``fbn.WIDTHS``: f=512
    stays on F.conv2d), basic blocks where ``fb.reference_fuses`` holds for
    the stage shape that block0 leaves, ``size`` x ``size`` x ``filters``
    (the 7²×512 ImageNet stage stays on F.conv2d); a basic stage that the
    reference fuses at a width without kernels (``fb.CHANNELS``) raises.
    The forward checks the shape it meets against that decision.
    ``remat``: each block recomputed in the backward pass."""

    def __init__(self, in_features: int, filters: int, blocks: int,
                 strides: int, fused: bool = False, epilogue: str = "off",
                 bottleneck: bool = False, remat: bool = False,
                 size: int | None = None):
        super().__init__()
        self.remat = remat
        block_cls = BottleneckBlock if bottleneck else BuildingBlock
        # Basic stages probe their shape, as the reference's BlockLayer.
        self.probed = fused and not bottleneck and blocks > 1
        if self.probed and size is None:
            raise ValueError("a fused basic stage needs its spatial size")
        fuse = fused and (filters in fbn.WIDTHS if bottleneck
                          else fb.reference_fuses((1, size, size, filters)))
        if fuse and not bottleneck and filters not in fb.CHANNELS:
            raise NotImplementedError(
                f"the reference fuses the basic blocks of a {size}x{size}x"
                f"{filters} stage; the port's block kernels take C in "
                f"{fb.CHANNELS}")
        self.fuse = fuse
        fused_cls = FusedBottleneckBlock if bottleneck else FusedBuildingBlock
        out_features = 4 * filters if bottleneck else filters
        self.add_module("block0", block_cls(in_features, filters, strides,
                                            True, epilogue))
        for i in range(1, blocks):
            self.add_module(f"block{i}", fused_cls(filters) if fuse
                            else block_cls(out_features, filters, 1, False,
                                           epilogue))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        remat = self.remat and train and torch.is_grad_enabled()
        for i, block in enumerate(self.children()):
            if i == 1 and self.probed and (fb.reference_fuses(x.shape)
                                           != self.fuse):
                raise ValueError(
                    f"stage built {'fused' if self.fuse else 'unfused'} "
                    f"for another image size; the reference "
                    f"{'does not fuse' if self.fuse else 'fuses'} its "
                    f"blocks at {tuple(x.shape[1:])}")
            x = _remat_block(block, x) if remat else block(x, train)
        return x


class ImagenetStem(nn.Module):
    """The ImageNet 7x7/2 stem conv, one 7x7xCxF parameter (``weight``,
    OIHW), in either of the reference's two equal forms:

    - space-to-depth (``space_to_depth``, even inputs): the kernel padded to
      8x8 with a zero leading row and column and rearranged to 4x4x4C, the
      input rearranged to s2d(2) with channel order (row, column, channel),
      then a 4x4/1 conv with padding (2, 1);
    - plain (odd inputs, or ``space_to_depth=False``): 7x7/2 with fixed
      padding (3, 3)."""

    def __init__(self, in_features: int, filters: int,
                 space_to_depth: bool = True):
        super().__init__()
        self.space_to_depth = space_to_depth
        self.weight = nn.Parameter(torch.empty(filters, in_features, 7, 7))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if not self.space_to_depth or h % 2 or w % 2:
            return _conv_nhwc(x, self.weight, 2, 3)
        f = self.weight.shape[0]
        k8 = F.pad(self.weight.permute(2, 3, 1, 0), (0, 0, 0, 0, 1, 0, 1, 0))
        k4 = k8.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5).reshape(
            4, 4, 4 * c, f).permute(3, 2, 0, 1)
        xs = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        xs = F.pad(xs, (0, 0, 2, 1, 2, 1))
        return _conv_nhwc(xs, k4, 1, 0)


def max_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (s, s), "SAME")`` over NHWC: SAME pads
    (total // 2, total - total // 2) with -inf, so 112 -> 56 pads (0, 1),
    not the (1, 1) of ``F.max_pool2d(padding=1)``."""
    pads = []
    for n in (x.shape[2], x.shape[1]):   # F.pad order: W, then H
        total = max((-(-n // stride) - 1) * stride + window - n, 0)
        pads += [total // 2, total - total // 2]
    xp = F.pad(x.permute(0, 3, 1, 2), pads, value=float("-inf"))
    return F.max_pool2d(xp, window, stride).permute(0, 2, 3, 1).contiguous()


class ResNetV2(nn.Module):
    """Pre-activation ResNet-v2 over NHWC inputs. ``stem="cifar"``: 3x3/1
    conv, no max-pool; ``stem="imagenet"``: 7x7/2 conv (space-to-depth by
    default) and a 3x3/2 SAME max-pool. ``image_size`` (default 32, or 224
    with the ImageNet stem) sizes each stage, where fused basic stages
    probe the reference's plan."""

    def __init__(self, stage_filters: Sequence[int],
                 stage_blocks: Sequence[int], stage_strides: Sequence[int],
                 num_classes: int, stem_filters: int = 16,
                 dtype: torch.dtype = torch.bfloat16,
                 fused_blocks: bool = False, fused_epilogue: str = "off",
                 bottleneck: bool = False, stem: str = "cifar",
                 stem_space_to_depth: bool = True, remat: bool = False,
                 image_size: int | None = None):
        super().__init__()
        self.dtype = dtype
        if stem == "cifar":
            self.initial_conv = ConvFixedPadding(3, stem_filters, 3, 1)
            size = image_size or 32
        elif stem == "imagenet":
            self.initial_conv = ImagenetStem(3, stem_filters,
                                             stem_space_to_depth)
            # The 7x7/2 conv, then the 3x3/2 SAME max-pool.
            size = -(-(-(-(image_size or 224) // 2)) // 2)
        else:
            raise ValueError(f"unknown stem {stem!r}")
        self.stem = stem
        prev = stem_filters
        for i, (f, b, s) in enumerate(zip(stage_filters, stage_blocks,
                                          stage_strides)):
            size = -(-size // s)   # the shape block0 leaves
            self.add_module(f"block_layer{i + 1}", BlockLayer(
                prev, f, b, s, fused_blocks, fused_epilogue, bottleneck,
                remat, size))
            prev = 4 * f if bottleneck else f
        self.final_bnrelu = BatchNormRelu(prev, fused_epilogue)
        self.final_dense = nn.Linear(prev, num_classes)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """x float [B,H,W,3] → logits float32 [B,num_classes]. ``train``:
        batch-moment BN, running statistics updated in place."""
        x = self.initial_conv(x.to(self.dtype))
        if self.stem == "imagenet":
            x = max_pool_same(x)
        for name, layer in self.named_children():
            if name.startswith("block_layer"):
                x = layer(x, train)
        x = self.final_bnrelu(x, train)
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
                    fused_epilogue: str = "off",
                    remat: bool = False,
                    image_size: int = 32) -> ResNetV2:
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
                    fused_blocks=fused_blocks, fused_epilogue=fused_epilogue,
                    remat=remat, image_size=image_size)


# size: (bottleneck, stage_blocks), as the reference's _IMAGENET_PARAMS.
IMAGENET_PARAMS = {
    18: (False, (2, 2, 2, 2)),
    34: (False, (3, 4, 6, 3)),
    50: (True, (3, 4, 6, 3)),
    101: (True, (3, 4, 23, 3)),
    152: (True, (3, 8, 36, 3)),
    200: (True, (3, 24, 36, 3)),
}


def imagenet_resnet_v2(resnet_size: int, num_classes: int,
                       dtype: torch.dtype = torch.bfloat16,
                       stem_space_to_depth: bool = True,
                       fused_blocks: bool = False,
                       fused_epilogue: str = "off",
                       remat: bool = False,
                       image_size: int = 224) -> ResNetV2:
    """ImageNet ResNet-v2 18/34/50/101/152/200 (stages 64/128/256/512,
    ImageNet stem). ``fused_blocks``: the bottleneck sizes fuse their
    stages of width 64-256; ResNet-18/34 fuse the basic stages where the
    reference finds a plan at ``image_size`` (at 224²: 56²×64, 28²×128,
    14²×256; the 7²×512 stage stays on F.conv2d)."""
    if resnet_size not in IMAGENET_PARAMS:
        raise ValueError(f"invalid resnet_size {resnet_size}; have "
                         f"{sorted(IMAGENET_PARAMS)}")
    bottleneck, blocks = IMAGENET_PARAMS[resnet_size]
    return ResNetV2(stage_filters=(64, 128, 256, 512), stage_blocks=blocks,
                    stage_strides=(1, 2, 2, 2), num_classes=num_classes,
                    stem_filters=64, dtype=dtype, fused_blocks=fused_blocks,
                    fused_epilogue=fused_epilogue, bottleneck=bottleneck,
                    stem="imagenet", stem_space_to_depth=stem_space_to_depth,
                    remat=remat, image_size=image_size)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation with the reference's distributions: convs
    variance_scaling(1.0, fan_in, truncated_normal), the dense kernel
    xavier-uniform with a zero bias, BN gamma 1, beta 0, mean 0, var 1.
    Draws on the CPU; move the model afterwards."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (ConvFixedPadding, ImagenetStem)):
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
