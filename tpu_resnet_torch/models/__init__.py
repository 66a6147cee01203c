"""Model registry: ``build_model(cfg)`` from a ``RunConfig``, with the
reference's guards (``tpu_resnet/models/__init__.py``)."""

from __future__ import annotations

import torch

from tpu_resnet_torch.models import resnet
from tpu_resnet_torch.models.mlp import MLP
from tpu_resnet_torch.models.resnet import (ResNetV2, cifar_resnet_v2,
                                            imagenet_resnet_v2)

__all__ = ["MLP", "ResNetV2", "cifar_resnet_v2", "imagenet_resnet_v2",
           "init_weights", "build_model"]


def init_weights(model: torch.nn.Module,
                 generator: torch.Generator) -> torch.nn.Module:
    """Seeded initialisation with the reference's distributions (the MLP's
    own, or the ResNets' ``resnet.init_weights``), on the CPU."""
    if isinstance(model, MLP):
        return model.init_weights(generator)
    return resnet.init_weights(model, generator)


def build_model(cfg) -> torch.nn.Module:
    """The configured model, on the CPU with uninitialised weights (load a
    checkpoint or call :func:`init_weights`, then move it)."""
    dtype = getattr(torch, cfg.model.compute_dtype)
    if cfg.model.name == "mlp":
        return MLP(hidden_units=cfg.model.mlp_hidden_units,
                   num_classes=cfg.data.num_classes,
                   image_size=cfg.data.resolved_image_size)
    if cfg.model.name != "resnet":
        raise ValueError(f"unknown model {cfg.model.name!r}")
    epilogue = cfg.model.fused_epilogue
    if epilogue not in ("off", "on", "auto"):
        raise ValueError(f"model.fused_epilogue must be off|on|auto, "
                         f"got {epilogue!r}")
    if cfg.data.dataset == "imagenet":
        # fused_blocks: the bottleneck sizes run their stride-1 identity
        # blocks of width 64-256 as the fused bottleneck kernel; the
        # basic-block sizes (18/34) fuse the stages where the reference
        # finds a plan at the configured image size.
        return imagenet_resnet_v2(
            cfg.model.resnet_size, cfg.data.num_classes, dtype=dtype,
            stem_space_to_depth=cfg.model.stem_space_to_depth,
            fused_blocks=cfg.model.fused_blocks, fused_epilogue=epilogue,
            remat=cfg.model.remat,
            image_size=cfg.data.resolved_image_size)
    if cfg.model.fused_blocks and cfg.model.width_multiplier > 1:
        raise ValueError("model.fused_blocks is only measured/tiled for "
                         "width_multiplier=1 (16/32/64-channel stages)")
    return cifar_resnet_v2(cfg.model.resnet_size, cfg.data.num_classes,
                           width_multiplier=cfg.model.width_multiplier,
                           dtype=dtype, fused_blocks=cfg.model.fused_blocks,
                           fused_epilogue=epilogue, remat=cfg.model.remat,
                           image_size=cfg.data.resolved_image_size)
