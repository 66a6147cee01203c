"""The serve forward's kernels as ``torch.library`` custom ops, for tracing.

``torch.export`` traces with fake tensors, which hold no data, so a wrapper
that hands ``data_ptr()`` to a C function cannot be traced through. While
tracing (``torch.compiler.is_compiling()``, true under ``torch.export``),
the wrappers of the three kernels the serve forward runs
(``epilogue._sbr_kernel``, ``fused_block.block_fwd``,
``fused_bottleneck.bottleneck_fwd``) call the ops below instead, so that an
exported program holds one node a call: ``tpu_resnet_torch::sbr``,
``::block_fwd`` and ``::bottleneck_fwd``. An op's body is its wrapper's
launch: the CUDA kernel for a CUDA tensor (counted there, so a loaded
program's launches count as an eager forward's do), the plain version for a
CPU tensor, a raise for anything else. Its fake gives the output's shape
and dtype, x's, under a symbolic batch.

Eager calls do not pass through here: the custom-op dispatch adds host time
to every call, and the eager forward and the graphed train step keep their
own.

Importing ``tpu_resnet_torch.ops`` registers the ops, which
``torch.export.load`` of a program holding them needs.
"""

from __future__ import annotations

from typing import Optional

import torch

NAMESPACE = "tpu_resnet_torch"
OPS = ("sbr", "block_fwd", "bottleneck_fwd")


@torch.library.custom_op(f"{NAMESPACE}::sbr", mutates_args=())
def sbr(x: torch.Tensor, scale: torch.Tensor,
        bias: torch.Tensor) -> torch.Tensor:
    from tpu_resnet_torch.ops import epilogue
    return epilogue._sbr_launch(x, scale, bias)


@sbr.register_fake
def _sbr_fake(x, scale, bias):
    return torch.empty_like(x)


@torch.library.custom_op(f"{NAMESPACE}::block_fwd", mutates_args=())
def block_fwd(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              s1: torch.Tensor, b1: torch.Tensor, s2: torch.Tensor,
              b2: torch.Tensor,
              c1: Optional[torch.Tensor] = None) -> torch.Tensor:
    from tpu_resnet_torch.ops import fused_block
    return fused_block._block_fwd_launch(x, w1, w2, s1, b1, s2, b2, c1=c1)


@block_fwd.register_fake
def _block_fwd_fake(x, w1, w2, s1, b1, s2, b2, c1=None):
    return torch.empty_like(x)


@torch.library.custom_op(f"{NAMESPACE}::bottleneck_fwd", mutates_args=())
def bottleneck_fwd(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   w3: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                   s2: torch.Tensor, b2: torch.Tensor, s3: torch.Tensor,
                   b3: torch.Tensor) -> torch.Tensor:
    from tpu_resnet_torch.ops import fused_bottleneck
    return fused_bottleneck._bottleneck_fwd_launch(x, w1, w2, w3, s1, b1, s2,
                                                   b2, s3, b3)


@bottleneck_fwd.register_fake
def _bottleneck_fwd_fake(x, w1, w2, w3, s1, b1, s2, b2, s3, b3):
    return torch.empty_like(x)
