"""A/B the fused bottleneck kernels against the plain PyTorch version of the
identical math (cuBLAS/cuDNN, autograd for the gradients), at ResNet-50's
stride-1 identity bottleneck shapes: the port of the reference's
``tools/fused_bottleneck_ab.py``.

    python -m tpu_resnet_torch.tools.fused_bottleneck_ab [--out JSON]
        [--length 8] [--reps 5] [--batch B] [--shapes b,h,f[;b,h,f...]]
        [--dtype bfloat16|float32] [--device cpu]

The arms, timing, seeding and JSON are those of
:mod:`tpu_resnet_torch.tools.fused_block_ab`: ``fwd`` (``bottleneck_fwd``),
``fwd_bwd`` (``bottleneck_apply`` differentiated in x and all nine
parameters: ``bottleneck_fwd`` and ``bottleneck_bwd``),
``train_fwd_live_bn`` and ``train_fwd_bwd_live_bn``
(``bottleneck_train_fwd``, ``bottleneck_train_apply``, the identity scales
and biases doubling as gammas and betas, as in the reference). The
reference's ``--batch-tile`` and ``--row-tile`` are not taken: the port's
kernels have no tiles (the row kernels choose their band height).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_resnet_torch.device import resolve_device
from tpu_resnet_torch.ops import fused_bottleneck as fbn
from tpu_resnet_torch.tools.fused_block_ab import (Arm, chained, chained_grad,
                                                   parser, run_shapes,
                                                   time_arms)

# (batch, spatial, f): ResNet-50's three fusable identity-bottleneck stage
# shapes (f=512 at 7x7 is not fused).
SHAPES = [(128, 56, 64), (128, 28, 128), (128, 14, 256)]


def shape_key(shape) -> str:
    b, h, _, c4 = shape
    return f"b{b}_{h}x{h}x{c4}_f{c4 // 4}"


def _first(block):
    """A live-BN block's output without its moments."""
    return lambda x, *p: block(x, *p)[0]


def make_arms(shape, length: int, dtype: torch.dtype, device: torch.device
              ) -> Tuple[torch.Tensor, Dict[str, Tuple[Arm, Arm]]]:
    """The input x0 [B,H,W,4f] and each arm's (kernel run, plain run), seeded
    as the reference's tool seeds them."""
    b, h, w, c4 = shape
    f = c4 // 4
    rng = np.random.default_rng(f)
    x0 = torch.from_numpy(rng.normal(size=(b, h, w, c4)).astype(
        np.float32)).to(device=device, dtype=dtype)

    def weight(*size):
        return torch.from_numpy((rng.normal(size=size) * 0.01).astype(
            np.float32)).to(device)

    params = (weight(c4, f), weight(3, 3, f, f), weight(f, c4),
              torch.ones(c4, device=device), torch.zeros(c4, device=device),
              *(t for _ in range(2) for t in (torch.ones(f, device=device),
                                              torch.zeros(f, device=device))))
    return x0, {
        "fwd": (chained(fbn.bottleneck_fwd, params, length),
                chained(fbn.bottleneck_fwd_reference, params, length)),
        "fwd_bwd": (chained_grad(fbn.bottleneck_apply, params, length),
                    chained_grad(fbn.bottleneck_fwd_reference, params,
                                 length)),
        "train_fwd_live_bn": (
            chained(_first(fbn.bottleneck_train_fwd), params, length),
            chained(_first(fbn.bottleneck_train_fwd_reference), params,
                    length)),
        "train_fwd_bwd_live_bn": (
            chained_grad(_first(fbn.bottleneck_train_apply), params, length),
            chained_grad(_first(fbn.bottleneck_train_fwd_reference), params,
                         length))}


def run_shape(shape, length: int, reps: int, dtype: torch.dtype,
              device: torch.device) -> Dict[str, dict]:
    """The four arms' times at one shape [B,H,W,4f]; raises on any
    failure."""
    x0, arms = make_arms(shape, length, dtype, device)
    return time_arms(x0, arms, length, reps)


def main(argv: Optional[List[str]] = None) -> int:
    ap = parser(8, __doc__)
    ap.add_argument("--batch", type=int, default=None,
                    help="override the per-shape batch")
    ap.add_argument("--shapes", default=None,
                    help="override as b,h,f[;b,h,f...]")
    args = ap.parse_args(argv)
    if args.length < 1 or args.reps < 1:
        raise SystemExit("--length and --reps must be >= 1")
    specs = SHAPES
    if args.shapes:
        specs = [tuple(int(v) for v in s.split(","))
                 for s in args.shapes.split(";")]
    shapes = [(args.batch or b, h, h, 4 * f) for b, h, f in specs]
    return run_shapes(shapes, shape_key, run_shape, args,
                      resolve_device(args.device))


if __name__ == "__main__":
    raise SystemExit(main())
