#!/usr/bin/env python3
"""Device time of the eval-mode fused model's backward on a CUDA card, the
model of ``chip_smoke.py``'s grad phase: ``--preset cifar10`` (CIFAR-10
ResNet-50) or ``imagenet`` (ImageNet ResNet-50 at 224²) with
``model.fused_blocks=true model.fused_epilogue=on
model.compute_dtype=float32``, seeded weights, B=16, the gradient of
Σ logits·cotangent in the images and every parameter.

    python3 tools/profile_torch_grad.py [--preset cifar10|imagenet]
        [--iters 5] [--root DIR] [--tag NAME]

One forward builds the graph; then ``--iters`` backwards (the graph kept)
run under ``torch.profiler``. Prints one JSON line: the backward's device
busy ms (the kernels' device times summed; one stream), the folded
gradients' share of it (the kernels that ``block_bwd`` or
``bottleneck_bwd`` launches, by name), and the kernels by device time with
their launches per backward. The package profiled is the one under
``--root`` (default: this checkout), so a parent commit unpacked into an
ignored directory runs beside it in one run on one card. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

OVERRIDES = ["model.fused_blocks=true", "model.fused_epilogue=on",
             "model.compute_dtype=float32"]
BATCH = 16
# Kernel names of the folded gradients in a backward (block_bwd* and
# bottleneck_bwd*: the tile passes or a parent's row kernels; the
# bottleneck's p2 pass, its step 2, the sums of rows and the weight
# gradients).
FOLDED = ("block_bwd", "bottleneck_bwd", "bottleneck_fold",
          "bottleneck_fwd_p2", "bottleneck_sum", "bottleneck_wgrad")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="cifar10")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.device import resolve_device
    from tpu_resnet_torch.models import build_model, init_weights
    from tpu_resnet_torch.tools.profiling import device_profile
    if not torch.cuda.is_available():
        print("profile_torch_grad: needs a CUDA card", file=sys.stderr)
        return 2
    device = resolve_device("cuda")
    cfg = load_config(args.preset, "", OVERRIDES)
    size, classes = cfg.data.resolved_image_size, cfg.data.num_classes
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(6))
    model = model.to(device).eval()
    gen = torch.Generator(device="cuda").manual_seed(8)
    leaf = torch.randn(BATCH, size, size, 3, generator=gen,
                       device="cuda").requires_grad_()
    cot = torch.randn(BATCH, classes, generator=gen, device="cuda")
    params = list(model.parameters())
    loss = (model(leaf, train=False).float() * cot).sum()

    def backward():
        return torch.autograd.grad(loss, [leaf, *params], retain_graph=True)

    for _ in range(2):
        backward()
    torch.cuda.synchronize()
    prof = device_profile(backward, args.iters)
    kernels = prof["kernels"]
    folded = [k for k in kernels
              if any(name in k["name"] for name in FOLDED)
              and "at::" not in k["name"]]
    print(json.dumps({
        "tag": args.tag, "root": root, "preset": args.preset,
        "batch": BATCH, "gpu": torch.cuda.get_device_name(0),
        "device_busy_ms_per_backward": prof["device_busy_ms"],
        "folded_ms_per_backward": sum(k["ms_per_call"] for k in folded),
        "folded_launches_per_backward": sum(k["launches_per_call"]
                                            for k in folded),
        "kernels": [{"name": k["name"], "ms_per_backward": k["ms_per_call"],
                     "launches_per_backward": k["launches_per_call"]}
                    for k in kernels]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
