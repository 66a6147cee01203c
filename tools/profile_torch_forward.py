#!/usr/bin/env python3
"""Device-time breakdown of the port's serve forward pass on a CUDA card.

    python3 tools/profile_torch_forward.py [--batch 1 16] [--iters 20]
        [--preset cifar10|imagenet] [section.field=value ...]

Builds the model as the serve path runs it (``--preset``, default
``cifar10``, with ``model.fused_blocks=true model.fused_epilogue=on`` and
then the given overrides; bfloat16, seeded random weights), then for each
batch size runs eval preprocessing and the forward pass ``--iters`` times
under ``torch.profiler``. Prints one JSON line per batch size: wall ms
per forward (host clock, ending in a synchronize), device-busy ms per
forward (sum of the kernels' device times; one stream, so they do not
overlap), the device's idle share, and the kernels by device time with
their launches per forward. Then the card's name and power limit. Needs
CUDA; raises without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpu_resnet_torch.config import load_config  # noqa: E402
from tpu_resnet_torch.device import resolve_device  # noqa: E402
from tpu_resnet_torch.models import build_model, init_weights  # noqa: E402
from tpu_resnet_torch.serve.infer import make_serve_infer  # noqa: E402
from tpu_resnet_torch.tools.profiling import device_profile  # noqa: E402


def profile_batch(model, infer, batch: int, iters: int, size: int) -> dict:
    images = np.random.default_rng(0).integers(
        0, 256, (batch, size, size, 3), dtype=np.uint8)
    for _ in range(5):
        infer(model, images).cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        infer(model, images).cpu()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    prof = device_profile(lambda: infer(model, images).cpu(), iters)
    busy = prof["device_busy_ms"]
    return {"batch": batch, "iters": iters, "wall_ms_per_forward": wall_ms,
            "device_busy_ms_per_forward": busy,
            "device_idle_share": None if busy is None else 1 - busy / wall_ms,
            "images_per_s": batch * 1e3 / wall_ms,
            "kernels": [{"name": k["name"],
                         "ms_per_forward": k["ms_per_call"],
                         "launches_per_forward": k["launches_per_call"]}
                        for k in prof["kernels"]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="+", default=[1, 16])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--preset", default="cifar10")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    cfg = load_config(args.preset, "", ["model.fused_blocks=true",
                                        "model.fused_epilogue=on",
                                        *args.overrides])
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    infer = make_serve_infer(cfg, device)
    for batch in args.batch:
        print(json.dumps(profile_batch(model, infer, batch, args.iters,
                                       cfg.data.resolved_image_size)),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
