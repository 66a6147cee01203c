#!/usr/bin/env python3
"""Device time of the BN+ReLU epilogue's backward (``sbr_bwd``), one call
at a time, at every BN+ReLU site shape of two bfloat16 B=128 train steps on
one CUDA card: the unfused CIFAR ResNet-50 (49 sites) and ImageNet
ResNet-50 at 224x224 with the fused bottlenecks (19 sites); each beside
its plain version.

    python3 tools/time_torch_epilogue.py [--root DIR] [--tag NAME]

Each call is queued behind a device spin, so the CUDA events time the card
alone (median of 10 runs of 5 calls; the plain version 5 runs of 2).
Checked against the plain version: dx bit for bit, ds and db within
1e-5·Σ|terms| + 1e-6 (``err_over_limit`` ≤ 1 passes); inputs are seeded
normals, scales in [0.5, 1.5), biases of both signs. ``per_step_ms`` sums
the calls of one step of each path. The package timed is the one under
``--root`` (default: this checkout), so two checkouts, say a parent commit
unpacked into an ignored directory, run as separate processes in one run
on one card: parent, change, change, parent. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

BATCH = 128
# (shape without the batch, sites a step) of each path's BN+ReLU sites.
PATHS = {
    "cifar10_train": (((32, 32, 16), 17), ((16, 16, 32), 16),
                      ((8, 8, 64), 16)),
    "imagenet_fused_train": (
        ((56, 56, 64), 3), ((56, 56, 256), 1), ((56, 56, 128), 1),
        ((28, 28, 128), 1), ((28, 28, 512), 1), ((28, 28, 256), 1),
        ((14, 14, 256), 1), ((14, 14, 1024), 1), ((14, 14, 512), 1),
        ((7, 7, 512), 5), ((7, 7, 2048), 3)),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from tpu_resnet_torch.device import resolve_device
    from tpu_resnet_torch.ops import epilogue as ep
    if not torch.cuda.is_available():
        print("time_torch_epilogue: needs a CUDA card", file=sys.stderr)
        return 2
    if not ep.__file__.startswith(root):
        raise RuntimeError(f"imported {ep.__file__}, not the one under "
                           f"{root}")
    resolve_device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def time_ms(fn, reps=10, inner=5):
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / inner)
        return statistics.median(times)

    rows, per_step = [], {}
    for path, sites in PATHS.items():
        for hwc, n in sites:
            shape = (BATCH, *hwc)
            c = shape[-1]
            x = torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            g = torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            s = torch.rand(c, generator=gen, device="cuda") + 0.5
            b = torch.randn(c, generator=gen, device="cuda") * 0.5
            got = ep.scale_bias_relu_bwd(x, s, b, g)
            want = ep.scale_bias_relu_bwd_reference(x, s, b, g)
            gm = torch.where(x.float() * s + b > 0, g.float(), 0.0)
            check = 0.0 if torch.equal(got[0], want[0]) else float("inf")
            for k, terms in ((1, gm * x.float()), (2, gm)):
                limit = 1e-5 * terms.abs().sum(dim=(0, 1, 2)) + 1e-6
                check = max(check, float(((got[k] - want[k]).abs()
                                          / limit).max()))
            del got, want, gm
            row = {"shape": list(shape), "sites": n,
                   "ms": time_ms(lambda: ep.scale_bias_relu_bwd(x, s, b, g)),
                   "plain_ms": time_ms(
                       lambda: ep.scale_bias_relu_bwd_reference(x, s, b, g),
                       reps=5, inner=2),
                   "err_over_limit": check}
            rows.append({"path": path, **row})
            totals = per_step.setdefault(path, {"ms": 0.0, "plain_ms": 0.0})
            for key in ("ms", "plain_ms"):
                totals[key] += n * row[key]
            del x, g
            torch.cuda.empty_cache()
    print(json.dumps({"tag": args.tag, "root": root,
                      "gpu": torch.cuda.get_device_name(0),
                      "per_step_ms": per_step, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
