#!/usr/bin/env python3
"""Device time of the fused bottleneck's forward and second moment pass, one
launch at a time, at ImageNet ResNet-50's three fusable stage shapes: B=16
(the serve forward) and B=128 (the train step), bfloat16, on one CUDA card.

    python3 tools/time_torch_bottleneck.py [--root DIR] [--tag NAME]

Each call is queued behind a device spin, so the CUDA events time the card
alone (median of 10 runs of 5 calls). ``bottleneck_fwd`` is held against its
plain version (max abs error), ``bottleneck_stats_b``'s sums against
1e-5·Σ|terms| + 1e-6 (``err_over_limit`` ≤ 1 passes). ``per_pass`` sums the
launches of one serve forward (10) and one train step (10 of each). The
package timed is the one under ``--root`` (default: this checkout), so two
checkouts, say a parent commit unpacked into an ignored directory, run as
separate processes in one run on one card: parent, change, change,
parent. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

# (spatial, launches per forward pass or train step) of each stage, 4f.
STAGES = (((56, 256), 2), ((28, 512), 3), ((14, 1024), 5))


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
    from tpu_resnet_torch.ops import fused_bottleneck as fbn
    if not torch.cuda.is_available():
        print("time_torch_bottleneck: needs a CUDA card", file=sys.stderr)
        return 2
    if not fbn.__file__.startswith(root):
        raise RuntimeError(f"imported {fbn.__file__}, not the one under "
                           f"{root}")
    resolve_device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*size, scale=1.0):
        return torch.randn(size, generator=gen, device="cuda") * scale

    def positive(n):
        return torch.rand(n, generator=gen, device="cuda") + 0.5

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

    rows, per_pass = [], {}
    for b, kinds in ((16, ("bottleneck_fwd",)),
                     (128, ("bottleneck_fwd", "bottleneck_stats_b"))):
        for (hw, c), n in STAGES:
            f = c // 4
            x = randn(b, hw, hw, c).to(torch.bfloat16)
            w1, w2 = randn(c, f, scale=c ** -0.5), randn(
                3, 3, f, f, scale=(9 * f) ** -0.5)
            for kind in kinds:
                if kind == "bottleneck_fwd":
                    args_ = (x, w1, w2, randn(f, c, scale=f ** -0.5),
                             positive(c), randn(c, scale=0.5), positive(f),
                             randn(f, scale=0.5), positive(f),
                             randn(f, scale=0.5))
                    fn = fbn.bottleneck_fwd
                    d = (fn(*args_).float()
                         - fbn.bottleneck_fwd_reference(*args_).float())
                    check = {"max_abs_err": float(d.abs().max())}
                else:
                    args_ = (x, w1, w2, positive(c), randn(c, scale=0.5),
                             randn(c, scale=0.5), positive(c), positive(f),
                             randn(f, scale=0.5), randn(f, scale=0.5),
                             positive(f))
                    fn = fbn.bottleneck_stats_b
                    with torch.backends.cudnn.flags(enabled=False):
                        want = fbn.bottleneck_stats_b_reference(*args_)
                        scale = fbn.bottleneck_stats_b_reference(
                            *args_, magnitudes=True)
                    check = {"err_over_limit": max(
                        float(((g - w).abs() / (1e-5 * s + 1e-6)).max())
                        for g, w, s in zip(fn(*args_), want, scale))}
                ms = time_ms(lambda: fn(*args_))
                rows.append({"kernel": kind, "shape": [b, hw, hw, c],
                             "ms": ms, **check})
                key = f"{kind} B={b}"
                per_pass[key] = per_pass.get(key, 0.0) + n * ms
            del x
            torch.cuda.empty_cache()
    print(json.dumps({"tag": args.tag, "root": root,
                      "gpu": torch.cuda.get_device_name(0),
                      "per_pass_ms": per_pass, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
