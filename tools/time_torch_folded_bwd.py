#!/usr/bin/env python3
"""Device time of the folded blocks' gradients, ``block_bwd`` and
``bottleneck_bwd``, one call at a time on one CUDA card, each beside its
plain version: at the eval-mode gradient's shapes (float32, B=16: the CIFAR
ResNet-50's three fused stage shapes, 7 blocks each, and the ImageNet
ResNet-50's at 224², 2, 3 and 5 blocks) and at the A/B tools' (bfloat16,
B=128, one call per stage shape).

    python3 tools/time_torch_folded_bwd.py [--root DIR] [--tag NAME]

Each call is queued behind a device spin, so the CUDA events time the card
alone (median of 10 runs of 3 calls; the plain versions 5 runs of 2).
Inputs are seeded normals, folded scales in [0.5, 1.5) and biases of both
signs. Checked against the plain versions, reported, not gated
(``err_over_limit`` ≤ 1 passes): dx within the forward's tolerance (1e-4
float32, 1e-2 bfloat16, abs and rel), the sums and weight gradients within
1e-5·Σ|terms| + 1e-6. ``per_pass_ms`` sums one eval-mode backward's calls
(``grad``) and one call per shape (``ab``). The package timed is the one
under ``--root`` (default: this checkout), so two checkouts, say a parent
commit unpacked into an ignored directory, run as separate processes in one
run on one card: parent, change, change, parent. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

# (path, dtype name, [(shape, calls per pass)]) per kernel.
BLOCK = (("grad", "float32", [((16, 32, 32, 16), 7), ((16, 16, 16, 32), 7),
                              ((16, 8, 8, 64), 7)]),
         ("ab", "bfloat16", [((128, 32, 32, 16), 1), ((128, 16, 16, 32), 1),
                             ((128, 8, 8, 64), 1)]))
BOTTLENECK = (("grad", "float32", [((16, 56, 56, 256), 2),
                                   ((16, 28, 28, 512), 3),
                                   ((16, 14, 14, 1024), 5)]),
              ("ab", "bfloat16", [((128, 56, 56, 256), 1),
                                  ((128, 28, 28, 512), 1),
                                  ((128, 14, 14, 1024), 1)]))


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
    from tpu_resnet_torch.ops import fused_block as fb
    from tpu_resnet_torch.ops import fused_bottleneck as fbn
    if not torch.cuda.is_available():
        print("time_torch_folded_bwd: needs a CUDA card", file=sys.stderr)
        return 2
    if not fb.__file__.startswith(root):
        raise RuntimeError(f"imported {fb.__file__}, not the one under "
                           f"{root}")
    resolve_device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*size, scale=1.0):
        return torch.randn(size, generator=gen, device="cuda") * scale

    def sb(n):
        return (torch.rand(n, generator=gen, device="cuda") + 0.5,
                randn(n, scale=0.5))

    def time_ms(fn, reps=10, inner=3):
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

    def block_args(shape, dtype):
        c = shape[-1]
        w = (9 * c) ** -0.5
        return (randn(*shape).to(dtype), randn(*shape),
                randn(3, 3, c, c, scale=w), randn(3, 3, c, c, scale=w),
                *sb(c), *sb(c))

    def bottleneck_args(shape, dtype):
        c4 = shape[-1]
        f = c4 // 4
        return (randn(*shape).to(dtype), randn(*shape),
                randn(c4, f, scale=c4 ** -0.5),
                randn(3, 3, f, f, scale=(9 * f) ** -0.5),
                randn(f, c4, scale=f ** -0.5), *sb(c4), *sb(f), *sb(f))

    rows, per_pass = [], {}
    for kind, cases, make, kernel, plain in (
            ("block_bwd", BLOCK, block_args, fb.block_bwd,
             fb.block_bwd_reference),
            ("bottleneck_bwd", BOTTLENECK, bottleneck_args,
             fbn.bottleneck_bwd, fbn.bottleneck_bwd_reference)):
        for path, dtype_name, shapes in cases:
            dtype = getattr(torch, dtype_name)
            tol = 1e-4 if dtype == torch.float32 else 1e-2
            for shape, calls in shapes:
                a = make(shape, dtype)
                got = kernel(*a)
                with torch.backends.cudnn.flags(enabled=False):
                    want = plain(*a)
                    scale = plain(*a, magnitudes=True)
                d = (got[0].float() - want[0].float()).abs()
                dx_over = float((d / (tol + tol * want[0].float().abs()))
                                .max())
                sums_over = max(
                    float(((g - w).abs() / (1e-5 * s + 1e-6)).max())
                    for g, w, s in zip(got[1:], want[1:], scale[1:]))
                del got, want, scale, d
                row = {"kernel": kind, "path": path, "shape": list(shape),
                       "dtype": dtype_name, "calls_per_pass": calls,
                       "ms": time_ms(lambda: kernel(*a)),
                       "plain_ms": time_ms(lambda: plain(*a), reps=5,
                                           inner=2),
                       "dx_err_over_limit": dx_over,
                       "err_over_limit": sums_over}
                rows.append(row)
                totals = per_pass.setdefault(f"{kind} {path}", {})
                for key in ("ms", "plain_ms"):
                    totals[key] = totals.get(key, 0.0) + calls * row[key]
                del a
                torch.cuda.empty_cache()
    print(json.dumps({"tag": args.tag, "root": root,
                      "gpu": torch.cuda.get_device_name(0),
                      "per_pass_ms": per_pass, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
