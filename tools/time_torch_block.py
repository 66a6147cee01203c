#!/usr/bin/env python3
"""Device time of the fused basic block's kernels, one call at a time, at
the CIFAR ResNet-50's three fused stage shapes, bfloat16 x, on one CUDA
card: at B=128 (the fused train step) ``block_fwd`` (live moments folded,
as the train step calls it: from the stats' c1 where ``block_fwd`` takes
``c1=``, else from x), ``block_stats`` and the three backward passes, and
at B=16 (the serve bucket) ``block_fwd`` from x; each beside its plain
version.

    python3 tools/time_torch_block.py [--root DIR] [--tag NAME]

Each call is queued behind a device spin, so the CUDA events time the card
alone (median of 10 runs of 5 calls; the plain versions 5 runs of 2).
Checked against the plain versions (``err_over_limit`` ≤ 1 passes):
``block_fwd`` and pass 3's dx within ``block_fwd``'s bfloat16 tolerance
(1e-2 abs and rel), the sums of the stats and of passes 1 and 2 within
1e-5·Σ|terms| + 1e-6, the stats' c1 and pass 1's handed-over dz2 and ẑ2
within ``block_fwd``'s float32 tolerance (1e-4); inputs are seeded normals
with the batch's own BN moments. The training ``block_fwd`` and its plain
version take the kernel's own c1. Pass 2 and its plain version take the kernel's own pass 1
handoff, pass 3 its own pass 2's dz1. ``per_step_ms`` sums the calls of one
fused train step (7 blocks a stage), ``per_forward_ms`` those of one B=16
serve forward. The package timed is the one under ``--root`` (default:
this checkout), so two checkouts, say a parent commit unpacked into an
ignored directory, run as separate processes in one run on one card:
parent, change, change, parent. A parent whose pass 3 takes no ``dz1``,
whose pass 2 takes no ``dz2`` and ``z2hat``, or whose ``block_fwd`` takes no
``c1``, recomputes them. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import sys

STAGES = ((32, 16), (16, 32), (8, 64))   # (spatial, C); 7 blocks each
PER_STAGE = 7
TRAIN_BATCH, SERVE_BATCH = 128, 16


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
    if not torch.cuda.is_available():
        print("time_torch_block: needs a CUDA card", file=sys.stderr)
        return 2
    if not fb.__file__.startswith(root):
        raise RuntimeError(f"imported {fb.__file__}, not the one under "
                           f"{root}")
    resolve_device("cuda")
    handoff = "dz1" in inspect.signature(fb.block_bwd3).parameters
    handoff1 = "dz2" in inspect.signature(fb.block_bwd2).parameters
    handoff0 = "c1" in inspect.signature(fb.block_fwd).parameters
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

    def over(got, want, atol, rtol):
        d = (got.float() - want.float()).abs()
        return float((d / (atol + rtol * want.float().abs())).max())

    def sums_over(got, want, scale):
        return max(float(((g - w).abs() / (1e-5 * s + 1e-6)).max())
                   for g, w, s in zip(got, want, scale))

    rows, per_step, per_forward = [], {}, {}

    def record(kind, shape, fn, plain, check, totals):
        row = {"kernel": kind, "shape": list(shape), "ms": time_ms(fn),
               "plain_ms": time_ms(plain, reps=5, inner=2),
               "err_over_limit": check}
        rows.append(row)
        for key, name in (("ms", kind), ("plain_ms", f"{kind} plain")):
            totals[name] = totals.get(name, 0.0) + PER_STAGE * row[key]

    for hw, c in STAGES:
        for b in (TRAIN_BATCH, SERVE_BATCH):
            shape = (b, hw, hw, c)
            x = randn(*shape).to(torch.bfloat16)
            w1, w2 = (randn(3, 3, c, c, scale=(9 * c) ** -0.5) for _ in "12")
            g1, b1, g2, b2 = (positive(c), randn(c, scale=0.5), positive(c),
                              randn(c, scale=0.5))
            m1, v1, m2, v2 = fb.block_train_fwd(x, w1, w2, g1, b1, g2, b2)[1]
            s1, sb1 = fb._fold(g1, b1, m1, v1, fb.EPS)
            s2, sb2 = fb._fold(g2, b2, m2, v2, fb.EPS)
            fwd = (x, w1, w2, s1, sb1, s2, sb2)
            # The train step's forward from the stats' c1 (one launch).
            kw0 = ({"c1": fb.block_stats(x, w1, s1, sb1)[2]}
                   if handoff0 and b == TRAIN_BATCH else {})
            with torch.backends.cudnn.flags(enabled=False):
                want = fb.block_fwd_reference(*fwd)
            record("block_fwd", shape, lambda: fb.block_fwd(*fwd, **kw0),
                   lambda: fb.block_fwd_reference(*fwd, **kw0),
                   over(fb.block_fwd(*fwd, **kw0), want, 1e-2, 1e-2),
                   per_step if b == TRAIN_BATCH else per_forward)
            if b == SERVE_BATCH:
                continue
            stats = fb.block_stats(x, w1, s1, sb1)
            with torch.backends.cudnn.flags(enabled=False):
                want0 = fb.block_stats_reference(x, w1, s1, sb1)
                scale0 = fb.block_stats_reference(x, w1, s1, sb1,
                                                  magnitudes=True)
            check0 = sums_over(stats[:2], want0[:2], scale0[:2])
            if handoff0:
                check0 = max(check0, over(stats[2], want0[2], 1e-4, 1e-4))
            gy = randn(*shape)
            i1, i2 = torch.rsqrt(v1 + fb.EPS), torch.rsqrt(v2 + fb.EPS)
            base = (x, gy, w1, w2, g1, b1, g2, b2, m1, i1, m2, i2)
            out1 = fb.block_bwd1(*base)
            t = out1[:2]
            kw2 = ({"dz2": out1[3], "z2hat": out1[4]} if handoff1 else {})
            out2 = fb.block_bwd2(*base, *t, **kw2)
            u = out2[:2]
            kw3 = {"dz1": out2[3]} if handoff else {}
            with torch.backends.cudnn.flags(enabled=False):
                want1 = fb.train_bwd_pass1_reference(*base)
                scale1 = fb.train_bwd_pass1_reference(*base, magnitudes=True)
                want2 = fb.train_bwd_pass2_reference(*base, *t, **kw2)
                scale2 = fb.train_bwd_pass2_reference(*base, *t, **kw2,
                                                      magnitudes=True)
                want3 = fb.train_bwd_pass3_reference(*base, *t, *u, **kw3)
            check1 = sums_over(out1[:3], want1[:3], scale1[:3])
            if handoff1:
                check1 = max(check1, *(over(g, w, 1e-4, 1e-4)
                                       for g, w in zip(out1[3:], want1[3:])))
            calls = {
                "block_stats": (lambda: fb.block_stats(x, w1, s1, sb1),
                                lambda: fb.block_stats_reference(
                                    x, w1, s1, sb1), check0),
                "block_bwd1": (lambda: fb.block_bwd1(*base),
                               lambda: fb.train_bwd_pass1_reference(*base),
                               check1),
                "block_bwd2": (lambda: fb.block_bwd2(*base, *t, **kw2),
                               lambda: fb.train_bwd_pass2_reference(
                                   *base, *t, **kw2),
                               sums_over(out2[:3], want2[:3], scale2[:3])),
                "block_bwd3": (lambda: fb.block_bwd3(*base, *t, *u, **kw3),
                               lambda: fb.train_bwd_pass3_reference(
                                   *base, *t, *u, **kw3),
                               over(fb.block_bwd3(*base, *t, *u, **kw3),
                                    want3, 1e-2, 1e-2))}
            for kind, (fn, plain, check) in calls.items():
                record(kind, shape, fn, plain, check, per_step)
            del gy, base, out1, out2, kw2, kw3, want1, want2, want3, calls
            del scale1, scale2, kw0, stats, want0, scale0
            torch.cuda.empty_cache()
    print(json.dumps({"tag": args.tag, "root": root, "handoff": handoff,
                      "handoff1": handoff1, "handoff0": handoff0,
                      "gpu": torch.cuda.get_device_name(0),
                      "per_step_ms": per_step,
                      "per_forward_ms": per_forward, "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
