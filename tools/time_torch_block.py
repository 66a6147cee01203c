#!/usr/bin/env python3
"""Device time of the fused basic block's training kernels, one call at a
time, at the CIFAR ResNet-50's three fused stage shapes, B=128, bfloat16 x,
on one CUDA card: ``block_fwd`` (live moments folded), ``block_stats`` and
the three backward passes, with the plain versions of passes 2 and 3.

    python3 tools/time_torch_block.py [--root DIR] [--tag NAME]

Each call is queued behind a device spin, so the CUDA events time the card
alone (median of 10 runs of 5 calls). Pass 2's sums are held against
1e-5·Σ|terms| + 1e-6 and pass 3's dx against ``block_fwd``'s bfloat16
tolerance (``err_over_limit`` ≤ 1 passes); inputs are seeded normals with
the batch's own BN moments. ``per_step_ms`` sums the launches of one fused
train step (7 blocks a stage). The package timed is the one under
``--root`` (default: this checkout), so two checkouts, say a parent commit
unpacked into an ignored directory, run as separate processes in one run
on one card: parent, change, change, parent. A parent whose pass 3 takes
no ``dz1`` recomputes it. Prints one JSON line.
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

    rows, per_step = [], {}
    for hw, c in STAGES:
        shape = (128, hw, hw, c)
        x = randn(*shape).to(torch.bfloat16)
        gy = randn(*shape)
        w1, w2 = (randn(3, 3, c, c, scale=(9 * c) ** -0.5) for _ in "12")
        g1, b1, g2, b2 = (positive(c), randn(c, scale=0.5), positive(c),
                          randn(c, scale=0.5))
        m1, v1, m2, v2 = fb.block_train_fwd(x, w1, w2, g1, b1, g2, b2)[1]
        i1, i2 = torch.rsqrt(v1 + fb.EPS), torch.rsqrt(v2 + fb.EPS)
        s1, sb1 = fb._fold(g1, b1, m1, v1, fb.EPS)
        s2, sb2 = fb._fold(g2, b2, m2, v2, fb.EPS)
        vecs = (g1, b1, g2, b2, m1, i1, m2, i2)
        base = (x, gy, w1, w2, *vecs)
        t = fb.block_bwd1(*base)[:2]
        out2 = fb.block_bwd2(*base, *t)
        u = out2[:2]
        kw3 = {"dz1": out2[3]} if handoff else {}
        calls = {
            "block_fwd": lambda: fb.block_fwd(x, w1, w2, s1, sb1, s2, sb2),
            "block_stats": lambda: fb.block_stats(x, w1, s1, sb1),
            "block_bwd1": lambda: fb.block_bwd1(*base),
            "block_bwd2": lambda: fb.block_bwd2(*base, *t),
            "block_bwd3": lambda: fb.block_bwd3(*base, *t, *u, **kw3)}
        with torch.backends.cudnn.flags(enabled=False):
            want2 = fb.train_bwd_pass2_reference(*base, *t)
            scale2 = fb.train_bwd_pass2_reference(*base, *t, magnitudes=True)
            want3 = fb.train_bwd_pass3_reference(*base, *t, *u, **kw3)
        plain = {
            "block_bwd2": lambda: fb.train_bwd_pass2_reference(*base, *t),
            "block_bwd3": lambda: fb.train_bwd_pass3_reference(*base, *t,
                                                               *u, **kw3)}
        got3 = calls["block_bwd3"]().float()
        checks = {
            "block_bwd2": max(
                float(((g - w).abs() / (1e-5 * s + 1e-6)).max())
                for g, w, s in zip(out2[:3], want2[:3], scale2[:3])),
            "block_bwd3": float(((got3 - want3.float()).abs()
                                 / (1e-2 + 1e-2 * want3.float().abs()))
                                .max())}
        for kind, fn in calls.items():
            row = {"kernel": kind, "shape": list(shape), "ms": time_ms(fn)}
            if kind in plain:
                row["plain_ms"] = time_ms(plain[kind], reps=5, inner=2)
                row["err_over_limit"] = checks[kind]
            rows.append(row)
            for key in ("ms", "plain_ms"):
                if key in row:
                    name = kind if key == "ms" else f"{kind} plain"
                    per_step[name] = (per_step.get(name, 0.0)
                                      + PER_STAGE * row[key])
        del x, gy, out2, calls, plain, want2, scale2, want3, got3
        torch.cuda.empty_cache()
    print(json.dumps({"tag": args.tag, "root": root, "handoff": handoff,
                      "gpu": torch.cuda.get_device_name(0),
                      "per_step_ms": per_step, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
