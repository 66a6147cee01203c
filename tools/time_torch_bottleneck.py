#!/usr/bin/env python3
"""Device time of the fused bottleneck's forward, its two moment passes and
its weight-gradient products, one call at a time, at ImageNet ResNet-50's
three fusable stage shapes: B=16 (the serve forward) and B=128 (the train
step), bfloat16 x, on one CUDA card.

    python3 tools/time_torch_bottleneck.py [--root DIR] [--tag NAME]

Each call is queued behind a device spin, so the CUDA events time the card
alone (median of 10 runs of 5 calls). ``bottleneck_fwd`` is held against its
plain version (max abs error), the moment passes' sums and the weight
gradients against 1e-5·Σ|terms| + 1e-6 (``err_over_limit`` ≤ 1 passes).
The weight gradients (``wgrad.weight_grad``: dw3 from mid and gy, dw2 from p2
and dmid, dw1 from x and dc1, as passes 1-3 call it) carry ``library_ms``,
one PyTorch call on the operand made beforehand: ``torch.matmul(a.t(), b)``
or ``torch.nn.grad.conv2d_weight``, TF32 off. ``per_pass`` sums the
launches of one serve forward (10) and one train step (10 of each, 30 of
the weight gradients). The
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
    from tpu_resnet_torch.ops import wgrad as wg
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

    def over_limit(got, want, scale):
        return max(float(((g - w).abs() / (1e-5 * s + 1e-6)).max())
                   for g, w, s in zip(got, want, scale))

    def wgrad_rows(b, hw, c, n):
        """dw3, dw2, dw1 of one block: (name, kernel, plain, magnitudes,
        library) per product."""
        f = c // 4
        x = randn(b, hw, hw, c).to(torch.bfloat16)
        gy, mid, p2, dmid, dc1 = (randn(b, hw, hw, k) for k in
                                  (c, f, f, f, f))
        p2 = p2.clamp_min(0.0)
        bn3 = (positive(f), randn(f, scale=0.5), randn(f, scale=0.5),
               positive(f))
        bn1 = (positive(c), randn(c, scale=0.5), randn(c, scale=0.5),
               positive(c))

        def p_of(v, bn):
            g, be, mu, i = bn
            return torch.clamp_min(g * ((v.float() - mu) * i) + be, 0.0)

        p3, p1 = p_of(mid, bn3), p_of(x, bn1)
        mm = lambda a, bm: torch.matmul(a.reshape(-1, a.shape[-1]).t(),  # noqa
                                        bm.reshape(-1, bm.shape[-1]))
        nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
        return (
            ("dw3", lambda: wg.weight_grad("dw3", 2, mid, gy, f, c, x, 1,
                                           bn3),
             lambda m: (mm(p3.abs(), gy.abs()) if m else mm(p3, gy)),
             lambda: mm(p3, gy)),
            ("dw2", lambda: wg.weight_grad("dw2", 1, p2, dmid, f, f, x, 9),
             lambda m: wg.shifted_reference(p2.abs(), dmid.abs()) if m
             else wg.shifted_reference(p2, dmid),
             lambda: torch.nn.grad.conv2d_weight(
                 nchw(p2), (f, f, 3, 3), nchw(dmid), padding=1)),
            ("dw1", lambda: wg.weight_grad("dw1", 2, x, dc1, c, f, x, 1,
                                           bn1),
             lambda m: (mm(p1.abs(), dc1.abs()) if m else mm(p1, dc1)),
             lambda: mm(p1, dc1)))

    rows, per_pass = [], {}
    for (hw, c), n in STAGES:
        for name, kernel, plain, library in wgrad_rows(128, hw, c, n):
            got = kernel().reshape(-1)
            with torch.backends.cudnn.flags(enabled=False):
                want, scale = plain(False).reshape(-1), plain(True).reshape(-1)
            again = kernel().reshape(-1)
            ms = time_ms(kernel)
            lib = time_ms(library)
            rows.append({"kernel": "bottleneck_wgrad", "product": name,
                         "shape": [128, hw, hw, c], "ms": ms,
                         "library_ms": lib,
                         "err_over_limit": over_limit([got], [want],
                                                      [scale]),
                         "bit_equal": bool(torch.equal(got, again))})
            for key, v in (("bottleneck_wgrad B=128", ms),
                           (f"bottleneck_wgrad {name} B=128", ms),
                           ("library wgrad B=128", lib)):
                per_pass[key] = per_pass.get(key, 0.0) + n * v
        torch.cuda.empty_cache()
    for b, kinds in ((16, ("bottleneck_fwd",)),
                     (128, ("bottleneck_fwd", "bottleneck_stats_a",
                            "bottleneck_stats_b"))):
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
                elif kind == "bottleneck_stats_a":
                    args_ = (x, w1, positive(c), randn(c, scale=0.5),
                             randn(c, scale=0.5), positive(c))
                    fn = fbn.bottleneck_stats_a
                    want = fbn.bottleneck_stats_a_reference(*args_)
                    scale = fbn.bottleneck_stats_a_reference(
                        *args_, magnitudes=True)
                    check = {"err_over_limit": over_limit(fn(*args_), want,
                                                          scale)}
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
                    check = {"err_over_limit": over_limit(fn(*args_), want,
                                                          scale)}
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
