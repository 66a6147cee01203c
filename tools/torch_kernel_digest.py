#!/usr/bin/env python3
"""Digests of the port's kernels' outputs on seeded inputs, on one CUDA
card: ``sbr``, ``sbr_add``, ``sbr_bwd``, the fused block's kernels (forward
from x and from c1, stats, passes 1-3, the folded gradient) at the CIFAR
ResNet's widths (C = 16, 32, 64; B=16, the small tile plan, and B=128, the
tile plan), and the fused bottleneck's (forward, both moment passes, passes
1-4, the folded gradient, whose weight gradients run ``bottleneck_wgrad``)
at a ResNet-50 stage shape; with ``--wide`` also the fused block's at
ImageNet ResNet-34's widths (28²×128 and 14²×256, B=16 and 128, their
weight gradients ``bottleneck_wgrad``'s). Inputs are seeded normals (no
NaN), so two checkouts whose kernels compute the same bits print the same
digests.

    python3 tools/torch_kernel_digest.py [--root DIR] [--wide] --out FILE
    python3 tools/torch_kernel_digest.py --compare A.json B.json

The package run is the one under ``--root`` (default: this checkout): a
parent commit unpacked into an ignored directory and this checkout, each in
its own process, on one card. ``--compare`` prints the keys whose digests
differ and exits 1 if any does (or if the key sets differ).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

BLOCK_SHAPES = [(b, hw, hw, c) for b in (16, 128)
                for hw, c in ((32, 16), (16, 32), (8, 64))]
WIDE_BLOCK_SHAPES = [(b, hw, hw, c) for b in (16, 128)
                     for hw, c in ((28, 128), (14, 256))]
BOTTLENECK_SHAPE = (16, 14, 14, 1024)


def digest(t) -> str:
    import torch
    if isinstance(t, (tuple, list)):
        return hashlib.sha256("".join(digest(u) for u in t).encode()
                              ).hexdigest()
    t = t.detach().contiguous()
    raw = t.view(torch.uint8) if t.dtype != torch.bool else t.to(torch.uint8)
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()


def run(root: str, wide: bool = False) -> dict:
    sys.path.insert(0, root)
    import torch

    from tpu_resnet_torch.device import resolve_device
    from tpu_resnet_torch.ops import epilogue as ep
    from tpu_resnet_torch.ops import fused_block as fb
    from tpu_resnet_torch.ops import fused_bottleneck as fbn
    if not fb.__file__.startswith(root):
        raise RuntimeError(f"imported {fb.__file__}, not the one under "
                           f"{root}")
    resolve_device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*size, scale=1.0):
        return torch.randn(size, generator=gen, device="cuda") * scale

    def positive(n):
        return torch.rand(n, generator=gen, device="cuda") + 0.5

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        x = randn(16, 16, 16, 64).to(dtype)
        s, b, r = positive(64), randn(64, scale=0.5), randn(16, 16, 16, 64)
        g = randn(16, 16, 16, 64).to(dtype)
        out[f"sbr {name}"] = digest(ep.scale_bias_relu(x, s, b))
        out[f"sbr_add {name}"] = digest(ep.scale_bias_relu_add(
            x, s, b, r.to(dtype)))
        out[f"sbr_bwd {name}"] = digest(ep.scale_bias_relu_bwd(x, s, b, g))
        for shape in BLOCK_SHAPES + (WIDE_BLOCK_SHAPES if wide else []):
            c = shape[-1]
            key = f"{shape} {name}"
            x, gy = randn(*shape).to(dtype), randn(*shape)
            w1, w2 = (randn(3, 3, c, c, scale=(9 * c) ** -0.5)
                      for _ in range(2))
            g1, b1, g2, b2 = positive(c), randn(c, scale=0.5), positive(c), \
                randn(c, scale=0.5)
            m1, i1, m2, i2 = randn(c, scale=0.5), positive(c), \
                randn(c, scale=0.5), positive(c)
            vecs = (g1, b1, g2, b2, m1, i1, m2, i2)
            out[f"block_fwd {key}"] = digest(fb.block_fwd(x, w1, w2, *vecs[:4]))
            stats = fb.block_stats(x, w1, g1, b1)
            out[f"block_stats {key}"] = digest(stats)
            out[f"block_fwd_c1 {key}"] = digest(fb.block_fwd(
                x, w1, w2, *vecs[:4], c1=stats[2]))
            t1, t2, dw2, dz2, z2hat = fb.block_bwd1(x, gy, w1, w2, *vecs)
            out[f"block_bwd1 {key}"] = digest((t1, t2, dw2, dz2, z2hat))
            u1, u2, dw1, dz1 = fb.block_bwd2(x, gy, w1, w2, *vecs, t1, t2,
                                             dz2=dz2, z2hat=z2hat)
            out[f"block_bwd2 {key}"] = digest((u1, u2, dw1, dz1))
            out[f"block_bwd3 {key}"] = digest(fb.block_bwd3(
                x, gy, w1, w2, *vecs, t1, t2, u1, u2, dz1=dz1))
            out[f"block_bwd {key}"] = digest(fb.block_bwd(
                x, gy, w1, w2, *vecs[:4]))
        shape = BOTTLENECK_SHAPE
        c4 = shape[-1]
        f = c4 // 4
        x, gy = randn(*shape).to(dtype), randn(*shape)
        w1, w2, w3 = (randn(c4, f, scale=c4 ** -0.5),
                      randn(3, 3, f, f, scale=(9 * f) ** -0.5),
                      randn(f, c4, scale=f ** -0.5))
        folds = (positive(c4), randn(c4, scale=0.5), positive(f),
                 randn(f, scale=0.5), positive(f), randn(f, scale=0.5))
        key = f"{shape} {name}"
        out[f"bottleneck_fwd {key}"] = digest(fbn.bottleneck_fwd(
            x, w1, w2, w3, *folds))
        out[f"bottleneck_bwd {key}"] = digest(fbn.bottleneck_bwd(
            x, gy, w1, w2, w3, *folds))
        vecs = (positive(c4), randn(c4, scale=0.5), randn(c4, scale=0.5),
                positive(c4), positive(f), randn(f, scale=0.5),
                randn(f, scale=0.5), positive(f), positive(f),
                randn(f, scale=0.5), randn(f, scale=0.5), positive(f))
        out[f"bottleneck_stats_a {key}"] = digest(fbn.bottleneck_stats_a(
            x, w1, *vecs[:4]))
        out[f"bottleneck_stats_b {key}"] = digest(fbn.bottleneck_stats_b(
            x, w1, w2, *vecs[:8]))
        *t3, dw3, p2, mid, dm3 = fbn.bottleneck_bwd1(x, gy, w1, w2, w3,
                                                     *vecs)
        out[f"bottleneck_bwd1 {key}"] = digest((*t3, dw3, p2, mid, dm3))
        *t2, dw2, dmid = fbn.bottleneck_bwd2(x, gy, w1, w2, w3, *vecs, *t3,
                                             p2=p2, mid=mid, dm3=dm3)
        out[f"bottleneck_bwd2 {key}"] = digest((*t2, dw2, dmid))
        *t1, dw1, dc1 = fbn.bottleneck_bwd3(x, gy, w1, w2, w3, *vecs, *t3,
                                            *t2, dmid=dmid)
        out[f"bottleneck_bwd3 {key}"] = digest((*t1, dw1, dc1))
        out[f"bottleneck_bwd4 {key}"] = digest(fbn.bottleneck_bwd4(
            x, gy, w1, w2, w3, *vecs, *t3, *t2, *t1, dc1=dc1))
    torch.cuda.synchronize()
    return {"device": torch.cuda.get_device_name(0), "digests": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args()
    if args.compare:
        a, b = (json.load(open(p))["digests"] for p in args.compare)
        differ = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        print(json.dumps({"compared": len(set(a) | set(b)),
                          "differ": differ}))
        return int(bool(differ))
    result = run(os.path.abspath(args.root), args.wide)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"digests": len(result["digests"]),
                      "device": result["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
