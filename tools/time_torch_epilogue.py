#!/usr/bin/env python3
"""Device time of the BN+ReLU epilogue (``sbr``), its backward
(``sbr_bwd``) and the softmax cross-entropy pair (``xent_fwd``,
``xent_bwd``), one call at a time, on one CUDA card, each beside its plain
version, and of one empty launch (the floor under every call):

- ``sbr`` and ``sbr_bwd`` at every BN+ReLU site shape of two bfloat16
  B=128 train steps, the unfused CIFAR ResNet-50 (49 sites) and ImageNet
  ResNet-50 at 224x224 with the fused bottlenecks (19 sites); ``sbr`` also
  at the B=16 sites of both serve forwards (CIFAR 7, ImageNet 19);
- ``sbr_add`` (unchanged since PR 6; a control) at the 14 B=128 shapes of
  the ``auto`` probe;
- ``xent_fwd``/``xent_bwd`` at [128, 10], [128, 100] and [128, 1000], int32
  labels, and the device launches of the mean loss and its gradient
  (``softmax_xent_mean``, ``torch.autograd.grad``) at [128, 1000] with
  int32 and with int64 labels, by kernel name.

    python3 tools/time_torch_epilogue.py [--root DIR] [--tag NAME]

Each call is queued behind a device spin, so the CUDA events time the card
alone (median of 10 runs of 5 calls; the plain version 5 runs of 2).
Checked against the plain version: ``sbr``, ``sbr_add`` and ``sbr_bwd``'s dx
bit for bit, ds and db within 1e-5·Σ|terms| + 1e-6, the cross-entropy pair
within 1e-5 abs and rel (``err_over_limit`` ≤ 1 passes); inputs are seeded
normals, scales in [0.5, 1.5), biases of both signs. ``per_pass_ms`` sums
the calls of one step or forward of each path, with ``floor_ms``, its
launches times ``launch_floor_ms`` (an empty ``tr_noop`` launch where the
package has one, else ``torch.cuda._sleep(0)``; both timed as every call
is). The package timed is the one under ``--root`` (default: this
checkout), so two checkouts, say a parent commit unpacked into an ignored
directory, run as separate processes in one run on one card: parent,
change, change, parent. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

# (shape without the batch, sites a pass) of each path's BN+ReLU sites.
IMAGENET_SITES = (
    ((56, 56, 64), 3), ((56, 56, 256), 1), ((56, 56, 128), 1),
    ((28, 28, 128), 1), ((28, 28, 512), 1), ((28, 28, 256), 1),
    ((14, 14, 256), 1), ((14, 14, 1024), 1), ((14, 14, 512), 1),
    ((7, 7, 512), 5), ((7, 7, 2048), 3))
# path: (batch, sites, kernels timed there)
PATHS = {
    "cifar10_train": (128, (((32, 32, 16), 17), ((16, 16, 32), 16),
                            ((8, 8, 64), 16)), ("sbr", "sbr_bwd")),
    "imagenet_fused_train": (128, IMAGENET_SITES, ("sbr", "sbr_bwd")),
    "cifar10_serve": (16, (((32, 32, 16), 3), ((16, 16, 32), 2),
                           ((8, 8, 64), 2)), ("sbr",)),
    "imagenet_serve": (16, IMAGENET_SITES, ("sbr",)),
}
# The auto probe's B=128 shapes (ep.model_epilogue_shapes of both presets).
PROBE_SHAPES = ((32, 32, 16), (16, 16, 32), (8, 8, 64), *(
    hwc for hwc, _ in IMAGENET_SITES))
XENT_SHAPES = ((128, 10), (128, 100), (128, 1000))


def time_ms(torch, fn, reps=10, inner=5):
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
    from tpu_resnet_torch.ops import _build
    from tpu_resnet_torch.ops import epilogue as ep
    from tpu_resnet_torch.ops import softmax_xent as sx
    from tpu_resnet_torch.tools.profiling import device_profile
    if not torch.cuda.is_available():
        print("time_torch_epilogue: needs a CUDA card", file=sys.stderr)
        return 2
    if not ep.__file__.startswith(root):
        raise RuntimeError(f"imported {ep.__file__}, not the one under "
                           f"{root}")
    resolve_device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    lib = _build.library("epilogue")
    stream = torch.cuda.current_stream().cuda_stream
    floors = {"sleep0_ms": time_ms(torch, lambda: torch.cuda._sleep(0),
                                   inner=10)}
    if "tr_noop" in _build.SIGNATURES["epilogue"]:
        floors["noop_ms"] = time_ms(
            torch, lambda: _build.check(lib.tr_noop(torch.cuda.current_device(), stream), "tr_noop"),
            inner=10)
    floor = floors.get("noop_ms", floors["sleep0_ms"])

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def folds(c):
        return (torch.rand(c, generator=gen, device="cuda") + 0.5,
                torch.randn(c, generator=gen, device="cuda") * 0.5)

    def bwd_excess(got, want, x, s, b, g):
        gm = torch.where(x.float() * s + b > 0, g.float(), 0.0)
        excess = 0.0 if torch.equal(got[0], want[0]) else float("inf")
        for k, terms in ((1, gm * x.float()), (2, gm)):
            limit = 1e-5 * terms.abs().sum(dim=(0, 1, 2)) + 1e-6
            excess = max(excess, float(((got[k] - want[k]).abs()
                                        / limit).max()))
        return excess

    rows, per_pass = [], {}

    def add(path, kernel, shape, n, fn, plain, excess):
        row = {"path": path, "kernel": kernel, "shape": list(shape),
               "sites": n, "ms": time_ms(torch, fn),
               "plain_ms": time_ms(torch, plain, reps=5, inner=2),
               "err_over_limit": excess}
        rows.append(row)
        totals = per_pass.setdefault(path, {}).setdefault(
            kernel, {"ms": 0.0, "plain_ms": 0.0, "floor_ms": 0.0,
                     "launches": 0})
        for key in ("ms", "plain_ms"):
            totals[key] += n * row[key]
        totals["floor_ms"] += n * floor
        totals["launches"] += n

    for path, (batch, sites, kernels) in PATHS.items():
        for hwc, n in sites:
            shape = (batch, *hwc)
            x, g = randn(shape), randn(shape)
            s, b = folds(shape[-1])
            if "sbr" in kernels:
                same = torch.equal(ep.scale_bias_relu(x, s, b),
                                   ep.scale_bias_relu_reference(x, s, b))
                add(path, "sbr", shape, n,
                    lambda: ep.scale_bias_relu(x, s, b),
                    lambda: ep.scale_bias_relu_reference(x, s, b),
                    0.0 if same else float("inf"))
            if "sbr_bwd" in kernels:
                excess = bwd_excess(ep.scale_bias_relu_bwd(x, s, b, g),
                                    ep.scale_bias_relu_bwd_reference(
                                        x, s, b, g), x, s, b, g)
                add(path, "sbr_bwd", shape, n,
                    lambda: ep.scale_bias_relu_bwd(x, s, b, g),
                    lambda: ep.scale_bias_relu_bwd_reference(x, s, b, g),
                    excess)
            del x, g
            torch.cuda.empty_cache()
    with torch.no_grad():
        for hwc in PROBE_SHAPES:
            shape = (128, *hwc)
            x, r = randn(shape), randn(shape)
            s, b = folds(shape[-1])
            same = torch.equal(ep.scale_bias_relu_add(x, s, b, r),
                               ep.scale_bias_relu_add_reference(x, s, b, r))
            add("probe", "sbr_add", shape, 1,
                lambda: ep.scale_bias_relu_add(x, s, b, r),
                lambda: ep.scale_bias_relu_add_reference(x, s, b, r),
                0.0 if same else float("inf"))
            del x, r
            torch.cuda.empty_cache()

    launches = {}
    for shape in XENT_SHAPES:
        bsz, classes = shape
        logits = torch.randn(shape, generator=gen, device="cuda") * 3
        labels = torch.randint(0, classes, (bsz,), generator=gen,
                               device="cuda", dtype=torch.int32)
        g = torch.rand(bsz, generator=gen, device="cuda")
        for kernel, fn, plain in (
                ("xent_fwd",
                 lambda: sx.softmax_xent_per_example(logits, labels),
                 lambda: sx.softmax_xent_per_example_reference(logits,
                                                               labels)),
                ("xent_bwd", lambda: sx.softmax_xent_bwd(logits, labels, g),
                 lambda: sx.softmax_xent_bwd_reference(logits, labels, g))):
            got, want = fn(), plain()
            excess = float(((got - want).abs()
                            / (1e-5 + 1e-5 * want.abs())).max())
            add("train_head", kernel, shape, 1, fn, plain, excess)
        if classes == 1000:
            leaf = logits.clone().requires_grad_(True)
            for name, lab in (("int32", labels), ("int64", labels.long())):
                prof = device_profile(lambda: torch.autograd.grad(
                    sx.softmax_xent_mean(leaf, lab), leaf), iters=4)
                launches[name] = {
                    "total": sum(k["launches_per_call"]
                                 for k in prof["kernels"]),
                    "kernels": [(k["name"], k["launches_per_call"])
                                for k in prof["kernels"]]}
    print(json.dumps({"tag": args.tag, "root": root,
                      "gpu": torch.cuda.get_device_name(0),
                      "launch_floor_ms": floor, "floors": floors,
                      "per_pass_ms": per_pass,
                      "mean_backward_launches": launches,
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
