#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``tpu_resnet_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing one JSON line:

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the seconds ``nvcc`` took to build the kernels from
   ``tpu_resnet_torch/csrc`` (one compiler per source, started together).
2. ``kernels``: each kernel against its plain PyTorch version on the card,
   at every shape the two serve paths give it with B=16 and the CIFAR train
   path gives it with B=128, in bfloat16 and float32 (float32 oracle with
   TF32 off): max abs/rel error against the stated tolerance; CUDA-event
   median times of kernel and plain version, on the device alone (``ms``:
   calls queued back to back behind a spin) and per call with the host's
   launch gaps (``call_ms``); the bound (bytes at 3.35 TB/s or float32
   operations at 67 TFLOP/s, the H100 SXM's published peaks); and for
   ``xent_fwd`` the time of ``F.cross_entropy(reduction="none")``
   (``library_ms``). ``sbr_bwd``: dx exact, ds/db within
   1e-5·Σ|g·mask·x| + 1e-6 per channel; ``xent_fwd``/``xent_bwd`` at
   [128, 10/100/1000] within 1e-5 abs and rel. The fused block's training
   kernels (``block_stats``, ``block_bwd1``, ``block_bwd2``,
   ``block_bwd3``) at the three B=128 stage shapes, on inputs from a coarse
   dyadic grid (so conv1's output and the masks are exact in both): every
   sum within 1e-5·Σ|terms| + 1e-6 per element, dx within ``block_fwd``'s
   tolerance, two calls bit for bit equal. The same for the fused
   bottleneck's training kernels (``bottleneck_stats_a``,
   ``bottleneck_stats_b``, ``bottleneck_bwd1`` .. ``bottleneck_bwd4``) at
   the three ImageNet ResNet-50 stage shapes with B=128, dx within
   ``bottleneck_fwd``'s tolerance; ``sbr``, ``sbr_bwd``, ``bottleneck_fwd``
   and the cross-entropy pair also at the ImageNet train path's shapes.
3. ``serve`` (``cifar10``): CIFAR-10 ResNet-50 at full width (``--preset
   cifar10 model.fused_blocks=true model.fused_epilogue=on``) from seeded
   random weights, checkpointed to a temporary train dir and served by the
   port's ``PredictServer`` (buckets 1..16 warmed). Octet-stream and JSON
   requests are checked against the same model run through the plain
   versions on the card, and the launch counters, zeroed just before, must
   read 21 ``block_fwd`` and 7 ``sbr`` launches per forward pass.
4. ``serve`` (``imagenet``): ImageNet ResNet-50 at 224x224, full depth and
   width (``--preset imagenet model.fused_blocks=true
   model.fused_epilogue=on``), served the same way. The counters must read
   10 ``bottleneck_fwd``, 19 ``sbr`` and 0 ``block_fwd`` per forward pass.
   Logits are held against the plain-version model (max |d| within 5% of
   the largest |logit|), and the argmax must agree on every image whose
   plain-version top-1/top-2 margin exceeds twice the measured max |d|
   (random weights with 1000 classes leave many near-ties).
5. ``train``: CIFAR-10 ResNet-50 at full width, B=128 (``--preset cifar10
   model.fused_epilogue=on optim.use_pallas_xent=on data.dataset=synthetic
   data.synthetic_learnable=true``): (a) one float32 train step from one
   seeded state through the kernels and one through the plain versions:
   loss, precision and grad_norm within 1e-5 relative, every updated
   parameter, momentum buffer and running statistic within 1e-5 + 1e-4·
   |plain|; (b) the port's ``train()`` for 100 steps in bfloat16 with a
   metrics line per step and a checkpoint every 50, the counters zeroed
   just before and read just after: 49 ``sbr``, 49 ``sbr_bwd``, 1
   ``xent_fwd`` and 1 ``xent_bwd`` launches per step and none of the fused
   blocks; every loss finite and the mean of the last 10 below the mean of
   the first 10; (c) ``train()`` again to step 120, resuming from 100; (d)
   ``evaluate`` once on checkpoint 120 (49 ``sbr`` per eval forward),
   printing its precision and loss; then ms/step, images/s, device-busy ms
   per step and idle share of the loop's step under ``torch.profiler``.
6. ``train`` again, with ``model.fused_blocks=true`` (21 fused blocks, 7
   unfused BN+ReLU sites): the same (a)-(d), where (a) also runs the
   control, the plain versions on PyTorch's own convolutions instead of
   cuDNN's: the fused blocks sum their convolutions in another order, so
   backward masks recomputed from them flip near 0 and the step limits fail
   for any two implementations (the control too); (a) is reported against
   them and passes within ``CONTROL_FACTOR`` times the control's distance
   from the plain step (``compare_step``). The launch table per step: 21
   ``block_fwd``, 21 each of ``block_stats``, ``block_bwd1``,
   ``block_bwd2``, ``block_bwd3``, 7 ``sbr``, 7 ``sbr_bwd``, 1 ``xent_fwd``
   and 1 ``xent_bwd``; eval 21 ``block_fwd`` and 7 ``sbr`` per forward.
7. ``train`` for ImageNet ResNet-50 at 224x224, full depth and width,
   B=128 (``--preset imagenet model.fused_blocks=true
   model.fused_epilogue=on optim.use_pallas_xent=on``): (a) as in 6, at
   B=``IMAGENET_GATE_BATCH``; (b) the loop's own step (``build_state`` +
   ``make_loop_step``, as ``train()`` builds them; the ImageNet input
   pipeline is not ported) for ``IMAGENET_STEPS`` bfloat16 steps on a few
   seeded uint8 batches repeated, the counters zeroed just before and read
   just after: 10 ``bottleneck_fwd``, 10 of each of the six bottleneck
   training kernels, 19 ``sbr``, 19 ``sbr_bwd``, 1 ``xent_fwd`` and 1
   ``xent_bwd`` per step; every loss finite and the mean of the last 5
   below the first 5's; (c) the step's profile. No eval.

8. ``autotune``: (a) ``ep.probe_epilogue(include_add=True)`` in bfloat16 at
   every ``model_epilogue_shapes`` shape of the ``cifar10`` and
   ``imagenet`` presets with B=128 (3 and 11 shapes), the counters zeroed
   just before and read just after: ``sbr_add`` and ``sbr`` launched
   ``iters + 1`` times per shape, every decision with finite times and
   ``use_pallas == (speedup >= 1)``; (b) the slice's path, ``train
   --preset cifar10 data.dataset=synthetic data.synthetic_learnable=true
   model.fused_epilogue=auto`` on the preset's defaults
   (``optim.use_pallas_xent=auto``, ``data.device_resident=auto``) for
   ``AUTO_STEPS`` steps in a fresh train dir: the log names the
   device-resident input, ``autotune.json`` lists the three CIFAR shapes
   and ``xent|128x10``, the launches per step equal the BN sites whose
   shape chose the kernel (``sbr``, ``sbr_bwd``) and 1 or 0 of each xent
   kernel as chosen, the loss falls, and ``evaluate`` runs once.

9. ``ab``: the twins of the reference's A/B tools
   (``tpu_resnet_torch.tools.fused_block_ab`` and ``fused_bottleneck_ab``)
   through their per-shape functions, at the reference's shapes (B=128,
   the three CIFAR stages, the three ResNet-50 stages) in bfloat16: one
   ``fwd_bwd`` call of ``AB_LENGTH`` chained blocks per shape, the counters
   zeroed just before and read just after (``AB_LENGTH`` launches of
   ``block_fwd`` and ``block_bwd``, or of ``bottleneck_fwd`` and
   ``bottleneck_bwd``, and nothing else); then the four arms' µs per block
   and speedups (``run_shape``, ``AB_REPS`` timed calls per arm).
10. ``grad``: the gradient, in the input images and every parameter, of an
   eval-mode fused model on seeded weights (BN moved off its init), float32,
   B=``GRAD_BATCH``: CIFAR-10 ResNet-50 and ImageNet ResNet-50 at 224x224
   (``--preset cifar10|imagenet model.fused_blocks=true
   model.fused_epilogue=on``). Through the kernels against the plain
   versions, normwise per tensor: the worst within ``GRAD_RTOL``'s floor
   or ``CONTROL_FACTOR`` times the control's worst (the plain versions on
   PyTorch's own convolutions), never beyond its ceiling; the counters
   read one forward and its backward: 21 ``block_fwd`` + 7 ``sbr`` + 21
   ``block_bwd`` + 7 ``sbr_bwd`` (CIFAR), 10 ``bottleneck_fwd`` + 19
   ``sbr`` + 10 ``bottleneck_bwd`` + 19 ``sbr_bwd`` (ImageNet).

The ``kernels`` phase also holds ``sbr_add`` (``tr_sbr_add``) against its
plain version at the 14 probe shapes, bfloat16 and float32: the forward
bit for bit, and through autograd dx bit for bit, dr == g, ds/db within
``sbr_bwd``'s limits; and the folded blocks' gradients, ``block_bwd`` at
the three CIFAR B=128 stage shapes and ``bottleneck_bwd`` at the three
ResNet-50 B=128 stage shapes, bfloat16 and float32, on the dyadic grids of
the training kernels, and again at the grad phase's B=``GRAD_BATCH``
shapes: every sum and weight gradient within 1e-5·Σ|terms| + 1e-6, dx
within ``block_fwd``'s or ``bottleneck_fwd``'s tolerance, two calls bit for
bit equal.

Then one ``{"kernels": [...]}`` line of the 19 kernels (times summed over
the launches of one forward pass of each serve path and one train step that
run the kernel, in bfloat16; for ``sbr_add`` over one call at each probe
shape, for ``block_bwd`` and ``bottleneck_bwd`` over one call at each A/B
shape, and per path also over one backward of the grad phase;
``launches`` is the count over the phases that drive the main paths:
both serve phases, the train and eval runs of both CIFAR train phases, the
ImageNet train steps, both parts of the autotune phase, the ``ab`` phase's
counted calls and the ``grad`` phase),
the ``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``. Any failure raises and exits non-zero before the last line;
without CUDA the script exits 2.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

# The port beside this script, however Python was started (``-I``, or from
# another directory).
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BATCH = 16
TRAIN_BATCH = 128


def imagenet_shapes(b: int) -> dict:
    """ImageNet ResNet-50 at 224x224, batch b: (shape, launches per forward
    pass or train step) of ``sbr`` (19 BN+ReLU sites: 6 unfused blocks and
    the final one) and of ``bottleneck_fwd`` (the 10 stride-1 identity
    bottlenecks of width 64/128/256)."""
    return {"sbr": (((b, 56, 56, 64), 3), ((b, 56, 56, 256), 1),
                    ((b, 56, 56, 128), 1), ((b, 28, 28, 128), 1),
                    ((b, 28, 28, 512), 1), ((b, 28, 28, 256), 1),
                    ((b, 14, 14, 256), 1), ((b, 14, 14, 1024), 1),
                    ((b, 14, 14, 512), 1), ((b, 7, 7, 512), 5),
                    ((b, 7, 7, 2048), 3)),
            "bottleneck_fwd": (((b, 56, 56, 256), 2), ((b, 28, 28, 512), 3),
                               ((b, 14, 14, 1024), 5))}


# (shape, launches per forward pass) on each serve path, at B=BATCH, and
# per step on the train paths, at B=TRAIN_BATCH.
TRAIN_SBR = (((TRAIN_BATCH, 32, 32, 16), 17), ((TRAIN_BATCH, 16, 16, 32), 16),
             ((TRAIN_BATCH, 8, 8, 64), 16))
SHAPES = {
    "cifar10": {
        "sbr": (((BATCH, 32, 32, 16), 3), ((BATCH, 16, 16, 32), 2),
                ((BATCH, 8, 8, 64), 2)),
        "block_fwd": (((BATCH, 32, 32, 16), 7), ((BATCH, 16, 16, 32), 7),
                      ((BATCH, 8, 8, 64), 7)),
    },
    "imagenet": imagenet_shapes(BATCH),
    "cifar10_train": {"sbr": TRAIN_SBR},
    # model.fused_blocks=true: 7 fused blocks per stage, B=TRAIN_BATCH.
    "cifar10_fused_train": {"block_fwd": (((TRAIN_BATCH, 32, 32, 16), 7),
                                          ((TRAIN_BATCH, 16, 16, 32), 7),
                                          ((TRAIN_BATCH, 8, 8, 64), 7))},
    # ImageNet ResNet-50 training through the 10 fused bottlenecks.
    "imagenet_fused_train": imagenet_shapes(TRAIN_BATCH),
}
# Train-path kernels with their own rows: sbr_bwd at the train paths' sbr
# shapes, the cross-entropy pair at these (path, class count, launches per
# step), the fused block's training kernels at the block_fwd shapes of the
# fused CIFAR train path, the fused bottleneck's at the bottleneck_fwd
# shapes of the ImageNet train path.
XENT_CLASSES = (("cifar10_train", 10, 1), ("cifar10_train", 100, 0),
                ("imagenet_fused_train", 1000, 1))
BLOCK_TRAIN = ("block_stats", "block_bwd1", "block_bwd2", "block_bwd3")
BOTTLENECK_TRAIN = ("bottleneck_stats_a", "bottleneck_stats_b",
                    "bottleneck_bwd1", "bottleneck_bwd2", "bottleneck_bwd3",
                    "bottleneck_bwd4")
KERNELS = ("sbr", "block_fwd", "bottleneck_fwd", "sbr_bwd", "xent_fwd",
           "xent_bwd", *BLOCK_TRAIN, *BOTTLENECK_TRAIN, "sbr_add",
           "block_bwd", "bottleneck_bwd")
# Launches per forward pass of each serve path and per train step, every
# kernel listed.
PER_PASS = {path: {k: sum(n for _, n in shapes.get(k, ()))
                   for k in KERNELS}
            for path, shapes in SHAPES.items()}
PER_PASS["cifar10_train"].update(
    sbr_bwd=sum(n for _, n in TRAIN_SBR), xent_fwd=1, xent_bwd=1)
# The fused train step keeps 7 unfused BN+ReLU sites (two per block0, the
# final one), as the CIFAR serve forward does.
PER_PASS["cifar10_fused_train"].update(
    sbr=7, sbr_bwd=7, xent_fwd=1, xent_bwd=1,
    **{k: PER_PASS["cifar10_fused_train"]["block_fwd"] for k in BLOCK_TRAIN})
# The ImageNet train step: each fused bottleneck runs bottleneck_fwd and the
# six training kernels once; the 19 sbr sites each run sbr_bwd.
PER_PASS["imagenet_fused_train"].update(
    sbr_bwd=PER_PASS["imagenet_fused_train"]["sbr"], xent_fwd=1, xent_bwd=1,
    **{k: PER_PASS["imagenet_fused_train"]["bottleneck_fwd"]
       for k in BOTTLENECK_TRAIN})
TRAIN_OVERRIDES = ["model.fused_epilogue=on", "optim.use_pallas_xent=on",
                   "data.dataset=synthetic", "data.synthetic_learnable=true"]
# Each train path: its overrides and the launches of one eval forward.
TRAIN_PATHS = {
    "cifar10_train": {"overrides": [], "label": "fused_blocks=off",
                      "eval_per_forward": {"sbr": 49}},
    "cifar10_fused_train": {"overrides": ["model.fused_blocks=true"],
                            "label": "fused_blocks=on",
                            "eval_per_forward": PER_PASS["cifar10"]},
}
TRAIN_STEPS, RESUME_STEPS = 100, 120
# The ImageNet train phase: the loop's step on a fixed set of seeded uint8
# 224x224 batches, repeated; the float32 step gate at IMAGENET_GATE_BATCH.
IMAGENET_OVERRIDES = ["model.fused_blocks=true", "model.fused_epilogue=on",
                      "optim.use_pallas_xent=on"]
IMAGENET_STEPS, IMAGENET_BATCHES, IMAGENET_GATE_BATCH = 30, 2, 32
# The autotune phase: the probe's timed calls per arm, and the steps of the
# slice's own train path (model.fused_epilogue=auto on the cifar10
# preset's defaults).
PROBE_ITERS, AUTO_STEPS = 30, 30
AUTO_OVERRIDES = ["data.dataset=synthetic", "data.synthetic_learnable=true",
                  "model.fused_epilogue=auto"]
# The A/B phase: blocks chained per call and timed calls per arm.
AB_LENGTH, AB_REPS = 2, 2
# The eval-mode gradient phase: each preset's fused model in float32, and
# the launches of one forward and its backward.
GRAD_BATCH = 16
GRAD_OVERRIDES = ["model.fused_blocks=true", "model.fused_epilogue=on",
                  "model.compute_dtype=float32"]
# The grad phase's block_bwd and bottleneck_bwd shapes, with their launches
# per backward.
GRAD_SHAPES = {
    "cifar10": (((GRAD_BATCH, 32, 32, 16), 7), ((GRAD_BATCH, 16, 16, 32), 7),
                ((GRAD_BATCH, 8, 8, 64), 7)),
    "imagenet": imagenet_shapes(GRAD_BATCH)["bottleneck_fwd"]}
# The gradient's gate, normwise per tensor: the floor, and the ceiling
# that CONTROL_FACTOR times the control's distance may not pass.
GRAD_RTOL = (1e-3, 1e-2)
GRAD_PER_BACKWARD = {
    "cifar10": {"block_fwd": 21, "sbr": 7, "block_bwd": 21, "sbr_bwd": 7},
    "imagenet": {"bottleneck_fwd": 10, "sbr": 19, "bottleneck_bwd": 10,
                 "sbr_bwd": 19}}
# |kernel - plain| <= atol + rtol * |plain|, elementwise. sbr rounds
# exactly as the plain version does; the fused blocks sum their convs in
# another order than cuDNN/cuBLAS, and in bfloat16 that can move the stored
# value by an ulp (2^-8 relative).
TOLERANCE = {
    ("sbr", torch.float32): (1e-6, 1e-6),
    ("sbr", torch.bfloat16): (1e-6, 1e-6),
    ("block_fwd", torch.float32): (1e-4, 1e-4),
    ("block_fwd", torch.bfloat16): (1e-2, 1e-2),
    ("bottleneck_fwd", torch.float32): (1e-4, 1e-4),
    ("bottleneck_fwd", torch.bfloat16): (1e-2, 1e-2),
}
# Served logits against the plain-version model: bfloat16 activations
# through 50 layers, where one-ulp differences compound.
LOGIT_TOL = 0.05   # max |d| as a fraction of max |plain logit|
ARGMAX_AGREE = 0.99
# sbr_bwd's ds/db and every sum of the fused block's training kernels:
# |kernel - plain| <= rtol * sum|terms| + atol per element (float32 sums over
# B*H*W pixels, in another order); sbr_bwd's dx is exact, block_bwd3's dx is
# held to block_fwd's tolerance.
SBR_BWD_TOL = (1e-5, 1e-6)
XENT_TOL = (1e-5, 1e-5)    # xent_fwd/xent_bwd, atol and rtol
# The float32 train step through the kernels against the plain versions:
# metrics within STEP_RTOL relative, state within atol + rtol * |plain|.
STEP_RTOL = 1e-5
STATE_TOL = (1e-5, 1e-4)
# Where the kernels replace convolutions: the kernels' step within this
# factor of the control's distance (compare_step).
CONTROL_FACTOR = 4.0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, queued: bool, reps: int = 20, inner: int = 10) -> float:
    """CUDA-event median of ``reps`` runs of ``inner`` calls, per call.

    ``queued``: the calls are enqueued behind a ~10 ms device spin, so they
    run back to back and the events time the device alone; otherwise the
    events also take in the host's launch gaps (wrapper checks, ctypes,
    PyTorch dispatch), which dominate a kernel shorter than its launch."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(kind: str, shape, dtype) -> tuple:
    """(least ms the card could take, what bounds it): each input read
    once, each output written once, operations at the float32 rate."""
    item = torch.tensor([], dtype=dtype).element_size()
    if kind in ("xent_fwd", "xent_bwd"):
        b, c = shape
        if kind == "xent_fwd":   # logits, labels in; loss out
            moved = b * c * 4 + 2 * b * 4
            ops = 4 * b * c + 3 * b   # max, sub, exp, add; log, add, sub
        else:                    # logits, labels, g in; dx out
            moved = 2 * b * c * 4 + 2 * b * 4
            ops = 8 * b * c           # max, sub, exp, add; sub, exp, div..
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")
    b, h, w, c = shape
    n = b * h * w * c
    if kind == "sbr":
        moved = 2 * n * item + 2 * c * 4
        ops = 3 * n                                  # mul, add, max
    elif kind == "sbr_add":   # x, r in, y out; s, b in
        moved = 3 * n * item + 2 * c * 4
        ops = 4 * n                                  # mul, add, max, add
    elif kind == "sbr_bwd":   # x, g in, dx out; s, b in, ds, db out
        moved = 3 * n * item + 4 * c * 4
        ops = 8 * n   # mul, add, compare; mul (dx); mul, add (ds); add (db)
    elif kind == "block_fwd":
        moved = 2 * n * item + 2 * 9 * c * c * 4 + 4 * c * 4
        ops = 2 * (2 * b * h * w * 9 * c * c) + 6 * n
    elif kind in BLOCK_TRAIN:
        # x (and gy, float32) in, weights and BN vectors in, the sums or
        # dx out; operations: the 3x3 products (one for the stats, three,
        # four and three for the passes), 2*B*H*W*9*C*C flops each.
        products, vecs, weights = {"block_stats": (1, 2, 1),
                                   "block_bwd1": (3, 8, 2),
                                   "block_bwd2": (4, 10, 2),
                                   "block_bwd3": (3, 12, 2)}[kind]
        sums = {"block_stats": 2 * c, "block_bwd1": 2 * c + 9 * c * c,
                "block_bwd2": 2 * c + 9 * c * c, "block_bwd3": 0}[kind]
        moved = (n * item + (0 if kind == "block_stats" else 4 * n)
                 + (weights * 9 * c * c + vecs * c + sums) * 4
                 + (n * item if kind == "block_bwd3" else 0))
        ops = products * 2 * b * h * w * 9 * c * c
    elif kind in BOTTLENECK_TRAIN:   # c = 4f; centre rows only
        f = c // 4
        ff = f * f
        # flops per pixel; floats of weights (w1 4f², w2 9f², w3 4f²), of
        # BN vectors and correction sums in, and of sums and weight
        # gradients out; x (and gy, float32) in, dx out.
        flops, weights, vecs, sums = {
            "bottleneck_stats_a": (8 * ff, 4 * ff, 4 * c, 2 * f),
            "bottleneck_stats_b": (26 * ff, 13 * ff, 4 * c + 4 * f, 2 * f),
            "bottleneck_bwd1": (42 * ff, 17 * ff, 4 * c + 8 * f,
                                2 * f + 4 * ff),
            "bottleneck_bwd2": (70 * ff, 17 * ff, 4 * c + 10 * f,
                                2 * f + 9 * ff),
            "bottleneck_bwd3": (68 * ff, 17 * ff, 4 * c + 12 * f,
                                2 * c + 4 * ff),
            "bottleneck_bwd4": (60 * ff, 17 * ff, 6 * c + 12 * f, 0)}[kind]
        moved = (n * item + (0 if "stats" in kind else 4 * n)
                 + (weights + vecs + sums) * 4
                 + (n * item if kind == "bottleneck_bwd4" else 0))
        ops = flops * b * h * w
    elif kind == "block_bwd":
        # x, gy (float32) in, dx out; w1, w2 and the four folded vectors in,
        # dw1, dw2 and the four sums out; five 3x3 products (the c1
        # recompute, two convT, dw1, dw2).
        moved = 2 * n * item + 4 * n + (4 * 9 * c * c + 8 * c) * 4
        ops = 5 * 2 * b * h * w * 9 * c * c
    elif kind == "bottleneck_bwd":   # c = 4f
        # x, gy (float32) in, dx out; the three weights (17f² floats) and
        # six folded vectors in, their gradients out; 94f² flops per pixel
        # (c1 8, mid 18, gy·W3ᵀ 8, convT 18, dc1·W1ᵀ 8, dW1 8, dW3 8, dw2
        # 18).
        f = c // 4
        moved = 2 * n * item + 4 * n + (2 * 17 * f * f + 4 * (c + 2 * f)) * 4
        ops = 94 * f * f * b * h * w
    else:   # bottleneck_fwd: c = 4f
        f = c // 4
        moved = 2 * n * item + (2 * c * f + 9 * f * f + 2 * c + 4 * f) * 4
        # 1x1 reduce, 3x3, 1x1 expand; three scale-bias-ReLUs; residual add
        ops = 2 * b * h * w * (2 * c * f + 9 * f * f) + b * h * w * (
            3 * (c + 2 * f) + c)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_args(kind: str, shape, dtype, gen) -> tuple:
    """Seeded inputs of one kernel call on the card: activations, weights
    scaled by 1/sqrt(fan-in), folded BN scales in [0.5, 1.5) and biases of
    both signs."""
    c = shape[-1]

    def randn(*size, scale=1.0):
        return torch.randn(size, generator=gen, device="cuda") * scale

    def sb(n):
        return (torch.rand(n, generator=gen, device="cuda") + 0.5,
                randn(n, scale=0.5))

    x = randn(*shape).to(dtype)
    if kind == "sbr":
        return (x, *sb(c))
    if kind == "block_fwd":
        std = (1.0 / (9 * c)) ** 0.5
        w1, w2 = randn(3, 3, c, c, scale=std), randn(3, 3, c, c, scale=std)
        return (x, w1, w2, *sb(c), *sb(c))
    f = c // 4
    return (x, randn(c, f, scale=c ** -0.5),
            randn(3, 3, f, f, scale=(9 * f) ** -0.5),
            randn(f, c, scale=f ** -0.5), *sb(c), *sb(f), *sb(f))


def _timed(row, kernel, plain, kind, shape, dtype, reps: int = 20,
           inner: int = 10) -> dict:
    for key, fn in (("ms", kernel), ("plain_ms", plain)):
        row[key] = time_ms(fn, queued=True, reps=reps, inner=inner)
        row["call_" + key] = time_ms(fn, queued=False, reps=reps,
                                     inner=inner)
    row["bound_ms"], row["bound_by"] = bound(kind, shape, dtype)
    row["bound_us"] = row["bound_ms"] * 1e3
    return row


def kernel_phase(wrappers):
    """Per-shape comparison and timing; returns the per-shape rows."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    cases = [(path, kind, shape, n) for path, kinds in SHAPES.items()
             for kind, shapes in kinds.items() for shape, n in shapes]
    for path, kind, shape, per_pass in cases:
        kernel, plain = wrappers[kind]
        for dtype in (torch.bfloat16, torch.float32):
            args = kernel_args(kind, shape, dtype, gen)
            got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            atol, rtol = TOLERANCE[(kind, dtype)]
            excess = float((d - atol - rtol * want.float().abs()).max())
            row = {"kernel": kind, "path": path, "shape": list(shape),
                   "dtype": str(dtype).split(".")[1],
                   "per_pass": per_pass,
                   "max_abs_err": float(d.max()),
                   "max_rel_err": float(d.max() / want.float().abs().max()),
                   "atol": atol, "rtol": rtol}
            check(got.dtype == dtype and got.shape == want.shape,
                  f"{kind} {shape} {dtype}: wrong output {got.dtype} "
                  f"{tuple(got.shape)}")
            check(excess <= 0, f"{kind} {shape} {dtype}: error beyond "
                  f"tolerance: {row}")
            rows.append(_timed(row, lambda: kernel(*args),
                               lambda: plain(*args), kind, shape, dtype))
    return rows


def train_kernel_phase(ep, sx):
    """The train paths' backward kernels against their plain versions:
    ``sbr_bwd`` at the CIFAR and ImageNet train paths' sbr shapes, bfloat16
    and float32, and the cross-entropy pair at B=128 for 10, 100 and 1000
    classes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    sbr_cases = [(path, shape, n)
                 for path in ("cifar10_train", "imagenet_fused_train")
                 for shape, n in SHAPES[path]["sbr"]]
    for path, shape, per_step in sbr_cases:
        c = shape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            sc = torch.rand(c, generator=gen, device="cuda") + 0.5
            bi = torch.randn(c, generator=gen, device="cuda") * 0.5
            got = ep.scale_bias_relu_bwd(x, sc, bi, g)
            want = ep.scale_bias_relu_bwd_reference(x, sc, bi, g)
            torch.cuda.synchronize()
            gm = torch.where(x.float() * sc + bi > 0, g.float(), 0.0)
            rtol, atol = SBR_BWD_TOL
            name = f"sbr_bwd {shape} {dtype}"
            check(got[0].dtype == dtype and torch.equal(got[0], want[0]),
                  f"{name}: dx differs from the plain version")
            excess = 0.0
            for k, terms in ((1, gm * x.float()), (2, gm)):
                limit = rtol * terms.abs().sum(dim=(0, 1, 2)) + atol
                excess = max(excess, float(((got[k] - want[k]).abs()
                                            / limit).max()))
            err = max(float((got[k].float() - want[k].float()).abs().max())
                      for k in range(3))
            row = {"kernel": "sbr_bwd", "path": path,
                   "shape": list(shape), "dtype": str(dtype).split(".")[1],
                   "per_pass": per_step, "max_abs_err": err,
                   "ds_db_err_over_limit": excess,
                   "tolerance": "dx exact; ds, db <= 1e-5*sum|terms| + 1e-6"}
            check(excess <= 1, f"{name}: ds/db beyond tolerance: {row}")
            rows.append(_timed(
                row, lambda: ep.scale_bias_relu_bwd(x, sc, bi, g),
                lambda: ep.scale_bias_relu_bwd_reference(x, sc, bi, g),
                "sbr_bwd", shape, dtype))
    atol, rtol = XENT_TOL
    for path, classes, per_step in XENT_CLASSES:
        shape = (TRAIN_BATCH, classes)
        logits = torch.randn(shape, generator=gen, device="cuda") * 3
        labels = torch.randint(0, classes, (TRAIN_BATCH,), generator=gen,
                               device="cuda", dtype=torch.int32)
        labels64 = labels.long()
        g = torch.rand(TRAIN_BATCH, generator=gen, device="cuda")
        pairs = {
            "xent_fwd": (lambda: sx.softmax_xent_per_example(logits, labels),
                         lambda: sx.softmax_xent_per_example_reference(
                             logits, labels)),
            "xent_bwd": (lambda: sx.softmax_xent_bwd(logits, labels, g),
                         lambda: sx.softmax_xent_bwd_reference(logits,
                                                               labels, g))}
        for kind, (kernel, plain) in pairs.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            d = (got - want).abs()
            row = {"kernel": kind, "path": path,
                   "shape": list(shape), "dtype": "float32",
                   "per_pass": per_step, "max_abs_err": float(d.max()),
                   "max_rel_err": float(d.max() / want.abs().max()),
                   "atol": atol, "rtol": rtol}
            check(got.shape == want.shape and bool(
                (d <= atol + rtol * want.abs()).all()),
                f"{kind} {shape}: error beyond tolerance: {row}")
            _timed(row, kernel, plain, kind, shape, torch.float32)
            # One PyTorch call computes the forward; none the backward.
            row["library_ms"] = (time_ms(lambda: F.cross_entropy(
                logits, labels64, reduction="none"), queued=True)
                if kind == "xent_fwd" else None)
            rows.append(row)
    return rows


def block_train_args(shape, dtype, gen) -> dict:
    """Seeded inputs of the fused block's training kernels on a coarse
    dyadic grid: x in steps of 1/4, gy of 1/8, weights of 1/32 (|w| <=
    1/8), gammas, betas and means of 1/8, 1/sigma a power of 2. Every
    product and partial sum of the recomputed c1 and of convT(gy, w2) is
    then exact in float32 whatever the order, so the kernel and the plain
    version reach the same c1 and the same masks [z > 0], and the sums and
    dx differ only by rounding."""
    c = shape[-1]

    def grid(size, lo, hi, step):
        return torch.randint(lo, hi + 1, size, generator=gen,
                             device="cuda").float() * step

    def vec(lo, hi, step):
        return grid((c,), lo, hi, step)

    return {"x": grid(shape, -8, 8, 0.25).to(dtype),
            "gy": grid(shape, -16, 16, 0.125),
            "w1": grid((3, 3, c, c), -4, 4, 1 / 32),
            "w2": grid((3, 3, c, c), -4, 4, 1 / 32),
            "g1": vec(4, 12, 1 / 8), "b1": vec(-4, 4, 1 / 8),
            "g2": vec(4, 12, 1 / 8), "b2": vec(-4, 4, 1 / 8),
            "m1": vec(-4, 4, 1 / 8), "i1": 2.0 ** vec(-1, 1, 1),
            "m2": vec(-8, 8, 1 / 8), "i2": 2.0 ** vec(-2, 0, 1)}


def _sum_excess(got, want, scale) -> float:
    """Largest |kernel - plain| over its limit rtol * sum|terms| + atol."""
    rtol, atol = SBR_BWD_TOL
    return max(float(((g - w).abs() / (rtol * s + atol)).max())
               for g, w, s in zip(got, want, scale))


def block_train_kernel_phase(fb):
    """The fused block's four training kernels against their plain versions
    at the three CIFAR train shapes, bfloat16 and float32: every sum within
    1e-5 * sum|terms| + 1e-6, dx within block_fwd's tolerance, two calls bit
    for bit equal. The oracle's convolutions run with cuDNN off (PyTorch's
    own im2col and cuBLAS GEMM), which keep the exact grid of
    :func:`block_train_args` exact."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for shape, per_step in SHAPES["cifar10_fused_train"]["block_fwd"]:
        for dtype in (torch.bfloat16, torch.float32):
            a = block_train_args(shape, dtype, gen)
            x, gy, w1, w2 = a["x"], a["gy"], a["w1"], a["w2"]
            vecs = tuple(a[k] for k in ("g1", "b1", "g2", "b2", "m1", "i1",
                                        "m2", "i2"))
            with torch.backends.cudnn.flags(enabled=False):
                t = fb.train_bwd_pass1_reference(x, gy, w1, w2, *vecs)[:2]
                u = fb.train_bwd_pass2_reference(x, gy, w1, w2, *vecs,
                                                 *t)[:2]
            calls = {
                "block_stats": ((x, w1, a["g1"], a["b1"]), fb.block_stats,
                                fb.block_stats_reference),
                "block_bwd1": ((x, gy, w1, w2, *vecs), fb.block_bwd1,
                               fb.train_bwd_pass1_reference),
                "block_bwd2": ((x, gy, w1, w2, *vecs, *t), fb.block_bwd2,
                               fb.train_bwd_pass2_reference),
                "block_bwd3": ((x, gy, w1, w2, *vecs, *t, *u), fb.block_bwd3,
                               fb.train_bwd_pass3_reference)}
            for kind, (args, kernel, plain) in calls.items():
                got, again = kernel(*args), kernel(*args)
                with torch.backends.cudnn.flags(enabled=False):
                    want = plain(*args)
                    scale = (plain(*args, magnitudes=True)
                             if kind != "block_bwd3" else None)
                torch.cuda.synchronize()
                name = f"{kind} {shape} {dtype}"
                if kind == "block_bwd3":
                    got, again, want = (got,), (again,), (want,)
                check(all(torch.equal(p, q) for p, q in zip(got, again)),
                      f"{name}: two calls differ")
                err = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(got, want))
                row = {"kernel": kind, "path": "cifar10_fused_train",
                       "shape": list(shape),
                       "dtype": str(dtype).split(".")[1],
                       "per_pass": per_step, "max_abs_err": err}
                if kind == "block_bwd3":
                    atol, rtol = TOLERANCE[("block_fwd", dtype)]
                    d = (got[0].float() - want[0].float()).abs()
                    excess = float((d / (atol + rtol * want[0].float().abs()))
                                   .max())
                    check(got[0].dtype == dtype,
                          f"{name}: dx is {got[0].dtype}")
                    row.update(atol=atol, rtol=rtol)
                else:
                    excess = _sum_excess(got, want, scale)
                    row["tolerance"] = "sums <= 1e-5*sum|terms| + 1e-6"
                row["err_over_limit"] = excess
                check(excess <= 1, f"{name}: beyond tolerance: {row}")
                rows.append(_timed(row, lambda: kernel(*args),
                                   lambda: plain(*args), kind, shape, dtype))
    return rows


def bottleneck_train_args(shape, dtype, gen) -> tuple:
    """Seeded inputs of the fused bottleneck's training kernels on a coarse
    dyadic grid: x in steps of 1/4 (|x| <= 2), gy of 1/8, weights of 1/32
    (|w| <= 1/8 or 1/16), betas of 1/16, means of 1/4 or 1/8, gammas and
    1/sigma powers of 2. c1, chat, mid and mhat are then exact in float32
    whatever the summation order, so kernel and plain version share their
    masks [m > 0] and the sums and dx differ only by rounding. Returns x,
    gy, w1, w2, w3 and the twelve BN vectors (g, be, mu, 1/sigma of BN1,
    BN2, BN3)."""
    c4 = shape[-1]
    f = c4 // 4

    def grid(size, lo, hi, step):
        return torch.randint(lo, hi + 1, size, generator=gen,
                             device="cuda").float() * step

    def pow2(n, lo, hi):
        return 2.0 ** grid((n,), lo, hi, 1)

    vecs = (pow2(c4, -1, 0), grid((c4,), -4, 4, 1 / 16),
            grid((c4,), -2, 2, 1 / 4), pow2(c4, -1, 0),
            pow2(f, -1, 0), grid((f,), -4, 4, 1 / 16),
            grid((f,), -8, 8, 1 / 8), pow2(f, -3, -2),
            pow2(f, -1, 0), grid((f,), -4, 4, 1 / 16),
            grid((f,), -8, 8, 1 / 8), pow2(f, -1, 0))
    return (grid(shape, -8, 8, 1 / 4).to(dtype), grid(shape, -16, 16, 1 / 8),
            grid((c4, f), -4, 4, 1 / 32), grid((3, 3, f, f), -2, 2, 1 / 32),
            grid((f, c4), -4, 4, 1 / 32), *vecs)


def bottleneck_train_kernel_phase(fbn):
    """The fused bottleneck's six training kernels against their plain
    versions at the three ImageNet B=128 stage shapes, bfloat16 and
    float32, on the dyadic grid of :func:`bottleneck_train_args`: every sum
    within 1e-5 * sum|terms| + 1e-6, dx within ``bottleneck_fwd``'s
    tolerance, two calls bit for bit equal. The oracle's convolutions run
    with cuDNN off. Fewer timing repetitions: each call takes
    milliseconds."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for shape, per_step in SHAPES["imagenet_fused_train"]["bottleneck_fwd"]:
        for dtype in (torch.bfloat16, torch.float32):
            base = bottleneck_train_args(shape, dtype, gen)
            x, gy, w1, w2, w3, *vecs = base
            with torch.backends.cudnn.flags(enabled=False):
                t3 = fbn.train_bwd_pass1_reference(*base)[:2]
                t2 = fbn.train_bwd_pass2_reference(*base, *t3)[:2]
                t1 = fbn.train_bwd_pass3_reference(*base, *t3, *t2)[:2]
            calls = {
                "bottleneck_stats_a": ((x, w1, *vecs[:4]),
                                       fbn.bottleneck_stats_a,
                                       fbn.bottleneck_stats_a_reference),
                "bottleneck_stats_b": ((x, w1, w2, *vecs[:8]),
                                       fbn.bottleneck_stats_b,
                                       fbn.bottleneck_stats_b_reference),
                "bottleneck_bwd1": (base, fbn.bottleneck_bwd1,
                                    fbn.train_bwd_pass1_reference),
                "bottleneck_bwd2": ((*base, *t3), fbn.bottleneck_bwd2,
                                    fbn.train_bwd_pass2_reference),
                "bottleneck_bwd3": ((*base, *t3, *t2), fbn.bottleneck_bwd3,
                                    fbn.train_bwd_pass3_reference),
                "bottleneck_bwd4": ((*base, *t3, *t2, *t1),
                                    fbn.bottleneck_bwd4,
                                    fbn.train_bwd_pass4_reference)}
            for kind, (args, kernel, plain) in calls.items():
                got, again = kernel(*args), kernel(*args)
                with torch.backends.cudnn.flags(enabled=False):
                    want = plain(*args)
                    scale = (plain(*args, magnitudes=True)
                             if kind != "bottleneck_bwd4" else None)
                torch.cuda.synchronize()
                name = f"{kind} {shape} {dtype}"
                if kind == "bottleneck_bwd4":
                    got, again, want = (got,), (again,), (want,)
                check(all(torch.equal(p, q) for p, q in zip(got, again)),
                      f"{name}: two calls differ")
                err = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(got, want))
                row = {"kernel": kind, "path": "imagenet_fused_train",
                       "shape": list(shape),
                       "dtype": str(dtype).split(".")[1],
                       "per_pass": per_step, "max_abs_err": err}
                if kind == "bottleneck_bwd4":
                    atol, rtol = TOLERANCE[("bottleneck_fwd", dtype)]
                    d = (got[0].float() - want[0].float()).abs()
                    excess = float((d / (atol + rtol * want[0].float().abs()))
                                   .max())
                    check(got[0].dtype == dtype,
                          f"{name}: dx is {got[0].dtype}")
                    row.update(atol=atol, rtol=rtol)
                else:
                    excess = _sum_excess(got, want, scale)
                    row["tolerance"] = "sums <= 1e-5*sum|terms| + 1e-6"
                row["err_over_limit"] = excess
                check(excess <= 1, f"{name}: beyond tolerance: {row}")
                rows.append(_timed(row, lambda: kernel(*args),
                                   lambda: plain(*args), kind, shape, dtype,
                                   reps=5, inner=2))
    return rows


def _bwd_rows(kind, path, shape, dtype, args, kernel, plain, per_pass,
              fwd_kind, **timing) -> dict:
    """One row of a folded block's gradient: two kernel calls bit for bit
    equal, dx within ``fwd_kind``'s tolerance, every sum and weight
    gradient within 1e-5 * sum|terms| + 1e-6 (the oracle's convolutions with
    cuDNN off)."""
    got, again = kernel(*args), kernel(*args)
    with torch.backends.cudnn.flags(enabled=False):
        want = plain(*args)
        scale = plain(*args, magnitudes=True)
    torch.cuda.synchronize()
    name = f"{kind} {shape} {dtype}"
    check(all(torch.equal(p, q) for p, q in zip(got, again)),
          f"{name}: two calls differ")
    check(got[0].dtype == dtype and all(t.dtype == torch.float32
                                        for t in got[1:]),
          f"{name}: output types {[t.dtype for t in got]}")
    atol, rtol = TOLERANCE[(fwd_kind, dtype)]
    d = (got[0].float() - want[0].float()).abs()
    dx_excess = float((d / (atol + rtol * want[0].float().abs())).max())
    excess = _sum_excess(got[1:], want[1:], scale[1:])
    row = {"kernel": kind, "path": path, "shape": list(shape),
           "dtype": str(dtype).split(".")[1], "per_pass": per_pass,
           "max_abs_err": max(float((g.float() - w.float()).abs().max())
                              for g, w in zip(got, want)),
           "dx_err_over_limit": dx_excess, "err_over_limit": excess,
           "atol": atol, "rtol": rtol,
           "tolerance": "dx as the forward; sums and weight gradients "
                        "<= 1e-5*sum|terms| + 1e-6"}
    check(dx_excess <= 1 and excess <= 1, f"{name}: beyond tolerance: {row}")
    del got, again, want, scale
    return _timed(row, lambda: kernel(*args), lambda: plain(*args), kind,
                  shape, dtype, **timing)


def fused_bwd_kernel_phase(fb, fbn):
    """The folded blocks' gradients against their plain versions:
    ``block_bwd`` at the three CIFAR stage shapes and ``bottleneck_bwd`` at
    the three ResNet-50 stage shapes, at B=128 (the A/B tools' shapes, one
    call per shape and pass) and at B=GRAD_BATCH (the grad phase's, with
    its launches per backward), bfloat16 and float32, on the dyadic grids
    of :func:`block_train_args` and :func:`bottleneck_train_args` (the
    folded scales and biases taken from their gammas, betas and powers of
    2, so that c1 and mid and with them the masks are exact)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    ab = [(shape, 1) for shape, _ in SHAPES["cifar10_fused_train"]
          ["block_fwd"]]
    for path, shapes in (("cifar10_ab", ab),
                         ("cifar10_grad", GRAD_SHAPES["cifar10"])):
        for shape, per_pass in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                a = block_train_args(shape, dtype, gen)
                args = (a["x"], a["gy"], a["w1"], a["w2"], a["g1"], a["b1"],
                        a["g2"], a["b2"])
                rows.append(_bwd_rows(
                    "block_bwd", path, shape, dtype, args, fb.block_bwd,
                    fb.block_bwd_reference, per_pass, "block_fwd"))
    ab = [(shape, 1) for shape, _ in SHAPES["imagenet_fused_train"]
          ["bottleneck_fwd"]]
    for path, shapes in (("imagenet_ab", ab),
                         ("imagenet_grad", GRAD_SHAPES["imagenet"])):
        for shape, per_pass in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                x, gy, w1, w2, w3, *v = bottleneck_train_args(shape, dtype,
                                                              gen)
                # s1 = g1, b1 = be1; s2 = i2 (1/8 or 1/4, so that mid stays
                # on the grid), b2 = be2; s3 = g3, b3 = be3.
                args = (x, gy, w1, w2, w3, v[0], v[1], v[7], v[5], v[8],
                        v[9])
                rows.append(_bwd_rows(
                    "bottleneck_bwd", path, shape, dtype, args,
                    fbn.bottleneck_bwd, fbn.bottleneck_bwd_reference,
                    per_pass, "bottleneck_fwd", reps=5, inner=2))
                del x, gy, args
    torch.cuda.empty_cache()
    return rows


def kernel_counters() -> dict:
    """{kernel: (module, launch counter)} of the port's wrappers."""
    from tpu_resnet_torch.ops import epilogue as ep
    from tpu_resnet_torch.ops import fused_block as fb
    from tpu_resnet_torch.ops import fused_bottleneck as fbn
    from tpu_resnet_torch.ops import softmax_xent as sx
    return {"sbr": (ep, "launches"), "block_fwd": (fb, "launches"),
            "bottleneck_fwd": (fbn, "launches"),
            "sbr_bwd": (ep, "bwd_launches"), "xent_fwd": (sx, "fwd_launches"),
            "xent_bwd": (sx, "bwd_launches"),
            "block_stats": (fb, "stats_launches"),
            "block_bwd1": (fb, "bwd1_launches"),
            "block_bwd2": (fb, "bwd2_launches"),
            "block_bwd3": (fb, "bwd3_launches"),
            "bottleneck_stats_a": (fbn, "stats_a_launches"),
            "bottleneck_stats_b": (fbn, "stats_b_launches"),
            "bottleneck_bwd1": (fbn, "bwd1_launches"),
            "bottleneck_bwd2": (fbn, "bwd2_launches"),
            "bottleneck_bwd3": (fbn, "bwd3_launches"),
            "bottleneck_bwd4": (fbn, "bwd4_launches"),
            "sbr_add": (ep, "add_launches"),
            "block_bwd": (fb, "bwd_launches"),
            "bottleneck_bwd": (fbn, "bwd_launches")}


def zero_counts(counters) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_counts(counters) -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


@contextlib.contextmanager
def plain_versions():
    """Route the model's and the train step's kernel calls to the plain
    versions (the oracle runs only); the plain sbr and cross-entropy are
    differentiable through their plain backward versions."""
    from tpu_resnet_torch.ops import epilogue as ep
    from tpu_resnet_torch.ops import fused_block as fb
    from tpu_resnet_torch.ops import fused_bottleneck as fbn
    from tpu_resnet_torch.ops import softmax_xent as sx
    swaps = ((ep, "scale_bias_relu", ep.scale_bias_relu_reference),
             (fb, "block_fwd", fb.block_fwd_reference),
             (fb, "block_apply", fb.block_apply_reference),
             (fb, "block_train_apply", fb.block_train_apply_reference),
             (fbn, "bottleneck_fwd", fbn.bottleneck_fwd_reference),
             (fbn, "bottleneck_apply", fbn.bottleneck_apply_reference),
             (fbn, "bottleneck_train_apply",
              fbn.bottleneck_train_apply_reference),
             (sx, "softmax_xent_per_example",
              sx.softmax_xent_per_example_reference))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def post(port: int, body: bytes, content_type: str, shape=None) -> tuple:
    """POST /predict?logits=1; returns (response json, seconds)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict?logits=1", data=body,
        headers={"Content-Type": content_type,
                 **({"X-Shape": ",".join(map(str, shape))} if shape else {})})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        out = json.loads(resp.read())
    return out, time.perf_counter() - t0


def get_status(port: int, path: str) -> int:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


# Each serve path, named by its preset: image size, the requests that check
# the served logits ((count, offset) octet-stream requests; the count of
# images in one JSON request), latency requests at N=1, and the argmax rule.
SERVE_PATHS = {
    "cifar10": {"size": 32, "octet": ((1, 0), (3, 1), (16, 4)), "json": 2,
                "lat1": 40, "argmax": "all"},
    "imagenet": {"size": 224, "octet": ((1, 0), (16, 1)), "json": 1,
                 "lat1": 20, "argmax": "margin"},
}
N_IMAGES = 256


def serve_phase(path: str, counters, gpu: str) -> dict:
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.models import build_model, init_weights
    from tpu_resnet_torch.serve.infer import make_serve_infer
    from tpu_resnet_torch.serve.server import PredictServer
    from tpu_resnet_torch.train import checkpoint

    spec = SERVE_PATHS[path]
    size = spec["size"]
    train_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{path}_")
    cfg = load_config(path, "", [
        "model.fused_blocks=true", "model.fused_epilogue=on",
        f"train.train_dir={train_dir}", "serve.host=127.0.0.1",
        "serve.port=0"])
    check(cfg.data.resolved_image_size == size, f"{path}: image size "
          f"{cfg.data.resolved_image_size}")
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    checkpoint.save(train_dir, 1, model)
    server = PredictServer(cfg, device="cuda")
    try:
        check(server.health()["ok"] is False, "ready before warmup")
        t0 = time.monotonic()
        server.start()
        warm_s = time.monotonic() - t0
        check(tuple(server.buckets) == (1, 2, 4, 8, 16),
              f"buckets {server.buckets}")
        check(get_status(server.port, "/healthz") == 200,
              "/healthz must be 200 once warm")
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (N_IMAGES, size, size, 3),
                              dtype=np.uint8)

        def octet(n, off):
            return post(server.port, images[off:off + n].tobytes(),
                        "application/octet-stream", (n, size, size, 3))

        batches0 = server.batcher.stats()["batches"]
        zero_counts(counters)
        served = []  # (images, logits)
        for n, off in spec["octet"]:
            out, _ = octet(n, off)
            check(out["count"] == n, f"count {out['count']} != {n}")
            served.append((images[off:off + n], np.asarray(out["logits"])))
        js = images[20:20 + spec["json"]]
        out, _ = post(server.port,
                      json.dumps({"instances": js.tolist()}).encode(),
                      "application/json")
        check(out["count"] == len(js), f"json count {out['count']}")
        served.append((js, np.asarray(out["logits"])))
        lat1 = [octet(1, i)[1] for i in range(spec["lat1"])]
        lat16 = [octet(16, i)[1] for i in range(0, N_IMAGES, 16)]
        launches = read_counts(counters)
        forwards = server.batcher.stats()["batches"] - batches0
        check(forwards > 0, "no batch ran")
        want_launches = {k: n * forwards for k, n in PER_PASS[path].items()}
        check(launches == want_launches,
              f"{path}: launch counts {launches} over {forwards} forward "
              f"passes, expected {want_launches}")

        # Oracle: the served model, on the card, through the plain versions.
        infer = make_serve_infer(cfg, server.backend.device)
        served_model = server.backend._model

        def run_all():
            return np.concatenate([
                infer(served_model, images[i:i + 16]).float().cpu().numpy()
                for i in range(0, N_IMAGES, 16)])

        with plain_versions():
            ref = [infer(served_model, im).float().cpu().numpy()
                   for im, _ in served]
            ref_all = run_all()
        kern_all = run_all()
        got = np.concatenate([lg for _, lg in served])
        want = np.concatenate(ref)
        check(got.shape == want.shape and np.isfinite(got).all(),
              f"served logits {got.shape}, finite={np.isfinite(got).all()}")
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        err_all = float(np.abs(kern_all - ref_all).max())
        agree = float(np.mean(kern_all.argmax(-1) == ref_all.argmax(-1)))
        check(err <= LOGIT_TOL * scale,
              f"served logits differ by {err} (scale {scale})")
        check(err_all <= LOGIT_TOL * scale,
              f"batched logits differ by {err_all} (scale {scale})")
        top2 = np.sort(ref_all, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * err_all
        if spec["argmax"] == "all":
            check(bool((got.argmax(-1) == want.argmax(-1)).all()),
                  "served argmax differs from the plain-version model")
            check(agree >= ARGMAX_AGREE,
                  f"argmax agreement {agree} over {N_IMAGES}")
        else:
            check(bool(clear.any()), "no image's top-1/top-2 margin exceeds "
                  f"twice the max logit difference {err_all}")
            check(bool((kern_all.argmax(-1) == ref_all.argmax(-1))[clear]
                       .all()), "argmax differs from the plain-version "
                  "model on an image with a clear margin")
    finally:
        clean = server.drain(timeout=60)
        server.close()
        shutil.rmtree(train_dir, ignore_errors=True)
    check(clean, "server did not drain cleanly")
    result = {
        "path": path,
        "model": f"{path} ResNet-50 {size}x{size} fused_blocks=on "
                 f"fused_epilogue=on bf16",
        "params": sum(p.numel() for p in model.parameters()),
        "warmup_s": warm_s, "forwards": forwards, "launches": launches,
        "per_forward": {k: v / forwards for k, v in launches.items()},
        "logits_max_abs_err": err, "batched_max_abs_err": err_all,
        "logits_scale": scale, "logit_tol_fraction": LOGIT_TOL,
        f"argmax_agreement_{N_IMAGES}": agree,
        "clear_margin_images": int(clear.sum()),
        "p50_request_ms_n1": statistics.median(lat1) * 1e3,
        "p50_request_ms_n16": statistics.median(lat16) * 1e3,
        "images_per_s_n16": 16 * len(lat16) / sum(lat16),
        "gpu": gpu, "drained_clean": clean,
    }
    emit("serve", **result)
    return result


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def imagenet_batches(n: int, batch: int, classes: int, size: int) -> list:
    """``n`` seeded (uint8 [batch,size,size,3], int32 labels in
    0..classes-1) batches: what the ImageNet input pipeline hands the
    device."""
    rng = np.random.default_rng(5)
    return [(rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8),
             rng.integers(0, classes, batch).astype(np.int32))
            for _ in range(n)]


def step_batch(cfg, batch: int) -> tuple:
    """One seeded augmented batch (x, labels) on the card for the float32
    step gate: CIFAR synthetic data, or seeded uint8 ImageNet images."""
    from tpu_resnet_torch.data import augment as aug
    from tpu_resnet_torch.data.cifar import synthetic_data

    cuda = torch.device("cuda")
    size, classes = cfg.data.resolved_image_size, cfg.data.num_classes
    if cfg.data.dataset == "imagenet":
        images, labels = imagenet_batches(1, batch, classes, size)[0]
    else:
        images, labels = synthetic_data(batch, size, classes, learnable=True)
    x = aug.get_train_augment(cfg.data.dataset)(
        torch.from_numpy(images).to(cuda), aug.step_key(0, 0))
    return x, torch.from_numpy(labels).to(cuda)


def step_arms(cfg, counters, arms, x, y) -> dict:
    """One float32 train step per arm from one seeded state and batch (x,
    y): ``arms`` maps a name to a context factory the step runs under.
    Returns {name: (state, metrics, launch counts)}."""
    from tpu_resnet_torch.train import schedule as sched_lib
    from tpu_resnet_torch.train.loop import build_state
    from tpu_resnet_torch.train.step import make_train_step

    cuda = torch.device("cuda")
    step_fn = make_train_step(cfg.optim, sched_lib.build_schedule(
        cfg.optim, cfg.train), cfg.data.num_classes)
    runs = {}
    for arm, context in arms.items():
        state = build_state(cfg, cuda)
        zero_counts(counters)
        with context():
            m = step_fn(state, x, y)
        torch.cuda.synchronize()
        runs[arm] = (state, {k: float(v) for k, v in m.items()},
                     read_counts(counters))
        del state
    return runs


def step_diff(got, want) -> dict:
    """Two steps' (state, metrics) compared: the metrics' relative errors,
    and every updated tensor's and momentum buffer's largest |d| over its
    limit atol + rtol * |want| (``STATE_TOL``)."""
    (gs, gm), (ws, wm) = got[:2], want[:2]
    out = {f"{k}_rel_err": _rel(gm[k], wm[k])
           for k in ("loss", "precision", "grad_norm")}
    atol, rtol = STATE_TOL
    pairs = [(f"state {n}", t, ws.model.state_dict()[n])
             for n, t in gs.model.state_dict().items()]
    gb, wb = gs.momentum_buffers(), ws.momentum_buffers()
    check(set(gb) == set(wb) and len(gb) > 0, "momentum buffers differ")
    pairs += [(f"momentum {n}", gb[n], wb[n]) for n in gb]
    excess = sorted(((float(((g - w).abs() / (atol + rtol * w.abs())).max()),
                      name) for name, g, w in pairs), reverse=True)
    out.update(tensors_compared=len(pairs),
               worst_err_over_limit=excess[0][0],
               tensors_over_limit=sum(e > 1 for e, _ in excess),
               worst_tensors=[[name, e] for e, name in excess[:5]])
    return out


@contextlib.contextmanager
def plain_native_convs():
    """The plain versions with cuDNN off: PyTorch's own convolutions, which
    sum in another order than cuDNN's (the control of ``compare_step``)."""
    with plain_versions(), torch.backends.cudnn.flags(enabled=False):
        yield


def compare_step(cfg, counters, path: str, batch: int = TRAIN_BATCH
                 ) -> dict:
    """One float32 train step from one seeded state through the kernels,
    and one through the plain versions; every metric and updated tensor
    compared against the step limits (``STEP_RTOL``, ``STATE_TOL``), and the
    kernel step's launches against ``path``'s table.

    Where the kernels replace convolutions (the fused blocks), the two
    steps sum their convolutions in different orders, and no two
    implementations of the step meet those limits: a backward mask [z > 0]
    recomputed from a conv output flips wherever z lies within rounding of
    0, and the step carries each flip down to the first layers' gradients.
    So the step is also run as the control, the plain versions on PyTorch's
    own convolutions, and the comparison passes when the step limits hold or
    when the kernels' step lies within ``CONTROL_FACTOR`` times the
    control's distance from the plain step (the worst tensor over the
    limit); loss and precision are held to ``STEP_RTOL`` either way, and
    grad_norm's error is reported beside the control's (a scalar of the
    whole gradient, it moves with a few flipped masks: 1.4-8x the
    control's over four weight seeds on an H100)."""
    arms = {"kernels": contextlib.nullcontext, "plain": plain_versions}
    fused = (PER_PASS[path]["block_fwd"] + PER_PASS[path]["bottleneck_fwd"]
             > 0)
    if fused:
        arms["control"] = plain_native_convs
    runs = step_arms(cfg, counters, arms, *step_batch(cfg, batch))
    (_, km, kc), (_, pm, pc) = runs["kernels"], runs["plain"]
    check(kc == PER_PASS[path], f"kernel step launches {kc}")
    check(not any(pc.values()), f"plain step launched kernels: {pc}")
    out = {"batch": batch, "metrics_kernels": km, "metrics_plain": pm,
           **step_diff(runs["kernels"], runs["plain"])}
    out["step_limits_held"] = (
        all(out[f"{k}_rel_err"] <= STEP_RTOL
            for k in ("loss", "precision", "grad_norm"))
        and out["worst_err_over_limit"] <= 1)
    ok = out["step_limits_held"]
    if fused:
        control = step_diff(runs["control"], runs["plain"])
        out["control_vs_plain"] = control
        out["control_factor"] = CONTROL_FACTOR
        ok = ok or (
            all(out[f"{k}_rel_err"] <= STEP_RTOL
                for k in ("loss", "precision"))
            and out["worst_err_over_limit"]
            <= CONTROL_FACTOR * max(control["worst_err_over_limit"], 1.0))
    check(ok, f"f32 step beyond {STEP_RTOL} (metrics) or {STATE_TOL} (atol, "
          f"rtol; tensors), and beyond {CONTROL_FACTOR} x the control: {out}")
    return out


def train_phase(path: str, counters, gpu: str) -> dict:
    """The port's training entry point at full width on one train path
    (``TRAIN_PATHS``): the f32 kernel-vs-plain step, 100 bf16 steps through
    ``train()``, the resume to 120, eval once, and the step's device
    profile."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.data.cifar import synthetic_data
    from tpu_resnet_torch.evaluation.evaluator import evaluate
    from tpu_resnet_torch.tools.profiling import profile_train_step
    from tpu_resnet_torch.train import checkpoint
    from tpu_resnet_torch.train.loop import make_loop_step, train

    spec = TRAIN_PATHS[path]
    overrides = [*TRAIN_OVERRIDES, *spec["overrides"]]
    compared = compare_step(load_config("cifar10", "", [
        *overrides, "model.compute_dtype=float32"]), counters, path)
    train_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{path}_")
    try:
        cfg = load_config("cifar10", "", [
            *overrides, f"train.train_dir={train_dir}",
            f"train.train_steps={TRAIN_STEPS}", "train.log_every=1",
            "train.checkpoint_every=50"])
        runs = {}
        for total in (TRAIN_STEPS, RESUME_STEPS):
            cfg.train.train_steps = total
            zero_counts(counters)
            t0 = time.monotonic()
            state = train(cfg, device="cuda")
            torch.cuda.synchronize()
            runs[total] = (time.monotonic() - t0, read_counts(counters))
            check(state.step == total, f"train() stopped at {state.step}")
        with open(os.path.join(train_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        steps = [r["step"] for r in recs]
        check(steps == list(range(1, RESUME_STEPS + 1)),
              f"metrics.jsonl steps {steps[:3]}..{steps[-3:]}")
        losses = [r["loss"] for r in recs]
        check(all(np.isfinite(losses)), "a logged loss is not finite")
        first10 = float(np.mean(losses[:10]))
        last10 = float(np.mean(losses[TRAIN_STEPS - 10:TRAIN_STEPS]))
        check(last10 < first10, f"loss did not fall: first 10 mean "
              f"{first10}, last 10 of {TRAIN_STEPS} {last10}")
        per_step = PER_PASS[path]
        for total, start in ((TRAIN_STEPS, 0), (RESUME_STEPS, TRAIN_STEPS)):
            want = {k: n * (total - start) for k, n in per_step.items()}
            check(runs[total][1] == want, f"train to {total}: launch counts "
                  f"{runs[total][1]}, expected {want}")
        saved = checkpoint.all_steps_in(train_dir)
        check(saved[-2:] == [TRAIN_STEPS, RESUME_STEPS],
              f"checkpoints {saved}")

        cfg.train.eval_once = True
        zero_counts(counters)
        precision = evaluate(cfg, device="cuda")
        eval_counts = read_counts(counters)
        with open(os.path.join(train_dir, "eval", "metrics.jsonl")) as f:
            eval_rec = json.loads(f.readlines()[-1])
        forwards = -(-cfg.data.eval_examples // cfg.train.eval_batch_size)
        want = {k: spec["eval_per_forward"].get(k, 0) * forwards
                for k in KERNELS}
        check(eval_counts == want, f"eval launch counts {eval_counts}, "
              f"expected {want}")
        check(eval_rec["step"] == RESUME_STEPS and precision is not None
              and np.isfinite(eval_rec["eval_loss"]), f"eval {eval_rec}")

        images, labels = synthetic_data(TRAIN_BATCH, 32,
                                        cfg.data.num_classes, learnable=True)
        prof = profile_train_step(
            state, make_loop_step(cfg, torch.device("cuda")), images, labels)
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    # The loop's speed over the window of steps 2..TRAIN_STEPS (step 1 pays
    # the builds), from the wall stamps of metrics.jsonl: stalls included.
    window_s = recs[TRAIN_STEPS - 1]["wall"] - recs[0]["wall"]
    rates = [r["steps_per_sec"] for r in recs[1:TRAIN_STEPS]
             if "steps_per_sec" in r]
    result = {
        "path": path,
        "model": f"cifar10 ResNet-50 32x32 {spec['label']} "
                 "fused_epilogue=on use_pallas_xent=on bf16, B=128",
        "f32_step_vs_plain": compared,
        "steps": RESUME_STEPS, "resumed_from": TRAIN_STEPS,
        "train_seconds": runs[TRAIN_STEPS][0],
        "resume_seconds": runs[RESUME_STEPS][0],
        "launches": {k: runs[TRAIN_STEPS][1][k] + runs[RESUME_STEPS][1][k]
                     for k in KERNELS},
        "launches_per_step": per_step,
        "loss_first10_mean": first10, "loss_last10_mean": last10,
        "loss_at": {str(s): losses[s - 1] for s in (1, 50, 100, 120)},
        "precision_last10_mean": float(np.mean(
            [r["precision"] for r in recs[TRAIN_STEPS - 10:TRAIN_STEPS]])),
        "loop_window_steps": TRAIN_STEPS - 1, "loop_window_s": window_s,
        "loop_ms_per_step": 1e3 * window_s / (TRAIN_STEPS - 1),
        "loop_images_per_s": TRAIN_BATCH * (TRAIN_STEPS - 1) / window_s,
        "step_ms_median": 1e3 / statistics.median(rates),
        "eval_precision": precision, "eval_loss": eval_rec["eval_loss"],
        "eval_forwards": forwards, "eval_launches": eval_counts,
        "profile": {k: v for k, v in prof.items() if k != "kernels"},
        "profile_top_kernels": prof["kernels"][:12],
        "gpu": gpu}
    emit("train", **result)
    return result


def imagenet_train_phase(counters, gpu: str) -> dict:
    """ImageNet ResNet-50 training at 224x224, full depth and width, B=128,
    bf16, through the 10 fused bottlenecks (``IMAGENET_OVERRIDES``): the
    float32 kernel-vs-plain step gate (B=IMAGENET_GATE_BATCH), then the
    loop's own step (``build_state`` + ``make_loop_step``, as ``train()``
    builds them) for IMAGENET_STEPS steps on IMAGENET_BATCHES seeded uint8
    batches repeated, the counters zeroed just before and read just after;
    every loss finite and the mean of the last 5 below the first 5's; then
    the step's device profile."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.tools.profiling import profile_train_step
    from tpu_resnet_torch.train.loop import build_state, make_loop_step

    path = "imagenet_fused_train"
    compared = compare_step(load_config("imagenet", "", [
        *IMAGENET_OVERRIDES, "model.compute_dtype=float32"]), counters, path,
        IMAGENET_GATE_BATCH)
    cfg = load_config("imagenet", "", IMAGENET_OVERRIDES)
    size, classes = cfg.data.resolved_image_size, cfg.data.num_classes
    check(size == 224 and classes == 1000 and cfg.model.resnet_size == 50,
          f"imagenet preset: {size}x{size}, {classes} classes, "
          f"ResNet-{cfg.model.resnet_size}")
    cuda = torch.device("cuda")
    state = build_state(cfg, cuda)
    step_fn = make_loop_step(cfg, cuda)
    host = imagenet_batches(IMAGENET_BATCHES, TRAIN_BATCH, classes, size)
    batches = [(torch.from_numpy(im).to(cuda), torch.from_numpy(lb).to(cuda))
               for im, lb in host]
    torch.cuda.synchronize()
    zero_counts(counters)
    t0 = time.monotonic()
    losses = [step_fn(state, *batches[i % IMAGENET_BATCHES])["loss"]
              for i in range(IMAGENET_STEPS)]
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    counts = read_counts(counters)
    losses = [float(v) for v in losses]
    want = {k: n * IMAGENET_STEPS for k, n in PER_PASS[path].items()}
    check(counts == want, f"{path}: launch counts {counts} over "
          f"{IMAGENET_STEPS} steps, expected {want}")
    check(state.step == IMAGENET_STEPS, f"state at step {state.step}")
    check(all(np.isfinite(losses)), f"a loss is not finite: {losses}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last5 < first5, f"loss did not fall: first 5 mean {first5}, "
          f"last 5 {last5}")
    prof = profile_train_step(state, step_fn, *host[0], iters=10)
    result = {
        "path": path,
        "model": f"imagenet ResNet-50 {size}x{size} fused_blocks=on "
                 f"fused_epilogue=on use_pallas_xent=on "
                 f"{cfg.model.compute_dtype}, B={TRAIN_BATCH}",
        "params": sum(p.numel() for p in state.model.parameters()),
        "f32_step_vs_plain": compared,
        "steps": IMAGENET_STEPS, "batches": IMAGENET_BATCHES,
        "train_seconds": seconds,
        "loop_ms_per_step_first_included": 1e3 * seconds / IMAGENET_STEPS,
        "launches": counts, "launches_per_step": PER_PASS[path],
        "eval_launches": {k: 0 for k in KERNELS},
        "loss_first5_mean": first5, "loss_last5_mean": last5,
        "losses": losses,
        "profile": {k: v for k, v in prof.items() if k != "kernels"},
        "profile_top_kernels": prof["kernels"][:16],
        "gpu": gpu}
    emit("train", **result)
    return result


def probe_shapes() -> dict:
    """{path: BN+ReLU shapes} of the cifar10 and imagenet presets' models
    at B=TRAIN_BATCH, as ``ep.model_epilogue_shapes`` gives them: where the
    reference's autotune probes (and so reaches ``_sbr_add_kernel``)."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.ops import epilogue as ep
    return {f"{preset}_probe": ep.model_epilogue_shapes(
        load_config(preset), TRAIN_BATCH) for preset in ("cifar10",
                                                         "imagenet")}


def sbr_add_kernel_phase(ep):
    """``sbr_add`` against its plain version at every probe shape, bfloat16
    and float32: the forward bit for bit; through autograd, dx bit for bit,
    dr == g and ds/db within ``SBR_BWD_TOL`` of the plain backward. Times
    are the forward's (the kernel's) against the plain forward's."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for path, shapes in probe_shapes().items():
        for shape in shapes:
            c = shape[-1]
            for dtype in (torch.bfloat16, torch.float32):
                def randn():
                    return torch.randn(shape, generator=gen,
                                       device="cuda").to(dtype)
                x, r, g = randn(), randn(), randn()
                sc = torch.rand(c, generator=gen, device="cuda") + 0.5
                bi = torch.randn(c, generator=gen, device="cuda") * 0.5
                name = f"sbr_add {shape} {dtype}"
                got = ep.scale_bias_relu_add(x, sc, bi, r)
                want = ep.scale_bias_relu_add_reference(x, sc, bi, r)
                torch.cuda.synchronize()
                check(got.dtype == dtype and torch.equal(got, want),
                      f"{name}: forward differs from the plain version")
                err = float((got.float() - want.float()).abs().max())
                del got, want
                grads = []
                for fn in (ep.scale_bias_relu_add,
                           ep.scale_bias_relu_add_reference):
                    leaves = [t.clone().requires_grad_(True)
                              for t in (x, sc, bi, r)]
                    fn(*leaves).backward(g)
                    grads.append([t.grad for t in leaves])
                    del leaves
                (dx, ds, db, dr), (wdx, wds, wdb, wdr) = grads
                check(torch.equal(dx, wdx), f"{name}: dx differs")
                check(torch.equal(dr, g) and torch.equal(wdr, g),
                      f"{name}: dr is not g")
                gm = torch.where(x.float() * sc + bi > 0, g.float(), 0.0)
                rtol, atol = SBR_BWD_TOL
                excess = 0.0
                for got_s, ref, terms in ((ds, wds, gm * x.float()),
                                          (db, wdb, gm)):
                    limit = rtol * terms.abs().sum(dim=(0, 1, 2)) + atol
                    excess = max(excess, float(((got_s - ref).abs()
                                                / limit).max()))
                del grads, dx, wdx, dr, wdr, gm
                row = {"kernel": "sbr_add", "path": path,
                       "shape": list(shape),
                       "dtype": str(dtype).split(".")[1], "per_pass": 1,
                       "max_abs_err": err, "ds_db_err_over_limit": excess,
                       "tolerance": "forward, dx exact; dr == g; ds, db "
                                    "<= 1e-5*sum|terms| + 1e-6"}
                check(excess <= 1, f"{name}: ds/db beyond tolerance: {row}")
                with torch.no_grad():
                    rows.append(_timed(
                        row, lambda: ep.scale_bias_relu_add(x, sc, bi, r),
                        lambda: ep.scale_bias_relu_add_reference(
                            x, sc, bi, r), "sbr_add", shape, dtype))
                del x, r, g
    torch.cuda.empty_cache()
    return rows


class LogRecords(logging.Handler):
    """Keeps the messages logged through it."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())


def autotune_phase(counters, gpu: str) -> dict:
    """The autotune harness on the card: (a) ``probe_epilogue`` with the
    residual-add variant at every probe shape, its launches counted; (b)
    the slice's ``auto`` train path through ``train()`` and ``evaluate``,
    each launch count checked against the decisions it made."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.evaluation.evaluator import evaluate
    from tpu_resnet_torch.ops import autotune
    from tpu_resnet_torch.ops import epilogue as ep
    from tpu_resnet_torch.ops import softmax_xent as sx
    from tpu_resnet_torch.train.loop import train

    # (a) the probe: the only route to _sbr_add_kernel in the reference.
    autotune.reset()
    shapes = [s for ss in probe_shapes().values() for s in ss]
    zero_counts(counters)
    t0 = time.monotonic()
    decisions = []
    for shape in shapes:
        decisions += ep.probe_epilogue(shape, torch.bfloat16,
                                       iters=PROBE_ITERS, force=True,
                                       include_add=True, device="cuda")
    torch.cuda.synchronize()
    probe_seconds = time.monotonic() - t0
    probe_counts = read_counts(counters)
    calls = len(shapes) * (PROBE_ITERS + 1)
    want = {k: 0 for k in KERNELS}
    want.update(sbr=calls, sbr_add=calls, sbr_bwd=2 * calls)
    check(probe_counts == want, f"probe launch counts {probe_counts}, "
          f"expected {want}")
    for d in decisions:
        check(np.isfinite(d.pallas_us) and np.isfinite(d.xla_us)
              and d.pallas_us > 0 and d.xla_us > 0
              and d.use_pallas == (d.speedup >= 1.0) and d.error is None,
              f"inconsistent decision {d}")
    probed = [d.to_dict() for d in decisions]
    torch.cuda.empty_cache()

    # (b) the slice's train path on the preset's defaults.
    autotune.reset()
    train_dir = tempfile.mkdtemp(prefix="chip_smoke_auto_")
    records = LogRecords()
    logger = logging.getLogger("tpu_resnet_torch")
    logger.addHandler(records)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        cfg = load_config("cifar10", "", [
            *AUTO_OVERRIDES, f"train.train_dir={train_dir}",
            f"train.train_steps={AUTO_STEPS}", "train.log_every=1",
            f"train.checkpoint_every={AUTO_STEPS}"])
        check(cfg.optim.use_pallas_xent == "auto"
              and cfg.data.device_resident == "auto"
              and cfg.train.global_batch_size == TRAIN_BATCH,
              "the cifar10 preset's defaults are not auto, B=128")
        zero_counts(counters)
        t0 = time.monotonic()
        state = train(cfg, device="cuda")
        torch.cuda.synchronize()
        train_seconds = time.monotonic() - t0
        counts = read_counts(counters)
        check(state.step == AUTO_STEPS, f"train() stopped at {state.step}")
        check(any("input device-resident" in m for m in records.messages),
              "the train log does not name the device-resident input")
        with open(os.path.join(train_dir, autotune.AUTOTUNE_FILE)) as f:
            table = json.load(f)["decisions"]
        want_keys = {f"{ep.OP_SBR}|{ep.sbr_key(s)}"
                     for s, _ in TRAIN_SBR} | {f"{sx.OP_XENT}|{TRAIN_BATCH}x10"}
        check(set(table) == want_keys, f"autotune.json lists {sorted(table)}"
              f", expected {sorted(want_keys)}")
        kernel_sites = sum(n for s, n in TRAIN_SBR
                           if table[f"{ep.OP_SBR}|{ep.sbr_key(s)}"]
                           ["use_pallas"])
        xent = int(table[f"{sx.OP_XENT}|{TRAIN_BATCH}x10"]["use_pallas"])
        per_step = {k: 0 for k in KERNELS}
        per_step.update(sbr=kernel_sites, sbr_bwd=kernel_sites,
                        xent_fwd=xent, xent_bwd=xent)
        want = {k: n * AUTO_STEPS for k, n in per_step.items()}
        check(counts == want, f"auto train launch counts {counts}, "
              f"expected {want}")
        with open(os.path.join(train_dir, "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        check(len(losses) == AUTO_STEPS and all(np.isfinite(losses)),
              f"losses {losses}")
        first5, last5 = float(np.mean(losses[:5])), float(np.mean(
            losses[-5:]))
        check(last5 < first5, f"loss did not fall: first 5 mean {first5}, "
              f"last 5 {last5}")
        cfg.train.eval_once = True
        zero_counts(counters)
        precision = evaluate(cfg, device="cuda")
        eval_counts = read_counts(counters)
        with open(os.path.join(train_dir, "eval", "metrics.jsonl")) as f:
            eval_rec = json.loads(f.readlines()[-1])
        check(precision is not None and np.isfinite(eval_rec["eval_loss"])
              and eval_rec["step"] == AUTO_STEPS, f"eval {eval_rec}")
    finally:
        logger.removeHandler(records)
        logger.setLevel(level)
        shutil.rmtree(train_dir, ignore_errors=True)
        autotune.reset()
    result = {
        "path": "cifar10_auto_train",
        "model": "cifar10 ResNet-50 32x32 fused_epilogue=auto "
                 "use_pallas_xent=auto device_resident=auto bf16, B=128",
        "probe_shapes": [list(s) for s in shapes],
        "probe_iters": PROBE_ITERS, "probe_seconds": probe_seconds,
        "probe_launches": probe_counts, "probe_decisions": probed,
        "train_decisions": table, "steps": AUTO_STEPS,
        "train_seconds": train_seconds,
        "launches": {k: probe_counts[k] + counts[k] for k in KERNELS},
        "train_launches": counts, "launches_per_step": per_step,
        "loss_first5_mean": first5, "loss_last5_mean": last5,
        "eval_precision": precision, "eval_loss": eval_rec["eval_loss"],
        "eval_launches": eval_counts, "gpu": gpu}
    emit("autotune", **result)
    return result


def ab_phase(counters, gpu: str) -> list:
    """The twins of the reference's A/B tools on the card, through their
    per-shape functions, at the reference's shapes in bfloat16: per shape,
    one ``fwd_bwd`` call of ``AB_LENGTH`` chained blocks with the counters
    zeroed just before and read just after (``AB_LENGTH`` launches of the
    block's forward and gradient kernels and nothing else, every gradient
    finite), then the four arms' times (``run_shape``, ``AB_REPS`` timed
    calls per arm), listing under ``host_paced`` each arm whose device spin
    did not hold (its time took in the host's gaps). One result per
    tool."""
    from tpu_resnet_torch.tools import fused_block_ab, fused_bottleneck_ab

    cuda = torch.device("cuda")
    tools = (("cifar10_ab", fused_block_ab, fused_block_ab.SHAPES,
              ("block_fwd", "block_bwd")),
             ("imagenet_ab", fused_bottleneck_ab,
              [(b, h, h, 4 * f) for b, h, f in fused_bottleneck_ab.SHAPES],
              ("bottleneck_fwd", "bottleneck_bwd")))
    results = []
    for path, tool, shapes, kinds in tools:
        per_call = {k: AB_LENGTH if k in kinds else 0 for k in KERNELS}
        total = {k: 0 for k in KERNELS}
        by_shape, host_paced = {}, []
        t0 = time.monotonic()
        for shape in shapes:
            x0, arms = tool.make_arms(shape, AB_LENGTH, torch.bfloat16, cuda)
            zero_counts(counters)
            grads = arms["fwd_bwd"][0](x0)
            torch.cuda.synchronize()
            counts = read_counts(counters)
            check(counts == per_call, f"{path} {shape}: fwd_bwd launches "
                  f"{counts}, expected {per_call}")
            check(all(bool(torch.isfinite(g).all()) for g in grads),
                  f"{path} {shape}: a gradient is not finite")
            total = {k: total[k] + counts[k] for k in KERNELS}
            del x0, arms, grads
            key = tool.shape_key(shape)
            by_shape[key] = tool.run_shape(shape, AB_LENGTH, AB_REPS,
                                           torch.bfloat16, cuda)
            host_paced += [f"{key} {arm} {side}"
                           for arm, e in by_shape[key].items()
                           for side, flag in (("kernel", "pallas"),
                                              ("plain", "xla"))
                           if e[f"{flag}_host_paced"]]
            torch.cuda.empty_cache()
        result = {
            "path": path, "tool": tool.__name__, "length": AB_LENGTH,
            "reps": AB_REPS, "dtype": "bfloat16",
            "shapes": [list(s) for s in shapes], "seconds":
            time.monotonic() - t0, "launches": total,
            "eval_launches": {k: 0 for k in KERNELS},
            "launches_per_step": per_call, "by_shape": by_shape,
            "host_paced": host_paced, "gpu": gpu}
        emit("ab", **result)
        results.append(result)
    return results


def _spread_bn(model, gen) -> None:
    """BN parameters and running statistics off their init (scales and
    variances in [0.5, 1.5), biases and means of std 0.2), so that every
    fold is its own affine."""
    from tpu_resnet_torch.models.resnet import BatchNormRelu
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNormRelu):
                for t, kind in ((m.weight, 1), (m.running_var, 1),
                                (m.bias, 0), (m.running_mean, 0)):
                    t.copy_(torch.rand(t.shape, generator=gen) + 0.5 if kind
                            else torch.randn(t.shape, generator=gen) * 0.2)


def _grad_rel(got, want) -> list:
    """Each tensor's normwise distance ||got - want|| / ||want||."""
    return [float((g - w).norm() / w.norm().clamp_min(1e-30))
            for g, w in zip(got, want)]


def grad_phase(preset: str, counters, gpu: str) -> dict:
    """The gradient of an eval-mode fused model (``GRAD_OVERRIDES`` on
    ``preset``, seeded weights, BN off its init, float32, B=GRAD_BATCH) in
    the input images and every parameter, of Σ logits·cotangent: through
    the kernels with the counters zeroed just before the forward and read
    just after the backward (``GRAD_PER_BACKWARD``), through the plain
    versions, and through the control (the plain versions on PyTorch's own
    convolutions). Gated normwise per tensor, as the port's tests gate
    gradients: the worst ||got - plain|| / ||plain|| within ``GRAD_RTOL``'s
    floor or ``CONTROL_FACTOR`` times the control's worst (the fused blocks
    sum in another order, and a recomputed mask [a > 0] flips where a lies
    within rounding of 0), and never beyond its ceiling, so that a zeroed
    (1.0) or sign-flipped (2.0) tensor fails whatever the control reads."""
    from tpu_resnet_torch.config import load_config
    from tpu_resnet_torch.models import build_model, init_weights

    cfg = load_config(preset, "", GRAD_OVERRIDES)
    size, classes = cfg.data.resolved_image_size, cfg.data.num_classes
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(6))
    _spread_bn(model, torch.Generator().manual_seed(7))
    model = model.to("cuda").eval()
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(GRAD_BATCH, size, size, 3, generator=gen, device="cuda")
    cot = torch.randn(GRAD_BATCH, classes, generator=gen, device="cuda")
    names = ["input"] + [n for n, _ in model.named_parameters()]
    params = list(model.parameters())

    def grads():
        leaf = x.clone().requires_grad_()
        logits = model(leaf, train=False)
        return torch.autograd.grad((logits.float() * cot).sum(),
                                   [leaf, *params])

    zero_counts(counters)
    got = grads()
    torch.cuda.synchronize()
    counts = read_counts(counters)
    want = {k: GRAD_PER_BACKWARD[preset].get(k, 0) for k in KERNELS}
    check(counts == want, f"{preset} grad: launch counts {counts}, expected "
          f"{want}")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{preset} grad: a gradient is not finite")
    zero_counts(counters)
    with plain_versions():
        plain = grads()
    with plain_native_convs():
        control = grads()
    torch.cuda.synchronize()
    check(not any(read_counts(counters).values()),
          f"{preset} grad: the plain arms launched kernels")
    rel, control_rel = _grad_rel(got, plain), _grad_rel(control, plain)
    worst, control_worst = max(rel), max(control_rel)
    floor, ceiling = GRAD_RTOL
    limit = min(max(CONTROL_FACTOR * control_worst, floor), ceiling)
    result = {
        "path": f"{preset}_grad",
        "model": f"{preset} ResNet-50 {size}x{size} fused_blocks=on "
                 f"fused_epilogue=on float32 eval mode, B={GRAD_BATCH}",
        "tensors_compared": len(got), "launches": counts,
        "eval_launches": {k: 0 for k in KERNELS}, "launches_per_step": want,
        "worst_rel": worst, "control_worst_rel": control_worst,
        "limit": limit, "tensors_over_floor": sum(r > floor for r in rel),
        "worst_tensors": sorted(zip(rel, names), reverse=True)[:5],
        "control_worst_tensors":
            sorted(zip(control_rel, names), reverse=True)[:3],
        "control_factor": CONTROL_FACTOR, "grad_rtol": GRAD_RTOL,
        "gpu": gpu}
    check(worst <= limit, f"{preset} grad: a tensor beyond {limit} "
          f"normwise: {result}")
    emit("grad", **result)
    del model, got, plain, control
    torch.cuda.empty_cache()
    return result


# Each kernel: its source in the port and the TPU kernel body it replaces.
KERNEL_SOURCES = (
    ("sbr", "tpu_resnet_torch/csrc/epilogue.cu",
     "tpu_resnet/ops/epilogue.py:110"),
    ("block_fwd", "tpu_resnet_torch/csrc/fused_block.cu",
     "tpu_resnet/ops/fused_block.py:87"),
    ("bottleneck_fwd", "tpu_resnet_torch/csrc/fused_bottleneck.cu",
     "tpu_resnet/ops/fused_bottleneck.py:154"),
    ("sbr_bwd", "tpu_resnet_torch/csrc/epilogue.cu",
     "tpu_resnet/ops/epilogue.py:158"),
    ("xent_fwd", "tpu_resnet_torch/csrc/softmax_xent.cu",
     "tpu_resnet/ops/softmax_xent.py:74"),
    ("xent_bwd", "tpu_resnet_torch/csrc/softmax_xent.cu",
     "tpu_resnet/ops/softmax_xent.py:88"),
    ("block_stats", "tpu_resnet_torch/csrc/fused_block_train.cu",
     "tpu_resnet/ops/fused_block.py:509"),
    ("block_bwd1", "tpu_resnet_torch/csrc/fused_block_train.cu",
     "tpu_resnet/ops/fused_block.py:381"),
    ("block_bwd2", "tpu_resnet_torch/csrc/fused_block_train.cu",
     "tpu_resnet/ops/fused_block.py:409"),
    ("block_bwd3", "tpu_resnet_torch/csrc/fused_block_train.cu",
     "tpu_resnet/ops/fused_block.py:433"),
    ("bottleneck_stats_a", "tpu_resnet_torch/csrc/fused_bottleneck_train.cu",
     "tpu_resnet/ops/fused_bottleneck.py:445"),
    ("bottleneck_stats_b", "tpu_resnet_torch/csrc/fused_bottleneck_train.cu",
     "tpu_resnet/ops/fused_bottleneck.py:464"),
    ("bottleneck_bwd1", "tpu_resnet_torch/csrc/fused_bottleneck_train.cu",
     "tpu_resnet/ops/fused_bottleneck.py:644"),
    ("bottleneck_bwd2", "tpu_resnet_torch/csrc/fused_bottleneck_train.cu",
     "tpu_resnet/ops/fused_bottleneck.py:678"),
    ("bottleneck_bwd3", "tpu_resnet_torch/csrc/fused_bottleneck_train.cu",
     "tpu_resnet/ops/fused_bottleneck.py:729"),
    ("bottleneck_bwd4", "tpu_resnet_torch/csrc/fused_bottleneck_train.cu",
     "tpu_resnet/ops/fused_bottleneck.py:754"),
    ("sbr_add", "tpu_resnet_torch/csrc/epilogue.cu",
     "tpu_resnet/ops/epilogue.py:116"),
    ("block_bwd", "tpu_resnet_torch/csrc/fused_block_train.cu",
     "tpu_resnet/ops/fused_block.py:252"),
    ("bottleneck_bwd", "tpu_resnet_torch/csrc/fused_bottleneck_train.cu",
     "tpu_resnet/ops/fused_bottleneck.py:241"))


def path_times(rows) -> dict:
    """One kernel's times summed over one pass of each path it runs on (a
    B=16 forward of a serve path, a B=128 train step)."""
    by_path = {}
    for path in dict.fromkeys(r["path"] for r in rows):
        on_path = [r for r in rows if r["path"] == path]
        library = [r["library_ms"] * r["per_pass"] for r in on_path
                   if r.get("library_ms") is not None]
        by_path[path] = {
            **{key: sum(r[src] * r["per_pass"] for r in on_path)
               for key, src in (("ms", "ms"), ("plain_ms", "plain_ms"),
                                ("call_ms", "call_ms"),
                                ("plain_call_ms", "call_plain_ms"),
                                ("bound_ms", "bound_ms"))},
            "bound_by": on_path[0]["bound_by"],
            # One F.cross_entropy call computes xent_fwd. No single PyTorch
            # call computes the others: relu of an affine is two calls at
            # least, its backward (dx, ds, db) several, the cross-entropy
            # backward softmax and a one-hot subtraction, the basic block
            # five or more, the bottleneck seven; no call returns the fused
            # block's or the fused bottleneck's training sums and
            # weight-gradient products, or their folded gradients.
            "library_ms": sum(library) if library else None}
    return by_path


def kernel_entries(rows, served, trained) -> list:
    """The ``kernels`` line: each kernel's launches on the main paths (both
    serve phases, and the train and eval runs of both train phases), its
    worst error against the plain version, and its times per path; the
    entry's own times are a train step's where the kernel runs there (the
    fused one first), else its one serve path's."""
    kernels = []
    for kind, source, replaces in KERNEL_SOURCES:
        by_path = path_times([
            r for r in rows if r["kernel"] == kind
            and r["dtype"] == ("float32" if kind.startswith("xent")
                               else "bfloat16")])
        timed = next((p for p in ("imagenet_fused_train",
                                  "cifar10_fused_train", "cifar10_train")
                      if p in by_path), next(iter(by_path)))
        kernels.append({
            "name": kind, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (sum(s["launches"][kind] for s in served)
                         + sum(t["launches"][kind] + t["eval_launches"][kind]
                               for t in trained)),
            "launches_per_forward": {s["path"]: s["per_forward"][kind]
                                     for s in served},
            "launches_per_step": {t["path"]: t["launches_per_step"][kind]
                                  for t in trained},
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == kind),
            **by_path[timed], "timed_path": timed, "by_path": by_path})
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from tpu_resnet_torch.device import resolve_device
    from tpu_resnet_torch.ops import _build
    from tpu_resnet_torch.ops import epilogue as ep
    from tpu_resnet_torch.ops import fused_block as fb
    from tpu_resnet_torch.ops import fused_bottleneck as fbn
    from tpu_resnet_torch.ops import softmax_xent as sx

    resolve_device("cuda")  # TF32 off for the float32 oracle
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.monotonic()
    libs = _build.build_all()
    emit("device", gpu=gpu, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_seconds=time.monotonic() - t0,
         libraries=sorted(libs))

    rows = kernel_phase({
        "sbr": (ep.scale_bias_relu, ep.scale_bias_relu_reference),
        "block_fwd": (fb.block_fwd, fb.block_fwd_reference),
        "bottleneck_fwd": (fbn.bottleneck_fwd,
                           fbn.bottleneck_fwd_reference)})
    rows += train_kernel_phase(ep, sx)
    rows += block_train_kernel_phase(fb)
    rows += bottleneck_train_kernel_phase(fbn)
    rows += sbr_add_kernel_phase(ep)
    rows += fused_bwd_kernel_phase(fb, fbn)
    emit("kernels", gpu=gpu, rows=rows)
    counters = kernel_counters()
    served = [serve_phase(path, counters, gpu) for path in SERVE_PATHS]
    trained = [train_phase(path, counters, gpu) for path in TRAIN_PATHS]
    trained.append(imagenet_train_phase(counters, gpu))
    trained.append(autotune_phase(counters, gpu))
    trained += ab_phase(counters, gpu)
    trained += [grad_phase(preset, counters, gpu)
                for preset in ("cifar10", "imagenet")]

    kernels = kernel_entries(rows, served, trained)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
