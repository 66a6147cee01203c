"""A/B the fused basic-block kernels against the plain PyTorch version of
the identical math (cuDNN convolutions, autograd for the gradients), at the
CIFAR ResNet's three stage shapes, or ImageNet ResNet-18/34's three fused
stage shapes (``--preset imagenet``: 56²×64, 28²×128, 14²×256): the port
of the reference's ``tools/fused_block_ab.py``.

    python -m tpu_resnet_torch.tools.fused_block_ab [--out JSON]
        [--length 32] [--reps 5] [--dtype bfloat16|float32] [--device cpu]
        [--preset cifar10|imagenet]

Four arms per shape, as the reference's: ``fwd`` (``block_fwd``),
``fwd_bwd`` (``block_apply`` differentiated in x and all six parameters:
``block_fwd`` and ``block_bwd``), ``train_fwd_live_bn``
(``block_train_fwd``) and ``train_fwd_bwd_live_bn`` (``block_train_apply``
differentiated). Each arm chains ``--length`` block applications, each on
the previous one's output. ``pallas_us_per_block`` is the kernel arm and
``xla_us_per_block`` the plain arm, under the reference's field names.

Timing: on the card, the calls of an arm queue behind a device spin
(``ops.autotune.timed_us``), so the times are the device's; where the spin
cannot hold (the host still enqueueing when it ends),
``pallas_host_paced``/``xla_host_paced`` mark the time as the host's. The
wall time (best of ``--reps`` synchronised calls) is printed
beside them (``*_wall_us_per_block``). x is in ``--dtype``; the parameters
are float32, as the kernels take them. The JSON is rewritten after every
shape. A shape that fails is recorded with its error and the others still
run; the tool then exits 1.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_resnet_torch.device import resolve_device
from tpu_resnet_torch.ops import autotune
from tpu_resnet_torch.ops import fused_block as fb

# (batch, H, W, C): the CIFAR ResNet's three stage shapes (16@32x32,
# 32@16x16, 64@8x8), as the reference's SHAPES without its tile columns:
# the port's kernels have no batch tile.
SHAPES = [(128, 32, 32, 16), (128, 16, 16, 32), (128, 8, 8, 64)]
# ImageNet ResNet-18/34 at 224²: the stages the reference fuses (its
# auto_batch_tile finds a plan; 7²×512 has none).
IMAGENET_SHAPES = [(128, 56, 56, 64), (128, 28, 28, 128), (128, 14, 14, 256)]

Arm = Callable[[torch.Tensor], object]


def chained(block, params, length: int, tuple_out: bool = False) -> Arm:
    """``length`` applications of ``block``, each on the previous one's
    output, without gradients."""
    def run(x):
        with torch.no_grad():
            for _ in range(length):
                x = block(x, *params)
                x = x[0] if tuple_out else x
        return x
    return run


def chained_grad(block, params, length: int, tuple_out: bool = False) -> Arm:
    """The gradient of Σ (float32) of ``length`` chained applications in the
    input and every parameter, so both arms compute the full gradient
    set."""
    def run(x):
        leaves = [t.detach().requires_grad_() for t in (x, *params)]
        y = leaves[0]
        for _ in range(length):
            y = block(y, *leaves[1:])
            y = y[0] if tuple_out else y
        return torch.autograd.grad(y.float().sum(), leaves)
    return run


def shape_key(shape) -> str:
    b, h, w, c = shape
    return f"b{b}_{h}x{w}x{c}"


def make_arms(shape, length: int, dtype: torch.dtype, device: torch.device
              ) -> Tuple[torch.Tensor, Dict[str, Tuple[Arm, Arm]]]:
    """The input x0 and each arm's (kernel run, plain run) at ``shape``:
    seeded as the reference's tool seeds them (tiny weights, so that the
    chained residual blocks stay finite; identity BN)."""
    b, h, w, c = shape
    rng = np.random.default_rng(c)
    x0 = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(
        np.float32)).to(device=device, dtype=dtype)

    def weight():
        return torch.from_numpy((rng.normal(size=(3, 3, c, c)) * 0.01)
                                .astype(np.float32)).to(device)

    ones = torch.ones(c, device=device)
    zeros = torch.zeros(c, device=device)
    params = (weight(), weight(), ones, zeros, ones, zeros)
    return x0, {
        "fwd": (chained(fb.block_fwd, params, length),
                chained(fb.block_fwd_reference, params, length)),
        "fwd_bwd": (chained_grad(fb.block_apply, params, length),
                    chained_grad(fb.block_fwd_reference, params, length)),
        "train_fwd_live_bn": (
            chained(fb.block_train_fwd, params, length, True),
            chained(fb.block_train_fwd_reference, params, length, True)),
        "train_fwd_bwd_live_bn": (
            chained_grad(fb.block_train_apply, params, length, True),
            chained_grad(fb.block_train_fwd_reference, params, length,
                         True))}


def wall_us(run: Arm, x0: torch.Tensor, reps: int) -> float:
    """Best of ``reps`` host-clock times of one call, synchronised."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run(x0)
        if x0.is_cuda:
            torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def time_arms(x0: torch.Tensor, arms: Dict[str, Tuple[Arm, Arm]],
              length: int, reps: int) -> Dict[str, dict]:
    """Each arm's µs per block: the device's (``timed_us`` over ``reps``
    calls after a warm-up; ``*_host_paced`` is true where its spin did not
    hold, so that the time took in the host's gaps) and the wall time of
    one synchronised call."""
    entry = {}
    for arm, (kernel, plain) in arms.items():
        k_us, k_paced = autotune.timed_us(kernel, (x0,), reps)
        p_us, p_paced = autotune.timed_us(plain, (x0,), reps)
        k_us, p_us = k_us / length, p_us / length
        entry[arm] = {
            "pallas_us_per_block": round(k_us, 2),
            "xla_us_per_block": round(p_us, 2),
            "speedup": round(p_us / k_us, 3),
            "pallas_host_paced": k_paced, "xla_host_paced": p_paced,
            "pallas_wall_us_per_block": round(
                wall_us(kernel, x0, reps) / length, 2),
            "xla_wall_us_per_block": round(
                wall_us(plain, x0, reps) / length, 2)}
    return entry


def run_shape(shape, length: int, reps: int, dtype: torch.dtype,
              device: torch.device) -> Dict[str, dict]:
    """The four arms' times at one shape; raises on any failure."""
    x0, arms = make_arms(shape, length, dtype, device)
    return time_arms(x0, arms, length, reps)


def run_shapes(shapes: List, key: Callable, run: Callable, args,
               device: torch.device) -> int:
    """Every shape through ``run`` (a tool's ``run_shape``), recorded as the
    reference records them: the JSON rewritten after each shape, a failure
    kept under the shape's key with its error. Returns the exit code: 1 if
    any shape failed."""
    dtype = getattr(torch, args.dtype)
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "length": args.length, "dtype": args.dtype, "by_shape": {}}

    def flush():
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=2)

    for shape in shapes:
        name = key(shape)
        try:
            out["by_shape"][name] = run(shape, args.length, args.reps, dtype,
                                        device)
        except Exception as e:  # record and keep measuring other shapes
            out["by_shape"][name] = {
                "error": f"{type(e).__name__}: {e}"[:500]}
            traceback.print_exc()
        print(name, out["by_shape"][name], flush=True)
        flush()
    print(json.dumps(out), flush=True)
    return int(any("error" in e for e in out["by_shape"].values()))


def parser(length: int, doc: str) -> argparse.ArgumentParser:
    """The options both tools take; ``length`` is --length's default."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--length", type=int, default=length,
                    help="blocks chained per call")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    ap = parser(32, __doc__)
    ap.add_argument("--preset", default="cifar10",
                    choices=["cifar10", "imagenet"],
                    help="the model whose fused stage shapes to run")
    args = ap.parse_args(argv)
    if args.length < 1 or args.reps < 1:
        raise SystemExit("--length and --reps must be >= 1")
    shapes = SHAPES if args.preset == "cifar10" else IMAGENET_SHAPES
    device = resolve_device(args.device)
    return run_shapes(shapes, shape_key, run_shape, args, device)


if __name__ == "__main__":
    raise SystemExit(main())
