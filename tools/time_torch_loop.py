#!/usr/bin/env python3
"""Loop ms a step of the port's ``train()`` on the card, for comparing two
checkouts on one machine.

    python3 tools/time_torch_loop.py [--root DIR] [--tag NAME]
        [--steps-per-call 10] [--steps 300] [section.field=value ...]

Runs ``python -m tpu_resnet_torch train`` from the checkout at ``--root``
(default: the one beside this script) in a subprocess: the fused CIFAR-10
ResNet-50 path (``--preset cifar10 model.fused_blocks=true
model.fused_epilogue=on optim.use_pallas_xent=on``, synthetic data,
B=128, bf16) for ``--steps`` steps at ``train.steps_per_call`` (1: eager;
above 1: chunks of CUDA graph replays), logging every ``--steps // 3``.
Prints one JSON line: the loop's ms a step between the first and the last
logged step (``metrics.jsonl`` wall stamps), the last loss, then the
card's name and power limit. Compare two checkouts in one call, in the
order parent, change, change, parent (a parent unpacked under
``build/tpu_resnet_torch/``, which ``.gitignore`` lists); each checkout
builds its kernels once.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = ["--preset", "cifar10", "model.fused_blocks=true",
        "model.fused_epilogue=on", "optim.use_pallas_xent=on",
        "data.dataset=synthetic", "data.synthetic_learnable=true"]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=HERE)
    p.add_argument("--tag", default="")
    p.add_argument("--steps-per-call", type=int, default=10)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("overrides", nargs="*")
    args = p.parse_args()
    train_dir = tempfile.mkdtemp(prefix="time_torch_loop_")
    try:
        subprocess.run(
            [sys.executable, "-m", "tpu_resnet_torch", "train", *PATH,
             f"train.steps_per_call={args.steps_per_call}",
             f"train.train_steps={args.steps}",
             f"train.log_every={max(1, args.steps // 3)}",
             "train.checkpoint_every=100000",
             f"train.train_dir={train_dir}", *args.overrides],
            cwd=args.root, check=True, stdout=subprocess.DEVNULL)
        with open(os.path.join(train_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    first, last = recs[0], recs[-1]
    print(json.dumps({
        "tag": args.tag, "root": args.root,
        "steps_per_call": args.steps_per_call,
        "window_steps": last["step"] - first["step"],
        "loop_ms_per_step": 1e3 * (last["wall"] - first["wall"])
        / (last["step"] - first["step"]),
        "last_loss": last["loss"]}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
