#!/usr/bin/env python3
"""Device-time breakdown of the port's train step on a CUDA card.

    python3 tools/profile_torch_train.py [--batch 128] [--iters 20]
        [--preset cifar10] [--steps-per-call 10] [section.field=value ...]
    python3 tools/profile_torch_train.py model.fused_blocks=true
    python3 tools/profile_torch_train.py --preset imagenet \
        model.fused_blocks=true

Builds the train state as ``python -m tpu_resnet_torch train`` does
(``--preset``, default ``cifar10``, with ``model.fused_epilogue=on
optim.use_pallas_xent=on`` and then the given overrides; bfloat16, seeded
weights) and runs the loop's step on one seeded uint8 batch on the card,
as the device-resident split feeds it: augmentation on the card, forward,
backward and the SGD update. The CIFAR presets train on
``data.dataset=synthetic``; the ``imagenet`` preset keeps its dataset
(ImageNet ResNet, 1000 classes) and is fed seeded uint8 224x224 images with
labels in 0..999, what the input pipeline hands the device. Two dispatches,
each on its own train state: the eager step (``train.steps_per_call=1``;
after 5 warm-up steps, ``--iters`` steps timed with the host clock, ending
in a synchronize, then ``--iters`` more under ``torch.profiler``) and the
loop's chunked dispatch (``--steps-per-call``, default the config's: chunks
of that many CUDA graph replays, ``data/device_data.py`` ``ChunkRunner``;
two warm-up chunks, which capture the step, then ``--iters`` steps' worth
of chunks timed and as many profiled; skipped at 1). Prints the model
line, then one JSON line per dispatch (``dispatch``: ``eager`` or
``graphed``): wall ms per step, device-busy ms per step, the device's idle
share, images/s, the port's kernels' device ms and launches per step, and
the kernels by device time (graphed: the capture's seconds). Then the
card's name and power limit. Needs CUDA; raises without it.
``model.fused_blocks=true`` profiles the fused train step (the live-BN
fused blocks, or with ``--preset imagenet`` the fused bottlenecks).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpu_resnet_torch.config import load_config  # noqa: E402
from tpu_resnet_torch.data.cifar import synthetic_data  # noqa: E402
from tpu_resnet_torch.data.device_data import ChunkRunner  # noqa: E402
from tpu_resnet_torch.device import resolve_device  # noqa: E402
from tpu_resnet_torch.tools.profiling import (  # noqa: E402
    device_batches, profile_train_chunks, profile_train_step)
from tpu_resnet_torch.train.loop import (build_state,  # noqa: E402
                                         make_loop_step)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--preset", default="cifar10")
    p.add_argument("--steps-per-call", type=int, default=None)
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    data = [] if args.preset == "imagenet" else ["data.dataset=synthetic"]
    cfg = load_config(args.preset, "", [
        "model.fused_epilogue=on", "optim.use_pallas_xent=on", *data,
        f"train.global_batch_size={args.batch}", *args.overrides])
    size, classes = cfg.data.resolved_image_size, cfg.data.num_classes
    if cfg.data.dataset == "imagenet":
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (args.batch, size, size, 3),
                              dtype=np.uint8)
        labels = rng.integers(0, classes, args.batch).astype(np.int32)
    else:
        images, labels = synthetic_data(args.batch, size, classes,
                                        learnable=True)
    per_call = args.steps_per_call or cfg.train.steps_per_call
    state = build_state(cfg, device)
    model = (f"{cfg.data.dataset} ResNet-{cfg.model.resnet_size} "
             f"({state.model.stem} stem) {size}x{size} {classes} "
             f"classes {cfg.model.compute_dtype} fused_epilogue="
             f"{cfg.model.fused_epilogue} fused_blocks="
             f"{cfg.model.fused_blocks}, B={args.batch}")
    print(f"model: {model}", flush=True)
    step = make_loop_step(cfg, device)
    out = profile_train_step(state, step,
                             device_batches(images, labels, device),
                             args.iters)
    print(json.dumps({"dispatch": "eager", **out, "model": model}),
          flush=True)
    if per_call > 1:
        del state
        state = build_state(cfg, device)
        runner = ChunkRunner(step, device, per_call)
        out = profile_train_chunks(
            state, runner, device_batches(images, labels, device), per_call,
            chunks=max(1, args.iters // per_call))
        out["capture_seconds"] = runner.capture_seconds
        runner.close()
        print(json.dumps({"dispatch": "graphed", **out, "model": model}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
