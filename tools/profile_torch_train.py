#!/usr/bin/env python3
"""Device-time breakdown of the port's CIFAR train step on a CUDA card.

    python3 tools/profile_torch_train.py [--batch 128] [--iters 20]
        [--preset cifar10] [section.field=value ...]
    python3 tools/profile_torch_train.py model.fused_blocks=true

Builds the train state as ``python -m tpu_resnet_torch train`` does
(``--preset``, default ``cifar10``, with ``model.fused_epilogue=on
optim.use_pallas_xent=on data.dataset=synthetic`` and then the given
overrides; bfloat16, seeded weights) and runs the loop's step on one seeded
uint8 batch: the host-to-device copy, augmentation on the card, forward,
backward and the SGD update. After 5 warm-up steps it times ``--iters``
steps with the host clock (ending in a synchronize), then runs ``--iters``
more under ``torch.profiler``. Prints one JSON line: wall ms per step,
device-busy ms per step (the kernels' device times summed; one stream, so
they do not overlap), the device's idle share, images/s, the port's
kernels' device ms and launches per step, and the kernels by device time.
Then the card's name and power limit. Needs CUDA; raises without it.
``model.fused_blocks=true`` profiles the fused-block train step (the live-BN
fused block kernels in place of 21 basic blocks).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpu_resnet_torch.config import load_config  # noqa: E402
from tpu_resnet_torch.data.cifar import synthetic_data  # noqa: E402
from tpu_resnet_torch.device import resolve_device  # noqa: E402
from tpu_resnet_torch.tools.profiling import profile_train_step  # noqa: E402
from tpu_resnet_torch.train.loop import (build_state,  # noqa: E402
                                         make_loop_step)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--preset", default="cifar10")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    cfg = load_config(args.preset, "", [
        "model.fused_epilogue=on", "optim.use_pallas_xent=on",
        "data.dataset=synthetic", f"train.global_batch_size={args.batch}",
        *args.overrides])
    images, labels = synthetic_data(args.batch, cfg.data.resolved_image_size,
                                    cfg.data.num_classes, learnable=True)
    out = profile_train_step(build_state(cfg, device),
                             make_loop_step(cfg, device), images, labels,
                             args.iters)
    out["model"] = (f"{cfg.data.dataset} resnet-{cfg.model.resnet_size} "
                    f"{cfg.model.compute_dtype} fused_epilogue="
                    f"{cfg.model.fused_epilogue} fused_blocks="
                    f"{cfg.model.fused_blocks}")
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
