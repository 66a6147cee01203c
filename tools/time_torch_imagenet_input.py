#!/usr/bin/env python3
"""Decode rate of the port's ImageNet input engine on one CUDA card, by
worker count, with the card idle and with the ImageNet train step running.

    python3 tools/time_torch_imagenet_input.py [--workers 1,2,4,8]
        [--batches 8]

Shards are made as ``chip_smoke.py``'s ``imagenet_input`` phase makes them
(the fixture JPEGs of ``tests/fixtures/imagenet`` cycled into 8 shards of
160 records). First it prints the decode stage on the first B=128 order
against its plain versions, as ``chip_smoke.py`` measures it before
applying its limits (``decode_stage_measure``: nvJPEG against the plain
decoder per sampling, max and mean |d|; the stage's; the parts' times and
the JPEGs' mean bytes). Then, for each worker count: a fresh engine at B=128, 224x224
(``data.train_batches`` on ``--preset imagenet``), two batches to warm up,
then ``--batches`` batches (at least two rings' worth; the ring is
workers + 1 batches) taken back to back (``idle``: nothing else on the
card) and as many more each followed by one ImageNet ResNet-50 train step
through the fused bottlenecks (``train``: the loop's step, bf16), each run
ending in a synchronize. ``--loads`` adds runs whose consumer does, after
each batch, only the step's kind of work: ``device``, bf16 matrix products
queued on the card for about a step's device time (the host free);
``host``, about a step's wall of pure-Python work (the card free, the
interpreter lock held but for its switch interval). Prints one JSON line
per worker count (images/s taken and decoded, ms per batch or step), then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (its shards and overrides)
from tpu_resnet_torch import data as data_lib  # noqa: E402
from tpu_resnet_torch.config import load_config  # noqa: E402
from tpu_resnet_torch.device import resolve_device  # noqa: E402
from tpu_resnet_torch.ops import _build  # noqa: E402
from tpu_resnet_torch.train.loop import build_state, make_loop_step  # noqa


def rate(engine, batches: int, step=None) -> tuple:
    """(images/s taken, images/s the workers decoded) over ``batches``
    batches, each followed by ``step``."""
    torch.cuda.synchronize()
    engine.stats()
    t0 = time.perf_counter()
    for _ in range(batches):
        images, labels = next(engine)
        if step is not None:
            step(images, labels)
    torch.cuda.synchronize()
    taken = batches * images.shape[0] / (time.perf_counter() - t0)
    return taken, engine.stats()["data_decode_images_per_sec"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workers", default="1,2,4,8")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--loads", default="",
                    help="comma-separated extra runs: device, host")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_imagenet_input: CUDA is not available",
              file=sys.stderr)
        return 2
    cuda = resolve_device("cuda")
    _build.build_all(("jpeg_decode", "epilogue", "softmax_xent",
                      "fused_bottleneck_tc", "bottleneck_wgrad"))
    root = tempfile.mkdtemp(prefix="time_input_")
    try:
        chip_smoke.make_input_shards(root)
        cfg = load_config("imagenet", "", [
            *chip_smoke.INPUT_OVERRIDES, f"data.data_dir={root}"])
        print(json.dumps({"decode_stage": chip_smoke.decode_stage_measure(
            root, cfg)}), flush=True)
        state = build_state(cfg, cuda)
        step_fn = make_loop_step(cfg, cuda)

        def step(images, labels):
            step_fn(state, images, labels)

        a = torch.randn(8192, 8192, device=cuda, dtype=torch.bfloat16)

        def device_load(images, labels):  # ~130 ms of products, queued
            for _ in range(100):
                torch.mm(a, a, out=b_out)

        b_out = torch.empty_like(a)

        def host_load(images, labels):  # ~150 ms of interpreter work
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.15:
                sum(range(1000))

        loads = {"device": device_load, "host": host_load}

        for workers in (int(w) for w in args.workers.split(",")):
            # A shallow ring, so that the timed batches are decoded in the
            # window and not taken from the prefetch.
            cfg.data.num_workers, cfg.data.ring_slots = workers, workers + 1
            n = max(args.batches, 2 * (workers + 1))
            engine = data_lib.train_batches(
                cfg.data, cfg.train.global_batch_size, seed=cfg.train.seed,
                device=cuda)
            try:
                rate(engine, 2, step)  # warm-up: the step's first builds
                runs = {"idle": rate(engine, n),
                        "train": rate(engine, n, step)}
                for name in filter(None, args.loads.split(",")):
                    runs[name] = rate(engine, n, loads[name])
            finally:
                engine.close()
            b = cfg.train.global_batch_size
            line = {"workers": workers, "batch": b, "batches": n}
            for name, (taken, decoded) in runs.items():
                line.update({f"{name}_images_per_s": taken,
                             f"{name}_decoded_images_per_s": decoded,
                             f"{name}_ms_per_batch": 1e3 * b / taken})
            print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
