"""The training loop (port of the core of ``tpu_resnet/train/loop.py``
``train()``), on one device, one step per dispatch:

- build the model (seeded from ``train.seed``), schedule and train state,
  and resume from the newest checkpoint in ``train.train_dir``;
- stream batches in the reference's order through a background thread,
  copy each to the device and augment it there;
- log every ``train.log_every`` steps (loss, precision, lr, grad_norm,
  steps/s, images/s) to the logger and ``metrics.jsonl``;
- checkpoint every ``train.checkpoint_every`` steps and at the end;
- on SIGTERM/SIGINT, stop before the next step, save a final checkpoint
  and raise ``Preempted`` (the CLI exits 42).

The reference loop's other features are not in this slice (ROADMAP lists
them): multi-step dispatch, device-resident data, staged and
double-buffered transfer, spans, telemetry, MFU and memory ledgers, the NaN
sentinel, the watchdog, fault injection and elastic resume. Their knobs are
accepted and logged as ignored; ``data.device_resident=on`` raises.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from tpu_resnet_torch import data as data_lib
from tpu_resnet_torch.data import augment as aug_lib
from tpu_resnet_torch.data.pipeline import BackgroundIterator
from tpu_resnet_torch.device import resolve_device
from tpu_resnet_torch.models import build_model, init_weights
from tpu_resnet_torch.resilience.shutdown import (Preempted,
                                                  ShutdownCoordinator)
from tpu_resnet_torch.train import schedule as sched_lib
from tpu_resnet_torch.train.checkpoint import CheckpointManager
from tpu_resnet_torch.train.metrics_io import MetricsWriter, ThroughputMeter
from tpu_resnet_torch.train.state import TrainState, create_state, param_count
from tpu_resnet_torch.train.step import check_step_config, make_train_step

log = logging.getLogger("tpu_resnet_torch")

# Knobs of the reference loop that this slice accepts and does not act on.
IGNORED_KNOBS = (
    "train.steps_per_call", "train.summary_every", "train.image_summary_every",
    "train.profiler_port", "train.profile_steps", "train.telemetry_port",
    "train.mfu_accounting", "train.memory_ledger", "train.comms_ledger",
    "data.transfer_stage", "data.h2d_double_buffer", "mesh.partition",
    "resilience.nan_guard", "resilience.watchdog_stall_sec",
    "resilience.emergency_save", "programs.cache")


def _knob(cfg, path: str):
    section, field = path.split(".")
    return getattr(getattr(cfg, section), field)


def build_state(cfg, device: torch.device) -> TrainState:
    """Fresh train state: the configured model with seeded weights on
    ``device``, and its optimizer."""
    model = init_weights(build_model(cfg),
                         torch.Generator().manual_seed(cfg.train.seed))
    return create_state(model.to(device), cfg.optim)


def make_loop_step(cfg, device: torch.device):
    """The loop's ``train_step(state, uint8 images, labels)``: the dataset's
    augmentation on ``device``, drawn from a generator seeded from
    ``(train.seed, step)``, then the train step."""
    augment = aug_lib.get_train_augment(cfg.data.dataset)
    seed = cfg.train.seed

    def augment_fn(images, step):
        return augment(images, aug_lib.step_generator(seed, step, device))

    return make_train_step(cfg.optim,
                           sched_lib.build_schedule(cfg.optim, cfg.train),
                           cfg.data.num_classes, augment_fn)


def train(cfg, device: Optional[str] = None) -> TrainState:
    """Run training to ``cfg.train.train_steps``; returns the final state."""
    device = resolve_device(device)
    check_step_config(cfg)
    if cfg.data.device_resident == "on":
        raise NotImplementedError(
            "data.device_resident=on: the device-resident input path is a "
            "later slice of the port (its order comes from jax.random, which "
            "torch cannot reproduce); use off or auto, which stream")
    state = build_state(cfg, device)
    ckpt = CheckpointManager(cfg.train.train_dir,
                             keep=cfg.train.keep_checkpoints)
    if ckpt.latest_step() is not None:
        ckpt.restore(state)
        log.info("resumed from step %d in %s", state.step,
                 cfg.train.train_dir)
    train_step = make_loop_step(cfg, device)
    total = cfg.train.train_steps
    batch = cfg.train.global_batch_size
    log.info("training %s-%d/%s to step %d on %s | params %.2fM | batch %d "
             "| input streaming (data.device_resident=%s)",
             cfg.model.name, cfg.model.resnet_size, cfg.data.dataset, total,
             device, param_count(state.model) / 1e6, batch,
             cfg.data.device_resident)
    log.info("this slice ignores: %s", ", ".join(
        f"{k}={_knob(cfg, k)}" for k in IGNORED_KNOBS))

    metrics = MetricsWriter(cfg.train.train_dir)
    meter = ThroughputMeter(batch)
    shutdown = ShutdownCoordinator(
        enabled=cfg.resilience.graceful_shutdown).install()
    host_iter = None
    step = state.step
    try:
        host_iter = BackgroundIterator(
            data_lib.train_batches(cfg.data, batch, seed=cfg.train.seed,
                                   start_step=step),
            capacity=cfg.data.prefetch + 2, external_stop=shutdown.event)
        meter.rate(step)
        first = True
        while step < total and not shutdown.requested:
            try:
                images, labels = next(host_iter)
            except StopIteration:
                if shutdown.requested:
                    break
                raise
            m = train_step(state, torch.from_numpy(images).to(device),
                           torch.from_numpy(labels).to(device))
            step = state.step
            if first:
                # The first step pays the kernel builds and cuDNN's plan
                # search: keep it out of the first logged rate.
                first = False
                float(m["loss"])
                meter.rate(step)
            if step % cfg.train.log_every == 0 or step == total:
                vals = {k: float(v) for k, v in m.items()}
                rate = meter.rate(step)
                if rate:
                    vals.update(rate)
                log.info("step %d | loss %.4f | precision %.4f | lr %.4g | "
                         "grad_norm %.4g%s", step, vals["loss"],
                         vals["precision"], vals["learning_rate"],
                         vals["grad_norm"],
                         f" | {rate['steps_per_sec']:.2f} st/s "
                         f"({rate['images_per_sec']:.0f} img/s)"
                         if rate else "")
                metrics.write(step, vals)
            if step % cfg.train.checkpoint_every == 0 or step == total:
                ckpt.save(state)
        if shutdown.requested and step < total:
            log.warning("stop requested at step %d: saving a final "
                        "checkpoint before exit", step)
            if ckpt.latest_step() != step:
                ckpt.save(state)
    finally:
        if host_iter is not None:
            host_iter.close()
        metrics.close()
        shutdown.uninstall()
    if shutdown.requested and step < total:
        raise Preempted(step, state=state, signum=shutdown.signum)
    return state
