"""The training loop (port of the core of ``tpu_resnet/train/loop.py``
``train()``), on one device, one step per dispatch:

- build the model (seeded from ``train.seed``), schedule and train state,
  and resume from the newest restorable checkpoint in ``train.train_dir``;
- under ``model.fused_epilogue=auto`` / ``optim.use_pallas_xent=auto`` on
  CUDA, run the timed A/B probes (``ops/autotune.py``) before the first
  step, keep their launches out of the kernels' counters, and write the
  decisions to ``<train_dir>/autotune.json``;
- feed batches in the reference's order: from the device-resident split
  where ``data/device_data.should_use`` says so (the default for
  CIFAR/synthetic), ImageNet's from the decode engine (records read on the
  host, decoded and cropped on the device: ``data/engine.py``), else
  streamed through a background thread and copied to the device; augment
  them there with the reference's draws;
- log every ``train.log_every`` steps (loss, precision, lr, grad_norm,
  steps/s, images/s) to the logger and ``metrics.jsonl``;
- checkpoint every ``train.checkpoint_every`` steps and at the end, but
  never a state whose loss is not finite;
- on a non-finite loss at a log boundary (``resilience.nan_guard``), roll
  back to the newest checkpoint and go on past the bad data window: the
  stream restarts at the bad step, the device-resident split replays
  ``batch_at(step)``; after ``resilience.nan_max_retries`` rollbacks, or
  with no checkpoint, raise ``DivergenceError``;
- on SIGTERM/SIGINT, stop before the next step, save a final checkpoint
  and raise ``Preempted`` (the CLI exits 42);
- on any other exception in flight (``resilience.emergency_save``), save
  the unsaved progress once, then let the exception go on.

The reference loop's other features are not in this slice (ROADMAP lists
them): multi-step dispatch, staged and double-buffered transfer, spans,
telemetry, MFU and memory ledgers, the watchdog, fault injection and
elastic resume. Their knobs are accepted and logged as ignored.
"""

from __future__ import annotations

import contextlib
import logging
import math
from typing import Optional

import torch

from tpu_resnet_torch import data as data_lib
from tpu_resnet_torch.data import augment as aug_lib
from tpu_resnet_torch.data import device_data
from tpu_resnet_torch.data.cifar import load_split
from tpu_resnet_torch.data.pipeline import BackgroundIterator
from tpu_resnet_torch.device import resolve_device
from tpu_resnet_torch.models import build_model, init_weights
from tpu_resnet_torch.ops import autotune
from tpu_resnet_torch.ops import epilogue as ep
from tpu_resnet_torch.ops import softmax_xent as sx
from tpu_resnet_torch.resilience.sentinel import DivergenceError, NaNSentinel
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
    "resilience.watchdog_stall_sec", "programs.cache",
    "data.use_native_loader")


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
    augmentation on ``device`` with the reference's draws for
    ``(train.seed, step)`` (``aug_lib.step_key``), then the train step
    (whose ``use_pallas_xent=auto`` probe runs here)."""
    augment = aug_lib.get_train_augment(cfg.data.dataset)
    seed = cfg.train.seed

    def augment_fn(images, step):
        return augment(images, aug_lib.step_key(seed, step))

    return make_train_step(cfg.optim,
                           sched_lib.build_schedule(cfg.optim, cfg.train),
                           cfg.data.num_classes, augment_fn, device=device,
                           xent_probe_batch=cfg.train.global_batch_size)


# The launch counters that the autotune probes move.
PROBED_COUNTERS = ((ep, "launches"), (ep, "add_launches"),
                   (ep, "bwd_launches"), (sx, "fwd_launches"),
                   (sx, "bwd_launches"))


@contextlib.contextmanager
def probe_launches_uncounted():
    """Give the probed kernels' launch counters back their values on exit,
    so that they count the steps only."""
    saved = [getattr(mod, attr) for mod, attr in PROBED_COUNTERS]
    try:
        yield
    finally:
        for (mod, attr), n in zip(PROBED_COUNTERS, saved):
            setattr(mod, attr, n)


def build_step(cfg, device: torch.device):
    """The loop's step, after the ``auto`` probes: under
    ``model.fused_epilogue=auto`` on CUDA every BN+ReLU shape of the model
    is probed, and the cross-entropy probe runs as the step is built. The
    decisions are written to the train dir when there are any."""
    with probe_launches_uncounted():
        if cfg.model.fused_epilogue == "auto" and device.type == "cuda":
            ep.probe_model_epilogues(cfg, cfg.train.global_batch_size,
                                     device=device)
        train_step = make_loop_step(cfg, device)
    if autotune.decisions():
        log.info("autotune decisions in %s",
                 autotune.dump(cfg.train.train_dir))
    return train_step


def train(cfg, device: Optional[str] = None) -> TrainState:
    """Run training to ``cfg.train.train_steps``; returns the final state."""
    device = resolve_device(device)
    check_step_config(cfg)
    resident = device_data.should_use(cfg.data)
    state = build_state(cfg, device)
    ckpt = CheckpointManager(cfg.train.train_dir,
                             keep=cfg.train.keep_checkpoints)
    if ckpt.latest_step() is not None:
        ckpt.restore(state, discard_failed=True)
        log.info("resumed from step %d in %s", state.step,
                 cfg.train.train_dir)
    train_step = build_step(cfg, device)
    total = cfg.train.train_steps
    batch = cfg.train.global_batch_size
    log.info("training %s-%d/%s to step %d on %s | params %.2fM | batch %d "
             "| input %s (data.device_resident=%s)",
             cfg.model.name, cfg.model.resnet_size, cfg.data.dataset, total,
             device, param_count(state.model) / 1e6, batch,
             "device-resident" if resident else "streaming",
             cfg.data.device_resident)
    log.info("this slice ignores: %s", ", ".join(
        f"{k}={_knob(cfg, k)}" for k in IGNORED_KNOBS))

    metrics = MetricsWriter(cfg.train.train_dir)
    meter = ThroughputMeter(batch)
    shutdown = ShutdownCoordinator(
        enabled=cfg.resilience.graceful_shutdown).install()
    sentinel = NaNSentinel(cfg.resilience.nan_max_retries,
                           enabled=cfg.resilience.nan_guard)
    host_iter = ds = m = None
    step = last_ckpt_step = state.step

    def stream(start_step):
        if cfg.data.dataset == "imagenet":  # the engine: its own workers
            return data_lib.train_batches(
                cfg.data, batch, seed=cfg.train.seed, start_step=start_step,
                device=device, external_stop=shutdown.event)
        return BackgroundIterator(
            data_lib.train_batches(cfg.data, batch, seed=cfg.train.seed,
                                   start_step=start_step),
            capacity=cfg.data.prefetch + 2, external_stop=shutdown.event)

    try:
        if resident:
            ds = device_data.DeviceDataset(
                *load_split(cfg.data, train=True), batch, device,
                seed=cfg.train.seed)
        else:
            host_iter = stream(step)
        meter.rate(step)
        first = True
        while step < total and not shutdown.requested:
            if ds is not None:
                images, labels = ds.batch_at(step)
            else:
                try:
                    host = next(host_iter)
                except StopIteration:
                    if shutdown.requested:
                        break
                    raise
                images, labels = (torch.as_tensor(a, device=device)
                                  for a in host)
            m = train_step(state, images, labels)
            step = state.step
            if first:
                # The first step pays the kernel builds and cuDNN's plan
                # search: keep it out of the first logged rate.
                first = False
                float(m["loss"])
                meter.rate(step)
            if step % cfg.train.log_every == 0 or step == total:
                vals = {k: float(v) for k, v in m.items()}
                if sentinel.check(step, vals["loss"]):
                    # Roll back to the newest checkpoint. The stream is a
                    # function of (seed, step): restarting it at the bad
                    # step feeds the replayed steps the batches after the
                    # bad window; the resident split replays batch_at.
                    if ckpt.latest_step() is None:
                        raise sentinel.no_checkpoint(step, vals["loss"])
                    bad_step = step
                    ckpt.restore(state, discard_failed=True)
                    step = last_ckpt_step = state.step
                    log.warning("nan rollback from step %d to checkpoint "
                                "step %d (retry %d)", bad_step, step,
                                sentinel.rollbacks)
                    if host_iter is not None:
                        host_iter.close()
                        host_iter = stream(bad_step)
                    m = None
                    meter.rate(step)
                    continue
                rate = meter.rate(step)
                if rate:
                    vals.update(rate)
                if hasattr(host_iter, "stats"):
                    vals.update(host_iter.stats())
                log.info("step %d | loss %.4f | precision %.4f | lr %.4g | "
                         "grad_norm %.4g%s", step, vals["loss"],
                         vals["precision"], vals["learning_rate"],
                         vals["grad_norm"],
                         f" | {rate['steps_per_sec']:.2f} st/s "
                         f"({rate['images_per_sec']:.0f} img/s)"
                         if rate else "")
                metrics.write(step, vals)
            if step % cfg.train.checkpoint_every == 0 or step == total:
                # A checkpoint boundary that is not a log boundary has not
                # had its loss checked: never save a non-finite state, it
                # would become the rollback target.
                if (sentinel.enabled and step % cfg.train.log_every != 0
                        and not math.isfinite(float(m["loss"]))):
                    log.warning("skipping checkpoint save at step %d: "
                                "non-finite loss; rollback engages at the "
                                "next log boundary", step)
                else:
                    ckpt.save(state)
                    last_ckpt_step = step
        if shutdown.requested and step < total:
            log.warning("stop requested at step %d: saving a final "
                        "checkpoint before exit", step)
            if ckpt.latest_step() != step:
                ckpt.save(state)
    except BaseException as exc:
        # An exception in flight with unsaved progress: one guarded save,
        # so the crash loses at most the current interval. Not for a
        # divergence (the state is not finite) or an operator's abort.
        if (cfg.resilience.emergency_save and step > last_ckpt_step
                and not isinstance(exc, (DivergenceError,
                                         KeyboardInterrupt))):
            try:
                ckpt.save(state)
                log.warning("emergency checkpoint saved at step %d after "
                            "in-flight %s", state.step,
                            type(exc).__name__)
            except Exception as e:  # noqa: BLE001 - the original goes on
                log.warning("emergency checkpoint at step %d failed "
                            "(%s: %s)", step, type(e).__name__, e)
        raise
    finally:
        if host_iter is not None:
            host_iter.close()
        metrics.close()
        shutdown.uninstall()
    if shutdown.requested and step < total:
        raise Preempted(step, state=state, signum=shutdown.signum)
    return state
