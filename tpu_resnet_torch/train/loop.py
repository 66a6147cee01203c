"""The training loop (port of the core of ``tpu_resnet/train/loop.py``
``train()``), on one device or on each rank of a data-parallel run:

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
  streamed through a background thread and copied to the device
  (:func:`build_train_iterator`); augment them there with the reference's
  draws;
- dispatch them in chunks (the reference's three branches: resident,
  staged, one batch at a time), each clipped by :func:`_chunk_len` to the
  next log, summary, image-summary, checkpoint, epoch or stop boundary, so
  that every interval fires at the steps a one-step loop fires it;
- log every ``train.log_every`` steps (loss, precision, lr, grad_norm,
  steps/s, images/s, the input's stats, the capture's seconds once) to the
  logger and ``metrics.jsonl``;
- checkpoint every ``train.checkpoint_every`` steps and at the end, but
  never a state whose loss is not finite;
- on a non-finite loss at a log boundary (``resilience.nan_guard``), roll
  back to the newest checkpoint and go on past the bad data window: the
  stream restarts at the bad step, the device-resident split replays
  ``batch_at(step)``; after ``resilience.nan_max_retries`` rollbacks, or
  with no checkpoint, raise ``DivergenceError``;
- on SIGTERM/SIGINT, stop before the next chunk, save a final checkpoint
  and raise ``Preempted`` (the CLI exits 42);
- on any other exception in flight (``resilience.emergency_save``), save
  the unsaved progress once, then let the exception go on.

The NaN guard, the checkpoint skip, the stop and the emergency save act
at chunk boundaries, as in the reference.

Across ranks (a process group opened by ``parallel.multihost.initialize``;
``main.py`` spawns one rank per card):

- the layout comes from ``resilience.elastic.resolve`` over the group's
  ranks, and ``train/step.py``'s gate sees its data axis; each rank trains
  on its rows of the global batch (``parallel.Mesh.rank_rows``) with the
  step's collectives (``train/step.py``, ``parallel/zero.py``);
- only the primary rank writes ``metrics.jsonl``, the manifest,
  ``events.jsonl``, ``flops.json``, ``memory.json``, ``autotune.json`` and
  ``topology.json`` (at the run's first save), and only it serves
  telemetry; checkpoints are written by the primary after a zero1 run
  gathers its momentum shards;
- the ``auto`` probes run on rank 0, which hands its decisions to the
  others, so that every rank runs the same kernels; under per-replica BN
  they probe the local batch;
- a stop request on any rank stops every rank at the same chunk boundary
  (an agreement on the host's gloo group); the NaN guard reads the loss
  averaged over the ranks, so every rank rolls back together; the
  watchdog runs on every rank (a rank's stack dumps under
  ``<train_dir>/rank<r>/``) and ends a rank whose chunk makes no progress
  for the collectives' timeout (a dead peer); the emergency save is the
  one-rank path's only, since a rank that failed alone cannot join a
  collective save.

What the reference's dispatch knobs mean here:

- ``train.steps_per_call = 1`` is the reference's one dispatch per step:
  the eager step, one Python call per op.
- ``train.steps_per_call = k > 1`` is the reference's fused multi-step
  dispatch. On CUDA each chunk of ``c <= k`` steps is ``c`` replays of one
  captured train step (``data/device_data.py`` ``ChunkRunner``): no host
  read inside a chunk, and the metrics are the chunk's last step's. A
  step that cannot be captured raises, naming ``steps_per_call=1``; there
  is no eager fallback. On the CPU the same runner runs ``c`` eager steps
  with the same chunk boundaries.
- ``data.transfer_stage = s > 1`` (streamed host batches): ``s`` batches
  are stacked in pinned memory and copied to the device in one transfer;
  ``data.h2d_double_buffer`` does that on a producer thread and a copy
  stream into a two-slot device buffer (``data/pipeline.py``), and its
  ``h2d_*`` stats go to ``metrics.jsonl``. On the ImageNet engine path
  the batches are on the device already: the stage only groups them into
  chunks, and ``h2d_double_buffer`` changes nothing.

Observability and drills, as the reference's loop has them:

- ``<train_dir>/run_id.json``, ``manifest.json`` and ``events.jsonl``
  (spans: ``run``, ``compile``, ``mfu_account``, ``memory_account``,
  checkpoint saves and restores, ``nan_rollback``, ``preempt_stop``,
  ``emergency_save``, ``oom``, the watchdog's); ``train.telemetry_port``
  >= 0 serves ``/metrics`` and ``/healthz`` (``obs/server.py``);
- after the first dispatch, ``compile_seconds`` (that dispatch's wall
  time, capture included), the step's FLOPs in ``flops.json``
  (``train.mfu_accounting``) and the first dispatch's measured memory in
  ``memory.json`` (``train.memory_ledger``);
- at each log boundary, and only there: the interval's breakdown (data
  wait, dispatch, the sampled device wait), ``model_flops_per_sec`` and
  ``mfu``, the ``train_step_ms`` histogram's percentiles and the
  allocator's ``hbm_bytes_*``, into ``metrics.jsonl`` and the gauges. The
  device is read where the loop reads the metrics anyway; nothing runs in
  a capture and nothing is read per step;
- ``train.profile_steps = "A:B"`` profiles the steps from A to B with
  ``torch.profiler`` (``tools/profiling.py`` ``StepTracer``): no chunk
  straddles the window's ends, the device is drained before the profiler
  stops, the trace lands in ``<train_dir>/profile/`` and a
  ``profiler_trace`` span on the run's timeline
  (``trace-export --device-trace``);
- ``resilience.watchdog_stall_sec`` > 0 watches the chunk boundaries
  (``resilience/watchdog.py``); the ``resilience.inject_*`` knobs and
  ``TPU_RESNET_FAULT_*`` drive the fault injector
  (``resilience/faultinject.py``); an out-of-memory error writes
  ``oom_report.json``.

The reference loop's other features are not in this slice (ROADMAP lists
them): summaries, the profiler server (``train.profiler_port``: PyTorch
has no profiler service to attach to), the comms ledger, the program cache
and the elastic supervisor. Their knobs are accepted and logged as
ignored.
"""

from __future__ import annotations

import contextlib
import logging
import math
import sys
import time
from typing import Optional

import torch

from tpu_resnet_torch import data as data_lib
from tpu_resnet_torch import obs
from tpu_resnet_torch import parallel
from tpu_resnet_torch.data import augment as aug_lib
from tpu_resnet_torch.data import device_data, pipeline
from tpu_resnet_torch.data.cifar import load_split
from tpu_resnet_torch.data.device_data import WARMUP_STEPS
from tpu_resnet_torch.data.pipeline import BackgroundIterator
from tpu_resnet_torch.device import resolve_device
from tpu_resnet_torch.models import build_model, init_weights
from tpu_resnet_torch.obs.server import CORE_HISTOGRAMS
from tpu_resnet_torch.ops import autotune
from tpu_resnet_torch.ops import epilogue as ep
from tpu_resnet_torch.ops import softmax_xent as sx
from tpu_resnet_torch.parallel import multihost, zero
from tpu_resnet_torch.resilience import elastic
from tpu_resnet_torch.resilience.faultinject import FaultInjector, FaultPlan
from tpu_resnet_torch.resilience.sentinel import DivergenceError, NaNSentinel
from tpu_resnet_torch.resilience.shutdown import (Preempted,
                                                  ShutdownCoordinator)
from tpu_resnet_torch.resilience.watchdog import HangWatchdog
from tpu_resnet_torch.tools.profiling import StepTracer
from tpu_resnet_torch.train import schedule as sched_lib
from tpu_resnet_torch.train.checkpoint import CheckpointManager
from tpu_resnet_torch.train.metrics_io import MetricsWriter, ThroughputMeter
from tpu_resnet_torch.train.state import TrainState, create_state, param_count
from tpu_resnet_torch.train.step import check_step_config, make_train_step

log = logging.getLogger("tpu_resnet_torch")

# Knobs of the reference loop that this slice accepts and does not act on.
IGNORED_KNOBS = (
    "train.summary_every", "train.image_summary_every",
    "train.profiler_port", "train.comms_ledger",
    "programs.cache", "data.use_native_loader")


def _knob(cfg, path: str):
    section, field = path.split(".")
    return getattr(getattr(cfg, section), field)


def build_state(cfg, device: torch.device) -> TrainState:
    """Fresh train state: the configured model with seeded weights on
    ``device``, and its optimizer."""
    model = init_weights(build_model(cfg),
                         torch.Generator().manual_seed(cfg.train.seed))
    return create_state(model.to(device), cfg.optim)


def per_replica_bn(cfg, mesh) -> bool:
    """The reference's rule: per-replica BN moments where
    ``model.sync_bn=false`` on a data axis of more than one rank."""
    return (not cfg.model.sync_bn) and mesh is not None and mesh.data > 1


def make_loop_step(cfg, device: torch.device, mesh=None, update=None):
    """The loop's ``TrainStep`` on uint8 images and labels: the dataset's
    augmentation on ``device`` with the reference's draws for
    ``(train.seed, step)`` (``aug_lib.StepAugment``), then the train step
    (whose ``use_pallas_xent=auto`` probe runs here, at the batch the
    kernel sees: this rank's). ``mesh`` (a ``parallel.Mesh``) and
    ``update`` (``parallel.zero.attach``) make it a rank's step."""
    local = cfg.train.global_batch_size // (mesh.data if mesh else 1)
    return make_train_step(cfg.optim,
                           sched_lib.build_schedule(cfg.optim, cfg.train),
                           cfg.data.num_classes,
                           aug_lib.StepAugment(cfg.data.dataset,
                                               cfg.train.seed),
                           device=device, xent_probe_batch=local,
                           mesh=mesh, per_replica_bn=per_replica_bn(cfg, mesh),
                           update=update)


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


def build_step(cfg, device: torch.device, mesh=None, update=None):
    """The loop's step, after the ``auto`` probes: under
    ``model.fused_epilogue=auto`` on CUDA every BN+ReLU shape of the model
    is probed (at this rank's batch), and the cross-entropy probe runs as
    the step is built. Across ranks rank 0 probes and the others take its
    decisions, so that every rank runs the same kernels. The decisions are
    written to the train dir (by the primary) when there are any."""
    local = cfg.train.global_batch_size // (mesh.data if mesh else 1)
    with probe_launches_uncounted():
        if multihost.is_primary():
            if cfg.model.fused_epilogue == "auto" and device.type == "cuda":
                ep.probe_model_epilogues(cfg, local, device=device)
            train_step = make_loop_step(cfg, device, mesh, update)
        autotune.install(multihost.broadcast_object(autotune.decisions()))
        if not multihost.is_primary():
            train_step = make_loop_step(cfg, device, mesh, update)
    if autotune.decisions() and multihost.is_primary():
        log.info("autotune decisions in %s",
                 autotune.dump(cfg.train.train_dir))
    return train_step


def build_train_iterator(cfg, device: torch.device, start_step: int = 0,
                         stop_event=None, injector=None, wait=None,
                         mesh=None):
    """The streaming input from ``start_step`` (reference
    ``build_train_iterator``): ``(data_iter, stage, host_iter)``.
    ``host_iter`` is the source the loop closes: the decode engine for
    ImageNet, else a :class:`BackgroundIterator` over the host batches.
    With ``data.transfer_stage`` = 1, ``data_iter`` yields one batch at a
    time (host arrays the loop copies in, or the engine's batches on the
    device); above 1 it yields stages ``(images, labels, k)``: the
    engine's batches grouped as they are (nothing to transfer), host
    batches stacked in pinned memory and copied once per stage, by a
    producer thread into a two-slot device buffer
    (``data.h2d_double_buffer``, :class:`DoubleBufferedH2D`) or on the
    loop's thread (:func:`staged_superbatch_prefetch`). ``injector`` (a
    ``FaultInjector``) wraps the batches with its planned data faults, as
    the reference's does: the host batches before their background
    thread, the engine's as the loop takes them. ``wait`` wraps the
    engine's batches to time each as a data wait (the loop's breakdown:
    the engine's stages are read while a chunk is issued). With ``mesh``
    each batch is this rank's rows of its process's stream."""
    stage = max(1, cfg.data.transfer_stage)
    batch = cfg.train.global_batch_size
    ranks = {}
    if mesh is not None and mesh.size > 1:
        batch = parallel.local_batch_size(batch, mesh)
        ranks = {"mesh": mesh}
    if cfg.data.dataset == "imagenet":  # the engine: its own workers
        engine = data_lib.train_batches(
            cfg.data, batch, seed=cfg.train.seed, start_step=start_step,
            device=device, external_stop=stop_event, **ranks)
        stream = engine
        if injector is not None:
            stream = injector.wrap_host_batches(stream, start_step)
        if wait is not None:
            stream = wait(stream)
        if stage > 1:
            return pipeline.device_stages(stream, stage), stage, engine
        return stream, 1, engine
    batches = data_lib.train_batches(cfg.data, batch, seed=cfg.train.seed,
                                     start_step=start_step, **ranks)
    if injector is not None:
        batches = injector.wrap_host_batches(batches, start_step)
    host_iter = BackgroundIterator(
        batches, capacity=stage * cfg.data.prefetch + 2,
        external_stop=stop_event)
    if stage == 1:
        return host_iter, 1, host_iter
    if cfg.data.h2d_double_buffer:
        return pipeline.DoubleBufferedH2D(
            host_iter, device, stage=stage, depth=cfg.data.prefetch,
            external_stop=stop_event), stage, host_iter
    return pipeline.staged_superbatch_prefetch(
        host_iter, device, stage=stage,
        depth=cfg.data.prefetch), stage, host_iter


def _chunk_len(step: int, total: int, train_cfg, steps_per_epoch: int,
               extra_boundaries: tuple = ()) -> int:
    """Steps to run in the next fused dispatch: at most ``steps_per_call``,
    clipped so the chunk ends exactly on the next log/summary/checkpoint/
    epoch/stop boundary — every interval fires at precisely the same steps
    a one-dispatch-per-step loop would fire them. ``extra_boundaries`` are
    absolute steps (e.g. a profiler trace window) chunks must not straddle."""
    k = max(1, train_cfg.steps_per_call)
    for interval in (train_cfg.log_every, train_cfg.summary_every,
                     train_cfg.image_summary_every,
                     train_cfg.checkpoint_every, steps_per_epoch):
        if interval > 0:
            k = min(k, interval - step % interval)
    for b in extra_boundaries:
        if b > step:
            k = min(k, b - step)
    return min(k, total - step)


def _close_input(*iters) -> None:
    for it in iters:
        if hasattr(it, "close"):
            it.close()


def _flops_entry(cfg, device, spans, train_dir) -> Optional[float]:
    """The step's FLOPs (``obs/mfu.py``), once, in the compile window; None
    when the count fails (the mfu gauges then stay 0)."""
    t0 = time.time()
    try:
        entry = obs.mfu.account_train_step(cfg, device, train_dir=train_dir)
    except Exception as e:  # noqa: BLE001 - accounting must never kill
        log.warning("mfu accounting failed (%s: %s): the mfu gauges stay 0",
                    type(e).__name__, e)
        return None
    spans.record("mfu_account", t0, time.time(),
                 flops_per_step=entry.get("flops_per_step"),
                 source=entry.get("flops_source"))
    return entry.get("flops_per_step")


def _memory_entry(cfg, state, device, baseline, runner, steps: int, spans,
                  ledger, train_dir) -> Optional[str]:
    """The first dispatch's memory (``obs/memory.py``) in the ledger, once;
    returns its program key, None when the accounting fails."""
    if runner.graph is not None:
        dispatch = (f"first chunk: {WARMUP_STEPS} warm-up steps, the "
                    f"capture, {runner.replays} CUDA graph replays")
    else:
        dispatch = f"first chunk: {steps} eager steps"
    t0 = time.time()
    try:
        entry = obs.memory.account_train_step(
            cfg, state, device, baseline, dispatch=dispatch, ledger=ledger,
            train_dir=train_dir)
    except Exception as e:  # noqa: BLE001 - accounting must never kill
        log.warning("memory ledger failed (%s: %s): memory.json absent for "
                    "this run", type(e).__name__, e)
        return None
    spans.record("memory_account", t0, time.time(),
                 program_key=entry["program_key"],
                 peak_bytes=entry.get("peak_bytes"),
                 transient_peak_bytes=entry.get("transient_peak_bytes"))
    return entry["program_key"]


def train(cfg, device: Optional[str] = None) -> TrainState:
    """Run training to ``cfg.train.train_steps``; returns the final state.
    In a process group (``parallel.multihost.initialize``) every rank calls
    it, on its own card."""
    device = resolve_device(device)
    kind = obs.mfu.device_kind(device)
    check_step_config(cfg)  # the model axis, before the layout
    # The layout over the ranks that exist (the reference's elastic
    # resolve): an explicit mesh.data that does not fit them is downsized.
    group = multihost.layout()
    elastic_ctx = elastic.resolve(cfg, group.size, layout=group,
                                  device_kind=kind)
    mesh = elastic_ctx.mesh
    if mesh.size != group.size:
        raise ValueError(
            f"mesh {mesh.shape} does not cover the process group's "
            f"{group.size} ranks; start as many ranks as mesh.data")
    check_step_config(cfg, mesh.data)
    primary = multihost.is_primary()
    resident = device_data.should_use(cfg.data)
    train_dir = cfg.train.train_dir
    rcfg = cfg.resilience

    # Observability (obs/): the run's id, spans and manifest, and the
    # telemetry registry and server, alive from startup; the primary
    # rank's alone.
    run_id = obs.ensure_run_id(train_dir) if primary else None
    run_id = multihost.broadcast_object(run_id)
    spans = obs.SpanTracer(train_dir, enabled=primary, run_id=run_id)
    if primary:
        obs.write_manifest(
            train_dir, cfg, device, run_id=run_id, mesh=mesh,
            extra=({"topology_change": elastic_ctx.attrs()}
                   if elastic_ctx.changed else None))
    telemetry = obs.TelemetryRegistry(
        stale_after_sec=cfg.train.telemetry_stale_sec,
        histograms=CORE_HISTOGRAMS)
    telemetry.heartbeat(0)
    server = obs.TelemetryServer.maybe_start(
        cfg.train.telemetry_port if primary else -1, telemetry,
        train_dir=train_dir)

    # From here on a failure (a bad restore, an injected corrupt checkpoint
    # with nothing to fall back to, a bad config) still runs the closers
    # below, so that no server, watchdog, signal handler or file outlives
    # the call.
    shutdown = watchdog = ckpt = metrics = runner = tracer = None
    host_iter = data_iter = ds = m = state = None
    stage = 1
    step = last_ckpt_step = 0
    total = cfg.train.train_steps
    run_wall0 = start_step = None
    mem_ledger = obs.memory.MemoryLedger()
    mem_key = None
    mem_ring = obs.memory.MemorySampleRing()
    stopping = False
    topology_recorded = []

    def record_topology():
        """``topology.json`` names the layout that wrote the newest
        checkpoints: written at this run's first save, not at startup."""
        if not topology_recorded:
            topology_recorded.append(True)
            elastic.write_topology(train_dir, mesh, cfg.mesh.partition,
                                   cfg.train.global_batch_size, kind)

    try:
        injector = FaultInjector(FaultPlan.from_config(rcfg),
                                 train_dir=train_dir)
        if injector.plan.preempt_burst > 0:
            telemetry.set("fault_preempt_burst", float(injector.burst_fired))
        shutdown = ShutdownCoordinator(
            enabled=rcfg.graceful_shutdown).install()
        sentinel = NaNSentinel(rcfg.nan_max_retries, enabled=rcfg.nan_guard)
        watchdog = HangWatchdog.maybe_start(
            rcfg.watchdog_stall_sec,
            train_dir if primary else f"{train_dir}/rank{mesh.rank}",
            telemetry=telemetry, spans=spans,
            abort_sec=(multihost.collective_timeout() if mesh.size > 1
                       else None))

        state = build_state(cfg, device)
        update = zero.attach(state, cfg.mesh, mesh)
        if primary:
            injector.maybe_corrupt_checkpoint(train_dir)
        ckpt = CheckpointManager(train_dir, keep=cfg.train.keep_checkpoints,
                                 spans=spans, primary=primary,
                                 barrier=multihost.barrier)
        if ckpt.latest_step() is not None:
            ckpt.restore(state, discard_failed=True)
            log.info("resumed from step %d in %s", state.step, train_dir)
        if elastic_ctx.changed:
            spans.event("topology_change", step=state.step,
                        **elastic_ctx.attrs())
            telemetry.set("topology_changes", 1.0)
        step = last_ckpt_step = state.step
        train_step = build_step(cfg, device, mesh, update)
        batch = cfg.train.global_batch_size
        per_call = max(1, cfg.train.steps_per_call)
        graphed = (device.type == "cuda" and per_call > 1
                   and multihost.capturable_collectives())
        log.info("training %s-%d/%s to step %d on %s | params %.2fM | batch "
                 "%d | mesh %s rank %d | partition %s | BN %s | input %s "
                 "(data.device_resident=%s) | dispatch %s",
                 cfg.model.name, cfg.model.resnet_size, cfg.data.dataset,
                 total, device, param_count(state.model) / 1e6, batch,
                 mesh.shape, mesh.rank,
                 parallel.make_partitioner(cfg.mesh, mesh).describe(),
                 "per-replica" if per_replica_bn(cfg, mesh) else "synced",
                 "device-resident" if resident else "streaming",
                 cfg.data.device_resident,
                 f"chunks of <= {per_call} CUDA graph replays" if graphed
                 else f"eager, chunks of <= {per_call} steps"
                 + (f" ({torch.distributed.get_backend()} collectives)"
                    if mesh.size > 1 else ""))
        log.info("this slice ignores: %s", ", ".join(
            f"{k}={_knob(cfg, k)}" for k in IGNORED_KNOBS))

        tracer = StepTracer(train_dir,
                            cfg.train.profile_steps if primary else "",
                            spans=spans, device=device)
        metrics = MetricsWriter(train_dir, enabled=primary)
        meter = ThroughputMeter(batch)
        # Where the interval's time goes (obs/breakdown.py): data waits,
        # dispatch, and the device sampled at log boundaries only.
        breakdown = obs.StepBreakdown()
        if resident:
            ds = device_data.DeviceDataset(
                *load_split(cfg.data, train=True), batch, device,
                seed=cfg.train.seed, rows=mesh.rank_rows(batch))
        else:
            data_iter, stage, host_iter = build_train_iterator(
                cfg, device, step, shutdown.event, injector=injector,
                wait=breakdown.waited, mesh=mesh)
        runner = device_data.ChunkRunner(train_step, device, per_call, ds)
        step_flops = None
        telemetry.heartbeat(step)
        run_wall0, start_step = time.time(), step
        meter.rate(step)
        breakdown.reset_interval()
        # The memory ledger measures the first dispatch: the warm-up steps
        # and the capture of a graphed run are in it (obs/memory.py).
        mem_base = (obs.memory.start_dispatch_measure(device)
                    if cfg.train.memory_ledger and primary else None)
        first = True
        capture_logged = False
        last_sync = last_log_step = step
        stage_buf = None  # the current stage: (images, labels, k, offset)
        while step < total:
            injector.maybe_sigterm(step)
            injector.maybe_oom(step)
            stopping = multihost.agree_any(shutdown.requested)
            if stopping:
                break  # stop at the chunk boundary; final save below
            tracer.before(step)
            if resident:
                with breakdown.dispatch():
                    m = runner.run(state, step, _chunk_len(
                        step, total, cfg.train, ds.steps_per_epoch,
                        tracer.boundaries()))
            elif stage > 1:
                if stage_buf is None:
                    try:
                        with breakdown.data_wait():
                            stage_buf = (*next(data_iter), 0)
                    except StopIteration:
                        if multihost.agree_any(shutdown.requested):
                            stopping = True
                            break
                        raise
                gi, gl, n, off = stage_buf
                # Up to the stage's end, clipped to the next log or
                # checkpoint boundary (the reference's staged branch).
                c = min(n - off, _chunk_len(step, total, cfg.train, 0,
                                            tracer.boundaries()))
                try:  # the engine's stages take each batch as it comes
                    with breakdown.dispatch():
                        m = runner.run_staged(state, gi, gl, off, c)
                except StopIteration:
                    if multihost.agree_any(shutdown.requested):
                        stopping = True
                        break
                    raise
                stage_buf = (None if off + c >= n
                             else (gi, gl, n, off + c))
            else:
                try:
                    with breakdown.data_wait():
                        host = next(data_iter)
                except StopIteration:
                    if multihost.agree_any(shutdown.requested):
                        stopping = True
                        break
                    raise
                with breakdown.dispatch():
                    m = runner.run_batches(state, [tuple(
                        torch.as_tensor(a, device=device) for a in host)])
            step = state.step
            if watchdog is not None:
                watchdog.progress(step)
            if tracer.after(step):
                # Closing the window drained the device: the next
                # boundary's backlog covers only the steps since here.
                last_sync = step
            if first:
                # The first chunk pays the kernel builds, cuDNN's plan
                # search and the capture: compile_seconds, kept out of the
                # first rate; then the once-a-run FLOPs and memory ledgers.
                first = False
                compile_s = breakdown.first_dispatch_done(
                    lambda: float(m["loss"]))
                now = time.time()
                spans.record("compile", now - compile_s, now,
                             seconds=round(compile_s, 3), step=start_step)
                telemetry.set("compile_seconds", compile_s)
                if cfg.train.mfu_accounting and primary:
                    step_flops = _flops_entry(cfg, device, spans, train_dir)
                if cfg.train.memory_ledger and primary:
                    mem_key = _memory_entry(cfg, state, device, mem_base,
                                            runner, step - start_step,
                                            spans, mem_ledger, train_dir)
                breakdown.reset_interval()
                meter.rate(step)
                last_sync = last_log_step = step
            if step % cfg.train.log_every == 0 or step == total:
                vals = breakdown.sample_device(
                    lambda: {k: float(v) for k, v in m.items()},
                    step - last_sync)
                last_sync = step
                if sentinel.check(step, vals["loss"]):
                    # Roll back to the newest checkpoint (written into the
                    # state's own tensors, so a captured step stays
                    # valid). The stream is a function of (seed, step):
                    # restarting it at the bad step feeds the replayed
                    # steps the batches after the bad window; the resident
                    # split replays batch_at.
                    if ckpt.latest_step() is None:
                        raise sentinel.no_checkpoint(step, vals["loss"])
                    bad_step = step
                    ckpt.restore(state, discard_failed=True)
                    step = last_ckpt_step = state.step
                    log.warning("nan rollback from step %d to checkpoint "
                                "step %d (retry %d)", bad_step, step,
                                sentinel.rollbacks)
                    spans.event("nan_rollback", from_step=bad_step,
                                to_step=step, loss=str(vals["loss"]),
                                retry=sentinel.rollbacks)
                    telemetry.set("fault_nan_rollbacks", sentinel.rollbacks)
                    if not resident:
                        _close_input(data_iter, host_iter)
                        data_iter, stage, host_iter = build_train_iterator(
                            cfg, device, bad_step, shutdown.event,
                            injector=injector, wait=breakdown.waited,
                            mesh=mesh)
                        stage_buf = None
                    m = None
                    breakdown.reset_interval()
                    meter.rate(step)
                    last_sync = last_log_step = step
                    telemetry.heartbeat(step)
                    continue
                rate = meter.rate(step)
                if rate:
                    vals.update(rate)
                    vals["images_per_sec_per_chip"] = rate["images_per_sec"]
                    # The interval's mean step time, once a step: the
                    # train_step_ms histogram and its percentiles.
                    telemetry.observe("train_step_ms",
                                      1e3 / rate["steps_per_sec"],
                                      n=max(1, step - last_log_step))
                    for q in (0.50, 0.95, 0.99):
                        vals[f"train_step_ms_p{int(q * 100)}"] = round(
                            telemetry.hist_percentile("train_step_ms", q),
                            3)
                    if step_flops:
                        mfs = step_flops * rate["steps_per_sec"]
                        vals["model_flops_per_sec"] = mfs
                        u = obs.mfu.mfu(mfs, kind, mesh.size)
                        if u is not None:
                            vals["mfu"] = u
                last_log_step = step
                vals.update(breakdown.interval())
                hbm = obs.memory.sample_device_memory(device)
                if hbm:
                    vals.update(hbm)
                    mem_ring.add(step, hbm)
                # The engine's decode stats; the double buffer's h2d stats
                # (each read once: a read starts the next interval).
                for it in ((host_iter,) if data_iter is host_iter
                           else (host_iter, data_iter)):
                    if hasattr(it, "stats"):
                        vals.update(it.stats())
                if runner.capture_seconds is not None and not capture_logged:
                    capture_logged = True
                    vals["capture_seconds"] = runner.capture_seconds
                telemetry.update(vals)
                telemetry.set("checkpoint_lag_steps", step - last_ckpt_step)
                telemetry.heartbeat(step)
                log.info("step %d | loss %.4f | precision %.4f | lr %.4g | "
                         "grad_norm %.4g%s | wait %d%%", step, vals["loss"],
                         vals["precision"], vals["learning_rate"],
                         vals["grad_norm"],
                         f" | {rate['steps_per_sec']:.2f} st/s "
                         f"({rate['images_per_sec']:.0f} img/s)"
                         if rate else "", round(vals["data_wait_frac"] * 100))
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
                    spans.event("checkpoint_save_skipped_nonfinite",
                                step=step)
                else:
                    ckpt.save(state)
                    record_topology()
                    last_ckpt_step = step
                    telemetry.set("checkpoint_lag_steps", 0)
        if stopping and step < total:
            log.warning("stop requested at step %d: saving a final "
                        "checkpoint before exit", step)
            spans.event("preempt_stop", step=step, signum=shutdown.signum)
            telemetry.set("fault_preemptions", 1.0)
            if injector.plan.preempt_burst > 0:
                telemetry.set("fault_preempt_burst",
                              float(injector.burst_fired))
            if ckpt.latest_step() != step:
                ckpt.save(state)
                record_topology()
                last_ckpt_step = step
    finally:
        # One shutdown path for clean exits and exceptions: each closer
        # runs even if one before it raised; a closer's error surfaces on
        # a clean exit and never masks the loop's own exception.
        exc_type, exc_val = sys.exc_info()[:2]
        closer_errs = []

        def _close(fn):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - shutdown must finish
                closer_errs.append(e)
                log.warning("shutdown closer %s failed: %s",
                            getattr(fn, "__name__", fn), e)

        if exc_val is not None and obs.memory.is_oom_error(exc_val):
            # OOM forensics first: the ledger, the recent samples and the
            # live tensors in <train_dir>/oom_report.json.
            _close(lambda: obs.memory.write_oom_report(
                train_dir, exc_val, context="train", step=step,
                program_key=mem_key, ledger=mem_ledger,
                samples=mem_ring.snapshot(), run_id=run_id, device=device))
            _close(lambda: spans.event("oom", step=step,
                                       program_key=mem_key))
        if (rcfg.emergency_save and exc_type is not None
                and mesh.size == 1
                and ckpt is not None and state is not None
                and not issubclass(exc_type, (DivergenceError,
                                              KeyboardInterrupt))
                and step > last_ckpt_step):
            # An exception in flight with unsaved progress: one guarded
            # save, so the crash loses at most the current interval. Not
            # for a divergence (the state is not finite) or an operator's
            # abort.
            def _emergency_save():
                ckpt.save(state)
                record_topology()
                spans.event("emergency_save", step=step)
                log.warning("emergency checkpoint saved at step %d after "
                            "in-flight %s", state.step, exc_type.__name__)

            _close(_emergency_save)
        if tracer is not None:
            _close(tracer.close)
        if run_wall0 is not None:  # the loop started
            _close(lambda: spans.record(
                "run", run_wall0, time.time(), start_step=start_step,
                stop_step=step, train_steps=total))
        _close(spans.close)
        if server is not None:
            _close(server.close)
        _close(lambda: _close_input(data_iter, host_iter))
        if runner is not None:
            _close(runner.close)
        if metrics is not None:
            _close(metrics.close)
        if watchdog is not None:
            _close(watchdog.close)
        if shutdown is not None:
            _close(shutdown.uninstall)
        if closer_errs and exc_type is None:
            raise closer_errs[0]
    if stopping and step < total:
        raise Preempted(step, state=state, signum=shutdown.signum)
    return state
