# Copy of tpu_resnet/config.py with every field, default, preset and override
# rule unchanged, so a config means the same in both packages
# (tests/test_torch_import.py compares every preset).
"""Typed run configuration — replaces the reference's per-script flag jungle.

The reference re-declares ~60 ``tf.app.flags`` in every entry script and
splits hyperparameters across four places: flags, the ``HParams`` namedtuple
(reference resnet_model.py:36-39), LR schedules embedded in session hooks
(resnet_cifar_train.py:291-311), and module constants
(resnet_cifar_train.py:98-100).  Here everything lives in one typed,
serializable tree of dataclasses with a flat ``--section.field=value`` CLI
override syntax and named presets matching the reference's published
configurations (BASELINE.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Mapping, Sequence


@dataclasses.dataclass
class DataConfig:
    """Input pipeline configuration.

    Mirrors the knobs of reference cifar_input.py:25-119 and the tf.data
    ``input_fn`` copies (resnet_cifar_train.py:204-247,
    resnet_imagenet_train.py:161-187) — minus the per-worker-reads-everything
    design: this pipeline shards files/records per host.
    """

    dataset: str = "cifar10"  # cifar10 | cifar100 | imagenet | synthetic
    data_dir: str = ""
    # synthetic only: derive labels from image content (a brightened band)
    # so training must genuinely learn — the no-download stand-in for
    # real-data convergence runs (data/cifar.py::synthetic_data).
    synthetic_learnable: bool = False
    # synthetic+learnable only: "bands" = easy linear-probe task (smoke
    # gates); "freq100" = 100-class frequency-pair task with random phase
    # (augmentation-invariant features required; convergence evidence —
    # see data/cifar.py::synthetic_data).
    synthetic_task: str = "bands"
    # freq100 only: fraction of TRAIN labels resampled uniformly (eval
    # stays clean). Makes the decayed tail of a piecewise LR schedule
    # measurably matter.
    synthetic_label_noise: float = 0.0
    # synthetic only: class count (smoke-test any head size, e.g. the
    # WRN-28-10 CIFAR-100 shape, without the real dataset bytes).
    synthetic_classes: int = 10
    # synthetic only: split sizes (0 = defaults 1024/256). Convergence
    # runs on the freq100 task need real split sizes (e.g. 20k/2k).
    synthetic_train_examples: int = 0
    synthetic_eval_examples: int = 0
    # Number of worker threads in the host loader (reference uses 16 queue
    # threads, cifar_input.py:99-100; and num_parallel_calls=4 tf.data maps).
    num_workers: int = 4
    # Host data engine worker kind for CPU-heavy sources (ImageNet JPEG
    # decode; data/engine.py). "thread" keeps decode in-process — fine
    # when the native GIL-free decoder carries the load, and the only
    # sensible choice for in-memory CIFAR (which bypasses the engine
    # entirely). "process" runs N decode *processes* over a shared-memory
    # ring — the fix when the step breakdown shows data_wait high and
    # host decode is the ceiling (BENCH_r04: one v5e consumes ~3032
    # img/s at b128 while the GIL-bound host decoded ~372).
    engine: str = "thread"  # thread | process
    # Decode worker processes when data.engine=process (0 = num_workers).
    num_decode_procs: int = 0
    # Engine ring slots — batch-sized decode targets preallocated up
    # front (shared memory in process mode). 0 = auto: hold window +
    # 3*workers + 2 (~3 orders in flight per worker; thinner rings
    # starve workers — see engine.py). RAM = slots × batch bytes
    # (b128@224 ≈ 19 MB/slot); hold covers the staged-transfer
    # look-back (transfer_stage + 1).
    ring_slots: int = 0
    # Batches buffered ahead on host + device (prefetch 2x in reference,
    # resnet_cifar_train.py:233).
    prefetch: int = 2
    shuffle_buffer: int = 50_000
    # ImageNet only: VGG-style resize-side jitter bounds for training
    # (vgg_preprocessing.py:306-309) and eval resize side (:330).
    resize_min: int = 256
    resize_max: int = 512
    eval_resize: int = 256
    image_size: int = 0  # 0 = dataset default (32 cifar / 224 imagenet)
    # Use the native C++ loader when the shared library is built.
    use_native_loader: bool = True
    # Verify the masked CRC32C of every TFRecord read. Near-free with the
    # native plane (919 MB/s, r3 bench; the pure-python CRC is ~4 MB/s),
    # so corrupted shards fail loudly instead of feeding garbage JPEGs.
    verify_records: bool = False
    # Device-resident dataset (data/device_data.py): upload the whole
    # training split to HBM once and cut batches on-device — removes all
    # per-step host→device traffic. "auto" enables it for single-process
    # in-memory datasets under ``resident_max_bytes``; "on" forces, "off"
    # always streams through the host pipeline. Measured (v5e, r3,
    # fetch-verified): resident 203.3 st/s vs streaming ≤104.4 on the
    # same CIFAR rn50 b128 step — resident wins wherever it applies.
    device_resident: str = "auto"  # auto | on | off
    resident_max_bytes: int = 2 << 30
    # Streaming path: batches staged per host→device transfer (amortizes
    # per-transfer command latency; per-step batches are cut on-device).
    # 1 = one transfer per batch. Measured sweep (v5e r3, CIFAR rn50
    # b128, bandwidth-bound link): stage 4/8/16 → 88.1/96.4/104.4 st/s;
    # 8 takes most of the amortization at half 16's staging HBM.
    transfer_stage: int = 8
    # Double-buffered H2D prefetch (data/pipeline.py::DoubleBufferedH2D;
    # the port stacks in pinned memory and copies on a stream of its own):
    # a producer thread assembles the NEXT staged superbatch and runs its
    # host->device transfer to completion while the loop dispatches
    # compute on the current one — an explicit two-slot device buffer,
    # recycled between stages. Gauges h2d_bytes_per_sec /
    # h2d_overlap_frac and the trace-export transfer lane make the
    # overlap visible (docs/OBSERVABILITY.md). Off = the plain staged
    # generator (transfer serialized with superbatch assembly on the
    # consumer thread). Superbatch CONTENTS are identical either way —
    # loss streams are bit-equal (tests/test_data.py).
    h2d_double_buffer: bool = True

    @property
    def num_classes(self) -> int:
        if self.dataset == "synthetic":
            return self.synthetic_classes
        return {"cifar10": 10, "cifar100": 100,
                "imagenet": 1000}[self.dataset]

    @property
    def default_image_size(self) -> int:
        return 224 if self.dataset == "imagenet" else 32

    @property
    def resolved_image_size(self) -> int:
        return self.image_size or self.default_image_size

    @property
    def train_examples(self) -> int:
        if self.dataset == "synthetic":
            return self.synthetic_train_examples or 1024
        return {"cifar10": 50_000, "cifar100": 50_000,
                "imagenet": 1_281_167}[self.dataset]

    @property
    def eval_examples(self) -> int:
        if self.dataset == "synthetic":
            return self.synthetic_eval_examples or 256
        return {"cifar10": 10_000, "cifar100": 10_000,
                "imagenet": 50_000}[self.dataset]


@dataclasses.dataclass
class ModelConfig:
    """Model selection.

    ``resnet_size`` semantics follow the reference exactly: for CIFAR the
    network is the 6n+2 basic-block ResNet-v2 and size must satisfy
    ``size % 6 == 2`` (resnet_model_official.py:233-236); for ImageNet the
    size must be one of 18/34/50/101/152/200 (resnet_model_official.py:352-358).
    ``width_multiplier`` > 1 turns the CIFAR net into a Wide-ResNet
    (e.g. WRN-28-10 = resnet_size 28, width 10).
    """

    name: str = "resnet"  # resnet | mlp
    resnet_size: int = 50
    width_multiplier: int = 1
    # bf16 compute on the MXU with fp32 params/BN stats. "float32" for
    # bit-exact CPU tests.
    compute_dtype: str = "bfloat16"
    # True (default): BN moments over the global batch — the natural
    # semantics of one auto-sharded SPMD program. False: per-replica BN,
    # the reference's semantics (each worker's update_ops ran on its own
    # batch, resnet_model.py:120-122), compiled via shard_map with
    # explicit pmean of grads/stats. The reference's distributed accuracy
    # gap (README.md:36) is partly this; both are offered so the delta
    # can be measured.
    sync_bn: bool = True
    # Execute the ImageNet 7x7/2 stem as a 4x4 conv over space-to-depth
    # input — identical math and identical parameters/checkpoints, much
    # better MXU utilization (models/resnet.py::SpaceToDepthStem).
    stem_space_to_depth: bool = True
    # Rematerialize residual blocks in backward (activation memory
    # O(depth)): enables batches past the HBM ceiling (e.g. b512 @224)
    # at ~33% block recompute cost. Off by default.
    remat: bool = False
    # Hybrid fused-Pallas block dispatch (CIFAR basic-block nets only):
    # stride-1 identity blocks run as single VMEM-resident Pallas kernels
    # (models/resnet.py::FusedBuildingBlock), transition blocks stay XLA.
    # Checkpoint-compatible with the XLA path (identical param tree).
    # Default OFF pending battery stage 05_fused_block_ab's live A/B
    # (docs/PERF.md "CIFAR is overhead-bound"); single-device validated.
    fused_blocks: bool = False
    # Forward batch tile of the fused kernels (backward tile derives from
    # it); tunable from tools/fused_model_ab.py --batch-tile.
    fused_block_tile: int = 16
    # Fused Pallas conv epilogues (ops/epilogue.py): every BN+ReLU site
    # runs as one VMEM-resident scale-bias-ReLU kernel over the conv
    # output instead of XLA's separate fused loops. "auto": the loop
    # probes each stage shape at startup (ops.probe_model_epilogues) and
    # only shapes with a measured win dispatch to Pallas — unprofitable
    # shapes keep the identical XLA math. "on" forces the kernel
    # everywhere (tests / forced runs); "off" keeps nn.BatchNorm.
    # Multi-chip: supported via the per-replica-BN shard_map path only
    # (model.sync_bn=false), same rule as fused_blocks — the train loop
    # and the config matrix both enforce it (train/step.py
    # check_step_config).
    fused_epilogue: str = "off"  # off | on | auto
    # MLP sanity model (reference logist_model.py:11) hidden units.
    mlp_hidden_units: int = 100


@dataclasses.dataclass
class OptimConfig:
    """Optimizer + schedule.

    Defaults reproduce the reference recipe: momentum 0.9
    (resnet_model.py:96-99), L2 weight decay summed over all trainable
    variables and added to the loss (resnet_model.py:85-86), piecewise LR
    0.1/0.01/0.001/0.0001 at steps 40k/60k/80k for CIFAR
    (resnet_cifar_train.py:302-311) or the Intel-Caffe warmup recipe for
    ImageNet (resnet_imagenet_train.py:236-260).
    """

    optimizer: str = "momentum"  # sgd | momentum
    momentum: float = 0.9
    schedule: str = "cifar_piecewise"  # cifar_piecewise | imagenet_warmup | constant | cosine
    base_lr: float = 0.1
    weight_decay: float = 0.0002  # reference _WEIGHT_DECAY for cifar
    # Reference applies L2 to *all* trainables incl. BN scale/bias
    # (resnet_model.py:85-86 uses tf.trainable_variables()); set False for the
    # modern no-decay-on-BN/bias variant.
    weight_decay_on_bn: bool = True
    label_smoothing: float = 0.0
    # Fused Pallas softmax-xent kernel (tpu_resnet/ops) on TPU backends;
    # the optax chain always serves CPU and label_smoothing != 0.
    # "auto" (default): a compile-time per-shape A/B probe
    # (ops/autotune.py + softmax_xent.ensure_xent_probe) times both
    # lowerings at step-build time and dispatches the measured winner —
    # the BENCH_r04 0.901x regression class auto-falls back to XLA.
    # "on" forces the (retuned, lane-tiled) kernel; "off" forces XLA.
    use_pallas_xent: str = "auto"  # auto | on | off
    # warmup schedule knobs (imagenet_warmup)
    warmup_steps: int = 6240
    warmup_init_lr: float = 0.1
    boundaries: tuple = ()  # override schedule boundaries; () = schedule default
    values: tuple = ()      # override schedule values


@dataclasses.dataclass
class MeshConfig:
    """Device mesh. ``data`` is the only axis needed for reference parity
    (its three distribution modes — PS-sync, async-PS, Horovod — are all data
    parallelism, SURVEY.md §2.3); ``model`` is there so tensor-style sharding
    composes without redesign."""

    data: int = -1   # -1 = all remaining devices
    model: int = 1
    axis_names: tuple = ("data", "model")
    # State partitioning scheme (tpu_resnet/parallel/partition.py — the
    # single owner of every TrainState sharding decision):
    # "replicated" keeps a full parameter + optimizer copy per device
    # (classic data parallelism); "zero1" shards the optimizer slots and
    # the weight update over the data axis via sharding annotations
    # (arXiv:2004.13336) — ~N× less optimizer HBM per device on an N-way
    # data axis, at the cost of an all-gather of the updated parameters
    # per step (docs/PARALLELISM.md has the tradeoff and the golden
    # memory-budget proof). Validated against the mesh at startup;
    # requires model.sync_bn=true on multi-chip meshes (the shard_map
    # per-replica-BN path cannot carry sharding constraints).
    partition: str = "replicated"  # replicated | zero1


@dataclasses.dataclass
class TrainConfig:
    """Training loop parameters (reference trainer flags + hook constants)."""

    train_dir: str = "/tmp/tpu_resnet/train"
    train_steps: int = 100_000
    # Global batch across the whole mesh. The reference is ambiguous between
    # global (Cori: 128/num_nodes per node, submit_ps_cifar_cori_dist.sh:27-31)
    # and per-worker (ImageNet: 128/node, README.md:39-40); we make global the
    # source of truth and derive per-device.
    global_batch_size: int = 128
    eval_batch_size: int = 100  # reference resnet_cifar_eval.py: batch 100
    log_every: int = 20          # LoggingTensorHook interval (resnet_cifar_train.py:282-287)
    summary_every: int = 100     # SummarySaverHook interval (:275-280)
    # Augmented input-batch image summaries (reference cifar_input.py:118
    # wrote the training batch to TensorBoard with every summary). Here a
    # small grid every N steps (0 = off); heavier than scalars, so the
    # default matches the checkpoint cadence rather than summary_every.
    image_summary_every: int = 1000
    checkpoint_every: int = 1000  # save_checkpoint_steps (:335)
    keep_checkpoints: int = 5
    seed: int = 0
    # Continuous-eval sidecar (resnet_cifar_eval.py:140-143)
    eval_interval_secs: int = 60
    eval_once: bool = False
    # Steps per dispatch (amortizes host→device command latency): the
    # reference fuses them with lax.scan; on CUDA the port runs a chunk as
    # that many replays of one CUDA graph of the step
    # (data/device_data.py ChunkRunner), on the CPU as eager steps.
    # Governs BOTH fused paths: device-resident chunks and staged
    # streaming superbatches (there additionally capped by
    # data.transfer_stage). 1 = one dispatch per step (the eager step);
    # chunks are clipped to log/checkpoint/epoch boundaries so all
    # intervals are honored exactly. The reference's measurement (TPU v5e
    # r3, resident CIFAR rn50 b128): k=10 → 203.3 st/s, k=50 → 195.8 —
    # the curve is flat past 10, and 10 keeps log/checkpoint clipping
    # cheap.
    steps_per_call: int = 10
    # Profiling (tools/profiling.py): port for the live jax.profiler
    # service (0 = off) and an optional "start:stop" step window traced
    # into <train_dir>/profile.
    profiler_port: int = 0
    profile_steps: str = ""
    # Telemetry HTTP server (tpu_resnet/obs/server.py), one per host:
    # /metrics (Prometheus text) + /healthz (liveness & heartbeat age).
    # -1 = off, 0 = OS-assigned ephemeral port (recorded in
    # <train_dir>/telemetry.json), >0 = fixed port.
    telemetry_port: int = -1
    # /healthz reports ok=false (HTTP 503) when the last heartbeat is
    # older than this many seconds.
    telemetry_stale_sec: float = 300.0
    # MFU accounting (tpu_resnet/obs/mfu.py): measure the train step's
    # per-step FLOPs once at first dispatch (abstract re-trace + HLO cost
    # analysis — no second XLA compile) and publish live
    # model_flops_per_sec / mfu gauges plus <train_dir>/flops.json.
    # Purely host-side: does not change the compiled program (no new
    # config-matrix rows needed).
    mfu_accounting: bool = True
    # Memory ledger (tpu_resnet/obs/memory.py): extract the compiled
    # train step's HBM budget (argument/output/temp/alias bytes —
    # donation-credited) into <train_dir>/memory.json once at first
    # dispatch, and sample live hbm_* gauges from device.memory_stats()
    # at log boundaries. Unlike mfu accounting the budget needs a
    # COMPILED program, so this pays ONE extra XLA compile at startup
    # (charged to the compile window, excluded from throughput);
    # failures degrade to absent, never kill training. Host-side only:
    # no compiled-program change, no new config-matrix rows.
    memory_ledger: bool = True
    # Comms ledger (tpu_resnet/obs/comms.py): extract the compiled train
    # step's collective-communication summary (op multiset, analytic
    # bytes-on-wire per mesh axis, predicted time-on-wire from the
    # per-chip ICI table) into <train_dir>/comms.json once at first
    # dispatch, plus a predicted_comms_fraction gauge. Pays ONE extra
    # XLA compile at startup, same contract as memory_ledger; degrades
    # to absent, never kills training. Host-side only.
    comms_ledger: bool = True


@dataclasses.dataclass
class ResilienceConfig:
    """Fault tolerance (tpu_resnet/resilience): recovery behavior and the
    deterministic fault-injection drill knobs. Recovery is ON by default —
    a preemptible-pod trainer that only recovers when asked recovers
    never; injection is OFF by default and costs nothing when off."""

    # SIGTERM/SIGINT → stop at the next chunk boundary, save a final
    # checkpoint, exit with preempt_exit_code (python -m
    # tpu_resnet_torch.tools.supervise resumes).
    graceful_shutdown: bool = True
    preempt_exit_code: int = 42  # resilience/exitcodes.py PREEMPTED
    # Non-finite loss at a log boundary (already host-synced there — zero
    # extra device syncs): roll back to the last checkpoint, advance the
    # data stream past the bad window, retry up to nan_max_retries times,
    # then raise DivergenceError.
    nan_guard: bool = True
    nan_max_retries: int = 2
    # No step progress for this many seconds → dump all-thread stacks to
    # <train_dir>/stall_stacks_N.txt and flip /healthz unhealthy until
    # progress resumes. 0 disables. Armed by the first completed dispatch,
    # so a long first compile can never false-trigger it.
    watchdog_stall_sec: float = 600.0
    # On an in-flight training-loop exception, attempt one guarded
    # ckpt.save(step, force=True) in the shutdown chain — a crash loses at
    # most the current interval, not everything since checkpoint_every.
    emergency_save: bool = True
    # Eval sidecar: retries (with exponential backoff) for a restore of a
    # just-committing checkpoint before the step is skipped-and-logged.
    eval_restore_retries: int = 3
    eval_restore_backoff_sec: float = 0.5
    # ---- fault injection (resilience/faultinject.py; drills only) ----
    # All off by default; TPU_RESNET_FAULT_{NAN_STEP,STALL_STEP,STALL_SEC,
    # SIGTERM_STEP,CORRUPT_CKPT,OOM_STEP} env vars override these fields.
    inject_nan_at_step: int = -1
    inject_stall_at_step: int = -1
    inject_stall_seconds: float = 0.0
    inject_sigterm_at_step: int = -1
    inject_corrupt_ckpt: bool = False
    # Raise a synthetic RESOURCE_EXHAUSTED (the XLA OOM status) at this
    # chunk boundary — the drill for the OOM-forensics path: the loop
    # must write <train_dir>/oom_report.json (ledger, gauge history,
    # live-array census) before re-raising (doctor --mem-probe).
    inject_oom_at_step: int = -1
    # Preemption burst: K SIGTERMs total ACROSS supervised restarts, each
    # fired inject_preempt_burst_every steps after its child's first
    # chunk boundary (count persisted in <train_dir>/fault_burst_state.
    # json — the firing kills the process that would remember it). The
    # deterministic drill for tools/supervise.py's downsize policy.
    inject_preempt_burst: int = 0
    inject_preempt_burst_every: int = 10
    # ---- serve-side faults (fleet chaos drills; docs/RESILIENCE.md) ----
    # Applied by the predict server (serve/server.py wraps the backend
    # infer / request admission). Env overrides: TPU_RESNET_FAULT_
    # {SERVE_SLOW_MS, SERVE_HANG_REQ, SERVE_KILL_REQ}.
    # Fixed extra latency per inference batch (slow-replica injection —
    # the router's passive latency tracking and hedging drill).
    inject_serve_slow_ms: float = 0.0
    # Accept requests normally, then hang the inference worker forever
    # starting at the Nth predict request (-1 off): the accept-then-hang
    # replica the router must evict on probe/deadline, not crash on.
    inject_serve_hang_at_request: int = -1
    # SIGKILL this serve process at the Nth predict request (-1 off):
    # the hard replica death mid-traffic the failover drill rides.
    inject_serve_kill_at_request: int = -1
    # Abruptly close the client connection (no HTTP response) at the Nth
    # predict request, once (-1 off): the router↔replica connection-drop
    # the router's retry-once failover must absorb without a client-
    # visible failure. Env override: TPU_RESNET_FAULT_SERVE_DROP_REQ.
    inject_serve_drop_at_request: int = -1


@dataclasses.dataclass
class ServeConfig:
    """Online inference server (tpu_resnet/serve; docs/SERVING.md).

    The serving shape the training side never needed: requests arrive one
    at a time, the hardware wants batches — the dynamic micro-batcher
    coalesces the request queue into a small set of bucketed batch shapes
    compiled ahead of time at startup, so no client mix ever triggers a
    mid-traffic recompile."""

    # HTTP port: 0 = OS-assigned ephemeral (recorded in
    # <train_dir>/serve.json like the telemetry discovery file), >0 fixed.
    port: int = 0
    host: str = "0.0.0.0"
    # "checkpoint": serve live weights from train.train_dir with
    # hot-reload (poll for new steps, atomic swap between batches).
    # "export": serve a frozen StableHLO bundle from ``export_dir``
    # (weights baked in — no reload; the .pb-serving analog).
    backend: str = "checkpoint"  # checkpoint | export
    export_dir: str = ""
    # Micro-batcher: coalesce queued requests until ``max_batch`` images
    # or ``max_wait_ms`` since the oldest queued request, whichever first.
    # max_wait_ms bounds the latency cost of batching for a lone request.
    max_batch: int = 16
    max_wait_ms: float = 5.0
    # Batch shapes compiled at startup. () = auto: powers of two up to
    # max_batch (1,2,4,...). Every batch pads up to the smallest bucket
    # that fits (pad fraction is exported as a gauge); requests larger
    # than max_batch are split across batches.
    batch_buckets: tuple = ()
    # Admission control: max requests queued ahead of the batcher. A full
    # queue rejects with HTTP 429 (backpressure) instead of letting the
    # tail latency grow without bound; a draining server rejects with 503.
    max_queue: int = 256
    # Hot-reload poll interval (checkpoint backend; 0 disables reload).
    # Restore retries/backoff reuse resilience.eval_restore_* — the same
    # mid-commit-checkpoint hazard the eval sidecar has.
    reload_interval_secs: float = 10.0
    # SIGTERM drain: stop accepting, flush the queue, then exit 0. After
    # this many seconds still-queued requests fail with 503 and the
    # server exits anyway (a second signal aborts immediately).
    drain_timeout_secs: float = 30.0
    # Latency ring: recent per-request latencies kept for the p50/p95/p99
    # gauges on /metrics.
    latency_ring: int = 1024
    # /healthz staleness for the SERVING heartbeat (the batcher loop
    # ticks it every batch and every idle tick, so any gap of seconds
    # means the inference worker is wedged). Much tighter than the
    # trainer's train.telemetry_stale_sec (300 s — sized for long
    # compiles): a hung replica must flip 503 fast enough that the
    # router's half-open probe cannot flap it back into rotation.
    healthz_stale_sec: float = 10.0
    # Colocation admission (resilience/elastic.py): estimated HBM bytes
    # this replica needs (weights + bucket activations). >0 gates startup
    # on the live device-memory gauges — a replica joining a trainer's
    # host starts only when the measured headroom fits it (exit code 3
    # when denied, so a scheduler can tell "no capacity here" from a
    # crash). 0 = no arbitration (single-tenant hosts).
    admission_hbm_bytes: int = 0
    # Fleet identity: when nonempty the discovery file is written as
    # <train_dir>/serve-<name>.json instead of serve.json, so N replicas
    # sharing one train_dir (same checkpoints, hot-reload in lockstep)
    # each announce their own port/pid and the router (serve/router.py)
    # discovers the whole fleet from one directory scan.
    replica_name: str = ""
    # Post-training quantization arm (ops/quant.py, serve/calibrate.py;
    # docs/SERVING.md "Quantized arm"). "int8": symmetric per-output-
    # channel int8 weight quantization + a calibrated per-tensor input
    # scale; the quantized tree is the PROGRAM ARGUMENT of a separate
    # registry program family (`_q8` key suffix), so buckets, AOT cache
    # entries, memory ledgers and golden twins all see it as its own
    # canonical program. Parity is gated (argmax >= 99% vs the f32/bf16
    # twin on the calibration set; tests/test_quant.py).
    quantize: str = "off"  # off | int8
    # Calibration (int8 only): N deterministic eval-split batches of
    # this size feed range collection; the result is digest-stamped into
    # <train_dir>/calibration.json and reused when present.
    calibration_batches: int = 4
    calibration_batch: int = 64


@dataclasses.dataclass
class RouteConfig:
    """Multi-replica serving router (tpu_resnet/serve/router.py;
    docs/SERVING.md "Serving fleet"). A stdlib-HTTP front that spreads
    /predict traffic over N serve replicas with active health probing,
    per-replica circuit breakers, bounded failover retries under a
    per-request deadline budget, optional hedged sends, and SLO-aware
    lane shedding — the production shape one replica process never had."""

    # Router HTTP port: 0 = OS-assigned ephemeral (recorded in
    # <discover_dir>/route.json), >0 fixed.
    port: int = 0
    host: str = "0.0.0.0"
    # Static replica list: base URLs ("http://127.0.0.1:8500", ...).
    # Named r0..rN-1 in rotation order. Empty = discovery only.
    replicas: tuple = ()
    # Discovery directory: scanned every probe round for the replicas'
    # serve.json / serve-<name>.json announcements (serve.replica_name).
    # A replica that restarts on a new port is re-resolved within one
    # probe interval. Also where route.json and route_events.jsonl land.
    discover_dir: str = ""
    # Active health: /healthz (+ /info queue depth) probed per replica
    # every probe_interval_secs with probe_timeout_secs. A killed or
    # hung replica is out of rotation within one probe interval.
    probe_interval_secs: float = 1.0
    probe_timeout_secs: float = 2.0
    # Circuit breaker: fail_threshold consecutive failures (probe or
    # passive request failures) open the circuit; after open_secs the
    # breaker goes half-open and the next successful probe readmits.
    fail_threshold: int = 2
    open_secs: float = 5.0
    # Per-request deadline budget (ms): the failover retry only fires
    # when enough budget remains, so a retry never blows the client SLO.
    # Clients can tighten per request with an X-Deadline-Ms header.
    deadline_ms: float = 10_000.0
    # Hedged sends: 0 = off (default). >0 = duplicate a request to a
    # second healthy replica after this many ms without a response;
    # -1 = auto (hedge at the router's rolling p99, floor 10 ms). First
    # response wins; gauged as route_hedges_total / route_hedge_wins.
    hedge_ms: float = 0.0
    # SLO-aware admission: 0 = shedding off. >0 = when the router's own
    # rolling p99 over the recent ring exceeds slo_ms, batch-lane
    # requests (X-Lane: batch) are shed with 429 + Retry-After; past
    # slo_ms * shed_hard_factor the interactive lane sheds too — never
    # queue-collapse, always an explicit retryable rejection.
    slo_ms: float = 0.0
    shed_hard_factor: float = 2.0
    # Recent end-to-end latencies kept for the rolling p50/p99 (the shed
    # and hedge signals, and the route_p99_ms gauge).
    latency_ring: int = 2048
    # Admin drain (route --drain NAME / POST /admin/drain): seconds to
    # wait for the drained replica's in-flight requests, then SIGTERM
    # (pid from its discovery record) and wait for the replica's drain.
    drain_timeout_secs: float = 30.0
    # Merit-gated dynamic membership (route --watch-discovery): a
    # replica whose discovery record APPEARS after router boot enters
    # rotation only after its first successful health probe (a
    # "pending" probation), instead of the default blind admission with
    # a fresh closed breaker. The autoscaler path relies on this: a
    # freshly spawned replica must not receive traffic before it has
    # proven /healthz once.
    watch_discovery: bool = False


@dataclasses.dataclass
class FleetConfig:
    """Fleet telemetry aggregator (tpu_resnet/obs/fleet.py;
    docs/OBSERVABILITY.md "Fleet"). ``fleetmon`` is a jax-free
    control-plane process that discovers every serving/telemetry
    endpoint from the discovery files in one directory, scrapes all
    /metrics on an interval into an append-only on-disk timeseries,
    merges per-replica latency histograms bucket-wise into true fleet
    percentiles, and tracks SLO error-budget burn rates — the sensor a
    future autoscaler reads."""

    # fleetmon's own HTTP port: 0 = OS-assigned ephemeral (recorded in
    # <discover_dir>/fleetmon.json), >0 fixed, <0 disabled.
    port: int = 0
    host: str = "0.0.0.0"
    # Directory scanned for serve*.json / route.json / telemetry*.json
    # announcements. "" = train.train_dir (the colocated default).
    discover_dir: str = ""
    # Scrape cadence and per-endpoint timeout.
    scrape_interval_secs: float = 2.0
    scrape_timeout_secs: float = 2.0
    # Fleet latency SLO: requests slower than slo_ms spend error budget.
    # 0 disables burn tracking (scraping/merging still runs).
    slo_ms: float = 0.0
    # Fraction of requests that must meet the SLO (0.999 = 0.1% budget).
    slo_target: float = 0.999
    # Multiwindow burn-rate alerting (the SRE-workbook shape): the alert
    # fires only when BOTH windows burn hot — the fast window catches
    # the spike, the slow window keeps a transient blip from paging.
    fast_window_secs: float = 60.0
    slow_window_secs: float = 600.0
    burn_alert_fast: float = 14.0
    burn_alert_slow: float = 6.0
    # Scrape rounds kept in memory for windowed burn math (the on-disk
    # timeseries is unbounded/append-only; this ring only needs to span
    # slow_window_secs of rounds).
    ring: int = 4096


@dataclasses.dataclass
class AutopilotConfig:
    """Traffic-driven autoscaling control plane (tpu_resnet/autopilot/;
    docs/AUTOPILOT.md). ``tpu_resnet autopilot`` is a jax-free control
    process that scrapes the router + fleetmon signal plane, feeds a
    deterministic target-replica policy (hysteresis bands, cooldowns,
    min/max bounds, step limits — a pure function of one signal
    snapshot, so recorded traces replay bit-identically), and actuates
    through the existing contracts: scale-up spawns a replica via the
    supervise/discovery path (colocation-admission exit 3 is a policy
    input, not a crash), scale-down drains via the router's
    /admin/drain rolling contract."""

    # Autopilot's own telemetry port: 0 = OS-assigned ephemeral
    # (recorded in <discover_dir>/autopilot.json), >0 fixed,
    # <0 disabled.
    port: int = 0
    host: str = "0.0.0.0"
    # Directory holding the fleet's discovery files (route.json,
    # fleetmon.json, serve-<name>.json) — also where the decision
    # ledger autopilot_events.jsonl and autopilot_status.json land.
    # "" = train.train_dir (the colocated default).
    discover_dir: str = ""
    # Control-loop cadence and per-scrape HTTP timeout.
    poll_interval_secs: float = 1.0
    scrape_timeout_secs: float = 2.0
    # Replica-count bounds the policy can never leave.
    min_replicas: int = 1
    max_replicas: int = 4
    # Latency SLO the policy scales against, ms. 0 = adopt the router's
    # advertised route.slo_ms from its /info (the usual colocated case).
    slo_ms: float = 0.0
    # Hysteresis bands as fractions of the SLO: p99 above
    # slo*up_band is scale-up pressure, p99 below slo*down_band is
    # scale-down pressure, and the corridor between them is a hold — a
    # p99 oscillating around one threshold can never flap the fleet.
    up_band: float = 0.9
    down_band: float = 0.5
    # Consecutive pressured rounds required before acting (the second
    # anti-flap stage: one noisy scrape is never a decision).
    up_rounds: int = 2
    down_rounds: int = 5
    # Non-latency scale-up pressure: total queued requests per healthy
    # replica (router /info), and the fleetmon fast-window burn rate.
    queue_high: float = 8.0
    burn_high: float = 6.0
    # Cooldowns (seconds of snapshot time) after an actuation before
    # the same direction may fire again. Scale-down is deliberately the
    # longer one: adding capacity is cheap, thrashing drains is not.
    scale_up_cooldown_secs: float = 10.0
    scale_down_cooldown_secs: float = 60.0
    # Per-decision step limits (replicas added/removed at once).
    max_step_up: int = 1
    max_step_down: int = 1
    # After a spawn exits with the colocation-admission NO_CAPACITY
    # code (3), hold all scale-ups this long — this host said no, and
    # asking again immediately would just be denied again.
    admission_backoff_secs: float = 30.0
    # Replica spawn command template, shlex-split; "" = observe-only
    # mode (decisions are ledgered and gauged but nothing is spawned or
    # drained). Placeholders: {python} -> sys.executable, {name} -> the
    # replica name the actuator minted (serve.replica_name={name} makes
    # the new replica discoverable), {i} -> the spawn ordinal.
    spawn_cmd: str = ""
    # Wrap spawns in tpu_resnet_torch.tools.supervise --stop-codes 3 so
    # crashes restart with decorrelated-jitter backoff while the
    # admission verdict stays terminal (and observable as the wrapper's
    # exit 3).
    spawn_supervised: bool = True
    # Names minted for autopilot-spawned replicas: <prefix><ordinal>.
    replica_prefix: str = "ap"
    # Budget (seconds) for spawn -> healthy-in-router; a spawn that
    # blows it is abandoned (process terminated, slot released) and
    # counted as a spawn failure. This is the advertised scale-up
    # latency the autoscale scenarios gate.
    ready_timeout_secs: float = 120.0
    # Capacity handoff: on scale-down write <dir>/capacity_lease.json
    # granting the freed capacity to a colocated trainer; the next
    # scale-up revokes the lease BEFORE spawning (docs/AUTOPILOT.md
    # "Capacity handoff").
    capacity_lease: bool = True


@dataclasses.dataclass
class ProgramsConfig:
    """Compiled-program registry (tpu_resnet/programs/registry.py;
    docs/PERF.md "Cold start"). One owner for the canonical program-key
    spelling and the persistent cross-process AOT executable cache that
    kills cold-start compiles across serve-replica restarts, elastic
    resume, and repeated sweep points."""

    # "auto" (default): the cache is ON for serve replicas (cold start
    # IS their cost model — the rolling-upgrade window) and ON for
    # train/eval/sweep only when a cache directory is configured here or
    # via TPU_RESNET_PROGRAM_CACHE_DIR. "on" forces it everywhere
    # (directory defaults to <train_dir>/progcache); "off" disables.
    # The TPU_RESNET_PROGRAM_CACHE=0 env kill-switch overrides all of
    # this — the operator's hard off-switch when a jaxlib's executable
    # deserialization is suspect (a wrong-result incident class; the cache
    # additionally fingerprint-verifies every entry and never
    # deserializes the same entry twice in one process).
    cache: str = "auto"  # auto | on | off
    # "" = <train_dir>/progcache when the cache is enabled. Replicas and
    # restarts sharing one train_dir share entries; a shared explicit
    # dir is the sweep/fleet-wide lever.
    cache_dir: str = ""


@dataclasses.dataclass
class RunConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    resilience: ResilienceConfig = dataclasses.field(
        default_factory=ResilienceConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    route: RouteConfig = dataclasses.field(default_factory=RouteConfig)
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    autopilot: AutopilotConfig = dataclasses.field(
        default_factory=AutopilotConfig)
    programs: ProgramsConfig = dataclasses.field(
        default_factory=ProgramsConfig)

    # ---------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=list)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RunConfig":
        cfg = cls()
        for section_name, section_val in d.items():
            section = getattr(cfg, section_name)
            for k, v in section_val.items():
                if not hasattr(section, k):
                    raise ValueError(f"unknown config field {section_name}.{k}")
                cur = getattr(section, k)
                if isinstance(cur, tuple) and isinstance(v, list):
                    v = tuple(v)
                setattr(section, k, v)
        return cfg

    # ------------------------------------------------------------------- CLI
    def apply_overrides(self, overrides: Sequence[str]) -> "RunConfig":
        """Apply ``section.field=value`` strings (the CLI surface)."""
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"override must be section.field=value: {ov!r}")
            key, raw = ov.split("=", 1)
            parts = key.lstrip("-").split(".")
            if len(parts) != 2:
                raise ValueError(f"override key must be section.field: {key!r}")
            section_name, field = parts
            section = getattr(self, section_name, None)
            if section is None or not hasattr(section, field):
                raise ValueError(f"unknown config field {key!r}")
            cur = getattr(section, field)
            setattr(section, field, _parse_value(raw, cur))
        return self


def _parse_value(raw: str, current: Any) -> Any:
    if isinstance(current, bool):
        if raw.lower() in ("1", "true", "yes"):
            return True
        if raw.lower() in ("0", "false", "no"):
            return False
        raise ValueError(f"bad bool {raw!r}")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        s = raw.strip()
        if s.startswith("(") and s.endswith(")"):  # accept Python-style
            s = "[" + s[1:-1].rstrip(",") + "]"    # tuples, not just JSON
        return tuple(json.loads(s))
    return raw


# ---------------------------------------------------------------- presets
def _cifar_local() -> RunConfig:
    """Reference 'local' config: ResNet-50(6n+2) CIFAR-10, batch 128,
    piecewise LR, ~80k steps → 93.6% (README.md:28)."""
    cfg = RunConfig()
    cfg.data.dataset = "cifar10"
    cfg.model.resnet_size = 50
    cfg.optim.schedule = "cifar_piecewise"
    cfg.optim.weight_decay = 0.0002
    cfg.train.train_steps = 90_000
    cfg.train.global_batch_size = 128
    return cfg


def _cifar100() -> RunConfig:
    cfg = _cifar_local()
    cfg.data.dataset = "cifar100"
    return cfg


def _wrn_28_10_cifar100() -> RunConfig:
    """Wide-ResNet-28-10 on CIFAR-100 (BASELINE.json configs[3])."""
    cfg = _cifar_local()
    cfg.data.dataset = "cifar100"
    cfg.model.resnet_size = 28
    cfg.model.width_multiplier = 10
    cfg.optim.weight_decay = 0.0005
    return cfg


def _imagenet() -> RunConfig:
    """ResNet-50 ImageNet, Intel-Caffe 8-node recipe: global batch 1024,
    warmup 0.1→0.4 over 6240 steps then /10 at 37440/74880/99840, weight
    decay 1e-4, 90 epochs = 112600 steps
    (resnet_imagenet_train.py:236-260, submit_imagenet_daint_dist.sh:38-40)."""
    cfg = RunConfig()
    cfg.data.dataset = "imagenet"
    cfg.model.resnet_size = 50
    cfg.optim.schedule = "imagenet_warmup"
    cfg.optim.weight_decay = 1e-4
    cfg.train.train_steps = 112_600
    cfg.train.global_batch_size = 1024
    cfg.train.eval_batch_size = 125
    return cfg


def _smoke() -> RunConfig:
    """Laptop-scale smoke config — the reference's only integration test
    (mkl-scripts/submit_mac_dist.sh: batch 10, 100 steps)."""
    cfg = RunConfig()
    cfg.data.dataset = "synthetic"
    cfg.model.resnet_size = 8
    cfg.model.compute_dtype = "float32"
    cfg.train.train_steps = 100
    cfg.train.global_batch_size = 16
    cfg.train.checkpoint_every = 50
    cfg.optim.schedule = "constant"
    cfg.optim.base_lr = 0.01
    return cfg


# The supported config space (these presets × mesh/dtype/fused/remat/
# engine variations) is certified statically: tpu_resnet/analysis/
# configmatrix.py traces the compiled train/eval program of every
# combination in its MATRIX and pins it to a golden jaxpr hash, and the
# unsupported combinations are must-raise entries there. Adding a field
# here that changes the compiled step means adding/regenerating matrix
# rows (`python -m tpu_resnet check --update-golden`; docs/CHECKS.md).
PRESETS = {
    "cifar10": _cifar_local,
    "cifar100": _cifar100,
    "wrn28_10_cifar100": _wrn_28_10_cifar100,
    "imagenet": _imagenet,
    "smoke": _smoke,
}


def load_config(preset: str = "", config_file: str = "",
                overrides: Sequence[str] = ()) -> RunConfig:
    if preset:
        if preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r}; have {sorted(PRESETS)}")
        cfg = PRESETS[preset]()
    elif config_file:
        with open(config_file) as f:
            cfg = RunConfig.from_dict(json.load(f))
    else:
        cfg = RunConfig()
    return cfg.apply_overrides(overrides)


def build_arg_parser(description: str = "") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--preset", default="", help=f"one of {sorted(PRESETS)}")
    p.add_argument("--config", default="", help="JSON config file")
    p.add_argument("overrides", nargs="*",
                   help="section.field=value overrides")
    return p
