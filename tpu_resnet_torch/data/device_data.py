"""Device-resident training split (port of ``tpu_resnet/data/device_data.py``).

An in-memory split small enough to keep twice on the device (the flat
split and one shuffled epoch) is copied there once, as uint8, and every
batch is cut on the device: no per-step host-to-device copy of images.

The order is the reference's: epoch ``e`` is
``jax.random.permutation(fold_in(PRNGKey(seed), e), n)`` cut to
``steps_per_epoch · B`` indices, computed on the host with
``data/prng.py``'s numpy copy of ``jax.random`` (a few ms for n = 50 000)
and applied with one ``index_select`` per epoch on the device. Step ``s``
takes slice ``s % steps_per_epoch`` of epoch ``s // steps_per_epoch``, so
a run resumed at any step gets the batch the uninterrupted run got.

:class:`ChunkRunner` is the port of the reference's multi-step dispatch
(``make_chunk_fn``, ``compile_staged_stream_steps`` and
``compile_resident_steps``): it runs a chunk of ``c <= steps_per_call``
steps, from the resident split (``run``), from a staged superbatch
(``run_staged``) or from a list of batches on the device
(``run_batches``). The reference fuses a chunk with ``lax.scan`` into one
XLA program; on CUDA with ``steps_per_call > 1`` the runner's chunk is
``c`` replays of one CUDA graph of the train step, with no host read
inside the chunk:

- the step's inputs live in static slots on the device: the uint8
  images, the labels, the learning rate (a 0-dim float32 tensor) and the
  augmentation draws; its outputs (loss, precision, learning_rate,
  grad_norm) are the graph's own tensors;
- the host computes a chunk's learning rates (``schedule(step)``) and
  draws (the reference's, ``data/augment.py``) and writes them into one of
  two pinned staging buffers as ``[c, ...]`` rows, copied to the device
  once per chunk; before each replay the step's batch (a view of the
  epoch buffer, a row of a superbatch, or a batch of the decode engine)
  and its rows are copied into the slots on the current stream. The slots
  are never rebound;
- the first ``WARMUP_STEPS`` steps of the run are run eagerly on a side
  stream, on the slots, so that everything the capture must not create
  exists: the kernel builds, cuDNN's plans, the momentum buffers (made at
  the first step), ``sbr_bwd``'s tickets for the capture stream. Then the
  step is captured on that stream (one graph for every ``c``: a chunk is
  its replays) and replayed on the current stream;
- the kernels' launch counters are Python ints that a replay never moves:
  the increments made while capturing are taken back and added once per
  replay, so the counts mean launches as in the eager step.

Across ranks the captured step holds its NCCL collectives (the warm-up
steps open the communicators before the capture); gloo's cannot be
captured, so a gloo group's ranks run their chunks eagerly.

The metrics of a chunk are its last step's, copied out of the graph, as
the reference's are the scan's last. A chunk never crosses an epoch
boundary of the resident split (the loop's ``_chunk_len`` clips it; the
runner raises otherwise). On the CPU, or with ``steps_per_call = 1``, the
runner runs the chunk's steps eagerly, one call each, with the same chunk
boundaries.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_resnet_torch.data import prng
from tpu_resnet_torch.parallel import multihost
from tpu_resnet_torch.train.step import TrainStep

RESIDENT_DATASETS = ("cifar10", "cifar100", "synthetic")


def should_use(data_cfg) -> bool:
    """True when the resident path applies: policy ``on``/``auto``, an
    in-memory dataset, and a split small enough for double residency (flat
    split + epoch buffer) under ``data.resident_max_bytes``. Policy ``on``
    raises where the path is impossible rather than silently streaming.
    The port runs one process, so the reference's multi-process refusal
    never applies."""
    policy = getattr(data_cfg, "device_resident", "auto")
    if policy == "off":
        return False
    forced = policy == "on"
    if data_cfg.dataset not in RESIDENT_DATASETS:
        if forced:
            raise ValueError(
                f"data.device_resident=on is unsupported for dataset "
                f"{data_cfg.dataset!r} (streams from TFRecord shards)")
        return False
    size = data_cfg.resolved_image_size
    nbytes = 2 * data_cfg.train_examples * size * size * 3
    return forced or nbytes <= data_cfg.resident_max_bytes


class DeviceDataset:
    """A training split resident on ``device`` with the reference's
    per-epoch order. ``rows = (lo, hi)`` keeps a rank's rows of each
    global batch of ``batch`` (``parallel.Mesh.rank_rows``): every rank
    computes the epoch's order, a pure function of (seed, epoch), and its
    epoch buffer holds its own rows only."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch: int,
                 device: torch.device, seed: int = 0,
                 rows: Optional[Tuple[int, int]] = None):
        n = len(images)
        if n < batch:  # tile tiny (smoke/synthetic) splits up to one batch
            reps = -(-batch // n)
            images = np.concatenate([images] * reps)
            labels = np.concatenate([labels] * reps)
            n = len(images)
        self.n = n
        self.batch = batch
        self.rows = rows or (0, batch)
        self.steps_per_epoch = n // batch
        self.seed = seed
        self.device = torch.device(device)
        self._images = torch.from_numpy(np.ascontiguousarray(images)).to(
            self.device)
        self._labels = torch.from_numpy(labels.astype(np.int32)).to(
            self.device)
        self._epoch: Optional[int] = None
        self.images = self.labels = None

    def order(self, epoch: int) -> np.ndarray:
        """Epoch ``epoch``'s indices into the split, int32
        [steps_per_epoch · batch]."""
        key = prng.fold_in(prng.prng_key(self.seed), epoch)
        return prng.permutation(key, self.n)[:self.steps_per_epoch
                                             * self.batch]

    def ensure_epoch(self, epoch: int) -> None:
        """(Re)build the shuffled epoch buffer if ``epoch`` changed."""
        if epoch != self._epoch:
            lo, hi = self.rows
            order = self.order(epoch).reshape(self.steps_per_epoch,
                                              self.batch)[:, lo:hi]
            idx = torch.from_numpy(order.reshape(-1).astype(np.int64)).to(
                self.device)
            self.images = self._images.index_select(0, idx)
            self.labels = self._labels.index_select(0, idx)
            self._epoch = epoch

    def batch_at(self, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Step ``step``'s (uint8 images [b,H,W,3], int32 labels [b]) on
        the device, this rank's ``b`` rows: views into the epoch buffer."""
        self.ensure_epoch(step // self.steps_per_epoch)
        b = self.rows[1] - self.rows[0]
        lo = (step % self.steps_per_epoch) * b
        return self.images[lo:lo + b], self.labels[lo:lo + b]


# Eager steps on the capture stream before the train step is captured: the
# first makes the momentum buffers, the second runs the code path the graph
# records.
WARMUP_STEPS = 2


def launch_counters() -> List[Tuple[object, str]]:
    """(module, name) of every kernel launch counter of the port's ops."""
    from tpu_resnet_torch.ops import epilogue, fused_block, fused_bottleneck
    from tpu_resnet_torch.ops import softmax_xent, wgrad
    return [(mod, name) for mod in (epilogue, fused_block, fused_bottleneck,
                                    softmax_xent, wgrad)
            for name, value in sorted(vars(mod).items())
            if name.endswith("launches") and type(value) is int]


class ChunkRunner:
    """Runs chunks of at most ``steps_per_call`` train steps of
    ``train_step`` (see the module docstring): CUDA graph replays on CUDA
    when ``steps_per_call > 1``, eager steps otherwise. ``ds`` is the
    resident split :meth:`run` reads. ``record_steps`` keeps a copy of
    every step's metrics in ``recorded`` (on the device, no host read), not
    only each chunk's last."""

    def __init__(self, train_step, device, steps_per_call: int,
                 ds: Optional[DeviceDataset] = None,
                 record_steps: bool = False):
        self.train_step = train_step
        self.device = torch.device(device)
        self.steps_per_call = max(1, int(steps_per_call))
        self.ds = ds
        self.graphed = (self.device.type == "cuda"
                        and self.steps_per_call > 1
                        and multihost.capturable_collectives())
        if self.graphed and not isinstance(train_step, TrainStep):
            raise ValueError(
                f"train.steps_per_call={self.steps_per_call} on CUDA replays "
                f"a captured train step, and {train_step!r} is not a "
                f"capturable TrainStep; train.steps_per_call=1 runs it "
                f"eagerly")
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_seconds: Optional[float] = None
        self.replays = 0
        self.record_steps = record_steps
        self.recorded: List[Dict[str, torch.Tensor]] = []
        self._warmed = 0
        self._state = None
        self._slots = None          # images, labels, lr, *draws
        self._out: Dict[str, torch.Tensor] = {}
        self._increments: Dict[Tuple[object, str], int] = {}
        self._staging = None        # two pinned sets of [k, ...] rows
        self._staged = None         # their device copy
        self._turn = 0
        # The warm-up and capture stream. PyTorch hands out streams from a
        # pool, so another stream of the program (a decode worker's, the
        # double buffer's copies) may be this very stream, and its work
        # would join the capture: take it from the high-priority pool, which
        # nothing else in the port draws from.
        self._stream = (torch.cuda.Stream(self.device, priority=-1)
                        if self.graphed else None)

    # ------------------------------------------------------------ entries
    def run(self, state, step: int, c: int) -> Dict[str, torch.Tensor]:
        """Steps ``step .. step + c`` from the resident split; ``step`` is
        the loop's step counter and must equal ``state.step``."""
        ds = self.ds
        self._check_len(c)
        if step != state.step:
            raise ValueError(f"chunk at step {step}, state at {state.step}")
        off = step % ds.steps_per_epoch
        if off + c > ds.steps_per_epoch:
            raise ValueError(f"chunk [{step}, {step + c}) crosses the epoch "
                             f"boundary (steps_per_epoch="
                             f"{ds.steps_per_epoch})")
        return self._run(state, c, lambda i: ds.batch_at(step + i))

    def run_staged(self, state, gi, gl, off: int,
                   c: int) -> Dict[str, torch.Tensor]:
        """Rows ``off .. off + c`` of a staged superbatch (``gi``, ``gl``:
        [stage, B, ...] tensors, or rows that give a batch each); each row
        is read when its step comes."""
        return self._run(state, c, lambda i: (gi[off + i], gl[off + i]))

    def run_batches(self, state, batches: Sequence[Tuple[torch.Tensor,
                                                         torch.Tensor]]
                    ) -> Dict[str, torch.Tensor]:
        """One step per (images, labels) batch on the device, in order;
        returns the last step's metrics."""
        return self._run(state, len(batches), lambda i: batches[i])

    def _run(self, state, c: int, batch_at) -> Dict[str, torch.Tensor]:
        """``c`` steps, step i on ``batch_at(i)`` (read when the step comes,
        after the step before it was queued)."""
        self._check_len(c)
        if not self.graphed:
            for i in range(c):
                m = self.train_step(state, *batch_at(i))
                self._record(m)
            return m
        return self._run_graphed(state, c, batch_at)

    def _check_len(self, c: int) -> None:
        if not 0 < c <= self.steps_per_call:
            raise ValueError(f"a chunk of {c} steps; train.steps_per_call="
                             f"{self.steps_per_call}")

    def close(self) -> None:
        """Drop the graph and the gradients it wrote (its memory pool)."""
        self.graph = None
        if self._state is not None:
            self._state.optimizer.zero_grad(set_to_none=True)
        self._state = None
        self._slots = self._staging = self._staged = None
        self._out = {}
        self._warmed = 0

    # ------------------------------------------------------------- graphs
    def _run_graphed(self, state, c: int,
                     batch_at) -> Dict[str, torch.Tensor]:
        if self._state is not None and state is not self._state:
            raise ValueError("the runner's graph was captured on another "
                             "train state")
        batch = batch_at(0)
        hosts = [self.train_step.host_inputs(state.step + i,
                                             batch[0].shape[0])
                 for i in range(c)]
        if self._slots is None:
            self._make_slots(*batch, hosts[0][1])
        rows = self._stage_rows(hosts)
        images, labels, lr, *draws = self._slots
        cur = torch.cuda.current_stream(self.device)
        m = None
        for i in range(c):
            im, lb = batch if i == 0 else batch_at(i)
            # A float batch of the slots' shape on an integer stream is the
            # fault injector's NaN batch: one eager step, no recapture.
            fits = im.shape == images.shape and im.dtype == images.dtype
            poisoned = (im.shape == images.shape
                        and im.dtype.is_floating_point
                        and not images.dtype.is_floating_point)
            if not (fits or poisoned) or (
                    lb.shape != labels.shape or lb.dtype != labels.dtype):
                raise ValueError(
                    f"batch {tuple(im.shape)} {im.dtype} / labels "
                    f"{tuple(lb.shape)} {lb.dtype} does not fit the "
                    f"captured step's slots {tuple(images.shape)} "
                    f"{images.dtype} / {tuple(labels.shape)} {labels.dtype}")
            if not poisoned:
                images.copy_(im)
            labels.copy_(lb)
            for slot, staged in zip((lr, *draws), rows):
                slot.copy_(staged[i])
            if poisoned:
                self._stream.wait_stream(cur)
                with torch.cuda.stream(self._stream):
                    m = self.train_step.core(state, im, labels, lr, *draws)
                cur.wait_stream(self._stream)
            elif self.graph is None and self._warmed < WARMUP_STEPS:
                self._stream.wait_stream(cur)
                with torch.cuda.stream(self._stream):
                    m = self.train_step.core(state, *self._slots)
                cur.wait_stream(self._stream)
                self._warmed += 1
            else:
                if self.graph is None:
                    self._capture(state)
                self.graph.replay()
                self.replays += 1
                for (mod, name), n in self._increments.items():
                    setattr(mod, name, getattr(mod, name) + n)
                m = self._out
            state.step += 1
            self._record(m)
        return {k: v.clone() for k, v in m.items()}

    def _record(self, m) -> None:
        if self.record_steps:
            self.recorded.append({k: torch.as_tensor(v).clone()
                                  for k, v in m.items()})

    def _make_slots(self, images, labels, draws) -> None:
        dev = self.device
        self._slots = [torch.empty_like(images, device=dev),
                       torch.empty_like(labels, device=dev),
                       torch.empty((), dtype=torch.float32, device=dev),
                       *(torch.empty(d.shape, device=dev,
                                     dtype=torch.from_numpy(d).dtype)
                         for d in draws)]
        k = self.steps_per_call
        shapes = [((k,), torch.float32)] + [
            ((k, *d.shape), torch.from_numpy(d).dtype) for d in draws]
        self._staging = [[[torch.empty(shape, dtype=dt, pin_memory=True)
                           for shape, dt in shapes], None]
                         for _ in range(2)]
        self._staged = [torch.empty(shape, dtype=dt, device=dev)
                        for shape, dt in shapes]

    def _stage_rows(self, hosts) -> List[torch.Tensor]:
        """The chunk's learning rates and draws as ``[c, ...]`` rows on the
        device: written into one of two pinned buffers (waiting until the
        copy that last read it is done), then copied once."""
        pinned, done = self._staging[self._turn]
        if done is not None:
            done.synchronize()
        c = len(hosts)
        pinned[0].numpy()[:c] = [lr for lr, _ in hosts]
        for j, buf in enumerate(pinned[1:]):
            buf.numpy()[:c] = [draws[j] for _, draws in hosts]
        for src, dst in zip(pinned, self._staged):
            dst[:c].copy_(src[:c], non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._staging[self._turn][1] = done
        self._turn ^= 1
        return [t[:c] for t in self._staged]

    def _capture(self, state) -> None:
        """Capture ``core`` on the slots, on the warm-up stream."""
        from tpu_resnet_torch.ops import autotune
        from tpu_resnet_torch.ops import epilogue as ep

        counters = launch_counters()
        before = [getattr(mod, name) for mod, name in counters]
        tickets = set(ep._bwd_tickets)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                out = self.train_step.core(state, *self._slots)
        except autotune.UnprobedUnderCapture:
            raise
        except Exception as e:
            raise RuntimeError(
                f"the train step could not be captured as a CUDA graph "
                f"({type(e).__name__}: {e}); train.steps_per_call=1 runs "
                f"it eagerly") from e
        finally:
            after = [getattr(mod, name) for mod, name in counters]
            for (mod, name), n in zip(counters, before):
                setattr(mod, name, n)
        if set(ep._bwd_tickets) != tickets:
            raise RuntimeError("sbr_bwd's tickets for the capture stream "
                               "were made inside the capture; the warm-up "
                               "must make them")
        self.capture_seconds = time.perf_counter() - t0
        self._increments = {key: a - b for key, a, b in
                            zip(counters, after, before) if a != b}
        self.graph, self._out, self._state = graph, out, state
