"""Host side of the input pipeline, one process (port of the single-process
part of ``tpu_resnet/data/pipeline.py``).

``ShardedBatcher`` gives the reference's streaming order bit for bit: the
shuffle of each epoch is ``np.random.default_rng((seed, epoch))
.permutation``, so the stream is a pure function of (seed, step) and a
resumed run fast-forwards to its step without replaying batches.
``BackgroundIterator`` runs a source in a daemon thread with a bounded
queue; the train loop copies each batch to the device and augments it
there.

Staged transfer (the reference's ``data.transfer_stage``): with a stage of
``k`` > 1, ``k`` batches are stacked into one ``[k, B, ...]`` superbatch
in pinned host memory and copied to the device in one transfer, and the
loop runs their steps as chunks (``device_data.ChunkRunner``).
:func:`staged_superbatch_prefetch` does it on the consumer's thread and
stream, ``depth`` superbatches ahead; :class:`DoubleBufferedH2D`
(``data.h2d_double_buffer``) on a producer thread and a copy stream of
its own, into an explicit two-slot device buffer ordered with events.
Both yield ``(images [k, B, ...], labels [k, B], k)``, a final partial
stage with its true ``k``, and their superbatches hold exactly the
unstaged stream's batches. :func:`device_stages` groups batches that are
already on the device (the decode engine's) the same way, without a copy,
each taken from the engine when its step comes.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

Batch = Tuple[np.ndarray, np.ndarray]

# How long the consumer's get() waits between producer-liveness checks, and
# how long an erroring producer tries the ordered put before freeing a slot.
GET_POLL_SEC = 1.0
ERROR_PUT_TIMEOUT_SEC = 2.0


class ShardedBatcher:
    """Infinite shuffled batches over a per-process shard of an in-memory
    array source, in the reference's order: process ``i`` of ``n`` owns
    records ``i, i+n, i+2n, …``. ``rows = (lo, hi)`` yields rows
    ``lo:hi`` of each of the process's batches (a rank's rows)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 local_batch: int, seed: int = 0, start_step: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 rows=None):
        self.images = images[process_index::process_count]
        self.labels = labels[process_index::process_count]
        self.rows = rows or (0, local_batch)
        self.local_batch = local_batch
        self.seed = seed
        self.n = len(self.images)
        if self.n < local_batch:
            reps = -(-local_batch // self.n)
            self.images = np.concatenate([self.images] * reps)
            self.labels = np.concatenate([self.labels] * reps)
            self.n = len(self.images)
        self.start_step = start_step

    def __iter__(self) -> Iterator[Batch]:
        batches_per_epoch = self.n // self.local_batch
        epoch = self.start_step // batches_per_epoch
        pos = (self.start_step % batches_per_epoch) * self.local_batch
        order = np.random.default_rng((self.seed, epoch)).permutation(self.n)
        epoch += 1
        while True:
            if pos + self.local_batch > self.n:
                order = np.random.default_rng(
                    (self.seed, epoch)).permutation(self.n)
                epoch += 1
                pos = 0
            idx = order[pos:pos + self.local_batch][slice(*self.rows)]
            pos += self.local_batch
            yield self.images[idx], self.labels[idx]


def eval_batches(images: np.ndarray, labels: np.ndarray,
                 batch: int) -> Iterator[Batch]:
    """Sequential full pass; the last partial batch is zero-padded with
    labels -1."""
    n = len(images)
    for start in range(0, n, batch):
        img = images[start:start + batch]
        lab = labels[start:start + batch]
        if len(img) < batch:
            pad = batch - len(img)
            img = np.concatenate([img, np.zeros((pad,) + img.shape[1:],
                                                img.dtype)])
            lab = np.concatenate([lab, np.full((pad,), -1, lab.dtype)])
        yield img, lab


class BackgroundIterator:
    """Runs an iterator in a daemon thread with a bounded queue.

    ``external_stop``: an event whose set() ends iteration at the consumer
    within ~GET_POLL_SEC even while the producer is stalled, so a graceful
    stop never waits on a dead source. A producer error is raised at the
    consumer; a producer that dies without one raises RuntimeError."""

    def __init__(self, it: Iterator, capacity: int = 4,
                 external_stop: Optional[threading.Event] = None):
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._it = it
        self._stop = threading.Event()
        self._external_stop = external_stop
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                if not self._put(item):
                    return
        except Exception as e:  # surface loader errors to the consumer
            # Never deadlock against a full queue: keep the order when
            # there is room, else drop the buffered batches (the error is
            # terminal) and enqueue the exception into the freed slot.
            try:
                self._q.put(e, timeout=ERROR_PUT_TIMEOUT_SEC)
            except queue.Full:
                self._drain()
                try:
                    self._q.put_nowait(e)
                except queue.Full:  # pragma: no cover - sole producer
                    pass
            return
        self._put(StopIteration)

    def _put(self, item) -> bool:
        """Stop-aware bounded put; False when close() was requested."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def close(self):
        """Release the producer thread and its buffered items."""
        self._stop.set()
        self._drain()
        self._thread.join(timeout=5)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=GET_POLL_SEC)
                break
            except queue.Empty:
                if (self._external_stop is not None
                        and self._external_stop.is_set()):
                    raise StopIteration
                if self._thread.is_alive():
                    continue
                try:
                    item = self._q.get_nowait()
                    break
                except queue.Empty:
                    raise RuntimeError(
                        "BackgroundIterator producer thread died without "
                        "yielding a result or an error") from None
        if item is StopIteration:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item


def _stack(batches) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[(images, labels), ...]`` host arrays → (images [k, ...], labels
    [k, ...]) CPU tensors, pinned when CUDA is there to copy them (a
    batch of another dtype, e.g. a poisoned float one, promotes the
    superbatch as ``np.stack`` does)."""
    out = []
    for arrays in zip(*batches):
        stacked = np.stack(arrays)
        t = torch.from_numpy(stacked)
        if torch.cuda.is_available():
            t = torch.empty(t.shape, dtype=t.dtype,
                            pin_memory=True).copy_(t)
        out.append(t)
    return out[0], out[1]


def _take(it: Iterator, stage: int) -> list:
    """Up to ``stage`` items of ``it`` (fewer at its end)."""
    items = []
    for item in it:
        items.append(item)
        if len(items) == stage:
            break
    return items


def staged_superbatch_prefetch(host_iter: Iterator[Batch], device,
                               stage: int = 4, depth: int = 2
                               ) -> Iterator[Tuple[torch.Tensor,
                                                   torch.Tensor, int]]:
    """Copy ``stage`` host batches per transfer to ``device`` and yield the
    whole ``(k, B, ...)`` superbatch plus its true length ``k``, ``depth``
    transfers ahead; a final partial stage of a finite stream is yielded
    with its true k. On CUDA the copies are asynchronous, from pinned
    memory, on the consumer's current stream."""
    device = torch.device(device)
    it = iter(host_iter)

    def load():
        batches = _take(it, stage)
        if not batches:
            raise StopIteration
        images, labels = _stack(batches)
        return (images.to(device, non_blocking=True),
                labels.to(device, non_blocking=True), len(batches))

    buf: collections.deque = collections.deque()
    try:
        while len(buf) < depth:
            buf.append(load())
    except StopIteration:
        pass
    while buf:
        nxt = buf.popleft()
        try:
            buf.append(load())  # refill before yielding the current stage
        except StopIteration:
            pass
        yield nxt


class _DeviceStage:
    """Up to ``stage`` batches of an iterator, pulled as the steps reach
    them (``rows[i]``: images or labels of the stage's batch i)."""

    def __init__(self, it: Iterator, stage: int):
        self._it = it
        self._stage = stage
        self._batches = []

    def pull(self, i: int):
        if not 0 <= i < self._stage:
            raise IndexError(f"row {i} of a stage of {self._stage}")
        while len(self._batches) <= i:
            self._batches.append(next(self._it))
        return self._batches[i]



class _StageRows:
    """Row i: the images (part 0) or labels (part 1) of a stage's batch i."""

    def __init__(self, stage: _DeviceStage, part: int):
        self._stage = stage
        self._part = part

    def __getitem__(self, i: int):
        return self._stage.pull(i)[self._part]


def device_stages(batches: Iterator, stage: int):
    """Group batches already on the device (the decode engine's) into
    stages of ``stage``, yielded as ``(images rows, labels rows, stage)``:
    row i is the stage's batch i, taken from ``batches`` when a step first
    reads it, so nothing is copied or drawn ahead of the steps. A stream
    that ends inside a stage raises StopIteration at the row it lacks."""
    it = iter(batches)
    while True:
        group = _DeviceStage(it, stage)
        try:
            group.pull(0)
        except StopIteration:
            return
        yield _StageRows(group, 0), _StageRows(group, 1), stage


class DoubleBufferedH2D:
    """Double-buffered staged transfer, the overlapped form of
    :func:`staged_superbatch_prefetch` (reference ``DoubleBufferedH2D``).

    - A producer thread assembles the next ``(stage, B, ...)`` superbatch
      in pinned host memory, copies it into a free slot of an explicit
      two-slot device buffer on a copy stream of its own, and waits until
      the copy lands: transfer wall time and bytes are measured per stage.
    - The two slots bound the device memory staged: one superbatch the
      consumer reads, one landing or ready (the ready queue holds one).
      The consumer gets a slot after its copy's event (its stream waits on
      it); when it asks for the next superbatch it records an event on its
      stream, after the steps that read the slot, and hands the slot back;
      the producer waits on that event before it writes the slot again.
    - ``stats()`` reports the interval's ``h2d_bytes_per_sec`` and
      ``h2d_overlap_frac`` (1 − consumer-blocked time ∕ transfer time,
      clamped to [0, 1]); ``drain_transfers()`` the finished transfers as
      ``(start, end, bytes, k)``.

    The superbatches are the generator form's, the partial last one
    included. A producer error is raised at the consumer in order;
    ``external_stop`` ends iteration within ~GET_POLL_SEC even while the
    producer is stalled. On the CPU the slots are CPU tensors and nothing
    waits on events."""

    _DONE = object()

    def __init__(self, host_iter: Iterator[Batch], device, stage: int = 4,
                 depth: int = 2,
                 external_stop: Optional[threading.Event] = None):
        del depth  # two slots, whatever the prefetch depth (reference)
        self._time = time.perf_counter
        self._stage = max(1, int(stage))
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._it = iter(host_iter)
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._free: queue.Queue = queue.Queue()
        for slot in (0, 1):
            self._free.put((slot, None))
        self._slots = [None, None]   # (images, labels) device tensors
        self._held = None            # the slot the consumer reads
        self._copy_stream = (torch.cuda.Stream(self._device) if self._cuda
                             else None)
        self._stop = threading.Event()
        self._external_stop = external_stop
        self._lock = threading.Lock()
        self._events = []           # finished transfers: (t0, t1, bytes, k)
        self._bytes = 0             # interval accumulators for stats()
        self._transfer_sec = 0.0
        self._wait_sec = 0.0
        self._last_stats = self._time()
        self._thread = threading.Thread(target=self._fill, daemon=True,
                                        name="tpu-resnet-torch-h2d")
        self._thread.start()

    # ------------------------------------------------------------ producer
    def _get_free(self):
        while not self._stop.is_set():
            try:
                return self._free.get(timeout=0.2)
            except queue.Empty:
                continue
        return None

    def _land(self, slot: int, images: torch.Tensor, labels: torch.Tensor):
        """Copy the stacked superbatch into ``slot`` (remade where its
        shape or dtype changed) and wait until it has landed; returns the
        copy's event (None on the CPU)."""
        have = self._slots[slot]
        if have is None or any(
                d.shape[1:] != h.shape[1:] or d.dtype != h.dtype
                or d.shape[0] < h.shape[0]
                for d, h in zip(have, (images, labels))):
            have = self._slots[slot] = tuple(
                torch.empty((self._stage, *h.shape[1:]), dtype=h.dtype,
                            device=self._device) for h in (images, labels))
        k = images.shape[0]
        if not self._cuda:
            for d, h in zip(have, (images, labels)):
                d[:k].copy_(h)
            return None
        with torch.cuda.stream(self._copy_stream):
            for d, h in zip(have, (images, labels)):
                d[:k].copy_(h, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(self._copy_stream)
        landed.synchronize()
        return landed

    def _fill(self):
        try:
            while not self._stop.is_set():
                got = self._get_free()
                if got is None:
                    return
                slot, released = got
                batches = _take(self._it, self._stage)
                if not batches:
                    self._put(self._DONE)
                    return
                images, labels = _stack(batches)
                if released is not None:
                    released.synchronize()  # the steps that read it ran
                t0 = self._time()
                landed = self._land(slot, images, labels)
                t1 = self._time()
                nbytes = (images.numel() * images.element_size()
                          + labels.numel() * labels.element_size())
                with self._lock:
                    self._events.append((t0, t1, nbytes, len(batches)))
                    self._bytes += nbytes
                    self._transfer_sec += t1 - t0
                if not self._put((slot, landed, len(batches))):
                    return
        except Exception as e:  # surface loader/transfer errors in order
            try:
                self._q.put(e, timeout=ERROR_PUT_TIMEOUT_SEC)
            except queue.Full:
                self._drain()
                try:
                    self._q.put_nowait(e)
                except queue.Full:  # pragma: no cover - sole producer
                    pass

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    # ------------------------------------------------------------ consumer
    def __iter__(self):
        return self

    def _release(self) -> None:
        if self._held is None:
            return
        released = None
        if self._cuda:
            released = torch.cuda.Event()
            released.record(torch.cuda.current_stream(self._device))
        self._free.put((self._held, released))
        self._held = None

    def __next__(self):
        self._release()
        t0 = self._time()
        while True:
            try:
                item = self._q.get(timeout=GET_POLL_SEC)
                break
            except queue.Empty:
                if (self._external_stop is not None
                        and self._external_stop.is_set()):
                    raise StopIteration  # preemption: stop waiting
                if self._thread.is_alive():
                    continue
                try:
                    item = self._q.get_nowait()
                    break
                except queue.Empty:
                    raise RuntimeError(
                        "DoubleBufferedH2D producer thread died without "
                        "yielding a result or an error") from None
        with self._lock:
            self._wait_sec += self._time() - t0
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        slot, landed, k = item
        if landed is not None:
            torch.cuda.current_stream(self._device).wait_event(landed)
        self._held = slot
        images, labels = self._slots[slot]
        return images[:k], labels[:k], k

    def close(self) -> None:
        """Release the producer thread and the device slots; idempotent."""
        self._stop.set()
        self._drain()
        self._thread.join(timeout=5)

    # --------------------------------------------------------------- stats
    def drain_transfers(self):
        """Finished transfers since the last drain, as ``(start, end,
        bytes, k)`` on the wall clock."""
        with self._lock:
            events, self._events = self._events, []
        offset = time.time() - self._time()
        return [(t0 + offset, t1 + offset, nbytes, k)
                for t0, t1, nbytes, k in events]

    def stats(self) -> dict:
        """Interval gauges since the previous stats() call."""
        now = self._time()
        with self._lock:
            dt = max(now - self._last_stats, 1e-9)
            rate = self._bytes / dt
            overlap = (max(0.0, 1.0 - self._wait_sec / self._transfer_sec)
                       if self._transfer_sec > 0 else 0.0)
            self._bytes = 0
            self._transfer_sec = 0.0
            self._wait_sec = 0.0
            self._last_stats = now
        return {"h2d_bytes_per_sec": round(rate, 1),
                "h2d_overlap_frac": round(min(overlap, 1.0), 6)}
