"""Host side of the input pipeline, one process (port of the single-process
part of ``tpu_resnet/data/pipeline.py``).

``ShardedBatcher`` gives the reference's streaming order bit for bit: the
shuffle of each epoch is ``np.random.default_rng((seed, epoch))
.permutation``, so the stream is a pure function of (seed, step) and a
resumed run fast-forwards to its step without replaying batches.
``BackgroundIterator`` runs a source in a daemon thread with a bounded
queue; the train loop copies each batch to the device and augments it
there.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]

# How long the consumer's get() waits between producer-liveness checks, and
# how long an erroring producer tries the ordered put before freeing a slot.
GET_POLL_SEC = 1.0
ERROR_PUT_TIMEOUT_SEC = 2.0


class ShardedBatcher:
    """Infinite shuffled batches over an in-memory array source, in the
    reference's order for process 0 of 1."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 local_batch: int, seed: int = 0, start_step: int = 0):
        self.images = images
        self.labels = labels
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
            idx = order[pos:pos + self.local_batch]
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
