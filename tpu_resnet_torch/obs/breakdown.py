"""Step-time breakdown: where wall time goes between log boundaries (port
of ``tpu_resnet/obs/breakdown.py``). Each logged interval is split into:

``data_wait``      blocked on the next batch: the streamed iterator, the
                   staged superbatch, or the ImageNet engine's ring.
``dispatch``       host time that issues a chunk: eager steps' launches,
                   or a graphed chunk's slot copies and graph replays.
``device_sync``    the host's wait at the interval's boundary for the
                   device to drain what was issued: ≈0 when the host is
                   the bottleneck, ≈ device step time × steps when the
                   device is.

The device is sampled only at the log boundaries, where the loop reads
the metrics anyway; nothing here synchronizes per step or runs inside a
CUDA graph capture. The first dispatch (kernel builds, cuDNN's plan
search, the warm-up steps and the capture) is reported apart as
``compile_seconds`` and kept out of the first interval.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Optional


class StepBreakdown:
    """Accumulates one interval's timings; ``interval()`` drains them as
    the metrics merged into ``metrics.jsonl``. ``sync`` arguments are
    callables that block until the newest chunk is done on the device
    (the loop's read of its metrics)."""

    def __init__(self):
        self.compile_seconds: Optional[float] = None
        self._data_wait = 0.0
        self._dispatch = 0.0
        self._sync: Optional[float] = None       # last boundary sample
        self._sync_steps = 0
        self._waiting = 0                        # data_wait nesting depth
        self._interval_start = time.perf_counter()

    @contextmanager
    def data_wait(self):
        """Time a blocking read of the next batch (nested reads count
        once)."""
        self._waiting += 1
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._waiting -= 1
            if not self._waiting:
                self._data_wait += time.perf_counter() - t0

    def waited(self, batches: Iterator) -> Iterator:
        """``batches`` with each ``next`` timed as a data wait: for
        streams whose batches a chunk reads while it is issued (the
        engine's stages, row by row)."""
        it = iter(batches)
        while True:
            with self.data_wait():
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    @contextmanager
    def dispatch(self):
        """Time the issue of a chunk, less the data waits inside it."""
        t0, waited = time.perf_counter(), self._data_wait
        try:
            yield
        finally:
            self._dispatch += (time.perf_counter() - t0
                               - (self._data_wait - waited))

    def first_dispatch_done(self, sync: Callable[[], object]) -> float:
        """Call right after the run's first dispatch returns: waits for it
        (``sync()``) and records ``compile_seconds``, the first dispatch's
        wall time less the time blocked on input; then restarts the
        interval clock, so that the first logged interval leaves it out."""
        sync()
        self.compile_seconds = (time.perf_counter() - self._interval_start
                                - self._data_wait)
        self.reset_interval()
        return self.compile_seconds

    def add_device_sample(self, seconds: float, steps: int) -> None:
        """Record a boundary wait timed by the caller."""
        self._sync = seconds
        self._sync_steps = max(1, steps)

    def sample_device(self, sync: Callable[[], object], steps: int):
        """Time ``sync()`` at an interval boundary (``steps``: the steps
        issued since the last full sync) and return what it returned."""
        t0 = time.perf_counter()
        out = sync()
        self.add_device_sample(time.perf_counter() - t0, steps)
        return out

    def reset_interval(self) -> None:
        self._data_wait = 0.0
        self._dispatch = 0.0
        self._sync = None
        self._sync_steps = 0
        self._interval_start = time.perf_counter()

    def interval(self) -> Dict[str, float]:
        """Drain the interval: ``data_wait_sec``, ``data_wait_frac`` and
        ``dispatch_sec``; ``device_sync_sec`` and
        ``device_step_sec_sampled`` when the boundary was sampled;
        ``compile_seconds`` once it is known."""
        wall = max(time.perf_counter() - self._interval_start, 1e-9)
        out = {
            "data_wait_sec": round(self._data_wait, 6),
            "data_wait_frac": round(min(self._data_wait / wall, 1.0), 6),
            "dispatch_sec": round(self._dispatch, 6),
        }
        if self._sync is not None:
            out["device_sync_sec"] = round(self._sync, 6)
            out["device_step_sec_sampled"] = round(
                self._sync / self._sync_steps, 6)
        if self.compile_seconds is not None:
            out["compile_seconds"] = round(self.compile_seconds, 4)
        self.reset_interval()
        return out
