"""Event spans: the run's lifecycle as ``<dir>/events.jsonl`` (port of
``tpu_resnet/obs/spans.py``'s ``SpanTracer``, ``TailSampler`` and
readers).

One JSON object a span, in the reference's schema, so the reference's
``load_spans`` reads the port's file unchanged::

    {"span": "checkpoint_save", "start": <wall>, "end": <wall>,
     "duration_sec": 0.041, "pid": 1234, "run_id": "...", "step": 3000}

``start``/``end`` are wall-clock (``time.time()``). Kinds the port writes:
``run``, ``compile`` (the first dispatch), ``mfu_account``,
``memory_account``, ``checkpoint_save``, ``checkpoint_restore``,
``checkpoint_restore_failed``, ``checkpoint_save_skipped_nonfinite``,
``nan_rollback``, ``preempt_stop``, ``emergency_save``, ``oom``,
``watchdog_stall``, ``watchdog_recovered``, in the eval directory
``eval_pass`` and ``eval_restore_failed``, and in the predict server's
``serve_events.jsonl`` ``colocation_admission``, ``serve_warmup``,
``serve_warmup_bucket``, ``serve_ready``, ``serve_reload``,
``serve_drain``, ``oom`` and the tail-sampled ``serve_request``
(:class:`TailSampler`). The writer is append-only and
line-buffered; ``close()`` is idempotent and a record after it is a
no-op, so shutdown races cannot turn telemetry into a crash.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional


class SpanTracer:
    def __init__(self, directory: str, enabled: bool = True,
                 filename: str = "events.jsonl", run_id: str = None):
        """``run_id`` (``obs/manifest.py`` ``ensure_run_id``) is stamped on
        every record; a reader that starts before the trainer minted it may
        set ``tracer.run_id`` later."""
        self.enabled = enabled
        self.run_id = run_id
        self._pid = os.getpid()
        self._f = None
        if not enabled:
            return
        os.makedirs(directory, exist_ok=True)
        self._f = open(os.path.join(directory, filename), "a", buffering=1)

    def record(self, kind: str, start: float, end: float, **attrs) -> None:
        """Append one finished span. Safe after ``close()`` (no-op)."""
        if self._f is None:
            return
        rec = {"span": kind, "start": round(start, 6), "end": round(end, 6),
               "duration_sec": round(end - start, 6), "pid": self._pid}
        if self.run_id is not None:
            rec["run_id"] = self.run_id
        rec.update(attrs)
        try:
            self._f.write(json.dumps(rec) + "\n")
        except ValueError:  # closed underneath us in a shutdown race
            self._f = None

    def event(self, kind: str, **attrs) -> None:
        """Instantaneous marker (zero-duration span)."""
        now = time.time()
        self.record(kind, now, now, **attrs)

    @contextmanager
    def span(self, kind: str, **attrs):
        """Time a block as a span. Yields the attrs dict so the body can
        attach results; an exception is recorded on the span and
        re-raised."""
        t0 = time.time()
        try:
            yield attrs
        except BaseException as e:
            attrs.setdefault("error", f"{type(e).__name__}: {e}"[:200])
            raise
        finally:
            self.record(kind, t0, time.time(), **attrs)

    def close(self) -> None:
        if self._f is not None:
            f, self._f = self._f, None
            try:
                f.close()
            except OSError:  # pragma: no cover - fs-specific
                pass


class TailSampler:
    """Which per-request ``serve_request`` spans to keep (the reference's
    tail-based sampler, decision for decision): every error, shed,
    retried or hedged request; every request slower than a rolling
    latency quantile; and a baseline sample of healthy traffic whose
    period doubles every 64 keeps, so the kept volume grows as the log of
    the request count. ``observe()`` returns the keep reason (the span's
    ``sampled`` attribute) or None to drop; the decision is made in
    memory under its own lock, and the caller writes the span outside
    it."""

    ALWAYS_KEEP = ("error", "shed", "retry", "hedge")

    def __init__(self, quantile: float = 0.95, base_period: int = 50,
                 ring: int = 512, min_samples: int = 100):
        self.quantile = float(quantile)
        self._lock = threading.Lock()
        self._ring = [0.0] * int(ring)
        self._n = 0                     # total observations
        self._kept_baseline = 0         # baseline keeps since last doubling
        self._period = int(base_period)
        self._since_sample = 0          # observations since last baseline keep
        self._threshold = None          # cached rolling quantile
        self._min_samples = int(min_samples)
        self._kept = 0

    def _slow_threshold(self) -> Optional[float]:
        """Rolling nearest-rank quantile over the latency ring, recomputed
        every 100 observations."""
        if self._n < self._min_samples:
            return None
        if self._threshold is None or self._n % 100 == 0:
            vals = sorted(self._ring[:min(self._n, len(self._ring))])
            idx = min(len(vals) - 1,
                      max(0, int(self.quantile * len(vals) + 0.5) - 1))
            self._threshold = vals[idx]
        return self._threshold

    def observe(self, latency_ms: float, error: bool = False,
                shed: bool = False, retried: bool = False,
                hedged: bool = False) -> Optional[str]:
        """Record one request; return the keep reason or None (drop)."""
        with self._lock:
            self._ring[self._n % len(self._ring)] = float(latency_ms)
            self._n += 1
            self._since_sample += 1
            reason = None
            if error:
                reason = "error"
            elif shed:
                reason = "shed"
            elif retried:
                reason = "retry"
            elif hedged:
                reason = "hedge"
            else:
                thr = self._slow_threshold()
                if thr is not None and latency_ms > thr:
                    reason = "slow"
                elif self._since_sample >= self._period:
                    reason = "sampled"
                    self._since_sample = 0
                    self._kept_baseline += 1
                    if self._kept_baseline >= 64:
                        self._kept_baseline = 0
                        self._period *= 2
            if reason is not None:
                self._kept += 1
            return reason

    def stats(self) -> dict:
        with self._lock:
            return {"observed": self._n, "kept": self._kept,
                    "period": self._period,
                    "slow_threshold_ms": self._threshold}


def load_jsonl(path: str, require_key: str):
    """One dict per parseable line of ``path`` that carries
    ``require_key``; a torn last line (a live writer, a crash mid-write)
    is skipped, not an error."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if require_key in rec:
                out.append(rec)
    return out


def load_spans(path: str):
    """``events.jsonl`` → list of span records."""
    return load_jsonl(path, "span")
