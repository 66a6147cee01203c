"""Event spans: the run's lifecycle as ``<dir>/events.jsonl`` (port of
``tpu_resnet/obs/spans.py``'s ``SpanTracer`` and readers).

One JSON object a span, in the reference's schema, so the reference's
``load_spans`` reads the port's file unchanged::

    {"span": "checkpoint_save", "start": <wall>, "end": <wall>,
     "duration_sec": 0.041, "pid": 1234, "run_id": "...", "step": 3000}

``start``/``end`` are wall-clock (``time.time()``). Kinds the port writes:
``run``, ``compile`` (the first dispatch), ``mfu_account``,
``memory_account``, ``checkpoint_save``, ``checkpoint_restore``,
``checkpoint_restore_failed``, ``checkpoint_save_skipped_nonfinite``,
``nan_rollback``, ``preempt_stop``, ``emergency_save``, ``oom``,
``watchdog_stall``, ``watchdog_recovered``, and in the eval directory
``eval_pass`` and ``eval_restore_failed``. The writer is append-only and
line-buffered; ``close()`` is idempotent and a record after it is a
no-op, so shutdown races cannot turn telemetry into a crash.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager


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
