"""Hang watchdog (port of ``tpu_resnet/resilience/watchdog.py``): a
daemon thread fed ``progress(step)`` at every chunk boundary. When no
progress lands for ``stall_sec``:

- every thread's stack is written to ``<train_dir>/stall_stacks_<n>.txt``,
  while it is stuck;
- the telemetry registry is marked unhealthy, so ``/healthz`` answers 503
  with the reason before the heartbeat's staleness threshold trips;
- a ``watchdog_stall`` span is recorded and ``fault_watchdog_stalls``
  counts it.

When progress resumes the mark is cleared and a ``watchdog_recovered``
span records the outage. The first ``progress()`` arms it, so the first
dispatch (kernel builds, the CUDA graph capture) never trips it.
``stall_sec <= 0`` disables it.

A rank of a data-parallel run also passes ``abort_sec``, its collectives'
timeout: when no progress lands for that long, a peer is gone or hung and
this rank waits on it for ever (a collective replayed in a CUDA graph has
no timeout of its own), so the stacks go to ``abort_stacks.txt`` and the
process ends with ``ABORT_EXIT_CODE``, from the watchdog's thread, which
still runs while the loop's thread is blocked.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import traceback
from typing import Optional

log = logging.getLogger("tpu_resnet_torch")

ABORT_EXIT_CODE = 1


def dump_all_stacks(path: str, reason: str = "") -> None:
    """Write every live thread's stack to ``path`` (best-effort)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    lines = [f"# all-thread stack dump @ {time.strftime('%F %T')}"]
    if reason:
        lines.append(f"# reason: {reason}")
    for ident, frame in sys._current_frames().items():
        lines.append(f"\n--- thread {names.get(ident, '?')} ({ident}) ---")
        lines.extend(l.rstrip() for l in traceback.format_stack(frame))
    try:
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    except OSError as e:  # diagnostics must never crash the diagnosed
        log.warning("could not write stack dump %s: %s", path, e)


class HangWatchdog:
    """``maybe_start`` returns None when ``stall_sec <= 0`` and there is
    no ``abort_sec`` (disabled)."""

    def __init__(self, stall_sec: float, train_dir: str, telemetry=None,
                 spans=None, poll_sec: Optional[float] = None,
                 abort_sec: Optional[float] = None):
        self.stall_sec = float(stall_sec)
        self.abort_sec = abort_sec
        self.train_dir = train_dir
        self._telemetry = telemetry
        self._spans = spans
        deadline = min(d for d in (self.stall_sec, abort_sec or 0.0,
                                   float("inf")) if d > 0)
        self._poll = poll_sec if poll_sec else min(deadline / 4, 5.0)
        self._lock = threading.Lock()
        self._last_wall: Optional[float] = None  # armed by first progress()
        self._last_step: Optional[int] = None
        self._stalled_since: Optional[float] = None
        self.stalls = 0
        self.dumps = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="tpu-resnet-torch-watchdog",
                                        daemon=True)

    @classmethod
    def maybe_start(cls, stall_sec: float, train_dir: str, telemetry=None,
                    spans=None, abort_sec: Optional[float] = None
                    ) -> Optional["HangWatchdog"]:
        stall_sec = stall_sec or 0.0
        if stall_sec <= 0 and not abort_sec:
            return None
        wd = cls(stall_sec, train_dir, telemetry=telemetry, spans=spans,
                 abort_sec=abort_sec)
        wd.start()
        return wd

    def start(self) -> "HangWatchdog":
        self._thread.start()
        return self

    def progress(self, step: int) -> None:
        """Mark step progress; called at every chunk boundary (a lock +
        two assignments — nanoseconds against a multi-ms chunk)."""
        with self._lock:
            self._last_wall = time.monotonic()
            self._last_step = int(step)

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=self._poll + 5)

    # ------------------------------------------------------------ internals
    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            with self._lock:
                last_wall, last_step = self._last_wall, self._last_step
            if last_wall is None:  # not armed yet (still compiling)
                continue
            stalled = time.monotonic() - last_wall
            if self.abort_sec and stalled > self.abort_sec:
                self._abort(last_step, stalled)
                return
            if self.stall_sec <= 0:
                continue
            if stalled > self.stall_sec and self._stalled_since is None:
                self._stalled_since = last_wall
                self._on_stall(last_step, stalled)
            elif stalled <= self.stall_sec and self._stalled_since \
                    is not None:
                outage = last_wall - self._stalled_since
                self._stalled_since = None
                self._on_recover(last_step, outage)

    def _on_stall(self, step, stalled_sec: float) -> None:
        n = self.stalls + 1
        path = os.path.join(self.train_dir, f"stall_stacks_{n}.txt")
        reason = (f"no step progress for {stalled_sec:.1f}s "
                  f"(> watchdog deadline {self.stall_sec:.1f}s) at step "
                  f"{step}")
        log.error("watchdog: %s — dumping all-thread stacks to %s and "
                  "flipping /healthz unhealthy", reason, path)
        dump_all_stacks(path, reason=reason)
        self.dumps.append(path)
        if self._telemetry is not None:
            self._telemetry.mark_unhealthy(reason)
            self._telemetry.set("fault_watchdog_stalls", n)
        if self._spans is not None:
            self._spans.event("watchdog_stall", step=step,
                              stalled_sec=round(stalled_sec, 3),
                              stack_dump=path)
        # Published last: pollers of ``stalls`` see the dump/telemetry/
        # span side effects already landed.
        self.stalls = n

    def _abort(self, step, stalled_sec: float) -> None:
        path = os.path.join(self.train_dir, "abort_stacks.txt")
        reason = (f"no step progress for {stalled_sec:.1f}s (> the "
                  f"collectives' timeout {self.abort_sec:.1f}s) at step "
                  f"{step}: a peer rank is gone or hung")
        log.error("watchdog: %s — ending this rank (stacks in %s)", reason,
                  path)
        os.makedirs(self.train_dir, exist_ok=True)
        dump_all_stacks(path, reason=reason)
        os._exit(ABORT_EXIT_CODE)

    def _on_recover(self, step, outage_sec: float) -> None:
        log.warning("watchdog: step progress resumed at step %s after a "
                    "%.1fs stall — clearing the unhealthy mark",
                    step, outage_sec)
        if self._telemetry is not None:
            self._telemetry.clear_unhealthy()
        if self._spans is not None:
            self._spans.event("watchdog_recovered", step=step,
                              outage_sec=round(outage_sec, 3))
