"""Graceful shutdown: SIGTERM/SIGINT become a stop request.

Copy of ``ShutdownCoordinator`` and ``Preempted`` from
``tpu_resnet/resilience/shutdown.py``. The handler only sets a flag (and
logs); the serve loop that waits on :attr:`ShutdownCoordinator.event`
drains the server, and the train loop stops at the next step, saves a
final checkpoint and raises :class:`Preempted` (the CLI exits
``resilience.preempt_exit_code``, 42). A second signal while
the first is being honored restores the original handlers and raises
``KeyboardInterrupt``, so an operator is never trapped behind a slow drain.
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Optional

log = logging.getLogger("tpu_resnet_torch")


class Preempted(Exception):
    """Raised by ``train()`` after a graceful stop: the final checkpoint is
    on disk. Carries the stop step and the final state."""

    def __init__(self, step: int, state=None, signum: Optional[int] = None):
        self.step = int(step)
        self.state = state
        self.signum = signum
        name = signal.Signals(signum).name if signum is not None else "?"
        super().__init__(
            f"training preempted by {name} at step {step}; final "
            f"checkpoint saved — restart to resume")


class ShutdownCoordinator:
    """Installable SIGTERM/SIGINT → stop-request flag.

    ``install()`` is a no-op off the main thread (CPython only delivers
    signals there, and ``signal.signal`` raises elsewhere) and when
    ``enabled=False`` — ``requested`` then just stays False and the
    process keeps its default signal behavior."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, enabled: bool = True,
                 action_desc: Optional[str] = None):
        """``action_desc`` is what the first-signal log line promises the
        process will now do (the predict server passes its drain
        contract)."""
        self.enabled = enabled
        self.action_desc = action_desc or "stopping"
        self.signum: Optional[int] = None
        self.requested_at: Optional[float] = None
        self._event = threading.Event()
        self._previous = {}

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    @property
    def event(self) -> threading.Event:
        """The stop-request event, for consumers that block outside the
        loop (e.g. the input pipeline's consumer-side get)."""
        return self._event

    def request_stop(self, signum: Optional[int] = None) -> None:
        """Programmatic stop request (what the signal handler calls)."""
        if self.signum is None:
            self.signum = signum
            self.requested_at = time.time()
        self._event.set()

    def _handle(self, signum, frame) -> None:
        if self._event.is_set():
            # Second signal: the operator wants OUT, not a slow drain.
            # Put the default handlers back and raise.
            self.uninstall()
            raise KeyboardInterrupt(
                f"second {signal.Signals(signum).name} during graceful "
                f"shutdown — aborting immediately")
        log.warning("received %s: %s (send again to abort immediately)",
                    signal.Signals(signum).name, self.action_desc)
        self.request_stop(signum)

    def install(self) -> "ShutdownCoordinator":
        if not self.enabled or self._previous:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in self.SIGNALS:
            try:
                self._previous[sig] = signal.signal(sig, self._handle)
            except (ValueError, OSError):  # exotic embedding; stay inert
                self._previous.pop(sig, None)
        return self

    def uninstall(self) -> None:
        prev, self._previous = self._previous, {}
        for sig, handler in prev.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass

    def __enter__(self) -> "ShutdownCoordinator":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
