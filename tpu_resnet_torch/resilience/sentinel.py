"""NaN/divergence sentinel: bounded rollback-and-retry policy.

Copy of ``NaNSentinel`` and ``DivergenceError`` from
``tpu_resnet/resilience/sentinel.py``, with the same policy and messages.
A diverged run (NaN/Inf loss from an LR spike or a poisoned batch) would
otherwise train NaN to its last step and checkpoint it. The sentinel checks
loss finiteness **at the log boundaries only**, where the loop already
reads the metrics on the host, so the check adds no device sync.

The sentinel owns the *policy* (how many rollbacks before giving up); the
*mechanics* (checkpoint restore, data-stream restart) live in
``train/loop.py`` where the state and iterator are.
"""

from __future__ import annotations

import logging
import math

log = logging.getLogger("tpu_resnet_torch")


class DivergenceError(RuntimeError):
    """Training diverged and rollback retries are exhausted (or there is
    no checkpoint to roll back to): fail loudly instead of training NaNs."""


class NaNSentinel:
    def __init__(self, max_retries: int = 2, enabled: bool = True):
        self.enabled = enabled
        self.max_retries = int(max_retries)
        self.rollbacks = 0

    def check(self, step: int, loss: float) -> bool:
        """True: the loop must roll back (non-finite loss and the sentinel
        is enabled). Raises :class:`DivergenceError` when retries are
        exhausted; the message carries everything the operator needs."""
        if not self.enabled or math.isfinite(loss):
            return False
        if self.rollbacks >= self.max_retries:
            raise DivergenceError(
                f"non-finite loss ({loss}) at step {step} after "
                f"{self.rollbacks} rollback(s) — divergence persists past "
                f"resilience.nan_max_retries={self.max_retries}; lower the "
                f"LR / inspect the data around this step window")
        self.rollbacks += 1
        log.warning("non-finite loss (%s) at step %d — rolling back to the "
                    "last checkpoint and skipping the bad data window "
                    "(retry %d/%d)", loss, step, self.rollbacks,
                    self.max_retries)
        return True

    def no_checkpoint(self, step: int, loss: float) -> DivergenceError:
        """The error for a divergence with nothing to roll back to."""
        return DivergenceError(
            f"non-finite loss ({loss}) at step {step} and no checkpoint "
            f"exists to roll back to — failing immediately (first "
            f"checkpoint lands at train.checkpoint_every)")
