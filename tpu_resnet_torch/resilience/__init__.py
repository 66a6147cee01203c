"""Fault tolerance of a training run: graceful shutdown (``shutdown``), the
NaN sentinel's rollback policy (``sentinel``), the hang watchdog
(``watchdog``) and the deterministic fault injector for drills
(``faultinject``)."""

from tpu_resnet_torch.resilience.faultinject import (
    FaultInjector,
    FaultPlan,
    corrupt_checkpoint,
)
from tpu_resnet_torch.resilience.watchdog import HangWatchdog, dump_all_stacks

__all__ = ["FaultInjector", "FaultPlan", "HangWatchdog", "corrupt_checkpoint",
           "dump_all_stacks"]
