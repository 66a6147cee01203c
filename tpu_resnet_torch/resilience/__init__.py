"""Fault tolerance of a training run: graceful shutdown (``shutdown``), the
NaN sentinel's rollback policy (``sentinel``), the hang watchdog
(``watchdog``) and the deterministic fault injector for drills
(``faultinject``).

The names below load on first use, so that importing a submodule alone
(``exitcodes``, which the stdlib-only supervisor reads) loads nothing
else of the package.
"""

import importlib

_LAZY = {"FaultInjector": "faultinject", "FaultPlan": "faultinject",
         "corrupt_checkpoint": "faultinject", "HangWatchdog": "watchdog",
         "dump_all_stacks": "watchdog"}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                   name)
