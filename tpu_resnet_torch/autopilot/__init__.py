"""The fleet's autopilot: traffic-driven scaling of the port's serve
replicas (the reference's ``tpu_resnet/autopilot``).

The router's SLO, queue and shed signals and fleetmon's burn rates are
its inputs; replicas spawned under the port's supervisor (with
colocation admission's exit 3 a policy input) and the router's rolling
drain are its outputs; between them a deterministic policy whose every
decision can be replayed from its ledger.

``signals.py``     one frozen ``SignalSnapshot`` a round (router ``/info``
                   and fleetmon's digest-verified
                   ``fleet_snapshot.json``).
``policy.py``      the pure ``decide(snapshot, config, state)``:
                   hysteresis bands, streaks, cooldowns, bounds, step
                   limits, the admission-denied backoff.
``actuator.py``    every side effect: supervised replica spawns, the
                   router's ``/admin/drain``, the capacity lease handed
                   to a colocated trainer.
``controller.py``  the loop thread, its ledger, gauges and status file.
``cli.py``         ``python -m tpu_resnet_torch autopilot``.

Host code: no module here imports torch, and the control process holds
no CUDA context; the replicas it spawns run on the card.
"""

from tpu_resnet_torch.autopilot.policy import (Decision, PolicyState, decide,
                                               note_admission_denied, replay)
from tpu_resnet_torch.autopilot.signals import SignalSnapshot, collect

__all__ = ["Decision", "PolicyState", "SignalSnapshot", "collect",
           "decide", "note_admission_denied", "replay"]
