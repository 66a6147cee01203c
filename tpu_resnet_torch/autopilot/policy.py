"""The autopilot's target-replica policy (the reference's
``tpu_resnet/autopilot/policy.py``, decision for decision).

:func:`decide` is a pure function of ``(snapshot, config, state)`` and
returns ``(decision, new_state)``: no clock, no randomness, no I/O. Its
only "now" is ``snapshot.wall``, so a recorded signal trace replayed
through the same config gives the same decisions. This module resolves
what should happen; ``actuator.py`` makes it happen.

Anti-flap has two stages:

- **hysteresis bands**: p99 above ``slo * up_band`` is scale-up
  pressure, p99 below ``slo * down_band`` scale-down pressure, and the
  corridor between them holds, so a p99 oscillating around one
  threshold never alternates decisions;
- **streaks and cooldowns**: pressure must hold ``up_rounds`` /
  ``down_rounds`` snapshots in a row, and an actuation starts a
  cooldown in which its direction holds.

Bounds come first: a fleet below ``min_replicas`` (a replica SIGKILLed
under it) is restored at once, with no streak and no cooldown, because
the floor is a capacity promise. Only the colocation-admission backoff
delays it: this host said "no capacity here" (serve exit 3), and asking
again at once would be denied again.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from tpu_resnet_torch.config import AutopilotConfig

ACTIONS = ("scale_up", "scale_down", "hold")


@dataclasses.dataclass(frozen=True)
class PolicyState:
    """Everything :func:`decide` carries between rounds. Frozen: every
    transition mints a new state, so a trace replay can check the whole
    state sequence, not just the decisions."""

    up_streak: int = 0
    down_streak: int = 0
    # Walls of the last actuation per direction (snapshot time), None =
    # never — cooldown anchors.
    last_up_wall: Optional[float] = None
    last_down_wall: Optional[float] = None
    # Scale-ups hold until this wall after a colocation-admission
    # denial (note_admission_denied).
    denied_until: float = 0.0
    # High-water mark of the router's cumulative shed counter; a raise
    # between rounds means requests were shed SINCE the last look.
    shed_seen: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PolicyState":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Decision:
    """One round's verdict. ``target = current + step`` (step signed);
    ``pressure`` is the raw band verdict before streaks/cooldowns so a
    ledger reader can see WHY a hold held."""

    action: str                 # one of ACTIONS
    current: int                # healthy + in-flight spawns this round
    target: int
    step: int                   # replicas to add (+) / drain (-)
    reason: str
    pressure: str               # "up" | "down" | "none"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def effective_slo(snapshot, cfg: AutopilotConfig) -> float:
    """The SLO the bands anchor to: an explicit autopilot.slo_ms wins,
    else adopt the router's advertised route.slo_ms (the colocated
    default). 0 = no latency signal; only shed/queue/burn pressure
    remains and scale-down is disabled (never drain capacity on the
    strength of no signal)."""
    if cfg.slo_ms > 0:
        return float(cfg.slo_ms)
    return float(getattr(snapshot, "slo_ms", 0.0) or 0.0)


def note_admission_denied(state: PolicyState, wall: float,
                          cfg: AutopilotConfig) -> PolicyState:
    """A spawn exited with the colocation NO_CAPACITY code (3): arm the
    scale-up backoff. The denial is a policy INPUT, not a crash."""
    until = float(wall) + max(0.0, cfg.admission_backoff_secs)
    return dataclasses.replace(state, denied_until=max(
        state.denied_until, until), up_streak=0)


def _pressure(snapshot, cfg: AutopilotConfig, state: PolicyState,
              current: int, slo: float) -> Tuple[str, str]:
    """Raw band verdict for one snapshot: ("up"|"down"|"none", why)."""
    p99 = snapshot.p99_ms
    shed_delta = max(0.0, float(snapshot.shed_total) - state.shed_seen)
    per = max(1, current)
    queue_per = float(snapshot.queue_depth) / per
    burn = snapshot.burn_fast
    why = []
    if slo > 0 and p99 is not None and p99 > slo * cfg.up_band:
        why.append("p99")
    if shed_delta > 0:
        why.append("shed")
    if queue_per > cfg.queue_high:
        why.append("queue")
    if burn is not None and burn >= cfg.burn_high:
        why.append("burn")
    if why:
        return "up", "+".join(why)
    if (slo > 0 and p99 is not None and p99 < slo * cfg.down_band
            and shed_delta == 0 and queue_per <= cfg.queue_high / 2
            and (burn is None or burn < 1.0)):
        return "down", "p99_low"
    return "none", "in_band"


def decide(snapshot, cfg: AutopilotConfig,
           state: PolicyState) -> Tuple[Decision, PolicyState]:
    """One policy round. ``snapshot`` is a signals.SignalSnapshot (or
    anything with its fields — the tests hand in literals)."""
    lo = max(0, int(cfg.min_replicas))
    hi = max(lo, int(cfg.max_replicas))
    wall = float(snapshot.wall)

    if not snapshot.ok:
        # Blind round: never act on missing signals, and never let them
        # advance a streak either.
        new = dataclasses.replace(state, up_streak=0, down_streak=0)
        return Decision("hold", -1, -1, 0, "signals_unavailable",
                        "none"), new

    current = int(snapshot.replicas_healthy) + max(
        0, int(snapshot.replicas_pending))
    slo = effective_slo(snapshot, cfg)
    pressure, why = _pressure(snapshot, cfg, state, current, slo)
    up_streak = state.up_streak + 1 if pressure == "up" else 0
    down_streak = state.down_streak + 1 if pressure == "down" else 0
    new = dataclasses.replace(
        state, up_streak=up_streak, down_streak=down_streak,
        shed_seen=max(state.shed_seen, float(snapshot.shed_total)))

    step_up = max(1, int(cfg.max_step_up))
    step_down = max(1, int(cfg.max_step_down))

    # Bounds first: the floor/ceiling are promises, not signals.
    if current < lo:
        if wall < new.denied_until:
            return Decision("hold", current, current, 0,
                            "admission_backoff", pressure), new
        step = min(step_up, lo - current)
        new = dataclasses.replace(new, last_up_wall=wall, up_streak=0)
        return Decision("scale_up", current, current + step, step,
                        "below_min", pressure), new
    if current > hi:
        step = min(step_down, current - hi)
        new = dataclasses.replace(new, last_down_wall=wall,
                                  down_streak=0)
        return Decision("scale_down", current, current - step, -step,
                        "above_max", pressure), new

    if pressure == "up" and up_streak >= max(1, int(cfg.up_rounds)):
        if current >= hi:
            return Decision("hold", current, current, 0, "at_max",
                            pressure), new
        if wall < new.denied_until:
            return Decision("hold", current, current, 0,
                            "admission_backoff", pressure), new
        if (new.last_up_wall is not None
                and wall - new.last_up_wall
                < cfg.scale_up_cooldown_secs):
            return Decision("hold", current, current, 0, "up_cooldown",
                            pressure), new
        step = min(step_up, hi - current)
        new = dataclasses.replace(new, last_up_wall=wall, up_streak=0)
        return Decision("scale_up", current, current + step, step, why,
                        pressure), new

    if pressure == "down" and down_streak >= max(1, int(cfg.down_rounds)):
        if current <= lo:
            return Decision("hold", current, current, 0, "at_min",
                            pressure), new
        # Scale-down cools down against the LAST actuation in either
        # direction: capacity just added must prove itself for a full
        # cooldown before any of it is drained away.
        anchors = [w for w in (new.last_up_wall, new.last_down_wall)
                   if w is not None]
        if anchors and wall - max(anchors) < cfg.scale_down_cooldown_secs:
            return Decision("hold", current, current, 0,
                            "down_cooldown", pressure), new
        step = min(step_down, current - lo)
        new = dataclasses.replace(new, last_down_wall=wall,
                                  down_streak=0)
        return Decision("scale_down", current, current - step, -step,
                        why, pressure), new

    reason = ("steady" if pressure == "none"
              else f"pressure_{pressure}_building")
    return Decision("hold", current, current, 0, reason, pressure), new


def replay(snapshots, cfg: AutopilotConfig,
           state: Optional[PolicyState] = None):
    """Run a recorded snapshot trace through the policy; returns the
    decision list (the replay half of the determinism contract — two
    calls over the same trace must be equal)."""
    state = state if state is not None else PolicyState()
    out = []
    for snap in snapshots:
        decision, state = decide(snap, cfg, state)
        out.append(decision)
    return out, state
