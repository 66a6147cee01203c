"""The autopilot's control loop: snapshot, decide, actuate, record (the
reference's ``tpu_resnet/autopilot/controller.py``).

One loop thread owns the whole round: it collects a
:class:`~tpu_resnet_torch.autopilot.signals.SignalSnapshot` (router
``/info`` and fleetmon's snapshot, no lock held), folds the actuator's
spawn lifecycle events into the policy state (a colocation-admission
denial arms the scale-up backoff; a replica turning healthy in the
router stops the scale-up-latency clock), runs the pure policy, acts,
and writes three records of the same round:

- ``autopilot_events.jsonl``, a span ledger (``obs/spans.SpanTracer``,
  stamped with the directory's run id) of every decision, holds
  included with their reason, and of each actuation and lifecycle
  event; ``trace-export`` shows it as the autopilot lane;
- the ``autopilot_*`` gauges (``AUTOPILOT_GAUGES``) on the controller's
  own telemetry port, announced in ``autopilot.json``;
- ``autopilot_status.json``, the latest round as one atomic file
  (target, counters, policy state).

The one lock guards in-memory state only (counters, policy state, the
integrators); every scrape, spawn, drain and file write happens with no
lock held, and teardown sets the stop event and joins the thread before
any writer closes. Only the loop thread touches the actuator. Host
code: no torch.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Callable, Optional

from tpu_resnet_torch.autopilot import signals
from tpu_resnet_torch.autopilot.actuator import Actuator
from tpu_resnet_torch.autopilot.policy import (Decision, PolicyState,
                                               decide, effective_slo,
                                               note_admission_denied)
from tpu_resnet_torch.config import RunConfig
from tpu_resnet_torch.obs.manifest import read_run_id
from tpu_resnet_torch.obs.server import AUTOPILOT_GAUGES, TelemetryRegistry
from tpu_resnet_torch.obs.spans import SpanTracer
from tpu_resnet_torch.obs.trace import AUTOPILOT_EVENTS_FILE

log = logging.getLogger("tpu_resnet_torch")

AUTOPILOT_DISCOVERY = "autopilot.json"
AUTOPILOT_STATUS_FILE = "autopilot_status.json"


class AutopilotController:
    """Driven in-process (:meth:`run_round` directly, with an injected
    ``collect_fn``/``actuator``) or as the ``python -m tpu_resnet_torch
    autopilot`` process (``cli.py``)."""

    def __init__(self, cfg: RunConfig,
                 registry: Optional[TelemetryRegistry] = None,
                 collect_fn: Optional[Callable[[], object]] = None,
                 actuator: Optional[Actuator] = None,
                 clock=time.time):
        self.cfg = cfg
        self.directory = (cfg.autopilot.discover_dir
                          or cfg.train.train_dir)
        if not self.directory:
            raise ValueError("autopilot needs autopilot.discover_dir "
                             "or train.train_dir")
        os.makedirs(self.directory, exist_ok=True)
        self._clock = clock
        self._collect = collect_fn if collect_fn is not None else (
            lambda: signals.collect(
                self.directory,
                timeout=cfg.autopilot.scrape_timeout_secs,
                now=clock))
        self.registry = registry if registry is not None else \
            TelemetryRegistry(gauges=AUTOPILOT_GAUGES)
        self.registry.mark_unhealthy("starting: no control round yet")
        self.run_id = read_run_id(self.directory)
        self.spans = SpanTracer(self.directory,
                                filename=AUTOPILOT_EVENTS_FILE,
                                run_id=self.run_id)
        self.actuator = actuator if actuator is not None else \
            Actuator(cfg, self.directory, self.spans, clock=clock)

        self._lock = threading.Lock()   # in-memory state ONLY
        self._state = PolicyState()
        self._target: Optional[int] = None
        self._last: Optional[Decision] = None
        self._last_wall: Optional[float] = None
        self._counters = dict(rounds=0, signal_errors=0, scale_ups=0,
                              scale_downs=0, holds=0, spawns=0,
                              spawn_failures=0, admission_denied=0,
                              drains=0)
        self._slo_violation_s = 0.0
        self._replica_s = 0.0
        self._scale_up_latency_ms = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="tpu-resnet-torch-autopilot",
                                        daemon=True)

    # --------------------------------------------------------- one round
    def run_round(self) -> Decision:
        """One full control round; callable directly from tests."""
        cfg = self.cfg.autopilot
        snap = self._collect()                      # I/O, no lock
        # poll() BEFORE stamping replicas_pending: a spawn that is
        # healthy in THIS snapshot must not also count as pending, or
        # current = healthy + pending double-counts it for one round
        # and the above_max bound (which rightly bypasses cooldowns)
        # drains the replica the moment it is admitted — a flap loop.
        lifecycle = self.actuator.poll(snap)        # proc I/O, no lock
        snap = dataclasses.replace(
            snap, replicas_pending=self.actuator.pending_count())

        denied = [e for e in lifecycle
                  if e["kind"] == "admission_denied"]
        ready = [e for e in lifecycle if e["kind"] == "replica_ready"]
        failed = [e for e in lifecycle if e["kind"] == "spawn_failed"]

        with self._lock:
            state = self._state
            for _ in denied:
                state = note_admission_denied(state, snap.wall, cfg)
            decision, state = decide(snap, cfg, state)
            self._state = state
            c = self._counters
            c["rounds"] += 1
            if not snap.ok:
                c["signal_errors"] += 1
            c["admission_denied"] += len(denied)
            c["spawn_failures"] += len(failed)
            if ready:
                self._scale_up_latency_ms = ready[-1]["latency_ms"]
            key = {"scale_up": "scale_ups", "scale_down": "scale_downs",
                   "hold": "holds"}[decision.action]
            c[key] += 1
            if decision.target >= 0:
                self._target = decision.target
            # Integrators ride snapshot time, so a replayed trace
            # integrates identically.
            slo = effective_slo(snap, cfg) if snap.ok else 0.0
            if self._last_wall is not None and snap.ok:
                dt = max(0.0, snap.wall - self._last_wall)
                self._replica_s += snap.replicas_healthy * dt
                if (slo > 0 and snap.p99_ms is not None
                        and snap.p99_ms > slo):
                    self._slo_violation_s += dt
            if snap.ok:
                self._last_wall = snap.wall
            self._last = decision

        # ---- actuate + ledger: all I/O, no lock held ----
        for ev in lifecycle:
            self.spans.event(f"autopilot_{ev['kind']}",
                             **{k: v for k, v in ev.items()
                                if k != "kind"})
        self.spans.event(
            "autopilot_decision", action=decision.action,
            current=decision.current, target=decision.target,
            step=decision.step, reason=decision.reason,
            pressure=decision.pressure, ok=snap.ok,
            p99_ms=snap.p99_ms, slo_ms=effective_slo(snap, cfg),
            replicas_healthy=snap.replicas_healthy,
            replicas_pending=snap.replicas_pending,
            queue_depth=snap.queue_depth, shed_total=snap.shed_total,
            burn_fast=snap.burn_fast)

        if decision.action == "scale_up" and not self.actuator.observe_only:
            if self.actuator.lease_granted:
                # Reclaim the trainer's lease BEFORE the spawn: the new
                # replica's colocation admission must see the headroom.
                self.actuator.revoke_lease()
                self.spans.event("autopilot_capacity_revoke")
            spawned = 0
            for _ in range(decision.step):
                rec = self.actuator.spawn_replica()
                if rec is not None:
                    spawned += 1
                    self.spans.event("autopilot_spawn",
                                     name=rec["name"],
                                     pid_target=rec["pid"],
                                     reason=decision.reason)
            with self._lock:
                self._counters["spawns"] += spawned
        elif decision.action == "scale_down" \
                and not self.actuator.observe_only:
            drained = 0
            for _ in range(-decision.step):
                name = self.actuator.pick_drain_target(snap)
                if name is None:
                    break
                result = self.actuator.drain(snap, name)
                self.spans.event("autopilot_drain", name=name,
                                 ok=bool(result.get("ok")),
                                 error=result.get("error"))
                if result.get("ok"):
                    drained += 1
            if drained:
                self.actuator.grant_lease(drained)
                self.spans.event("autopilot_capacity_grant",
                                 freed_replicas=drained)
            with self._lock:
                self._counters["drains"] += drained

        self._publish(snap, decision)
        self._write_status(snap, decision)
        return decision

    # ------------------------------------------------------- publishing
    def _publish(self, snap, decision: Decision) -> None:
        with self._lock:
            c = dict(self._counters)
            target = self._target
            slo_violation = self._slo_violation_s
            replica_s = self._replica_s
            latency = self._scale_up_latency_ms
        util = (snap.requests_ok / replica_s) if replica_s > 0 else 0.0
        self.registry.update({
            "autopilot_rounds_total": c["rounds"],
            "autopilot_signal_errors_total": c["signal_errors"],
            "autopilot_scale_ups_total": c["scale_ups"],
            "autopilot_scale_downs_total": c["scale_downs"],
            "autopilot_holds_total": c["holds"],
            "autopilot_spawns_total": c["spawns"],
            "autopilot_spawn_failures_total": c["spawn_failures"],
            "autopilot_admission_denied_total": c["admission_denied"],
            "autopilot_drains_total": c["drains"],
            "autopilot_target_replicas":
                float(target if target is not None else -1),
            "autopilot_replicas_total": snap.replicas_total,
            "autopilot_replicas_healthy": snap.replicas_healthy,
            "autopilot_p99_ms": snap.p99_ms or 0.0,
            "autopilot_slo_ms": effective_slo(snap, self.cfg.autopilot),
            "autopilot_burn_rate_fast": snap.burn_fast or 0.0,
            "autopilot_scale_up_latency_ms": latency,
            "autopilot_slo_violation_seconds": round(slo_violation, 3),
            "autopilot_replica_seconds": round(replica_s, 3),
            "autopilot_utilization": round(util, 4),
            "autopilot_capacity_granted":
                1.0 if self.actuator.lease_granted else 0.0,
        })
        self.registry.heartbeat(c["rounds"])
        if snap.ok:
            self.registry.clear_unhealthy()
        else:
            self.registry.mark_unhealthy("; ".join(snap.errors)
                                         or "no signals")

    def _write_status(self, snap, decision: Decision) -> None:
        """Atomic latest-round record (the scenario-assertion and
        operator surface). Single writer: the loop thread."""
        status = self.status()
        status["decision"] = decision.to_dict()
        status["snapshot_ok"] = snap.ok
        path = os.path.join(self.directory, AUTOPILOT_STATUS_FILE)
        tmp = path + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(status, f, indent=2)
            os.replace(tmp, path)
        except OSError as e:  # pragma: no cover - fs-specific
            log.warning("autopilot: status write failed: %s", e)

    def status(self) -> dict:
        """Counters + policy state, thread-safe read."""
        with self._lock:
            return {"target": self._target,
                    "counters": dict(self._counters),
                    "state": self._state.to_dict(),
                    "slo_violation_seconds":
                        round(self._slo_violation_s, 3),
                    "replica_seconds": round(self._replica_s, 3),
                    "scale_up_latency_ms": self._scale_up_latency_ms,
                    "last_decision": (self._last.to_dict()
                                      if self._last else None)}

    # -------------------------------------------------------- lifecycle
    def _loop(self) -> None:
        interval = max(0.05, self.cfg.autopilot.poll_interval_secs)
        while not self._stop.is_set():
            try:
                self.run_round()
            except Exception:  # noqa: BLE001 - the controller outlives
                log.exception("autopilot: control round failed")
                with self._lock:
                    self._counters["signal_errors"] += 1
            self._stop.wait(interval)

    def start(self) -> "AutopilotController":
        self.spans.event(
            "autopilot_start", directory=self.directory,
            min_replicas=self.cfg.autopilot.min_replicas,
            max_replicas=self.cfg.autopilot.max_replicas,
            poll_interval_secs=self.cfg.autopilot.poll_interval_secs,
            observe_only=self.actuator.observe_only)
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop and JOIN the loop before closing any writer the loop
        appends to, then reap the actuator's children."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=15.0)
        self.actuator.close()
        self.spans.event("autopilot_stop")
        self.spans.close()
