"""The autopilot's actuation: every side effect lives here (the
reference's ``tpu_resnet/autopilot/actuator.py``).

The policy (``policy.py``) resolves what should happen; this module makes
it happen through contracts that already exist:

- **scale-up** spawns a replica from the ``autopilot.spawn_cmd``
  template, by default wrapped in the port's supervisor
  (``python -m tpu_resnet_torch.tools.supervise --stop-codes 3``):
  crashes restart with decorrelated-jitter backoff, the colocation
  verdict stays terminal. The child announces itself in the discovery
  directory (``serve.replica_name={name}``) and the router's
  watch-discovery probation admits it on merit. Exit 3 (no capacity
  here) becomes an ``admission_denied`` event, a policy input that arms
  the scale-up backoff, not a crash.
- **scale-down** drains through the router's ``/admin/drain``
  (``serve/router.request_drain``): in-flight requests finish, then the
  replica gets its SIGTERM and exits 0, so no client request fails.
- **capacity handoff**: a drain frees card memory; the actuator grants
  it to a colocated trainer by writing ``capacity_lease.json``
  atomically, and revokes the lease before the next spawn, so the
  trainer and the new replica never both count on the headroom that
  colocation admission meters.

Each spawn (the supervisor and the replica under it) is a process group
of its own, so a teardown or an abandoned spawn signals the replica as
well as its supervisor. Only the controller's loop thread calls in here, so
there is no lock. Host code: no torch; the replicas it starts load it.
"""

from __future__ import annotations

import json
import logging
import os
import shlex
import signal
import subprocess
import sys
import time
from typing import List, Optional

from tpu_resnet_torch.config import RunConfig
from tpu_resnet_torch.hostenv import child_env
from tpu_resnet_torch.resilience import exitcodes

log = logging.getLogger("tpu_resnet_torch")

CAPACITY_LEASE_FILE = "capacity_lease.json"
SUPERVISE_MODULE = "tpu_resnet_torch.tools.supervise"


def _signal_group(proc, sig) -> None:
    """``sig`` to the process group a spawn leads: its supervisor and the
    replica under it."""
    try:
        os.killpg(proc.pid, sig)
    except ProcessLookupError:  # every process of the group has exited
        pass


def read_capacity_lease(directory: str) -> Optional[dict]:
    try:
        with open(os.path.join(directory, CAPACITY_LEASE_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class _Spawn:
    """One launched replica: the Popen handle plus admission state."""

    def __init__(self, name: str, proc: subprocess.Popen,
                 started_wall: float, log_path: str):
        self.name = name
        self.proc = proc
        self.started_wall = started_wall
        self.log_path = log_path
        self.admitted = False   # seen healthy in a router snapshot
        self.done = False       # process reaped (any reason)


class Actuator:
    def __init__(self, cfg: RunConfig, directory: str, spans,
                 clock=time.time):
        self.cfg = cfg
        self.directory = directory
        self.spans = spans
        self._clock = clock
        self._spawns: List[_Spawn] = []
        self._ordinal = 0
        self._lease_granted = False

    # ------------------------------------------------------- spawning
    @property
    def observe_only(self) -> bool:
        """No spawn template = decisions are ledgered and gauged but
        nothing is spawned or drained (the dry-run deployment mode and
        the unit-test default)."""
        return not self.cfg.autopilot.spawn_cmd.strip()

    def pending_count(self) -> int:
        return sum(1 for s in self._spawns
                   if not s.admitted and not s.done)

    def live_spawn_names(self) -> List[str]:
        return [s.name for s in self._spawns if not s.done]

    def _build_argv(self, name: str, ordinal: int) -> List[str]:
        tokens = shlex.split(self.cfg.autopilot.spawn_cmd)
        argv = [t.replace("{python}", sys.executable)
                 .replace("{name}", name)
                 .replace("{i}", str(ordinal)) for t in tokens]
        if self.cfg.autopilot.spawn_supervised:
            # --stop-codes 3: the colocation-admission denial ends
            # supervision and becomes the wrapper's own exit code, which
            # poll() reads as the policy input.
            argv = [sys.executable, "-m", SUPERVISE_MODULE,
                    "--max-restarts", "2", "--backoff-base", "0.5",
                    "--stop-codes", str(exitcodes.NO_CAPACITY),
                    "--"] + argv
        return argv

    def spawn_replica(self) -> Optional[dict]:
        """Launch one replica; returns {"name", "pid"} or None in
        observe-only mode."""
        if self.observe_only:
            return None
        name = f"{self.cfg.autopilot.replica_prefix}{self._ordinal}"
        argv = self._build_argv(name, self._ordinal)
        self._ordinal += 1
        log_path = os.path.join(self.directory,
                                f"autopilot_spawn_{name}.log")
        logf = open(log_path, "ab")
        try:
            proc = subprocess.Popen(argv, stdout=logf,
                                    stderr=subprocess.STDOUT,
                                    env=child_env(),
                                    start_new_session=True)
        finally:
            logf.close()  # the child holds its own fd now
        spawn = _Spawn(name, proc, float(self._clock()), log_path)
        self._spawns.append(spawn)
        log.info("autopilot: spawned replica %s (pid %d): %s", name,
                 proc.pid, " ".join(argv))
        return {"name": name, "pid": proc.pid}

    def poll(self, snapshot) -> List[dict]:
        """Advance every in-flight spawn against the newest snapshot;
        returns lifecycle events for the controller to ledger/count:
        ``replica_ready`` (with the spawn->healthy latency the autoscale
        scenarios gate), ``admission_denied`` (exit 3 — arms the policy
        backoff), ``spawn_failed`` (crash or blown ready budget)."""
        events: List[dict] = []
        wall = float(getattr(snapshot, "wall", self._clock()))
        healthy_names = {
            r.get("name") for r in getattr(snapshot, "replicas", ())
            if r.get("state") == "closed" and not r.get("draining")
            and not r.get("pending")}
        for s in self._spawns:
            if s.done:
                continue
            rc = s.proc.poll()
            if not s.admitted and s.name in healthy_names:
                s.admitted = True
                events.append({
                    "kind": "replica_ready", "name": s.name,
                    "latency_ms":
                        round((wall - s.started_wall) * 1000.0, 1)})
                continue
            if rc is None:
                if (not s.admitted and wall - s.started_wall
                        > self.cfg.autopilot.ready_timeout_secs):
                    _signal_group(s.proc, signal.SIGTERM)
                    s.done = True
                    events.append({"kind": "spawn_failed",
                                   "name": s.name,
                                   "reason": "ready_timeout",
                                   "log": s.log_path})
                continue
            s.done = True
            if rc == exitcodes.NO_CAPACITY:
                events.append({"kind": "admission_denied",
                               "name": s.name, "rc": rc})
            elif rc == 0:
                # Drained (scale-down) or clean shutdown: expected end
                # of life, nothing to alarm about.
                events.append({"kind": "replica_gone", "name": s.name,
                               "rc": 0})
            else:
                events.append({"kind": "spawn_failed", "name": s.name,
                               "reason": f"exit {rc}", "rc": rc,
                               "log": s.log_path})
        return events

    # ------------------------------------------------------- draining
    def pick_drain_target(self, snapshot) -> Optional[str]:
        """LIFO over autopilot-owned replicas first (drain what we
        added, newest first), else the lexicographically-last healthy
        externally-managed replica."""
        healthy = [r.get("name")
                   for r in getattr(snapshot, "replicas", ())
                   if r.get("state") == "closed"
                   and not r.get("draining") and not r.get("pending")]
        owned = [s.name for s in self._spawns
                 if not s.done and s.name in healthy]
        if owned:
            return owned[-1]
        return sorted(healthy)[-1] if healthy else None

    def drain(self, snapshot, name: str) -> dict:
        """Rolling drain through the router's admin contract."""
        from tpu_resnet_torch.serve.router import request_drain

        port = getattr(snapshot, "router_port", None)
        if port is None:
            return {"ok": False, "error": "router port unknown"}
        return request_drain(f"http://127.0.0.1:{port}", name,
                             timeout=self.cfg.route.drain_timeout_secs
                             + 10.0)

    # ------------------------------------------------ capacity lease
    @property
    def lease_granted(self) -> bool:
        return self._lease_granted

    def _write_lease(self, state: str, freed: int) -> None:
        path = os.path.join(self.directory, CAPACITY_LEASE_FILE)
        tmp = path + f".tmp.{os.getpid()}"
        body = {"state": state, "holder": "trainer",
                "freed_replicas": int(freed),
                "wall": round(float(self._clock()), 3)}
        try:
            with open(tmp, "w") as f:
                json.dump(body, f, indent=2)
            os.replace(tmp, path)
        except OSError as e:
            log.warning("autopilot: capacity lease write failed: %s", e)

    def grant_lease(self, freed: int) -> None:
        """Scale-down freed capacity: hand it to the colocated
        trainer."""
        if not self.cfg.autopilot.capacity_lease:
            return
        self._write_lease("granted", freed)
        self._lease_granted = True

    def revoke_lease(self) -> None:
        """Reclaim BEFORE a spawn: the new replica's colocation
        admission must see the headroom the trainer was lent."""
        if not self._lease_granted:
            return
        self._write_lease("revoked", 0)
        self._lease_granted = False

    # ------------------------------------------------------ lifecycle
    def close(self, timeout: float = 10.0) -> None:
        """The autopilot owns the replicas it spawned: SIGTERM each live
        spawn's process group, supervisor and replica (the serve drain
        contract exits 0), and reap; whoever started the autopilot knows
        only its own children, so a replica left here would outlive
        it."""
        for s in self._spawns:
            if s.done or s.proc.poll() is not None:
                continue
            _signal_group(s.proc, signal.SIGTERM)
        for s in self._spawns:
            if s.done:
                continue
            try:
                s.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:  # pragma: no cover
                _signal_group(s.proc, signal.SIGKILL)
                s.proc.wait(timeout=5.0)
            s.done = True
