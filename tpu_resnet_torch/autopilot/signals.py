"""Signal plane of the autopilot: one snapshot a control round (the
reference's ``tpu_resnet/autopilot/signals.py``, field for field).

:func:`collect` is the only I/O on the sensing side: it dials the port
router's ``/info`` (rolling p99 against the advertised ``route.slo_ms``,
shed and lane counters, each replica's queue depth and rotation state;
the port is read from ``route.json`` by ``serve/router.read_route_port``)
and reads fleetmon's digest-verified ``fleet_snapshot.json``
(``obs/fleet.read_fleet_snapshot``: pooled percentiles, burn rates, each
endpoint's device-memory gauges) into one frozen :class:`SignalSnapshot`.
The policy does no I/O and the collector decides nothing: a snapshot
written into ``autopilot_events.jsonl`` comes back through
:meth:`SignalSnapshot.from_dict` and replays to the same decisions.

An unreachable router makes the snapshot ``ok=False`` (the policy holds
on blind rounds); a missing or digest-failing fleet snapshot leaves the
fleet fields ``None`` (fleetmon enriches, the router suffices). Host
code: the standard library and the port's host modules, no torch.
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.request
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SignalSnapshot:
    """One round of fleet signals, frozen at ``wall``."""

    wall: float
    ok: bool = False                      # router answered /info
    errors: Tuple[str, ...] = ()
    # ------------------------------------------------- router signals
    router_port: Optional[int] = None
    p99_ms: Optional[float] = None        # rolling router p99
    slo_ms: float = 0.0                   # advertised route.slo_ms
    requests_total: float = 0.0
    requests_ok: float = 0.0
    shed_total: float = 0.0               # cumulative 429s (all lanes)
    inflight: float = 0.0
    queue_depth: float = 0.0              # summed across replicas
    replicas_total: int = 0
    replicas_healthy: int = 0
    # In-flight spawns the controller already launched but the router
    # has not admitted yet — filled by the controller, not collect():
    # the policy must count capacity en route or it double-spawns.
    replicas_pending: int = 0
    # Per-replica rotation detail, one small dict per replica (name,
    # state, draining, pending, inflight, queue_depth).
    replicas: Tuple[dict, ...] = ()
    # ------------------------------------------------ fleetmon signals
    fleet_p99_ms: Optional[float] = None  # pooled, bucket-merged
    burn_fast: Optional[float] = None
    burn_slow: Optional[float] = None
    fleet_round: Optional[int] = None
    # name -> {"hbm_bytes_in_use": ..., "hbm_bytes_limit": ...} for
    # endpoints that export HBM gauges (the colocation headroom view).
    hbm: Tuple[Tuple[str, dict], ...] = ()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["errors"] = list(self.errors)
        d["replicas"] = [dict(r) for r in self.replicas]
        d["hbm"] = {name: dict(v) for name, v in self.hbm}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SignalSnapshot":
        d = dict(d)
        d["errors"] = tuple(d.get("errors", ()))
        d["replicas"] = tuple(d.get("replicas", ()))
        hbm = d.get("hbm", {})
        if isinstance(hbm, dict):
            hbm = tuple(sorted(hbm.items()))
        d["hbm"] = tuple(hbm)
        return cls(**d)


def _get_json(url: str, timeout: float) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def replica_is_healthy(rec: dict) -> bool:
    """Rotation verdict from a router /info replica record — must match
    Replica.healthy (breaker closed, not draining, not in the
    watch-discovery probation)."""
    return (rec.get("state") == "closed" and not rec.get("draining")
            and not rec.get("pending"))


def collect(directory: str, timeout: float = 2.0,
            now=time.time) -> SignalSnapshot:
    """Scrape one snapshot from the fleet rooted at ``directory``."""
    from tpu_resnet_torch.obs.fleet import read_fleet_snapshot
    from tpu_resnet_torch.serve.router import read_route_port

    wall = float(now())
    errors = []

    port = read_route_port(directory)
    info = None
    if port is None:
        errors.append("no route.json — router not announced yet")
    else:
        try:
            info = _get_json(f"http://127.0.0.1:{port}/info", timeout)
        except (OSError, ValueError) as e:
            errors.append(f"router /info: {type(e).__name__}: {e}"[:160])

    fleet = read_fleet_snapshot(directory)

    if info is None:
        return SignalSnapshot(
            wall=wall, ok=False, errors=tuple(errors),
            router_port=port,
            fleet_p99_ms=(fleet or {}).get("fleet", {}).get("p99_ms"),
            burn_fast=(fleet or {}).get("burn_rate_fast"),
            burn_slow=(fleet or {}).get("burn_rate_slow"),
            fleet_round=(fleet or {}).get("round"))

    counters = info.get("counters", {})
    replicas = []
    for rec in info.get("replicas", []):
        replicas.append({
            "name": rec.get("name"), "state": rec.get("state"),
            "draining": bool(rec.get("draining")),
            "pending": bool(rec.get("pending")),
            "inflight": int(rec.get("inflight") or 0),
            "queue_depth": int(rec.get("queue_depth") or 0)})
    healthy = sum(1 for r in replicas if replica_is_healthy(r))

    hbm = {}
    for name, per in ((fleet or {}).get("per") or {}).items():
        if isinstance(per, dict) and "hbm_bytes_in_use" in per:
            hbm[name] = {"hbm_bytes_in_use": per["hbm_bytes_in_use"],
                         "hbm_bytes_limit":
                         per.get("hbm_bytes_limit", 0.0)}

    return SignalSnapshot(
        wall=wall, ok=True, errors=tuple(errors), router_port=port,
        p99_ms=float(info.get("p99_ms") or 0.0),
        slo_ms=float(info.get("slo_ms") or 0.0),
        requests_total=float(counters.get("requests", 0)),
        requests_ok=float(counters.get("ok", 0)),
        shed_total=float(counters.get("shed", 0)),
        inflight=float(sum(r["inflight"] for r in replicas)),
        queue_depth=float(sum(r["queue_depth"] for r in replicas)),
        replicas_total=len(replicas),
        replicas_healthy=healthy,
        replicas=tuple(replicas),
        fleet_p99_ms=(fleet or {}).get("fleet", {}).get("p99_ms"),
        burn_fast=(fleet or {}).get("burn_rate_fast"),
        burn_slow=(fleet or {}).get("burn_rate_slow"),
        fleet_round=(fleet or {}).get("round"),
        hbm=tuple(sorted(hbm.items())))
