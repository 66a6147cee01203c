"""The port's autopilot (``tpu_resnet_torch/autopilot/``) against the
reference's (``tpu_resnet/autopilot/``).

- Policy parity: seeded random walks of ~300 signal snapshots (p99 across
  both bands, queue, shed and burn pressure, blind rounds, fleets below
  the floor, admission denials) through both ``decide``/``replay`` under
  four configurations built from the same field values: the same
  decisions and the same end state, exactly (both are pure Python).
- The reference's unit cases (``tests/test_autopilot.py``) on the port's
  modules: the policy table, snapshots and ``collect``, the controller's
  counters, gauges, status file and ledger (also against the
  reference's controller over one trace), the actuator's argv around
  ``-m tpu_resnet_torch.tools.supervise``, the LIFO drain target, the
  capacity lease, the CLI's refusal without a fleet directory.
- End to end on the CPU: the port's router, one ``serve --device cpu``
  MLP replica and ``python -m tpu_resnet_torch autopilot`` with
  ``min_replicas=2``: the floor restore spawns a supervised replica that
  the router admits; ``autopilot_status.json`` and ``/metrics`` agree;
  SIGTERM reaps the spawn; ``trace-export`` shows the autopilot lane.
"""

import json
import os
import signal
import subprocess
import sys
import types
import urllib.request

import numpy as np
import pytest

from tpu_resnet.autopilot import controller as ref_controller
from tpu_resnet.autopilot import policy as ref_policy
from tpu_resnet.autopilot import signals as ref_signals
from tpu_resnet.config import AutopilotConfig as RefAutopilotConfig
from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.obs import server as ref_server
from tpu_resnet_torch.autopilot import signals
from tpu_resnet_torch.autopilot.actuator import (Actuator, _Spawn,
                                                 read_capacity_lease)
from tpu_resnet_torch.autopilot.cli import autopilot, read_autopilot_port
from tpu_resnet_torch.autopilot.controller import (AUTOPILOT_STATUS_FILE,
                                                   AutopilotController)
from tpu_resnet_torch.autopilot.policy import (PolicyState, decide,
                                               effective_slo,
                                               note_admission_denied,
                                               replay)
from tpu_resnet_torch.autopilot.signals import SignalSnapshot
from tpu_resnet_torch.config import AutopilotConfig, load_config
from tpu_resnet_torch.obs.server import (AUTOPILOT_GAUGES,
                                         parse_prometheus)
from tpu_resnet_torch.obs.spans import load_spans
from tpu_resnet_torch.obs.trace import AUTOPILOT_EVENTS_FILE
from tpu_resnet_torch.resilience import exitcodes
from torch_fleet_util import mk_replica, mk_router, stop_all, wait_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _snap(wall, p99=None, healthy=1, pending=0, ok=True, shed=0.0,
          queue=0.0, burn=None, slo=0.0, replicas=(), port=None):
    return SignalSnapshot(
        wall=float(wall), ok=ok, p99_ms=p99, slo_ms=float(slo),
        replicas_healthy=healthy, replicas_pending=pending,
        replicas_total=healthy, shed_total=float(shed),
        queue_depth=float(queue), burn_fast=burn,
        replicas=tuple(replicas), router_port=port)


def _cfg(**kw):
    base = dict(slo_ms=100.0, up_rounds=2, down_rounds=3,
                min_replicas=1, max_replicas=4,
                scale_up_cooldown_secs=10.0,
                scale_down_cooldown_secs=60.0,
                admission_backoff_secs=30.0)
    base.update(kw)
    return AutopilotConfig(**base)


# --------------------------------------------------------- policy parity
# Four configurations, each built from the same field values for both
# packages: the reference's test defaults; an adopted SLO with one-round
# streaks and wide steps; narrow bands with non-latency pressure easy to
# trip; a fixed fleet with a long admission backoff.
PARITY_CONFIGS = {
    "test_defaults": dict(slo_ms=100.0, up_rounds=2, down_rounds=3,
                          min_replicas=1, max_replicas=4,
                          scale_up_cooldown_secs=10.0,
                          scale_down_cooldown_secs=60.0,
                          admission_backoff_secs=30.0),
    "adopted_slo_wide_steps": dict(slo_ms=0.0, up_rounds=1, down_rounds=1,
                                   min_replicas=2, max_replicas=3,
                                   scale_up_cooldown_secs=0.0,
                                   scale_down_cooldown_secs=5.0,
                                   max_step_up=2, max_step_down=2,
                                   admission_backoff_secs=5.0),
    "narrow_bands": dict(slo_ms=50.0, up_band=0.8, down_band=0.3,
                         queue_high=4.0, burn_high=3.0, min_replicas=0,
                         max_replicas=6, up_rounds=3, down_rounds=5,
                         scale_up_cooldown_secs=20.0,
                         scale_down_cooldown_secs=40.0, max_step_up=3,
                         admission_backoff_secs=12.0),
    "fixed_fleet": dict(slo_ms=200.0, min_replicas=3, max_replicas=3,
                        admission_backoff_secs=100.0),
}
WALK_ROUNDS = 300


def _walk(seed: int):
    """A seeded random walk of snapshot fields through calm, middling and
    stormy stretches, and the rounds before which an admission denial
    lands."""
    rng = np.random.default_rng(seed)
    wall, shed, healthy, regime = 1000.0, 0.0, 2, 0
    advertised = float(rng.choice([0.0, 120.0]))
    walk, denials = [], set()
    for i in range(WALK_ROUNDS):
        if rng.random() < 0.08:
            regime = int(rng.integers(0, 3))   # calm, middling, storm
        wall += float(rng.uniform(0.2, 4.0))
        p99 = float((15.0, 70.0, 250.0)[regime]
                    * np.exp(rng.normal(0.0, 0.3)))
        if regime == 2 and rng.random() < 0.3:
            shed += float(rng.integers(1, 20))
        healthy = int(np.clip(healthy + rng.choice([-1, 0, 0, 0, 0, 1]),
                              0, 7))
        queue = (0, 1, 2, 12, 40)[int(rng.integers(0, 2 + 3 * (regime > 0)))]
        burn = (None if rng.random() < 0.4 else
                float(rng.choice([0.0, 0.5] if regime == 0
                                 else [0.5, 2.0, 7.0, 20.0])))
        walk.append(dict(
            wall=wall, ok=bool(rng.random() > 0.06),
            p99_ms=None if rng.random() < 0.05 else p99,
            slo_ms=advertised, shed_total=shed, queue_depth=float(queue),
            replicas_healthy=healthy, replicas_total=healthy,
            replicas_pending=int(rng.choice([0, 0, 0, 1])),
            burn_fast=burn))
        if rng.random() < 0.04:
            denials.add(i)
    return walk, denials


def _policy_run(pol, snap_cls, cfg, walk, denials):
    state, out = pol.PolicyState(), []
    for i, fields in enumerate(walk):
        snap = snap_cls(**fields)
        if i in denials:
            state = pol.note_admission_denied(state, snap.wall, cfg)
        decision, state = pol.decide(snap, cfg, state)
        out.append(decision.to_dict())
    return out, state.to_dict()


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("name", sorted(PARITY_CONFIGS))
def test_policy_matches_reference_on_random_walks(name, seed):
    walk, denials = _walk(seed)
    cfg = AutopilotConfig(**PARITY_CONFIGS[name])
    ref_cfg = RefAutopilotConfig(**PARITY_CONFIGS[name])
    got = _policy_run(sys.modules[decide.__module__], SignalSnapshot, cfg,
                      walk, denials)
    want = _policy_run(ref_policy, ref_signals.SignalSnapshot, ref_cfg,
                       walk, denials)
    assert got == want
    decisions, end = replay([SignalSnapshot(**f) for f in walk], cfg)
    ref_decisions, ref_end = ref_policy.replay(
        [ref_signals.SignalSnapshot(**f) for f in walk], ref_cfg)
    assert [d.to_dict() for d in decisions] == \
        [d.to_dict() for d in ref_decisions]
    assert end.to_dict() == ref_end.to_dict()
    assert {d["action"] for d in got[0]} == {"scale_up", "scale_down",
                                             "hold"}


def test_random_walks_cover_every_policy_branch():
    """Across the configurations the walks reach every reason the policy
    can give, so the parity above is not parity of one branch."""
    reasons = set()
    for seed in range(2):
        walk, denials = _walk(seed)
        for kw in PARITY_CONFIGS.values():
            decisions, _ = _policy_run(
                sys.modules[decide.__module__], SignalSnapshot,
                AutopilotConfig(**kw), walk, denials)
            reasons |= {d["reason"] for d in decisions}
    fixed = {"signals_unavailable", "admission_backoff", "below_min",
             "above_max", "at_max", "at_min", "up_cooldown",
             "down_cooldown", "steady", "pressure_up_building",
             "pressure_down_building", "p99_low"}
    assert fixed <= reasons, sorted(fixed - reasons)
    assert {"p99", "shed", "queue", "burn"} <= {
        part for r in reasons for part in r.split("+")}


# ----------------------------------------------------------- pure policy
def test_scale_up_needs_a_full_pressure_streak():
    cfg = _cfg()
    state = PolicyState()
    d1, state = decide(_snap(0, p99=95), cfg, state)       # 95 > 90
    assert d1.action == "hold" and d1.pressure == "up"
    assert d1.reason == "pressure_up_building"
    d2, state = decide(_snap(1, p99=95), cfg, state)
    assert d2.action == "scale_up" and d2.reason == "p99"
    assert (d2.current, d2.target, d2.step) == (1, 2, 1)
    assert state.up_streak == 0 and state.last_up_wall == 1.0


@pytest.mark.parametrize("p99s,healthy", [((60, 85), 1), ((95, 45), 2)],
                         ids=["inside_corridor", "across_up_band"])
def test_oscillating_p99_never_flaps(p99s, healthy):
    decisions, _ = replay([_snap(i, p99=p99s[i % 2], healthy=healthy)
                           for i in range(30)], _cfg())
    assert all(d.action == "hold" for d in decisions)


def test_scale_up_cooldown_holds_then_releases():
    cfg = _cfg(up_rounds=1)
    state = PolicyState()
    d, state = decide(_snap(0, p99=150), cfg, state)
    assert d.action == "scale_up"
    d, state = decide(_snap(1, p99=150, healthy=2), cfg, state)
    assert d.action == "hold" and d.reason == "up_cooldown"
    d, state = decide(_snap(11, p99=150, healthy=2), cfg, state)
    assert d.action == "scale_up" and state.last_up_wall == 11.0


def test_scale_down_cooldown_anchors_on_last_actuation():
    cfg = _cfg(up_rounds=1, down_rounds=1)
    state = PolicyState()
    d, state = decide(_snap(0, p99=150), cfg, state)
    assert d.action == "scale_up"
    d, state = decide(_snap(5, p99=20, healthy=2), cfg, state)
    assert d.action == "hold" and d.reason == "down_cooldown"
    d, state = decide(_snap(61, p99=20, healthy=2), cfg, state)
    assert d.action == "scale_down" and d.step == -1
    assert state.last_down_wall == 61.0
    d, state = decide(_snap(200, p99=20, healthy=1), cfg, state)
    assert d.action == "hold" and d.reason == "at_min"


def test_admission_backoff_delays_the_below_min_restore():
    cfg = _cfg()
    state = note_admission_denied(PolicyState(), wall=0.0, cfg=cfg)
    assert state.denied_until == 30.0 and state.up_streak == 0
    d, state = decide(_snap(5, healthy=0), cfg, state)
    assert d.action == "hold" and d.reason == "admission_backoff"
    d, state = decide(_snap(31, healthy=0), cfg, state)
    assert d.action == "scale_up" and d.reason == "below_min"
    d, state = decide(_snap(32, healthy=0, pending=1), cfg, state)
    assert d.action == "hold" and d.current == 1


@pytest.mark.parametrize("healthy,p99,kw,want", [
    (0, None, {}, ("scale_up", "below_min", 1, 1)),
    (0, None, {"max_step_up": 5}, ("scale_up", "below_min", 2, 2)),
    (5, None, {}, ("scale_down", "above_max", -1, 4)),
    (5, None, {"max_step_down": 5}, ("scale_down", "above_max", -2, 3)),
    (3, 150, {}, ("hold", "at_max", 0, 3)),
], ids=["floor", "floor_clamped", "ceiling", "ceiling_clamped", "at_max"])
def test_bounds_beat_everything_and_steps_clamp(healthy, p99, kw, want):
    cfg = _cfg(min_replicas=2, max_replicas=3, up_rounds=1, **kw)
    d, _ = decide(_snap(0, p99=p99, healthy=healthy), cfg, PolicyState())
    assert (d.action, d.reason, d.step, d.target) == want


def test_blind_rounds_hold_and_reset_streaks():
    cfg = _cfg()
    state = PolicyState()
    _, state = decide(_snap(0, p99=150), cfg, state)
    assert state.up_streak == 1
    d, state = decide(_snap(1, ok=False), cfg, state)
    assert d.action == "hold" and d.reason == "signals_unavailable"
    assert d.current == -1
    assert state.up_streak == 0 and state.down_streak == 0
    d, state = decide(_snap(2, p99=150), cfg, state)
    assert d.action == "hold"
    d, state = decide(_snap(3, p99=150), cfg, state)
    assert d.action == "scale_up"


def test_shed_high_water_mark_fires_on_raises_only():
    cfg = _cfg(slo_ms=0.0)
    state = PolicyState()
    d, state = decide(_snap(0, shed=5), cfg, state)
    assert d.pressure == "up" and state.shed_seen == 5.0
    d, state = decide(_snap(1, shed=5), cfg, state)
    assert d.pressure == "none"
    d, state = decide(_snap(2, shed=9), cfg, state)
    assert d.pressure == "up" and state.shed_seen == 9.0


@pytest.mark.parametrize("advertised,explicit,want", [
    (250, 0.0, 250.0), (250, 400.0, 400.0), (0, 0.0, 0.0)])
def test_effective_slo_prefers_explicit_over_advertised(advertised,
                                                        explicit, want):
    assert effective_slo(_snap(0, slo=advertised),
                         _cfg(slo_ms=explicit)) == want


def test_replay_is_bit_identical_and_state_roundtrips():
    cfg = _cfg(up_rounds=1, down_rounds=2, scale_up_cooldown_secs=0.0,
               scale_down_cooldown_secs=5.0)
    trace = [_snap(0, p99=150), _snap(1, ok=False),
             _snap(2, p99=150, healthy=2, shed=3),
             _snap(3, p99=20, healthy=2), _snap(4, p99=20, healthy=2),
             _snap(10, p99=20, healthy=2), _snap(11, p99=20, healthy=2),
             _snap(12, p99=60, healthy=1), _snap(13, healthy=0)]
    first, end1 = replay(trace, cfg)
    second, end2 = replay(trace, cfg)
    assert first == second and end1 == end2
    assert [d.action for d in first].count("scale_up") >= 2
    assert "scale_down" in [d.action for d in first]
    assert PolicyState.from_dict(end1.to_dict()) == end1


# --------------------------------------------------------------- signals
def test_signal_snapshot_json_roundtrip():
    snap = _snap(7.5, p99=42.0, healthy=2, shed=3, port=8080,
                 replicas=[{"name": "r0", "state": "closed",
                            "draining": False, "pending": False,
                            "inflight": 1, "queue_depth": 0}])
    snap = SignalSnapshot(**{**snap.__dict__,
                             "errors": ("router /info: timeout",),
                             "hbm": (("r0", {"hbm_bytes_in_use": 5.0,
                                             "hbm_bytes_limit": 10.0}),)})
    back = SignalSnapshot.from_dict(json.loads(json.dumps(snap.to_dict())))
    assert back.to_dict() == snap.to_dict()
    assert back.wall == 7.5 and back.errors == snap.errors
    assert ref_signals.SignalSnapshot.from_dict(
        snap.to_dict()).to_dict() == snap.to_dict()


def test_collect_on_empty_dir_is_an_explicit_blind_round(tmp_path):
    snap = signals.collect(str(tmp_path))
    assert not snap.ok
    assert "route.json" in snap.errors[0]
    assert snap.to_dict() == ref_signals.collect(
        str(tmp_path), now=lambda: snap.wall).to_dict()


def test_collect_matches_reference_on_a_live_router(tmp_path):
    """Both collectors read the same port router (two stub replicas, one
    draining) and the same fleetmon snapshot into the same snapshot."""
    from tpu_resnet_torch.obs.fleet import write_fleet_snapshot
    from tpu_resnet_torch.serve.router import write_route_discovery

    d = str(tmp_path)
    r0, r1 = mk_replica(d, "r0"), mk_replica(d, "r1")
    router = mk_router(d).start()
    try:
        write_route_discovery(d, router.port)
        wait_for(lambda: sum(r.healthy for r in router.replicas()) == 2, 10)
        next(r for r in router.replicas() if r.name == "r1").draining = True
        write_fleet_snapshot(d, {
            "round": 4, "fleet": {"p99_ms": 12.5}, "burn_rate_fast": 2.5,
            "burn_rate_slow": 0.5,
            "per": {"r0": {"hbm_bytes_in_use": 3.0,
                           "hbm_bytes_limit": 8.0}, "r1": {}}})
        got = signals.collect(d, now=lambda: 5.0)
        want = ref_signals.collect(d, now=lambda: 5.0)
    finally:
        stop_all(r0, r1, router=router)
    assert got.ok and got.to_dict() == want.to_dict()
    assert (got.replicas_total, got.replicas_healthy) == (2, 1)
    assert got.burn_fast == 2.5 and dict(got.hbm) == {
        "r0": {"hbm_bytes_in_use": 3.0, "hbm_bytes_limit": 8.0}}


# ------------------------------------------------------------ controller
def _ctl_cfg(tmp_path, loader=load_config, **auto):
    cfg = loader()
    cfg.autopilot.discover_dir = str(tmp_path)
    cfg.autopilot.slo_ms = 100.0
    cfg.autopilot.up_rounds = 2
    cfg.autopilot.min_replicas = 1
    cfg.autopilot.max_replicas = 4
    for k, v in auto.items():
        setattr(cfg.autopilot, k, v)
    return cfg


def test_gauge_set_is_the_references():
    assert AUTOPILOT_GAUGES == ref_server.AUTOPILOT_GAUGES


def test_controller_round_counters_gauges_status_and_ledger(tmp_path):
    """Three scripted rounds (hold, scale_up, blind) in observe-only mode:
    counters, integrators, gauges, ``autopilot_status.json`` and the
    ledger describe the same rounds, and the reference's controller over
    the same trace reports the same status and gauges."""
    trace = [_snap(0, p99=150), _snap(1, p99=150), _snap(2, ok=False)]
    it = iter(trace)
    ctl = AutopilotController(_ctl_cfg(tmp_path),
                              collect_fn=lambda: next(it))
    ref_dir = tmp_path / "ref"
    ref_it = iter([ref_signals.SignalSnapshot.from_dict(s.to_dict())
                   for s in trace])
    ref_ctl = ref_controller.AutopilotController(
        _ctl_cfg(ref_dir, ref_load_config), collect_fn=lambda: next(ref_it))
    try:
        assert ctl.run_round().action == "hold"
        assert ctl.run_round().action == "scale_up"
        assert ctl.run_round().reason == "signals_unavailable"
        for _ in trace:
            ref_ctl.run_round()
        status = ctl.status()
        assert status == ref_ctl.status()
        c = status["counters"]
        assert c["rounds"] == 3 and c["scale_ups"] == 1
        assert c["holds"] == 2 and c["signal_errors"] == 1
        assert c["spawns"] == 0
        assert status["target"] == 2
        assert status["replica_seconds"] == 1.0
        assert status["slo_violation_seconds"] == 1.0
        gauges = parse_prometheus(ctl.registry.render())
        ref_gauges = parse_prometheus(ref_ctl.registry.render())
        names = [f"tpu_resnet_{n}" for n, _ in AUTOPILOT_GAUGES]
        assert {n: gauges[n] for n in names} == \
            {n: ref_gauges[n] for n in names}
        assert gauges["tpu_resnet_autopilot_rounds_total"] == 3.0
        assert gauges["tpu_resnet_autopilot_target_replicas"] == 2.0
        with open(os.path.join(str(tmp_path), AUTOPILOT_STATUS_FILE)) as f:
            on_disk = json.load(f)
        assert on_disk["counters"] == c
        assert on_disk["decision"]["reason"] == "signals_unavailable"
    finally:
        ctl.close()
        ref_ctl.close()
    spans = load_spans(os.path.join(str(tmp_path), AUTOPILOT_EVENTS_FILE))
    decisions = [s for s in spans if s["span"] == "autopilot_decision"]
    assert [s["action"] for s in decisions] == ["hold", "scale_up", "hold"]
    assert decisions[0]["reason"] == "pressure_up_building"


class _FakeActuator:
    """Scripted lifecycle events and recorded spawns; not observe-only, so
    the controller takes its actuation branch."""

    observe_only = False
    lease_granted = False

    def __init__(self, events):
        self.events = list(events)
        self.spawned = []

    def pending_count(self):
        return 0

    def poll(self, snapshot):
        return self.events.pop(0) if self.events else []

    def spawn_replica(self):
        self.spawned.append(f"ap{len(self.spawned)}")
        return {"name": self.spawned[-1], "pid": 4000 + len(self.spawned)}

    def close(self):
        pass


def test_controller_admission_denied_then_backoff_then_spawn(tmp_path):
    denial = [{"kind": "admission_denied", "name": "ap0", "rc": 3}]
    fake = _FakeActuator([denial, []])
    it = iter([_snap(0, healthy=0), _snap(40, healthy=0)])
    ctl = AutopilotController(_ctl_cfg(tmp_path),
                              collect_fn=lambda: next(it), actuator=fake)
    try:
        d1 = ctl.run_round()
        assert d1.action == "hold" and d1.reason == "admission_backoff"
        d2 = ctl.run_round()
        assert d2.action == "scale_up" and d2.reason == "below_min"
        assert fake.spawned == ["ap0"]
        c = ctl.status()["counters"]
        assert c["admission_denied"] == 1 and c["spawns"] == 1
    finally:
        ctl.close()
    kinds = [s["span"] for s in load_spans(
        os.path.join(str(tmp_path), AUTOPILOT_EVENTS_FILE))]
    assert "autopilot_admission_denied" in kinds
    assert "autopilot_spawn" in kinds


def _stub_proc(rc=None):
    """A spawn's stand-in; its pid (above any pid_max) leads no group."""
    return types.SimpleNamespace(pid=2 ** 22 + 1, poll=lambda: rc,
                                 wait=lambda timeout=None: rc)


def test_controller_admitted_spawn_is_not_also_counted_pending(tmp_path):
    """The round that first sees a spawn healthy must not also count it
    pending, or ``above_max`` drains it the moment it is admitted."""
    rec = {"state": "closed", "draining": False, "pending": False}
    ctl = AutopilotController(
        _ctl_cfg(tmp_path, max_replicas=2), collect_fn=lambda: _snap(
            10.0, p99=300, healthy=2,
            replicas=({"name": "r0", **rec}, {"name": "ap0", **rec})))
    try:
        ctl.actuator._spawns.append(_Spawn("ap0", _stub_proc(), 8.0, ""))
        assert ctl.actuator.pending_count() == 1
        d = ctl.run_round()
        assert d.action == "hold" and d.current == 2
        assert ctl.actuator.pending_count() == 0
        assert ctl.status()["scale_up_latency_ms"] == 2000.0
    finally:
        ctl.close()
    spans = load_spans(os.path.join(str(tmp_path), AUTOPILOT_EVENTS_FILE))
    ready = [s for s in spans if s["span"] == "autopilot_replica_ready"]
    assert len(ready) == 1 and ready[0]["name"] == "ap0"
    decision = [s for s in spans if s["span"] == "autopilot_decision"][-1]
    assert decision["replicas_pending"] == 0


@pytest.mark.parametrize("rc,kind", [
    (exitcodes.NO_CAPACITY, "admission_denied"), (0, "replica_gone"),
    (1, "spawn_failed")])
def test_actuator_poll_reads_the_spawns_exit(tmp_path, rc, kind):
    """Exit 3 is the policy input; 0 a drained replica; others a
    failure."""
    act = Actuator(load_config(), str(tmp_path), spans=None,
                   clock=lambda: 5.0)
    act._spawns.append(_Spawn("ap0", _stub_proc(rc), 1.0, "log"))
    events = act.poll(types.SimpleNamespace(wall=5.0, replicas=()))
    assert [e["kind"] for e in events] == [kind]
    assert act.pending_count() == 0


# -------------------------------------------------------------- actuator
@pytest.mark.parametrize("supervised", [True, False])
def test_actuator_builds_argv_from_template(tmp_path, supervised):
    cfg = load_config()
    cfg.autopilot.spawn_cmd = ("{python} -m tpu_resnet_torch serve "
                               "serve.replica_name={name} data.seed={i}")
    cfg.autopilot.spawn_supervised = supervised
    argv = Actuator(cfg, str(tmp_path), spans=None)._build_argv("ap3", 3)
    tail = [sys.executable, "-m", "tpu_resnet_torch", "serve",
            "serve.replica_name=ap3", "data.seed=3"]
    if supervised:
        assert argv == [sys.executable, "-m",
                        "tpu_resnet_torch.tools.supervise",
                        "--max-restarts", "2", "--backoff-base", "0.5",
                        "--stop-codes", str(exitcodes.NO_CAPACITY),
                        "--", *tail]
    else:
        assert argv == tail


def test_actuator_drain_target_is_lifo_owned_first(tmp_path):
    act = Actuator(load_config(), str(tmp_path), spans=None)

    def rec(name):
        return {"name": name, "state": "closed", "draining": False,
                "pending": False}

    snap = types.SimpleNamespace(
        replicas=(rec("r0"), rec("ap0"), rec("ap1")))
    assert act.pick_drain_target(snap) == "r0"
    for name in ("ap0", "ap1"):
        act._spawns.append(_Spawn(name, types.SimpleNamespace(), 0.0, ""))
    assert act.pick_drain_target(snap) == "ap1"
    act._spawns[-1].done = True
    assert act.pick_drain_target(snap) == "ap0"
    assert act.pick_drain_target(types.SimpleNamespace(replicas=())) is None


def test_capacity_lease_grant_and_revoke_roundtrip(tmp_path):
    d = str(tmp_path)
    act = Actuator(load_config(), d, spans=None, clock=lambda: 123.0)
    assert read_capacity_lease(d) is None
    act.grant_lease(2)
    lease = read_capacity_lease(d)
    assert lease == {"state": "granted", "holder": "trainer",
                     "freed_replicas": 2, "wall": 123.0}
    assert act.lease_granted
    act.revoke_lease()
    assert read_capacity_lease(d)["state"] == "revoked"
    assert not act.lease_granted


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    with open(f"/proc/{pid}/stat") as f:   # a zombie is not alive
        return f.read().rsplit(")", 1)[1].split()[0] != "Z"


def test_actuator_close_ends_the_spawns_whole_group(tmp_path):
    """A spawn's teardown reaches the process under its supervisor too."""
    d = str(tmp_path)
    child = os.path.join(d, "child.pid")
    cfg = load_config()
    cfg.autopilot.spawn_supervised = False
    cfg.autopilot.spawn_cmd = (
        "{python} -c \"import subprocess, sys; p = subprocess.Popen("
        "[sys.executable, '-c', 'import time; time.sleep(60)']); "
        f"open('{child}', 'w').write(str(p.pid)); p.wait()\"")
    act = Actuator(cfg, d, spans=None)
    act.spawn_replica()
    wait_for(lambda: os.path.exists(child) and open(child).read(), 10)
    pid = int(open(child).read())
    assert _alive(pid)
    act.close(timeout=10)
    wait_for(lambda: not _alive(pid), 5)


# ---------------------------------------------------------------- wiring
def test_cli_refuses_to_run_without_a_fleet_directory():
    cfg = load_config()
    cfg.autopilot.discover_dir = ""
    cfg.train.train_dir = ""
    assert autopilot(cfg) == exitcodes.USAGE_ERROR


def test_autopilot_command_loads_no_torch():
    """``python -m tpu_resnet_torch autopilot`` is host code: refused for
    want of a directory, it has loaded no torch and nothing of JAX or the
    reference."""
    code = ("import sys; from tpu_resnet_torch.main import main; "
            "rc = main(['autopilot', 'train.train_dir=']); "
            "print(rc, sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'tpu_resnet')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    assert out.strip() == "2 []", out


# ------------------------------------------------------------ end to end
SERVE = ["--preset", "smoke", "model.name=mlp", "serve.host=127.0.0.1",
         "serve.port=0", "serve.reload_interval_secs=0"]


def test_autopilot_restores_the_floor_with_a_supervised_replica(tmp_path):
    import torch

    from tpu_resnet_torch.hostenv import child_env
    from tpu_resnet_torch.models import build_model, init_weights
    from tpu_resnet_torch.obs.manifest import ensure_run_id
    from tpu_resnet_torch.obs.trace import export_trace
    from tpu_resnet_torch.serve.router import write_route_discovery
    from tpu_resnet_torch.train import checkpoint

    d = str(tmp_path)
    run_id = ensure_run_id(d)
    checkpoint.save(d, 1, init_weights(build_model(load_config(
        "smoke", "", ["model.name=mlp"])), torch.Generator().manual_seed(0)))
    router = mk_router(d, watch_discovery=True).start()
    write_route_discovery(d, router.port, run_id=run_id)
    procs = {}

    def spawn(name, args):
        """A child on one intra-op thread (so are the autopilot's spawns,
        which inherit its environment): the suite's workers share the
        host's cores."""
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "tpu_resnet_torch", *args],
            env=child_env({"OMP_NUM_THREADS": "1"}), cwd=REPO,
            stdout=open(os.path.join(d, f"{name}.log"), "w"),
            stderr=subprocess.STDOUT)

    def healthy():
        return sorted(r.name for r in router.replicas() if r.healthy)

    try:
        spawn("r0", ["serve", "--device", "cpu", *SERVE,
                     f"train.train_dir={d}", "serve.replica_name=r0"])
        wait_for(lambda: healthy() == ["r0"], 30)
        template = " ".join(["{python} -m tpu_resnet_torch serve --device "
                             "cpu", *SERVE, f"train.train_dir={d}",
                             "serve.replica_name={name}"])
        spawn("autopilot", [
            "autopilot", f"autopilot.discover_dir={d}",
            "autopilot.host=127.0.0.1", "autopilot.poll_interval_secs=0.2",
            "autopilot.min_replicas=2", "autopilot.max_replicas=2",
            "autopilot.slo_ms=1000", f"autopilot.spawn_cmd={template}"])
        wait_for(lambda: healthy() == ["ap0", "r0"], 40)
        status_path = os.path.join(d, AUTOPILOT_STATUS_FILE)

        def settled():
            with open(status_path) as f:
                st = json.load(f)
            # ap0 seen healthy (the stopwatch stopped), none pending.
            return (st["decision"]["reason"] == "at_min"
                    and st["scale_up_latency_ms"] > 0 and st)
        wait_for(lambda: os.path.exists(status_path) and settled(), 10)
        status = settled()
        port = read_autopilot_port(d)
        gauges = parse_prometheus(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode())
        c = status["counters"]
        assert (c["spawns"], c["scale_ups"], c["spawn_failures"],
                c["admission_denied"], c["drains"]) == (1, 1, 0, 0, 0)
        for key in ("spawns", "scale_ups", "scale_downs", "drains",
                    "spawn_failures", "admission_denied"):
            assert gauges[f"tpu_resnet_autopilot_{key}_total"] == c[key], key
        assert gauges["tpu_resnet_autopilot_target_replicas"] == \
            status["target"] == 2
        assert gauges["tpu_resnet_autopilot_replicas_healthy"] == 2
        assert gauges["tpu_resnet_autopilot_scale_up_latency_ms"] == \
            status["scale_up_latency_ms"] > 0
        with open(os.path.join(d, "serve-ap0.json")) as f:
            ap0_pid = json.load(f)["pid"]
        procs["autopilot"].send_signal(signal.SIGTERM)
        assert procs["autopilot"].wait(timeout=30) == 0
        wait_for(lambda: not _alive(ap0_pid), 10)
        _, trace = export_trace(d)
        assert trace["metadata"]["source_run_ids"]["autopilot"] == [run_id]
        names = {e["name"] for e in trace["traceEvents"]}
        assert {"autopilot_spawn", "autopilot_replica_ready",
                "replica_admitted"} <= names
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
            proc.wait(timeout=30)
        router.close()
