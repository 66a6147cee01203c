"""The port's serving-fleet router (``tpu_resnet_torch/serve/router.py``)
and load generator (``tpu_resnet_torch/tools/loadgen.py``) held against
the reference's (``tpu_resnet/serve/router.py``, ``tools/loadgen.py``).

Pure units on the same seeded inputs: the circuit breaker step by step,
discovery with torn files, the gauge and histogram sets, the loadgen's
qps schedules and failure classes. Then the reference's in-process router
cases on the port: a port ``Router`` in front of two port
``PredictServer``s over stub backends (millisecond start-up), and the
``route`` CLI in a subprocess."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tools import loadgen as ref_loadgen
from tpu_resnet.obs import server as ref_obs_server
from tpu_resnet.serve import router as ref_router
from tpu_resnet_torch.main import main as port_main
from tpu_resnet_torch.obs import server as obs_server
from tpu_resnet_torch.obs.manifest import ensure_run_id
from tpu_resnet_torch.obs.spans import load_spans
from tpu_resnet_torch.obs.trace import ROUTE_EVENTS_FILE
from tpu_resnet_torch.serve.router import (CircuitBreaker,
                                           _AttributedError,
                                           discover_replicas,
                                           read_route_port, request_drain,
                                           write_route_discovery)
from tpu_resnet_torch.serve.server import write_discovery
from tpu_resnet_torch.tools import loadgen
from torch_fleet_util import (http_get, http_post, img, mk_replica,
                              mk_router, stop_all, wait_for)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ pure units
@pytest.mark.parametrize("threshold, open_secs, seed",
                         [(1, 0.5, 0), (2, 5.0, 1), (3, 1.0, 2)])
def test_circuit_breaker_steps_as_the_reference(threshold, open_secs, seed):
    """One seeded walk of clock advances, successes and failures through
    both breakers: their states are equal after every step."""
    clock = [0.0]
    port = CircuitBreaker(threshold, open_secs, clock=lambda: clock[0])
    ref = ref_router.CircuitBreaker(threshold, open_secs,
                                    clock=lambda: clock[0])
    rng = np.random.default_rng(seed)
    seen = set()
    for _ in range(400):
        op = rng.integers(0, 4)
        if op == 0:
            clock[0] += float(rng.exponential(open_secs / 2))
        elif op == 1:
            port.record_success()
            ref.record_success()
        else:
            port.record_failure()
            ref.record_failure()
        assert (port.state, port.closed, port._failures) == \
            (ref.state, ref.closed, ref._failures)
        seen.add(port.state)
    assert seen == {"closed", "open", "half_open"}


def test_discovery_as_the_reference_with_torn_files(tmp_path):
    d = str(tmp_path)
    write_discovery(d, 8001, run_id="rid1", name="r0")
    write_discovery(d, 8002, run_id="rid1", name="r1")
    write_discovery(d, 8003, run_id="rid1")           # bare serve.json
    (tmp_path / "serve-torn.json").write_text('{"port": 80')
    (tmp_path / "serve-noport.json").write_text('{"pid": 1}')
    (tmp_path / "serve_other.txt").write_text("not discovery")
    (tmp_path / "served.json").write_text('{"port": 9}')
    got = discover_replicas(d)
    assert got == ref_router.discover_replicas(d)
    assert {r["name"] for r in got} == {"r0", "r1", "default"}
    assert all(r["pid"] == os.getpid() for r in got)
    assert discover_replicas(str(tmp_path / "none")) == []


def test_route_discovery_read_by_either(tmp_path):
    assert read_route_port(str(tmp_path)) is None
    write_route_discovery(str(tmp_path), 8500, run_id="rid")
    assert ref_router.read_route_port(str(tmp_path)) == 8500
    ref_router.write_route_discovery(str(tmp_path), 8501, run_id="rid")
    assert read_route_port(str(tmp_path)) == 8501
    with open(tmp_path / "route.json") as f:
        rec = json.load(f)
    assert rec["pid"] == os.getpid() and rec["run_id"] == "rid"


@pytest.mark.parametrize("name", ["ROUTE_GAUGES", "FLEET_GAUGES",
                                  "ROUTE_HISTOGRAMS"])
def test_series_sets_are_the_reference_sets(name):
    assert getattr(obs_server, name) == getattr(ref_obs_server, name)


@pytest.mark.parametrize("scenario", loadgen.SCENARIOS)
def test_loadgen_qps_schedule_as_the_reference(scenario):
    assert loadgen.SCENARIOS == ref_loadgen.SCENARIOS
    for frac in np.linspace(-0.1, 1.1, 61):
        assert loadgen.qps_factor(scenario, float(frac)) == \
            ref_loadgen.qps_factor(scenario, float(frac))


def test_loadgen_failure_classes_as_the_reference():
    """A refused connection (-1), a reply past the deadline (-2), and each
    status's tally, as the reference's loadgen counts them."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    dead = sock.getsockname()[1]
    sock.close()
    silent = socket.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(1)
    try:
        for fire in (loadgen._fire, ref_loadgen._fire):
            assert fire(f"http://127.0.0.1:{dead}", b"x", "1,8,8,3",
                        2.0) == -1
            assert fire(f"http://127.0.0.1:{silent.getsockname()[1]}",
                        b"x", "1,8,8,3", 0.3) == -2
    finally:
        silent.close()
    port_st, ref_st = loadgen.ClientStats(), ref_loadgen.ClientStats()
    for status in (200, 429, -2, -1, 500, 200, 404, 503):
        loadgen._note(port_st, status, 3, 1.5)
        ref_loadgen._note(ref_st, status, 3, 1.5)
        loadgen_trace = (port_st.mint_trace(), ref_st.mint_trace())
        assert loadgen_trace[0] == loadgen_trace[1]
    keys = ("ok", "rejected", "failed", "timeouts", "connect_failures",
            "images", "latencies_ms")
    assert {k: getattr(port_st, k) for k in keys} == \
        {k: getattr(ref_st, k) for k in keys}


# ------------------------------------------------------ in-process fleet
def _replica(router, name):
    return next(r for r in router.replicas() if r.name == name)


def _route_spans(router, d, kind=None):
    router.spans.close()
    spans = load_spans(os.path.join(d, ROUTE_EVENTS_FILE))
    return [s for s in spans if kind is None or s["span"] == kind]


@pytest.fixture()
def fleet(tmp_path):
    d = str(tmp_path)
    rid = ensure_run_id(d)
    replicas = [mk_replica(d, "r0"), mk_replica(d, "r1")]
    router = mk_router(d).start()
    # Healthy AND probed: image_shape arrives with the first /info probe.
    wait_for(lambda: sum(1 for r in router.replicas()
                      if r.healthy and r.image_shape) == 2, 10)
    yield router, replicas, d, rid
    stop_all(*replicas, router=router)


def test_router_spreads_reports_and_forwards_the_query(fleet):
    router, (s0, s1), d, rid = fleet
    assert router.run_id == rid
    for i in range(12):
        code, out, headers = http_post(router.port, img(i % 7).tobytes(),
                                   query="?logits=1")
        assert code == 200 and out["predictions"] == [i % 7]
        assert out["logits"][0][i % 7] == 1.0   # the query reached it
        assert headers.get("X-Replica") in ("r0", "r1")
    assert s0.backend.batches > 0 and s1.backend.batches > 0
    code, health = http_get(router.port, "/healthz")
    assert code == 200 and health["replicas_healthy"] == 2
    code, info = http_get(router.port, "/info")
    assert info["counters"]["ok"] == 12 and info["image_shape"] == [8, 8, 3]
    with urllib.request.urlopen(
            f"http://127.0.0.1:{router.port}/metrics", timeout=5) as r:
        text = r.read().decode()
    names = {line.split()[2] for line in text.splitlines()
             if line.startswith("# TYPE")}
    assert {f"tpu_resnet_{n}" for n, _ in obs_server.ROUTE_GAUGES} | {
        f"tpu_resnet_{n}" for n, _, _ in obs_server.ROUTE_HISTOGRAMS} <= names
    gauges = obs_server.parse_prometheus(text)
    assert gauges["tpu_resnet_route_replicas_healthy"] == 2.0


def test_failover_retry_covers_passive_death(fleet):
    """A replica that dies without the prober noticing: the in-flight
    connect failure retries on the survivor — no client error."""
    router, (s0, s1), d, rid = fleet
    router._stop.set()          # freeze the prober: passive path only
    time.sleep(0.3)
    stop_all(s0)                   # connection refused from now on
    for _ in range(30):
        code, out, _ = http_post(router.port, img(1).tobytes())
        assert code == 200, out
    with router._lock:
        counters = dict(router._counters)
    assert counters["retries"] >= 1 and counters["replica_errors"] >= 1
    assert not _replica(router, "r0").healthy


def test_probe_excludes_and_readmits(fleet):
    router, (s0, s1), d, rid = fleet
    s1.registry.mark_unhealthy("wedged for the drill")
    wait_for(lambda: not _replica(router, "r1").healthy)
    s1.registry.clear_unhealthy()
    wait_for(lambda: _replica(router, "r1").healthy)
    spans = _route_spans(router, d)
    kinds = [s["span"] for s in spans]
    assert "replica_down" in kinds and "replica_up" in kinds
    assert all(s["run_id"] == rid for s in spans)


@pytest.mark.parametrize("case", ["deadline", "no_replicas"])
def test_unanswerable_requests_are_retryable_errors(tmp_path, case):
    """A hung fleet answers 504 at the client's deadline (the retry never
    blows the budget); an empty one 503 with Retry-After."""
    d = str(tmp_path)
    slow = mk_replica(d, "slow", delay=5.0) if case == "deadline" else None
    router = mk_router(d).start()
    try:
        if slow is not None:
            wait_for(lambda: any(r.healthy for r in router.replicas()))
        t0 = time.monotonic()
        code, out, headers = http_post(router.port, img(0).tobytes(),
                                   headers={"X-Deadline-Ms": "400"})
        if case == "deadline":
            assert code == 504 and "deadline" in out["error"]
            assert time.monotonic() - t0 < 3.0
        else:
            assert code == 503 and out["retryable"]
            assert "Retry-After" in headers
        assert out["retryable"] and headers.get("X-Trace-Id")
    finally:
        router.close()
        if slow is not None:
            stop_all(slow, hung=True)


def _prime_ring(router, values):
    with router._lat_lock:
        router._latencies[:] = values
        router._last_latency_at = router._clock()
        router._p_cache = (0.0, 0.0, 0.0)


@pytest.mark.parametrize("hard_factor, lane, want", [
    (100.0, "batch", 429),        # the batch lane sheds first
    (100.0, "interactive", 200),  # interactive admitted below hard
    (1.5, "interactive", 429),    # past slo * hard_factor it sheds too
])
def test_slo_shedding_by_lane(fleet, hard_factor, lane, want):
    router, replicas, d, rid = fleet
    router.cfg.route.slo_ms = 50.0
    router.cfg.route.shed_hard_factor = hard_factor
    _prime_ring(router, [200.0] * 64)          # rolling p99 over the SLO
    code, out, headers = http_post(router.port, img(2).tobytes(),
                               headers={"X-Lane": lane,
                                        "X-Trace-Id": f"t-{lane}"})
    assert code == want
    assert headers.get("X-Trace-Id") == f"t-{lane}"
    if want == 429:
        assert out["lane"] == lane and headers.get("Retry-After") == "1"
        (span,) = [s for s in _route_spans(router, d, "route_request")
                   if s["trace_id"] == f"t-{lane}"]
        assert span["sampled"] == "shed" and span["decision"] == "shed"
        assert span["status"] == 429 and span["run_id"] == rid


def test_slo_shed_releases_when_signal_goes_stale(fleet):
    router, replicas, d, rid = fleet
    router.cfg.route.slo_ms = 50.0
    _prime_ring(router, [200.0] * 64)
    assert http_post(router.port, img(1).tobytes(),
                 headers={"X-Lane": "batch"})[0] == 429
    with router._lat_lock:
        router._last_latency_at = router._clock() - 10.0
    assert http_post(router.port, img(1).tobytes(),
                 headers={"X-Lane": "batch"})[0] == 200
    with router._lat_lock:
        assert len(router._latencies) <= 2


def test_hedged_send_wins_on_slow_primary(tmp_path):
    d = str(tmp_path)
    slow, fast = mk_replica(d, "slow", delay=1.0), mk_replica(d, "fast")
    router = mk_router(d, hedge_ms=60.0).start()
    try:
        wait_for(lambda: sum(r.healthy for r in router.replicas()) == 2)
        used = []
        t0 = time.monotonic()
        status, payload, _, answered = router._attempt(
            _replica(router, "slow"), img(4).tobytes(),
            {"Content-Type": "application/octet-stream",
             "X-Shape": "1,8,8,3"}, remaining=10.0, exclude=(), used=used)
        assert time.monotonic() - t0 < 0.9
        assert status == 200 and json.loads(payload)["predictions"] == [4]
        assert answered.name == "fast" and set(used) == {"slow", "fast"}
        with router._lock:
            c = dict(router._counters)
        assert c["hedges"] == 1 and c["hedge_wins"] == 1
    finally:
        router.close()
        stop_all(fast)
        stop_all(slow, hung=True)


def test_hedged_attempt_failure_is_attributed_once(tmp_path):
    d = str(tmp_path)
    dead = mk_replica(d, "dead")
    stop_all(dead)
    router = mk_router(d, hedge_ms=30.0, fail_threshold=2)
    router._stop.set()
    router.start()
    try:
        r_dead = _replica(router, "dead")
        with pytest.raises(_AttributedError):
            router._attempt(r_dead, img(0).tobytes(),
                            {"Content-Type": "application/octet-stream",
                             "X-Shape": "1,8,8,3"},
                            remaining=2.0, exclude=(), used=[])
        assert r_dead.breaker._failures == 1
        code, out, headers = http_post(router.port, img(0).tobytes(),
                                   headers={"X-Trace-Id": "err-1"})
        assert code in (502, 503) and headers.get("X-Trace-Id") == "err-1"
    finally:
        router.close()


def test_admin_drain_excludes_and_spans(fleet):
    router, (s0, s1), d, rid = fleet
    result = router.drain_replica("r0", kill=False, timeout=5.0)
    assert result["ok"] and result["inflight_at_signal"] == 0
    assert not _replica(router, "r0").healthy
    for _ in range(6):
        code, _, headers = http_post(router.port, img(1).tobytes())
        assert code == 200 and headers.get("X-Replica") == "r1"
    bad = request_drain(f"http://127.0.0.1:{router.port}", "nope")
    assert not bad["ok"] and "unknown replica" in bad["error"]
    (drain,) = _route_spans(router, d, "route_drain")
    assert drain["replica"] == "r0" and drain["run_id"] == rid


def test_route_drain_cli_against_a_running_router(fleet, capsys):
    """``route --drain NAME`` posts the admin drain of a running router
    (found through route.json) and exits 0 on success, 1 on a refusal;
    the replica's record names this process, so it is excluded and not
    signalled."""
    router, (s0, s1), d, rid = fleet
    write_route_discovery(d, router.port)
    assert port_main(["route", "--drain", "nope",
                      f"route.discover_dir={d}"]) == 1
    assert "unknown replica" in capsys.readouterr().out
    assert port_main(["route", "--drain", "r1", "--router-url",
                      f"http://127.0.0.1:{router.port}"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["replica"] == "r1"
    assert "signalled" not in out or out["signalled"] is False
    assert not _replica(router, "r1").healthy


def test_restarted_replica_re_resolved_from_discovery(fleet):
    router, (s0, s1), d, rid = fleet
    old_url = _replica(router, "r0").url
    stop_all(s0)
    replacement = mk_replica(d, "r0")   # a new port, the same name
    try:
        wait_for(lambda: _replica(router, "r0").url != old_url
              and _replica(router, "r0").healthy, 6)
        assert http_post(router.port, img(5).tobytes())[0] == 200
        assert "replica_resolved" in [
            s["span"] for s in _route_spans(router, d)]
    finally:
        stop_all(replacement)


def test_trace_id_minted_echoed_and_spanned(fleet):
    router, (s0, s1), d, rid = fleet
    code, _, headers = http_post(router.port, img(2).tobytes(),
                             headers={"X-Trace-Id": "cli-abc"})
    assert code == 200 and headers.get("X-Trace-Id") == "cli-abc"
    code, _, headers = http_post(router.port, img(2).tobytes())
    assert code == 200 and len(headers.get("X-Trace-Id", "")) == 16
    for i in range(60):
        http_post(router.port, img(i % 7).tobytes())
    spans = _route_spans(router, d, "route_request")
    assert spans, "no route_request span after 62 requests"
    s = spans[0]
    assert s["trace_id"] and s["status"] == 200 and s["lane"] == "interactive"
    assert s["replica"] in ("r0", "r1") and s["sampled"] in ("sampled", "slow")
    assert s["legs"][-1]["answered"] == s["replica"] and s["run_id"] == rid


@pytest.mark.parametrize("watch", [True, False])
def test_watch_discovery_probation(tmp_path, watch):
    """With route.watch_discovery a replica announced after boot waits out
    of rotation until its first healthy probe (a replica_admitted span);
    without it, it is admitted as it appears. Boot-time replicas never
    wait."""
    d = str(tmp_path)
    ensure_run_id(d)
    s0 = mk_replica(d, "r0")
    router = mk_router(d, watch_discovery=watch)      # not started
    s1 = None
    try:
        assert not _replica(router, "r0").pending
        s1 = mk_replica(d, "r1")
        router.refresh_discovery()
        r1 = _replica(router, "r1")
        assert r1.pending is watch and r1.healthy is not watch
        assert r1.describe()["pending"] is watch
        router.probe_once()
        assert not r1.pending and r1.healthy
        kinds = [s["span"] for s in _route_spans(router, d)]
        assert ("replica_admitted" in kinds) is watch
    finally:
        router.close()
        stop_all(s0, *([s1] if s1 else []))


# ---------------------------------------------------------------- the CLI
def test_route_cli_serves_healthz_and_exits_0_on_sigterm(tmp_path):
    """``python -m tpu_resnet_torch route`` with an empty discovery dir:
    announces route.json, /healthz 503 (no healthy replica) with the
    reason, /metrics with the route series, exit 0 on SIGTERM. Without
    replicas or a discovery dir it exits 2."""
    d = str(tmp_path)
    assert port_main(["route", "train.train_dir="]) == 2
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_resnet_torch", "route",
         f"route.discover_dir={d}", "route.host=127.0.0.1", "route.port=0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        wait_for(lambda: read_route_port(d) is not None, 30)
        port = read_route_port(d)
        code, health = http_get(port, "/healthz")
        assert code == 503 and health["replicas_healthy"] == 0
        assert health["unhealthy_reason"] == "no healthy replicas"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=5) as r:
            assert b"tpu_resnet_route_replicas_total 0" in r.read()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, out
        assert "route: exited cleanly" in out
        kinds = [s["span"] for s in
                 load_spans(os.path.join(d, ROUTE_EVENTS_FILE))]
        assert kinds[0] == "route_start"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
