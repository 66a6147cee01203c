"""The port's fleet telemetry plane (``tpu_resnet_torch/obs/fleet.py``,
``tools/obs_scrape.py``) and load-generator scenarios held against the
reference's (``tpu_resnet/obs/fleet.py``, ``tpu_resnet/tools/
obs_scrape.py``): the burn math, the bucket-wise merge, discovery, the
alert across rounds, the snapshot file and the fleet report on the same
seeded inputs; the aggregators of both over the same live endpoints;
``obs_scrape --fleet``'s exit codes; loadgen's scenarios through a port
router; and the ``fleetmon`` CLI in a subprocess."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.obs import fleet as ref_fleet
from tpu_resnet.obs import server as ref_obs_server
from tpu_resnet.tools import obs_scrape as ref_obs_scrape
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.main import main as port_main
from tpu_resnet_torch.obs import fleet
from tpu_resnet_torch.obs.manifest import ensure_run_id
from tpu_resnet_torch.obs.server import (LATENCY_BUCKETS_MS, SERVE_GAUGES,
                                         SERVE_HISTOGRAMS, Histogram,
                                         TelemetryRegistry, TelemetryServer,
                                         histogram_quantile, merge_histograms)
from tpu_resnet_torch.obs.spans import load_spans
from tpu_resnet_torch.serve.discovery import write_record
from tpu_resnet_torch.tools import loadgen, obs_scrape
from torch_fleet_util import http_get, mk_replica, mk_router, stop_all, \
    wait_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hist_of(samples, edges=LATENCY_BUCKETS_MS):
    h = Histogram("serve_latency_ms", edges=edges)
    for s in samples:
        h.observe(float(s))
    return h.snapshot()


def _seeded_hists(seed, n=4):
    rng = np.random.default_rng(seed)
    return [_hist_of(rng.gamma(2.0, float(rng.uniform(2, 200)),
                               size=int(rng.integers(0, 300))))
            for _ in range(n)]


# ------------------------------------------------------ the math, units
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_and_quantiles_as_the_reference(seed):
    hists = _seeded_hists(seed)
    got = merge_histograms(hists)
    assert got == ref_obs_server.merge_histograms(hists)
    for q in (0.5, 0.9, 0.95, 0.99):
        assert histogram_quantile(got, q) == \
            ref_obs_server.histogram_quantile(got, q)
    skewed = _hist_of([5.0], edges=(1.0, 10.0, 100.0))
    for merge in (merge_histograms, ref_obs_server.merge_histograms):
        with pytest.raises(ValueError, match="mismatched bucket edges"):
            merge([hists[0] or _hist_of([1.0]), skewed])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cumulative_at_and_burn_rate_as_the_reference(seed):
    rng = np.random.default_rng(seed + 10)
    old, add = _seeded_hists(seed, 2)
    cur = merge_histograms([old, add])
    for x in [0.0, 0.5, 3.0, 17.0, 250.0, 5000.0, 1e9,
              *rng.uniform(0, 3000, 20)]:
        assert fleet.cumulative_at(cur, float(x)) == \
            ref_fleet.cumulative_at(cur, float(x))
    for slo_ms in (5.0, 50.0, 333.0):
        for target in (0.9, 0.99, 0.999):
            for a, b in ((cur, old), (old, cur), (old, old), (cur, {})):
                assert fleet.burn_rate(a, b, slo_ms, target) == \
                    ref_fleet.burn_rate(a, b, slo_ms, target)


def test_discover_endpoints_as_the_reference(tmp_path):
    d = str(tmp_path)
    write_record(d, "route.json", 7001)
    write_record(d, "serve-r0.json", 7002, extra={"run_id": "abc"})
    write_record(d, "serve.json", 7003)
    write_record(d, "telemetry.json", 7004)
    write_record(d, "telemetry-host1.json", 7004)     # the same port
    write_record(d, "fleetmon.json", 7005)            # itself: left out
    (tmp_path / "serve-torn.json").write_text('{"port": 70')
    (tmp_path / "notes.json").write_text('{"port": 7006}')
    got = fleet.discover_endpoints(d)
    assert got == ref_fleet.discover_endpoints(d)
    assert {(e["kind"], e["port"]) for e in got} == {
        ("route", 7001), ("serve", 7002), ("serve", 7003), ("train", 7004)}
    assert fleet.discover_endpoints(str(tmp_path / "none")) == []


def _fleet_cfg(load, directory, **fleet_overrides):
    cfg = load("", "", [f"fleet.discover_dir={directory}", "fleet.port=-1"])
    for k, v in fleet_overrides.items():
        setattr(cfg.fleet, k, v)
    return cfg


def test_burn_alert_fires_and_clears_as_the_reference(tmp_path):
    """The same rounds through both aggregators' alert state machine: one
    alert fires when both windows burn, holds without re-firing, and
    clears after a quiet hour."""
    over = dict(slo_ms=10.0, slo_target=0.9, burn_alert_fast=5.0,
                burn_alert_slow=5.0, fast_window_secs=60.0,
                slow_window_secs=600.0)
    clock = {"t": 1000.0}
    port = fleet.FleetAggregator(
        _fleet_cfg(load_config, str(tmp_path / "p"), **over),
        clock=lambda: clock["t"])
    ref = ref_fleet.FleetAggregator(
        _fleet_cfg(ref_load_config, str(tmp_path / "r"), **over),
        clock=lambda: clock["t"])
    empty = {"buckets": [], "sum": 0.0, "count": 0}
    hot = _hist_of([400.0] * 100)
    rounds = []
    try:
        for dt, merged in ((0, empty), (5, hot), (5, hot), (3600, hot)):
            clock["t"] += dt
            got = port._note_round(clock["t"], merged)
            assert got == ref._note_round(clock["t"], merged)
            rounds.append(got[2:5])       # (fired, cleared, active)
        assert rounds == [(False, False, False), (True, False, True),
                          (False, False, True), (False, True, False)]
        assert port.snapshot() == ref.snapshot()
        assert port.snapshot()["alerts"] == 1
    finally:
        port.close()
        ref.close()


def test_fleet_snapshot_file_read_by_either(tmp_path):
    d = str(tmp_path)
    payload = {"round": 3, "fleet": {"p99_ms": 12.5}, "alert_active": False}
    fleet.write_fleet_snapshot(d, payload)
    assert ref_fleet.read_fleet_snapshot(d) == fleet.read_fleet_snapshot(d)
    assert fleet.read_fleet_snapshot(d)["round"] == 3
    ref_fleet.write_fleet_snapshot(d, {**payload, "round": 4})
    assert fleet.read_fleet_snapshot(d)["round"] == 4
    path = os.path.join(d, fleet.FLEET_SNAPSHOT_FILE)
    with open(path) as f:
        body = json.load(f)
    body["round"] = 5                           # a hand edit
    with open(path, "w") as f:
        json.dump(body, f)
    assert fleet.read_fleet_snapshot(d) is None
    assert fleet.read_fleet_snapshot(str(tmp_path / "none")) is None


def _report(snapshot):
    live = {"health": {"ok": True}, "metrics": {},
            "histograms": {fleet.SERVE_LATENCY_SERIES:
                           _hist_of([1.0, 7.0, 70.0, 700.0])}}
    stale = {"health": {"ok": False}, "metrics": {}, "histograms": {}}
    rows = [{"kind": "route", "name": "router", "port": 7001,
             "report": {"health": {"ok": True}, "histograms": {}}},
            {"kind": "serve", "name": "r0", "port": 7002, "report": live},
            {"kind": "serve", "name": "r1", "port": 7003, "report": stale},
            {"kind": "serve", "name": "dead", "port": 1,
             "error": "ConnectionRefusedError: [Errno 111]"}]
    merged = merge_histograms([live["histograms"][
        fleet.SERVE_LATENCY_SERIES]])
    return {"directory": "/d", "endpoints": rows, "fleet": merged,
            "snapshot": snapshot}


@pytest.mark.parametrize("as_json", [False, True])
@pytest.mark.parametrize("snapshot", [None, {
    "round": 9, "fleet": {"p99_ms": 61.5}, "burn_rate_fast": 14.2,
    "burn_rate_slow": 3.0}, "merge_error"])
def test_fleet_report_text_as_the_reference(snapshot, as_json):
    report = _report(None if snapshot == "merge_error" else snapshot)
    if snapshot == "merge_error":
        report["fleet"] = {"buckets": [], "sum": 0.0, "count": 0,
                           "merge_error": "mismatched bucket edges"}
    got = obs_scrape.format_fleet_report(report, as_json=as_json)
    assert got == ref_obs_scrape.format_fleet_report(report, as_json=as_json)
    assert ("(histogram merge)" in got) is (
        snapshot != "merge_error" and not as_json)


# ---------------------------------------------- live endpoints, scraped
def _serve_registry(latencies):
    reg = TelemetryRegistry(stale_after_sec=300.0, gauges=SERVE_GAUGES,
                            histograms=SERVE_HISTOGRAMS)
    for ms in latencies:
        reg.observe("serve_latency_ms", ms)
    reg.heartbeat(1)
    return reg


def test_aggregators_agree_on_live_endpoints(tmp_path):
    """Both aggregators' scrape rounds over the same two live endpoints and
    a dead one: equal records (but the wall clock), the degraded replica's
    stragglers in the pooled p99, one timeseries line each."""
    d = str(tmp_path)
    r0 = TelemetryServer(_serve_registry([5.0] * 90), 0, "127.0.0.1")
    r1 = TelemetryServer(_serve_registry([5.0] * 5 + [900.0] * 5), 0,
                         "127.0.0.1")
    write_record(d, "serve-r0.json", r0.port)
    write_record(d, "serve-r1.json", r1.port)
    write_record(d, "serve-dead.json", 1)
    over = dict(slo_ms=50.0, scrape_timeout_secs=30.0)
    aggs = [fleet.FleetAggregator(_fleet_cfg(load_config, d, **over),
                                  clock=lambda: 100.0),
            ref_fleet.FleetAggregator(_fleet_cfg(ref_load_config, d, **over),
                                      clock=lambda: 100.0)]
    try:
        got, want = (a.scrape_once() for a in aggs)
    finally:
        for a in aggs:
            a.close()
        r0.close()
        r1.close()
    assert got == want
    assert got["endpoints"] == 3 and got["up"] == 2 and got["errors"] == 1
    assert got["fleet"]["count"] == 100
    assert got["fleet"]["p99_ms"] > got["per"]["r0"]["serve_p99_ms"]
    assert "error" in got["per"]["dead"] and got["burn_rate_fast"] > 0.0
    m = aggs[0].registry.render()
    assert "tpu_resnet_fleet_endpoints_up 2" in m
    assert "tpu_resnet_fleet_requests_total 100" in m
    with open(os.path.join(d, fleet.FLEET_TIMESERIES_FILE)) as f:
        assert [json.loads(ln)["fleet"]["count"] for ln in f] == [100, 100]


def test_obs_scrape_fleet_exit_codes(tmp_path, capsys):
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert obs_scrape.main(["--fleet", empty]) == 2
    d = str(tmp_path / "fleet")
    srv = TelemetryServer(_serve_registry([5.0] * 20), 0, "127.0.0.1")
    write_record(d, "serve-r0.json", srv.port)
    write_record(d, "serve-dead.json", 1)
    try:
        assert obs_scrape.main(["--fleet", d]) == 3   # one endpoint down
        out = capsys.readouterr().out
        assert "r0" in out and "DOWN" in out and "(histogram merge)" in out
        os.remove(os.path.join(d, "serve-dead.json"))
        assert obs_scrape.main(["--fleet", d, "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["fleet"]["count"] == 20
        srv.registry.mark_unhealthy("wedged")
        assert obs_scrape.main(["--fleet", d]) == 3   # reachable, stale
    finally:
        srv.close()
    assert obs_scrape.main(["--fleet", d]) == 1       # none reachable
    with pytest.raises(SystemExit):
        obs_scrape.main(["--fleet", d, "--url", "localhost:1"])


# ------------------------------------------------------ loadgen scenarios
def _stub_fleet(d):
    """Two stub-backed port replicas behind a port router, both probed."""
    replicas = [mk_replica(d, "r0"), mk_replica(d, "r1")]
    router = mk_router(d).start()
    wait_for(lambda: sum(1 for r in router.replicas()
                         if r.healthy and r.image_shape) == 2, 10)
    return router, replicas


def test_loadgen_mixed_lane_through_the_router(tmp_path):
    d = str(tmp_path)
    rid = ensure_run_id(d)
    router, replicas = _stub_fleet(d)
    try:
        result = loadgen.run_load(f"http://127.0.0.1:{router.port}",
                                  clients=4, duration=1.0,
                                  scenario="mixed_lane")
    finally:
        stop_all(*replicas, router=router)
    assert result["failed"] == result["timeouts"] == 0
    assert result["connect_failures"] == 0 and result["run_id"] == rid
    assert set(result["lanes"]) == {"interactive", "batch"}
    assert result["lanes"]["batch"]["requests_ok"] > 0
    assert result["router"]["replicas_healthy"] == 2
    (point,) = result["points"]
    assert point["id"] == "scenario=mixed_lane" and point["status"] == "ok"
    assert all(t["trace_id"].startswith("lg")
               for t in result["slowest_traces"])


def test_loadgen_counts_timeouts_apart(tmp_path):
    hung = mk_replica(str(tmp_path), "hung", delay=5.0)
    try:
        result = loadgen.run_load(f"http://127.0.0.1:{hung.port}",
                                  clients=2, duration=1.0,
                                  deadline_ms=300.0)
    finally:
        stop_all(hung, hung=True)
    assert result["timeouts"] > 0
    assert result["failed"] == result["connect_failures"] == 0
    assert result["points"][0]["status"] == "error"
    assert result["deadline_ms"] == 300.0


def test_loadgen_rolling_drain_through_the_router(tmp_path):
    """rolling_drain drains each replica in turn through the router's admin
    endpoint while traffic runs (records without a pid: excluded, not
    signalled); a stand-in supervisor readmits each."""
    d = str(tmp_path)
    ensure_run_id(d)
    servers = [mk_replica(d, "r0"), mk_replica(d, "r1")]
    for name in ("r0", "r1"):
        path = os.path.join(d, f"serve-{name}.json")
        with open(path) as f:
            rec = json.load(f)
        rec["pid"] = None
        with open(path, "w") as f:
            json.dump(rec, f)
    router = mk_router(d).start()
    stop = threading.Event()

    def supervisor():
        while not stop.is_set():
            for r in router.replicas():
                if r.draining and r.inflight == 0:
                    time.sleep(0.2)
                    r.draining = False
            time.sleep(0.05)

    threading.Thread(target=supervisor, daemon=True).start()
    try:
        wait_for(lambda: sum(1 for r in router.replicas()
                             if r.healthy and r.image_shape) == 2, 10)
        result = loadgen.run_load(f"http://127.0.0.1:{router.port}",
                                  clients=4, duration=1.8,
                                  scenario="rolling_drain", fleet_dir=d,
                                  drain_interval=0.6)
    finally:
        stop.set()
        stop_all(*servers, router=router)
    assert result["failed"] == result["connect_failures"] == 0
    drains = result["chaos"]["drains"]
    assert [x["replica"] for x in drains] == ["r0", "r1"]
    assert all(x["ok"] for x in drains)


# ---------------------------------------------------------------- the CLI
def test_fleetmon_cli_serves_healthz_and_exits_0_on_sigterm(tmp_path):
    """``python -m tpu_resnet_torch fleetmon`` on a directory: announces
    fleetmon.json, /healthz 200 after its first round, /metrics with the
    fleet series, the timeseries and snapshot files, ``fleet_start``, exit
    0 on SIGTERM. Without a directory it exits 2."""
    d = str(tmp_path)
    assert port_main(["fleetmon", "train.train_dir="]) == 2
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_resnet_torch", "fleetmon",
         f"fleet.discover_dir={d}", "fleet.host=127.0.0.1", "fleet.port=0",
         "fleet.scrape_interval_secs=0.2"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        wait_for(lambda: fleet.read_fleet_port(d) is not None, 30)
        port = fleet.read_fleet_port(d)
        wait_for(lambda: http_get(port, "/healthz")[0] == 200, 10)
        text = subprocess.run(
            [sys.executable, "-m", "tpu_resnet_torch.tools.obs_scrape",
             "--url", f"127.0.0.1:{port}", "--json"], cwd=REPO,
            capture_output=True, text=True, timeout=60).stdout
        metrics = json.loads(text)["metrics"]
        assert "tpu_resnet_fleet_scrapes_total" in metrics
        assert metrics["tpu_resnet_fleet_endpoints_total"] == 0.0
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, out
        assert "fleetmon: exited cleanly" in out
        assert fleet.read_fleet_snapshot(d)["round"] >= 1
        assert os.path.getsize(os.path.join(d, fleet.FLEET_TIMESERIES_FILE))
        kinds = [s["span"] for s in load_spans(
            os.path.join(d, "fleet_events.jsonl"))]
        assert kinds[0] == "fleet_start"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
