"""The serve side of observability, fault injection and colocation
admission on the CPU, against the reference's: ``/metrics`` with exactly
the reference's serving series and counters that match the traffic,
``/healthz`` going stale when the batcher stalls, spans in
``serve_events.jsonl`` with the run id, ``X-Trace-Id`` echoed and the
request span kept, ``TailSampler``'s decisions, the four serve faults, and
``colocation_admission``'s verdicts with a denied ``serve()`` exiting 3."""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.obs import server as ref_obs_server
from tpu_resnet.obs.spans import TailSampler as RefTailSampler
from tpu_resnet.resilience import elastic as ref_elastic
from tpu_resnet.resilience.faultinject import FaultPlan as RefFaultPlan
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.models import build_model, init_weights
from tpu_resnet_torch.obs import ensure_run_id
from tpu_resnet_torch.obs.server import parse_histograms, parse_prometheus
from tpu_resnet_torch.obs.spans import SpanTracer, TailSampler, load_spans
from tpu_resnet_torch.obs.trace import SERVE_EVENTS_FILE
from tpu_resnet_torch.resilience import elastic, exitcodes
from tpu_resnet_torch.resilience.faultinject import FaultInjector, FaultPlan
from tpu_resnet_torch.serve.server import PredictServer, serve
from tpu_resnet_torch.train import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = ["model.resnet_size=8", "model.compute_dtype=float32",
             "model.fused_epilogue=on", "serve.host=127.0.0.1",
             "serve.port=0", "serve.max_batch=4",
             "serve.reload_interval_secs=0"]


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _cfg(train_dir, *extra):
    return load_config("cifar10", "", OVERRIDES + [
        f"train.train_dir={train_dir}", *extra])


def _checkpoint(train_dir):
    cfg = _cfg(train_dir)
    ckpt.save(str(train_dir), 4, init_weights(
        build_model(cfg), torch.Generator().manual_seed(0)))


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(port, images, trace_id=None, body=None):
    headers = {"Content-Type": "application/octet-stream",
               "X-Shape": "%d,32,32,3" % len(images)}
    if trace_id:
        headers["X-Trace-Id"] = trace_id
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=images.tobytes() if body is None else body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


@pytest.fixture
def server(tmp_path):
    """A started ResNet-8 server on the CPU, its spans in the train dir's
    serve_events.jsonl with the run id; closed after the test."""
    servers = []

    def start(*extra):
        _checkpoint(tmp_path)
        run_id = ensure_run_id(str(tmp_path))
        spans = SpanTracer(str(tmp_path), filename=SERVE_EVENTS_FILE,
                           run_id=run_id)
        srv = PredictServer(_cfg(tmp_path, *extra), device="cpu",
                            spans=spans)
        servers.append((srv, spans))
        return srv.start()

    yield start
    for srv, spans in servers:
        srv.drain(10.0)
        srv.close()
        spans.close()


# ---------------------------------------------------------------- /metrics
def test_metrics_are_the_reference_series_and_count_the_traffic(server):
    srv = server()
    sizes = (1, 3, 4, 2, 6)
    for i, n in enumerate(sizes):
        assert _post(srv.port, _images(n, seed=i))[0] == 200
    code, text = _get(srv.port, "/metrics")
    assert code == 200
    text = text.decode()

    ref_registry = ref_obs_server.TelemetryRegistry(
        stale_after_sec=10.0, gauges=ref_obs_server.SERVE_GAUGES,
        histograms=ref_obs_server.SERVE_HISTOGRAMS)
    ref_registry.heartbeat(4)    # as the reference's server does at start
    ref = ref_registry.render()

    def types(t):
        return sorted(line for line in t.splitlines()
                      if line.startswith(("# TYPE", "# HELP")))

    assert types(text) == types(ref)
    gauges = parse_prometheus(text)
    stats = srv.batcher.stats()
    ns = "tpu_resnet_"
    # A request of 6 images is two chunks of at most 4, each a request.
    requests = sum(-(-n // 4) for n in sizes)
    assert gauges[ns + "serve_requests_total"] == requests == \
        stats["requests"]
    assert gauges[ns + "serve_images_total"] == sum(sizes)
    assert gauges[ns + "serve_batches_total"] == stats["batches"] > 0
    assert gauges[ns + "serve_requests_rejected"] == 0
    assert gauges[ns + "serve_requests_failed"] == 0
    assert gauges[ns + "serve_model_step"] == 4
    assert gauges[ns + "serve_buckets_warm"] == len(srv.buckets)
    assert gauges[ns + "serve_weight_bytes"] == \
        srv.backend.weight_argument_bytes() > 0
    hists = parse_histograms(text)
    assert hists[ns + "serve_latency_ms"]["count"] == requests
    assert hists[ns + "serve_queue_wait_ms"]["count"] == requests
    assert hists[ns + "serve_pad_fraction"]["count"] == stats["batches"]
    assert hists[ns + "serve_time_to_ready_s"]["count"] == 1


def test_healthz_goes_stale_when_the_batcher_stalls(server):
    """A 2.5 s slow batch holds the batcher past serve.healthz_stale_sec=1:
    /healthz answers 503 with the stale reason while it runs, and 200
    after."""
    srv = server("serve.healthz_stale_sec=1",
                 "resilience.inject_serve_slow_ms=2500")
    assert _get(srv.port, "/healthz")[0] == 200
    done = threading.Event()
    threading.Thread(target=lambda: (_post(srv.port, _images(1)),
                                     done.set()), daemon=True).start()
    seen = []
    while not done.is_set():
        code, body = _get(srv.port, "/healthz")
        seen.append((code, json.loads(body)))
        time.sleep(0.2)
    stale = [b for c, b in seen if c == 503]
    assert stale and stale[0]["reason"].startswith("stale")
    assert not stale[0]["ok"] and stale[0]["heartbeat_age_sec"] > 1
    deadline = time.monotonic() + 10
    while _get(srv.port, "/healthz")[0] != 200:
        assert time.monotonic() < deadline
        time.sleep(0.1)


# ------------------------------------------------------------------ spans
def test_spans_carry_the_run_id_and_keep_traced_requests(server, tmp_path):
    srv = server()
    code, _, headers = _post(srv.port, _images(1), body=b"abc",
                             trace_id="t-error")
    assert code == 400 and headers["X-Trace-Id"] == "t-error"
    for i in range(50):   # the 50th healthy request is the baseline sample
        code, _, headers = _post(srv.port, _images(1, seed=i),
                                 trace_id=f"t-{i}")
        assert code == 200 and headers["X-Trace-Id"] == f"t-{i}"
    srv.drain(10.0)
    srv.spans.close()
    spans = load_spans(os.path.join(str(tmp_path), SERVE_EVENTS_FILE))
    run_id = ensure_run_id(str(tmp_path), create=False)
    assert run_id and {s["run_id"] for s in spans} == {run_id}
    kinds = [s["span"] for s in spans]
    for kind in ("serve_warmup", "serve_ready", "serve_drain"):
        assert kinds.count(kind) == 1, kind
    assert [s["bucket"] for s in spans
            if s["span"] == "serve_warmup_bucket"] == list(srv.buckets)
    requests = [s for s in spans if s["span"] == "serve_request"]
    assert [(s["trace_id"], s["sampled"], s["status"])
            for s in requests] == [("t-error", "error", 400),
                                   ("t-48", "sampled", 200)]
    assert requests[1]["n"] == 1 and requests[1]["batch_size"] == 1
    assert "queue_wait_ms" in requests[1] and "infer_ms" in requests[1]


def test_tail_sampler_decides_as_the_reference():
    rng = np.random.default_rng(11)
    latencies = rng.lognormal(2.0, 0.7, 6000)
    flags = rng.random((6000, 4)) < (0.01, 0.01, 0.005, 0.005)
    port, ref = TailSampler(), RefTailSampler()
    got = [port.observe(lat, *map(bool, f))
           for lat, f in zip(latencies, flags)]
    want = [ref.observe(lat, *map(bool, f))
            for lat, f in zip(latencies, flags)]
    assert got == want
    assert port.stats() == ref.stats()
    assert {"slow", "sampled", "error", "shed", "retry",
            "hedge"} <= set(got)


# ----------------------------------------------------------------- faults
def test_fault_plan_is_the_reference(monkeypatch):
    env = {"TPU_RESNET_FAULT_SERVE_SLOW_MS": "12.5",
           "TPU_RESNET_FAULT_SERVE_HANG_REQ": "7",
           "TPU_RESNET_FAULT_SERVE_KILL_REQ": "9",
           "TPU_RESNET_FAULT_SERVE_DROP_REQ": "3",
           "TPU_RESNET_FAULT_NAN_STEP": "4"}
    cfg = load_config("cifar10", "", ["resilience.inject_serve_slow_ms=5"])
    ref_cfg = ref_load_config("cifar10", "",
                              ["resilience.inject_serve_slow_ms=5"])
    for e in ({}, env):
        got = FaultPlan.from_config(cfg.resilience, env=e)
        want = RefFaultPlan.from_config(ref_cfg.resilience, env=e)
        assert vars(got) == vars(want)
        assert got.serves_faults and got.active
    quiet = FaultInjector(FaultPlan())
    fn = object()
    assert quiet.wrap_serve_infer(fn) is fn     # zero overhead when off
    assert not quiet.should_drop_connection()


def test_slow_and_drop_faults_in_process(server):
    srv = server("resilience.inject_serve_slow_ms=300",
                 "resilience.inject_serve_drop_at_request=2")
    t0 = time.monotonic()
    assert _post(srv.port, _images(1))[0] == 200
    assert time.monotonic() - t0 >= 0.3
    # Request 2: the socket closes with no response.
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    conn.request("POST", "/predict", body=_images(1).tobytes(),
                 headers={"Content-Type": "application/octet-stream",
                          "X-Shape": "1,32,32,3"})
    with pytest.raises((http.client.RemoteDisconnected,
                        ConnectionResetError)):
        conn.getresponse()
    conn.close()
    assert _post(srv.port, _images(1))[0] == 200     # one-shot
    assert srv.batcher.stats()["requests"] == 2


def test_kill_fault_ends_the_server_by_sigkill(tmp_path):
    _checkpoint(tmp_path)
    env = dict(os.environ, TPU_RESNET_FAULT_SERVE_KILL_REQ="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_resnet_torch", "serve", "--device",
         "cpu", "--preset", "cifar10", *OVERRIDES,
         f"train.train_dir={tmp_path}"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        record = os.path.join(str(tmp_path), "serve.json")
        deadline = time.monotonic() + 90
        while not os.path.exists(record) and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert os.path.exists(record), proc.stdout.read().decode()
        with open(record) as f:
            port = json.load(f)["port"]
        assert _post(port, _images(1))[0] == 200
        with pytest.raises((urllib.error.URLError, ConnectionError,
                            http.client.RemoteDisconnected)):
            _post(port, _images(1))
        assert proc.wait(30) == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        proc.stdout.close()


# -------------------------------------------------------------- admission
@pytest.mark.parametrize("required, limit", [
    (1 << 20, None), (1 << 30, 16 << 30), (16 << 30, 16 << 30),
    (int(15.2 * (1 << 30)), 16 << 30), (1, 1), (0, "garbage")])
def test_colocation_admission_is_the_reference(monkeypatch, required, limit):
    if limit is None:
        monkeypatch.delenv(elastic.HBM_BYTES_ENV, raising=False)
    else:
        monkeypatch.setenv(elastic.HBM_BYTES_ENV, str(limit))
    assert elastic.colocation_admission(required) == \
        ref_elastic.colocation_admission(required)


def test_denied_serve_exits_no_capacity(monkeypatch, tmp_path):
    monkeypatch.setenv(elastic.HBM_BYTES_ENV, str(1 << 30))
    cfg = _cfg(tmp_path, f"serve.admission_hbm_bytes={2 << 30}")
    assert serve(cfg, device="cpu") == exitcodes.NO_CAPACITY == 3
    events = load_spans(os.path.join(str(tmp_path), SERVE_EVENTS_FILE))
    assert [e["span"] for e in events] == ["colocation_admission"]
    assert events[0]["admit"] is False
    assert events[0]["reason"].startswith("denied:")
