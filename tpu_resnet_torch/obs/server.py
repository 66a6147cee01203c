"""Telemetry over HTTP: ``/metrics`` (Prometheus text) and ``/healthz``
(port of ``tpu_resnet/obs/server.py`` for the training process and the
predict server).

``GET /healthz``   JSON liveness: last heartbeat step, heartbeat age in
                   seconds, ``ok`` (age under the staleness threshold and
                   no unhealthy mark). HTTP 200 when ok, 503 with the
                   reason otherwise.
``GET /metrics``   Prometheus text exposition (version 0.0.4) of the
                   newest training gauges (``CORE_GAUGES``) and the
                   ``train_step_ms`` histogram (``CORE_HISTOGRAMS``), with
                   the reference's series names, so one scraper reads both.

The predict server (``serve/server.py``) serves the same registry on its
own port with the reference's serving sets, ``SERVE_GAUGES`` and
``SERVE_HISTOGRAMS``, and a staleness of ``serve.healthz_stale_sec``; the
router (``serve/router.py``) with ``ROUTE_GAUGES`` and
``ROUTE_HISTOGRAMS``, the fleet aggregator (``obs/fleet.py``) with
``FLEET_GAUGES``, the autopilot (``autopilot/controller.py``) with
``AUTOPILOT_GAUGES``.

Standard library only: ``http.server`` on a daemon thread. The bound port
is written to ``<train_dir>/telemetry.json`` (port 0 binds an ephemeral
port) so that scrapers can find it.
"""

from __future__ import annotations

import bisect
import json
import logging
import math
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

log = logging.getLogger("tpu_resnet_torch")

NAMESPACE = "tpu_resnet"

# Gauges pre-declared at registry creation, so that every scrape (one taken
# during the first dispatch too) sees the whole series set, with the
# reference's names and help texts. On one card some stay at their zeros:
# predicted_comms_fraction (no collective), topology_changes,
# compile_cache_* (no program cache); hbm_* stay 0 on the CPU.
CORE_GAUGES = (
    ("step", "Current training step (host counter)"),
    ("loss", "Training loss at the last log interval"),
    ("precision", "Training top-1 precision at the last log interval"),
    ("learning_rate", "Learning rate at the last log interval"),
    ("steps_per_sec", "Training steps per second over the last interval"),
    ("images_per_sec", "Global images per second over the last interval"),
    ("images_per_sec_per_chip", "Per-chip images per second"),
    ("data_wait_frac", "Fraction of interval wall time blocked on input"),
    ("data_ring_occupancy", "Decoded batches waiting in the engine ring"),
    ("data_ring_slots", "Total engine ring slots"),
    ("data_decode_images_per_sec",
     "Host decode throughput over the last interval"),
    ("h2d_bytes_per_sec",
     "Host->device staged transfer rate over the last interval"),
    ("h2d_overlap_frac",
     "Fraction of H2D transfer wall time overlapped with dispatch "
     "(0..1)"),
    ("compile_seconds", "First-dispatch wall time (trace+compile+run)"),
    ("checkpoint_lag_steps", "Steps since the last checkpoint save"),
    ("model_flops_per_sec", "Achieved model FLOP/s over the last "
                            "interval (global, all chips)"),
    ("mfu", "Model FLOPs utilization vs aggregate peak (0..1)"),
    ("hbm_bytes_in_use", "Device memory in use, max across this host's "
                         "devices (0 where memory_stats is unsupported)"),
    ("hbm_bytes_peak", "Peak device memory since process start, max "
                       "across this host's devices"),
    ("hbm_bytes_limit", "Per-device memory capacity (backend-reported, "
                        "else the obs/memory HBM table)"),
    ("hbm_utilization", "hbm_bytes_in_use / hbm_bytes_limit (0..1)"),
    ("predicted_comms_fraction",
     "Predicted time-on-wire / (time-on-wire + peak-compute time) for "
     "the compiled step (0..1; 0 where the ICI bandwidth is unknown)"),
    ("fault_nan_rollbacks", "NaN/divergence rollbacks performed"),
    ("fault_watchdog_stalls", "Hang-watchdog stall detections"),
    ("fault_preemptions", "Graceful preemption stops (SIGTERM/SIGINT)"),
    ("fault_preempt_burst", "Injected preemption-burst SIGTERMs fired "
                            "so far across supervised restarts "
                            "(resilience/faultinject.py drill)"),
    ("topology_changes", "This restart resumed across a mesh/partition "
                         "reshape (resilience/elastic.py)"),
    ("compile_cache_hits", "Compiled programs loaded from the "
                           "persistent AOT executable cache"),
    ("compile_cache_misses", "Programs compiled because the cache had "
                             "no trustworthy entry (cold, stale, "
                             "evicted, or disabled)"),
)

# Histogram bucket edges (upper bounds; +Inf is implicit), in ms.
LATENCY_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                      500.0, 1000.0, 2000.0, 5000.0)

# Pre-declared histogram series, same convention as the gauges: a scrape
# taken before the first observation sees empty buckets, not absent
# series. (name, help, bucket edges).
CORE_HISTOGRAMS = (
    ("train_step_ms", "Per-step wall time, observed once per step at "
                      "each log boundary", LATENCY_BUCKETS_MS),
)

# The predict server's gauges, the reference's names and help texts.
SERVE_GAUGES = (
    ("serve_requests_total", "Predict requests admitted"),
    ("serve_requests_rejected", "Requests rejected by admission control "
                                "(bounded queue full -> HTTP 429)"),
    ("serve_requests_failed", "Requests that failed during inference"),
    ("serve_images_total", "Images admitted across all requests"),
    ("serve_batches_total", "Coalesced batches dispatched to the model"),
    ("serve_queue_depth", "Requests currently queued for batching"),
    ("serve_batch_size_last", "Images in the most recent batch"),
    ("serve_batch_size_mean", "Mean images per batch since start"),
    ("serve_pad_fraction", "Padded fraction of all bucket slots "
                           "dispatched (compile-avoidance cost)"),
    ("serve_latency_p50_ms", "p50 request latency over the recent ring"),
    ("serve_latency_p95_ms", "p95 request latency over the recent ring"),
    ("serve_latency_p99_ms", "p99 request latency over the recent ring"),
    ("serve_model_step", "Checkpoint step being served (-1 = frozen "
                         "export bundle)"),
    ("serve_reloads_total", "Checkpoint hot-reloads completed"),
    ("serve_time_to_ready_seconds", "Backend build + restore + bucket "
                                    "warmup wall time until /healthz ok"),
    ("serve_buckets_warm", "Bucket programs warmed so far (== bucket "
                           "count once ready; partial during warmup)"),
    ("serve_weight_bytes", "Weight-argument bytes per bucket program "
                           "(int8 quantized arms ~0.25x of f32)"),
    ("compile_cache_hits", "Bucket programs loaded from the persistent "
                           "AOT executable cache instead of compiling"),
    ("compile_cache_misses", "Bucket programs XLA-compiled because the "
                             "cache had no trustworthy entry"),
)

# The 0..1 scale of the pad fraction, and seconds for once-per-process
# durations (time-to-ready).
FRACTION_BUCKETS = (0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.75, 1.0)
READY_BUCKETS_S = (0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 60.0, 120.0,
                   300.0)

SERVE_HISTOGRAMS = (
    ("serve_latency_ms", "End-to-end predict latency (enqueue to "
                         "result)", LATENCY_BUCKETS_MS),
    ("serve_queue_wait_ms", "Time a request waited in the queue before "
                            "its batch was formed", LATENCY_BUCKETS_MS),
    ("serve_pad_fraction", "Padded fraction of each dispatched bucket "
                           "(compile-avoidance cost per batch)",
     FRACTION_BUCKETS),
    ("serve_time_to_ready_s", "Time-to-ready per process start (backend "
                              "build + restore + bucket warmup) — the "
                              "series the cold-vs-warm restart gate "
                              "reads", READY_BUCKETS_S),
)

# The router's histograms, the reference's.
ROUTE_HISTOGRAMS = (
    ("route_latency_ms", "End-to-end router latency (accept to client "
                         "response, retries/hedges included)",
     LATENCY_BUCKETS_MS),
    ("route_upstream_ms", "Single upstream attempt latency per replica "
                          "send", LATENCY_BUCKETS_MS),
)

# The front router's gauges (serve/router.py), the reference's names and
# help texts; /healthz on the router's port is 503 while no replica is
# healthy.
ROUTE_GAUGES = (
    ("route_requests_total", "Predict requests accepted by the router"),
    ("route_requests_ok", "Requests answered 2xx end to end"),
    ("route_requests_failed", "Requests that exhausted replicas/retries "
                              "or blew the deadline budget"),
    ("route_retries_total", "Failover retries sent to a second replica "
                            "(connect failure / 5xx / deadline)"),
    ("route_hedges_total", "Hedged duplicate sends fired (requests "
                           "sitting past the hedge threshold)"),
    ("route_hedge_wins_total", "Hedged sends whose duplicate answered "
                               "first"),
    ("route_shed_total", "Requests shed by SLO admission (rolling p99 "
                         "over route.slo_ms) -> HTTP 429"),
    ("route_shed_batch_total", "Batch-lane requests shed (lowest "
                               "priority sheds first)"),
    ("route_shed_interactive_total", "Interactive-lane requests shed "
                                     "(p99 past slo*shed_hard_factor)"),
    ("route_replica_errors_total", "Passive replica failures observed "
                                   "(connect/5xx/timeout)"),
    ("route_replicas_total", "Replicas known to the router (static + "
                             "discovered)"),
    ("route_replicas_healthy", "Replicas currently in rotation (circuit "
                               "closed, not draining)"),
    ("route_inflight", "Requests currently in flight across replicas"),
    ("route_p50_ms", "Rolling p50 end-to-end router latency"),
    ("route_p99_ms", "Rolling p99 end-to-end router latency (the shed/"
                     "hedge signal)"),
    ("route_slo_ms", "Configured p99 SLO target (0 = shedding off)"),
    ("route_lane_interactive_total", "Interactive-lane requests routed"),
    ("route_lane_batch_total", "Batch-lane requests routed"),
)

# The fleet aggregator's gauges (obs/fleet.py), the reference's names and
# help texts; the fleet_serve_p* series are pooled quantiles of the
# bucket-wise histogram merge (merge_histograms), never an average of
# per-replica percentiles.
FLEET_GAUGES = (
    ("fleet_endpoints_total", "Endpoints found in the discovery dir on "
                              "the last scrape round"),
    ("fleet_endpoints_up", "Endpoints whose /metrics answered on the "
                           "last round"),
    ("fleet_scrapes_total", "Scrape rounds completed since start"),
    ("fleet_scrape_errors_total", "Individual endpoint scrapes that "
                                  "failed (cumulative)"),
    ("fleet_requests_total", "Requests admitted across all serve "
                             "replicas (summed serve_latency_ms count)"),
    ("fleet_serve_p50_ms", "Fleet-wide p50 predict latency (bucket-"
                           "merged across replicas)"),
    ("fleet_serve_p95_ms", "Fleet-wide p95 predict latency (bucket-"
                           "merged across replicas)"),
    ("fleet_serve_p99_ms", "Fleet-wide p99 predict latency (bucket-"
                           "merged across replicas)"),
    ("fleet_slo_ms", "Configured fleet latency SLO threshold (0 = burn "
                     "tracking off)"),
    ("fleet_burn_rate_fast", "Error-budget burn rate over the fast "
                             "window (1.0 = burning exactly the "
                             "budget)"),
    ("fleet_burn_rate_slow", "Error-budget burn rate over the slow "
                             "window"),
    ("fleet_alerts_total", "Burn-rate alerts fired since start"),
    ("fleet_alert_active", "1 while a burn-rate alert condition holds"),
)

# The autopilot's gauges (autopilot/controller.py), the reference's names
# and help texts; each mirrors a field of the decision records the
# controller appends to autopilot_events.jsonl.
AUTOPILOT_GAUGES = (
    ("autopilot_rounds_total", "Control-loop rounds completed (one "
                               "snapshot + one policy decision each)"),
    ("autopilot_signal_errors_total", "Rounds whose signal scrape failed "
                                      "(router unreachable etc.) — the "
                                      "policy holds on a blind round"),
    ("autopilot_scale_ups_total", "Scale-up decisions actuated"),
    ("autopilot_scale_downs_total", "Scale-down decisions actuated"),
    ("autopilot_holds_total", "Rounds the policy decided to do nothing"),
    ("autopilot_spawns_total", "Replica spawns launched (supervise/"
                               "discovery path)"),
    ("autopilot_spawn_failures_total", "Spawns that crashed or blew "
                                       "ready_timeout_secs"),
    ("autopilot_admission_denied_total", "Spawns denied by colocation "
                                         "admission (exit 3) — each "
                                         "arms the scale-up backoff"),
    ("autopilot_drains_total", "Replicas drained via the router's "
                               "/admin/drain rolling contract"),
    ("autopilot_target_replicas", "The policy's current target replica "
                                  "count"),
    ("autopilot_replicas_total", "Replicas the router knows (from the "
                                 "last signal snapshot)"),
    ("autopilot_replicas_healthy", "Replicas in rotation (from the last "
                                   "signal snapshot)"),
    ("autopilot_p99_ms", "Router rolling p99 from the last snapshot "
                         "(the primary pressure signal)"),
    ("autopilot_slo_ms", "Effective SLO the hysteresis bands are "
                         "anchored to"),
    ("autopilot_burn_rate_fast", "fleetmon fast-window burn rate from "
                                 "the last snapshot"),
    ("autopilot_scale_up_latency_ms", "Last observed spawn -> healthy-"
                                      "in-router latency (the series "
                                      "the autoscale scenarios gate)"),
    ("autopilot_slo_violation_seconds", "Integrated seconds the fleet "
                                        "p99 sat above the SLO while "
                                        "the autopilot watched"),
    ("autopilot_replica_seconds", "Integrated healthy-replica x seconds "
                                  "(the capacity-spend denominator)"),
    ("autopilot_utilization", "Router requests served per healthy "
                              "replica-second (capacity efficiency)"),
    ("autopilot_capacity_granted", "1 while the capacity lease is "
                                   "granted to the colocated trainer"),
)


def _sanitize(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", name)


class Histogram:
    """Fixed-bucket histogram with Prometheus exposition semantics.

    ``observe(v, n)`` adds ``n`` observations of value ``v`` (n>1 is the
    weighted form the train loop uses: one interval = ``steps``
    observations of the interval's mean step time). Rendering follows
    the Prometheus histogram convention exactly — cumulative
    ``_bucket{le="..."}`` counts, ``_sum`` and ``_count`` — so a stock
    Prometheus server can do ``histogram_quantile()`` over scrapes while
    :func:`histogram_quantile` here gives the same answer offline.

    Not thread-safe by itself; TelemetryRegistry serializes access under
    its lock."""

    __slots__ = ("name", "help", "edges", "counts", "total", "sum")

    def __init__(self, name: str, help: str = "", edges=LATENCY_BUCKETS_MS):
        edges = tuple(float(e) for e in edges)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(f"bucket edges must be strictly increasing, "
                             f"got {edges}")
        self.name = _sanitize(name)
        self.help = help
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)  # last = overflow (+Inf)
        self.total = 0
        self.sum = 0.0

    def observe(self, value, n: int = 1) -> None:
        try:
            value = float(value)
            n = int(n)
        except (TypeError, ValueError):
            return
        if n < 1:
            return
        i = bisect.bisect_left(self.edges, value)
        self.counts[i] += n
        self.total += n
        self.sum += value * n

    def snapshot(self) -> dict:
        """``{"buckets": [(le, cumulative_count)...], "sum", "count"}``
        with the trailing +Inf bucket — the same structure
        :func:`parse_histograms` reconstructs from a scrape."""
        cum, buckets = 0, []
        for edge, c in zip(self.edges, self.counts):
            cum += c
            buckets.append((edge, cum))
        buckets.append((math.inf, self.total))
        return {"buckets": buckets, "sum": self.sum, "count": self.total}

    def percentile(self, q: float) -> float:
        return histogram_quantile(self.snapshot(), q)

    def render(self, namespace: str = NAMESPACE) -> list:
        full = f"{namespace}_{self.name}"
        lines = []
        if self.help:
            lines.append(f"# HELP {full} {self.help}")
        lines.append(f"# TYPE {full} histogram")
        cum = 0
        for edge, c in zip(self.edges, self.counts):
            cum += c
            lines.append(f'{full}_bucket{{le="{edge!r}"}} {cum}')
        lines.append(f'{full}_bucket{{le="+Inf"}} {self.total}')
        lines.append(f"{full}_sum {self.sum!r}")
        lines.append(f"{full}_count {self.total}")
        return lines


def histogram_quantile(hist: dict, q: float) -> float:
    """Quantile from a histogram snapshot (``Histogram.snapshot()`` or a
    :func:`parse_histograms` entry): linear interpolation inside the
    bucket containing the target rank — the same estimator Prometheus's
    ``histogram_quantile()`` uses, so live dashboards and offline tools
    agree. Returns 0.0 for an empty histogram; the overflow bucket
    reports its lower edge (the largest finite edge)."""
    buckets = hist.get("buckets") or []
    total = hist.get("count", 0)
    if not buckets or total <= 0:
        return 0.0
    q = min(max(q, 0.0), 1.0)
    rank = q * total
    prev_edge, prev_cum = 0.0, 0
    for edge, cum in buckets:
        if cum >= rank:
            if math.isinf(edge):
                return float(prev_edge)
            if cum == prev_cum:
                return float(edge)
            frac = (rank - prev_cum) / (cum - prev_cum)
            return float(prev_edge + (edge - prev_edge) * frac)
        prev_edge, prev_cum = edge, cum
    return float(prev_edge)


def merge_histograms(snapshots) -> dict:
    """Bucket-wise merge of histogram snapshots from different processes
    into one pooled snapshot.

    Because every process uses the same fixed bucket edges, summing
    cumulative counts position-wise is exact pooling: ``histogram_quantile``
    over the merge equals the quantile of the pooled samples to within one
    bucket's interpolation error, not an average of per-process
    percentiles.

    Mismatched bucket boundaries raise ValueError — merging histograms
    with different edges silently would fabricate counts in buckets that
    never existed. Empty input merges to an empty snapshot."""
    snapshots = [s for s in snapshots if s and s.get("buckets")]
    if not snapshots:
        return {"buckets": [], "sum": 0.0, "count": 0}
    edges = [e for e, _ in snapshots[0]["buckets"]]
    for s in snapshots[1:]:
        other = [e for e, _ in s["buckets"]]
        if other != edges:
            raise ValueError(
                f"cannot merge histograms with mismatched bucket edges: "
                f"{edges} vs {other}")
    buckets = []
    for i, edge in enumerate(edges):
        buckets.append((edge, sum(s["buckets"][i][1] for s in snapshots)))
    return {"buckets": buckets,
            "sum": sum(float(s.get("sum", 0.0)) for s in snapshots),
            "count": sum(int(s.get("count", 0)) for s in snapshots)}


class TelemetryRegistry:
    """Thread-safe gauge store shared by the training loop (writer) and
    the HTTP server threads (readers)."""

    def __init__(self, stale_after_sec: float = 300.0, gauges=CORE_GAUGES,
                 histograms=()):
        """``gauges``/``histograms`` are the pre-declared series sets
        (``CORE_*`` for a training process): scrapes taken before the
        first log boundary see explicit zeros and empty buckets, not
        absent series."""
        self.stale_after_sec = float(stale_after_sec)
        self._lock = threading.Lock()
        self._gauges: Dict[str, float] = {}
        self._help: Dict[str, str] = {}
        self._hists: Dict[str, Histogram] = {}
        self._hb_wall: Optional[float] = None
        self._hb_step: Optional[int] = None
        self._unhealthy_reason: Optional[str] = None
        self._started = time.time()
        for name, help_text in gauges:
            self.set(name, 0.0, help=help_text)
        for name, help_text, edges in histograms:
            h = Histogram(name, help_text, edges)
            self._hists[h.name] = h

    def set(self, name: str, value, help: str = "") -> None:
        try:
            value = float(value)
        except (TypeError, ValueError):
            return
        name = _sanitize(name)
        with self._lock:
            self._gauges[name] = value
            if help:
                self._help[name] = help

    def update(self, scalars: Dict[str, float]) -> None:
        """Set several gauges at once: a scrape sees all of them or none
        (the gauges of one log boundary agree with each other)."""
        values = {}
        for k, v in scalars.items():
            try:
                values[_sanitize(k)] = float(v)
            except (TypeError, ValueError):
                continue
        with self._lock:
            self._gauges.update(values)

    def observe(self, name: str, value, n: int = 1) -> None:
        """Add ``n`` observations of ``value`` to histogram ``name``
        (created on first use with the default latency buckets if it was
        not pre-declared)."""
        name = _sanitize(name)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name)
            h.observe(value, n)

    def hist_percentile(self, name: str, q: float) -> float:
        """Quantile estimate over histogram ``name`` (0.0 when absent or
        empty): the loop's step-time percentile metrics."""
        with self._lock:
            h = self._hists.get(_sanitize(name))
            snap = h.snapshot() if h is not None else None
        return histogram_quantile(snap, q) if snap else 0.0

    def heartbeat(self, step: int) -> None:
        """Mark the trainer alive at ``step`` (call at every log point)."""
        with self._lock:
            self._hb_wall = time.time()
            self._hb_step = int(step)
            self._gauges["step"] = float(step)

    def heartbeat_age(self) -> float:
        with self._lock:
            base = self._hb_wall if self._hb_wall is not None \
                else self._started
        return max(0.0, time.time() - base)

    def mark_unhealthy(self, reason: str) -> None:
        """Force /healthz to 503 with an explicit reason — used by the
        hang watchdog, whose stall deadline is typically much tighter than
        the heartbeat-staleness threshold."""
        with self._lock:
            self._unhealthy_reason = str(reason)

    def clear_unhealthy(self) -> None:
        with self._lock:
            self._unhealthy_reason = None

    def health(self) -> dict:
        age = self.heartbeat_age()
        with self._lock:
            step = self._hb_step
            reason = self._unhealthy_reason
        out = {
            "ok": age < self.stale_after_sec and reason is None,
            "step": step,
            "heartbeat_age_sec": round(age, 3),
            "stale_after_sec": self.stale_after_sec,
            "time": time.time(),
        }
        if reason is not None:
            out["unhealthy_reason"] = reason
        return out

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4 — gauges plus
        histogram series (cumulative ``_bucket{le=...}``/``_sum``/
        ``_count``, the standard exposition
        :func:`parse_histograms` round-trips)."""
        with self._lock:
            gauges = dict(self._gauges)
            helps = dict(self._help)
            hist_lines = []
            for name in sorted(self._hists):
                hist_lines.extend(self._hists[name].render())
        gauges["heartbeat_age_seconds"] = round(self.heartbeat_age(), 3)
        helps.setdefault("heartbeat_age_seconds",
                         "Seconds since the trainer's last heartbeat")
        lines = []
        for name in sorted(gauges):
            full = f"{NAMESPACE}_{name}"
            if name in helps:
                lines.append(f"# HELP {full} {helps[name]}")
            lines.append(f"# TYPE {full} gauge")
            lines.append(f"{full} {gauges[name]!r}")
        lines.extend(hist_lines)
        return "\n".join(lines) + "\n"


class TelemetryServer:
    """Daemon-threaded HTTP server over a registry. ``port=0`` binds an
    OS-assigned ephemeral port (exposed as ``self.port``)."""

    def __init__(self, registry: TelemetryRegistry, port: int = 0,
                 host: str = "0.0.0.0"):
        self.registry = registry

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._send(200, registry.render().encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    health = registry.health()
                    self._send(200 if health["ok"] else 503,
                               json.dumps(health).encode(),
                               "application/json")
                else:
                    self._send(404, b'{"error": "not found"}\n',
                               "application/json")

            def log_message(self, *args):  # scrapes must not spam the run log
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tpu-resnet-torch-telemetry",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        if self._httpd is not None:
            httpd, self._httpd = self._httpd, None
            httpd.shutdown()
            httpd.server_close()

    @classmethod
    def maybe_start(cls, port: int, registry: TelemetryRegistry,
                    train_dir: Optional[str] = None
                    ) -> Optional["TelemetryServer"]:
        """Start a server per the config semantics: ``port < 0`` disabled,
        ``0`` ephemeral, ``> 0`` fixed. A bind failure (port taken) logs a
        warning and returns None — telemetry must never kill training. The
        bound port is recorded in ``<train_dir>/telemetry.json``."""
        if port is None or port < 0:
            return None
        try:
            server = cls(registry, port)
        except OSError as e:
            log.warning("telemetry server failed to bind port %s: %s "
                        "(training continues without /metrics)", port, e)
            return None
        log.info("telemetry server on :%d (/metrics Prometheus text, "
                 "/healthz liveness)", server.port)
        if train_dir:
            # The reference's discovery files: a hostname-keyed one and
            # the bare telemetry.json its primary process writes.
            try:
                import socket

                os.makedirs(train_dir, exist_ok=True)
                record = {"port": server.port, "pid": os.getpid(),
                          "hostname": socket.gethostname(),
                          "started_at": time.time()}
                # One process, one card: this process is the primary.
                names = [f"telemetry-{socket.gethostname()}.json",
                         "telemetry.json"]
                for name in names:
                    path = os.path.join(train_dir, name)
                    tmp = path + f".tmp{os.getpid()}"
                    with open(tmp, "w") as f:
                        json.dump(record, f)
                    os.replace(tmp, path)
            except OSError as e:  # discovery file is best-effort
                log.warning("could not write telemetry.json: %s", e)
        return server


def read_telemetry_port(train_dir: str) -> Optional[int]:
    """Port recorded by ``TelemetryServer.maybe_start`` for this run.

    Prefers this host's ``telemetry-<hostname>.json``, falling back to the
    bare ``telemetry.json``."""
    import socket

    for name in (f"telemetry-{socket.gethostname()}.json",
                 "telemetry.json"):
        try:
            with open(os.path.join(train_dir, name)) as f:
                return int(json.load(f)["port"])
        except (OSError, ValueError, KeyError):
            continue
    return None


def scrape(base_url: str, timeout: float = 5.0) -> dict:
    """One scrape of a telemetry server: GET ``/metrics`` + ``/healthz``.

    ``base_url`` is ``host[:port]`` or a full http URL. Returns
    ``{"metrics": {name: value}, "health": {...}, "health_status": int}``
    (a 503 — stale heartbeat or an unhealthy mark — is a valid report, not
    an error). Raises OSError when the server is unreachable and
    ValueError on malformed bodies."""
    import urllib.error
    import urllib.request

    base_url = base_url.rstrip("/")
    if "://" not in base_url:
        base_url = "http://" + base_url
    with urllib.request.urlopen(base_url + "/metrics",
                                timeout=timeout) as resp:
        text = resp.read().decode()
    metrics = parse_prometheus(text)
    try:
        with urllib.request.urlopen(base_url + "/healthz",
                                    timeout=timeout) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:  # 503 stale: report, don't raise
        status, body = e.code, e.read()
    return {"metrics": metrics, "histograms": parse_histograms(text),
            "health": json.loads(body.decode()),
            "health_status": status}


def parse_prometheus(text: str) -> Dict[str, float]:
    """Prometheus text → {metric_name: value}. Raises ValueError on a
    malformed sample line (the scrape tests use this as the parser).
    Histogram component series collapse to their last sample here; use
    :func:`parse_histograms` for the bucket structure."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 2:
            raise ValueError(f"malformed sample line: {line!r}")
        name = parts[0].split("{", 1)[0]
        out[name] = float(parts[1])
    return out


_LE_LABEL = re.compile(r'\{le="([^"]+)"\}')


def parse_histograms(text: str) -> Dict[str, dict]:
    """Prometheus text → histogram structures.

    Collects ``name_bucket{le="..."}``/``name_sum``/``name_count``
    triplets declared ``# TYPE name histogram`` into
    ``{name: {"buckets": [(le, cum)...], "sum": s, "count": n}}`` — the
    same snapshot shape :meth:`Histogram.snapshot` produces, so
    :func:`histogram_quantile` works on live scrapes and in-process
    histograms alike. Unparseable histogram lines are skipped (a gauge
    parser strictness here would make every scraper crash on a
    mid-write exposition)."""
    declared = set()
    for line in text.splitlines():
        if line.startswith("# TYPE ") and line.rstrip().endswith(
                " histogram"):
            declared.add(line.split()[2])
    out: Dict[str, dict] = {
        name: {"buckets": [], "sum": 0.0, "count": 0} for name in declared}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 2:
            continue
        sample, value = parts[0], parts[1]
        base = sample.split("{", 1)[0]
        for name in declared:
            if base == name + "_bucket":
                m = _LE_LABEL.search(sample)
                if not m:
                    break
                le = math.inf if m.group(1) == "+Inf" else float(m.group(1))
                try:
                    out[name]["buckets"].append((le, int(float(value))))
                except ValueError:
                    pass
                break
            if base == name + "_sum":
                try:
                    out[name]["sum"] = float(value)
                except ValueError:
                    pass
                break
            if base == name + "_count":
                try:
                    out[name]["count"] = int(float(value))
                except ValueError:
                    pass
                break
    for hist in out.values():
        hist["buckets"].sort(key=lambda b: b[0])
    return out
