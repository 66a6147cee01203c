"""The serving fleet's front router — ``python -m tpu_resnet_torch route``
(port of ``tpu_resnet/serve/router.py``: the same behaviour, names,
formats and exit codes, in front of the port's predict servers).

- **active health**: every replica's ``/healthz`` (+ ``/info`` queue
  depth) probed each ``route.probe_interval_secs``, plus passive
  error/latency tracking from live traffic, feeding a per-replica
  half-open circuit breaker — a killed or hung replica is out of
  rotation within one probe interval, and readmitted when it comes back
  healthy (a restarted replica on a NEW port is re-resolved from its
  discovery file the same way). A port replica answers ``/healthz`` 200
  only once every serve bucket has run through its kernels.
- **forwarding**: ``POST /predict`` goes to one replica with the
  request's ``Content-Type``, ``X-Shape``, ``X-Lane`` and ``X-Trace-Id``
  headers and its query string (``?logits=1``, which the reference's
  router drops), so a client reads logits through the router.
- **failover**: predicts are idempotent, so a connect failure, 5xx, or
  per-attempt deadline retries ONCE on a different healthy replica —
  under a per-request deadline budget (``route.deadline_ms`` /
  ``X-Deadline-Ms``). Hedged sends (``route.hedge_ms``, off by default)
  duplicate a request sitting past the hedge threshold to a second
  replica; first answer wins.
- **SLO-aware admission**: the router watches its own rolling p99
  against ``route.slo_ms`` and sheds the batch lane (``X-Lane: batch``)
  first with 429 + Retry-After; only past ``slo_ms * shed_hard_factor``
  does the interactive lane shed too. A ring with no completion for
  ``_SHED_STALE_SEC`` is cleared and the shed released.
- **rolling operations**: ``route --drain <replica>`` (HTTP:
  ``POST /admin/drain?replica=NAME``) takes one replica out of rotation,
  waits out its in-flight requests, then SIGTERMs the pid of its
  discovery record and waits for its endpoint to go — the replica's
  drain exits 0.
- **membership**: ``route.replicas`` (static urls) and the ``serve*.json``
  records under ``route.discover_dir``; with ``route.watch_discovery`` a
  record that appears after boot serves a probation until its first
  healthy probe.

Host code: the standard library and the port's host modules. Importing
this module imports no torch (so the router never holds a CUDA context
that would take card memory from the replicas) and nothing of JAX.
``/metrics`` (``ROUTE_GAUGES`` + ``ROUTE_HISTOGRAMS``) and ``/healthz``
(503 while no replica is healthy) on the router port; ``X-Trace-Id``
minted when absent, forwarded on every leg and echoed on every answer;
tail-sampled ``route_request`` spans and the rotation events in
``route_events.jsonl``, stamped with the fleet's run id, so
``trace-export`` lays the router lane beside the replica lanes.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import queue
import signal
import threading
import time
import urllib.error
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from tpu_resnet_torch.config import RunConfig
from tpu_resnet_torch.obs.manifest import read_run_id
from tpu_resnet_torch.obs.server import (ROUTE_GAUGES, ROUTE_HISTOGRAMS,
                                         TelemetryRegistry)
from tpu_resnet_torch.obs.spans import SpanTracer, TailSampler
from tpu_resnet_torch.obs.trace import ROUTE_EVENTS_FILE
from tpu_resnet_torch.serve.batcher import LANES, percentile
from tpu_resnet_torch.serve.discovery import read_port, send_json, write_record

log = logging.getLogger("tpu_resnet_torch")

ROUTE_DISCOVERY = "route.json"
# Headers forwarded upstream verbatim; everything else is router-local.
# X-Trace-Id rides every leg (forward, retry, hedge) so the replica's
# serve_request span joins the router's route_request span under one id.
_FORWARD_HEADERS = ("Content-Type", "X-Shape", "X-Lane", "X-Trace-Id")
# Below this remaining budget a retry/hedge cannot plausibly complete —
# answer 504 instead of burning a replica slot on a doomed attempt.
_MIN_ATTEMPT_SEC = 0.005
# Shed-release: when no request has completed for this long, the rolling
# p99 is stale (e.g. a batch-only workload where every request is being
# shed records nothing) — clear the ring and admit, letting fresh
# samples rebuild the signal instead of latching the shed forever.
_SHED_STALE_SEC = 5.0


class _AttributedError(OSError):
    """Raised by a hedged attempt after every failed leg's breaker was
    already charged inside :meth:`Router._attempt` — the caller must
    not charge the primary again (it may not even be the leg that
    failed last)."""


class CircuitBreaker:
    """Per-replica half-open circuit breaker.

    CLOSED (in rotation) → ``fail_threshold`` consecutive failures →
    OPEN (excluded) → after ``open_secs`` → HALF_OPEN (the prober — and
    only the prober — sends a trial) → success closes, failure re-opens
    with a fresh hold. ``clock`` is injectable for tests."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, fail_threshold: int = 2, open_secs: float = 5.0,
                 clock=time.monotonic):
        self.fail_threshold = max(1, int(fail_threshold))
        self.open_secs = float(open_secs)
        self._clock = clock
        self._failures = 0
        self._opened_at: Optional[float] = None

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return self.CLOSED
        if self._clock() - self._opened_at >= self.open_secs:
            return self.HALF_OPEN
        return self.OPEN

    @property
    def closed(self) -> bool:
        return self.state == self.CLOSED

    def record_success(self) -> None:
        self._failures = 0
        self._opened_at = None

    def record_failure(self) -> None:
        self._failures += 1
        if self._opened_at is not None or \
                self._failures >= self.fail_threshold:
            # A HALF_OPEN failure re-opens with a fresh hold; a CLOSED
            # replica opens once the consecutive-failure bar is met.
            self._opened_at = self._clock()


class Replica:
    """One serve replica as the router sees it: address, identity,
    breaker, and the live counters routing decisions read."""

    def __init__(self, name: str, url: str, pid: Optional[int] = None,
                 run_id: Optional[str] = None,
                 fail_threshold: int = 2, open_secs: float = 5.0,
                 clock=time.monotonic, pending: bool = False):
        self.name = name
        self.url = url.rstrip("/")
        self.pid = pid
        self.run_id = run_id
        self.breaker = CircuitBreaker(fail_threshold, open_secs,
                                      clock=clock)
        self.draining = False       # admin drain: excluded, not failed
        self.pending = pending      # probation: out of rotation until the
        #                             first successful probe admits it
        #                             (route.watch_discovery)
        self.queue_depth = 0        # passive signal from the /info probe
        self.model_step = -1
        self.image_shape: Optional[list] = None
        self.last_error: Optional[str] = None
        self._inflight = 0
        self._lock = threading.Lock()

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def note_inflight(self, delta: int) -> None:
        with self._lock:
            self._inflight += delta

    @property
    def healthy(self) -> bool:
        return self.breaker.closed and not self.draining \
            and not self.pending

    def describe(self) -> dict:
        return {"name": self.name, "url": self.url, "pid": self.pid,
                "state": self.breaker.state, "draining": self.draining,
                "pending": self.pending,
                "inflight": self.inflight,
                "queue_depth": self.queue_depth,
                "model_step": self.model_step,
                "last_error": self.last_error}


def discover_replicas(directory: str) -> List[dict]:
    """Parse every replica announcement under ``directory``:
    ``serve.json`` (name "default" unless the record carries one) and
    ``serve-<name>.json`` (serve.replica_name fleets). Unreadable or
    torn files are skipped — the prober re-reads every round, so a
    mid-write announcement resolves on the next pass."""
    records = []
    for path in sorted(glob.glob(os.path.join(directory, "serve*.json"))):
        base = os.path.basename(path)
        if not (base == "serve.json" or (base.startswith("serve-")
                                         and base.endswith(".json"))):
            continue
        try:
            with open(path) as f:
                rec = json.load(f)
            port = int(rec["port"])
        except (OSError, ValueError, KeyError, TypeError):
            continue
        name = rec.get("name") or (
            base[len("serve-"):-len(".json")] if base != "serve.json"
            else "default")
        records.append({"name": str(name), "port": port,
                        "pid": rec.get("pid"),
                        "run_id": rec.get("run_id"),
                        "url": f"http://127.0.0.1:{port}"})
    return records


class Router:
    """The front router, drivable in-process (tests) or via
    :func:`route` (CLI)."""

    def __init__(self, cfg: RunConfig,
                 registry: Optional[TelemetryRegistry] = None,
                 spans: Optional[SpanTracer] = None,
                 clock=time.monotonic):
        self.cfg = cfg
        self._clock = clock
        self._lock = threading.Lock()       # replica map + counters
        self._replicas: Dict[str, Replica] = {}
        self._last_health: Dict[str, bool] = {}
        self._rr = 0                        # round-robin tiebreak
        self._counters = dict(
            requests=0, ok=0, failed=0, retries=0, hedges=0, hedge_wins=0,
            shed=0, shed_batch=0, shed_interactive=0, replica_errors=0,
            lane_interactive=0, lane_batch=0)
        self._latencies: List[float] = []   # rolling ring (ms)
        self._last_latency_at = clock()
        self._lat_lock = threading.Lock()
        self._p_cache = (0.0, 0.0, 0.0)     # (asof, p50, p99)
        self._accepting = True
        self._stop = threading.Event()
        self._booted = False  # watch-discovery: boot-time replicas are
        #                       admitted as before; only post-boot
        #                       arrivals serve the probation
        self.registry = registry if registry is not None else \
            TelemetryRegistry(gauges=ROUTE_GAUGES,
                              histograms=ROUTE_HISTOGRAMS)
        self.registry.mark_unhealthy("starting: no replica probed yet")
        spans_dir = cfg.route.discover_dir or cfg.train.train_dir
        self.run_id = read_run_id(spans_dir) if spans_dir else None
        self.spans = spans if spans is not None else SpanTracer(
            spans_dir, filename=ROUTE_EVENTS_FILE, run_id=self.run_id,
            enabled=bool(spans_dir))
        # Tail-based retention for per-request route_request spans:
        # errors/sheds/retries/hedges always kept, the slowest percentile
        # kept, healthy traffic thinned.
        self.sampler = TailSampler()

        for i, url in enumerate(cfg.route.replicas):
            self._upsert_replica(f"r{i}", str(url), pid=None, run_id=None)
        self.refresh_discovery()
        self._booted = True

        self._httpd = ThreadingHTTPServer((cfg.route.host, cfg.route.port),
                                          self._make_handler())
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="tpu-resnet-torch-route-http",
            daemon=True)
        self._prober = threading.Thread(target=self._probe_loop,
                                        name="tpu-resnet-torch-route-prober",
                                        daemon=True)
        self._closed = False

    # ------------------------------------------------------ replica set
    def _upsert_replica(self, name: str, url: str, pid, run_id) -> None:
        """Add or re-resolve one replica (lock held by caller or init).
        A changed (url, pid) means the replica restarted — possibly on a
        new port: replace it with a fresh breaker so the next probe
        round readmits it on merit, and clear any stale admin-drain
        exclusion (the rolling-upgrade readmission path)."""
        cur = self._replicas.get(name)
        if cur is not None and cur.url == url.rstrip("/") \
                and cur.pid == pid:
            return
        # Merit gating (route.watch_discovery): anything that appears or
        # re-resolves AFTER boot starts in probation — out of rotation
        # until its first successful health probe clears `pending`. The
        # default stays the historical blind admission (fresh closed
        # breaker = instantly routable) so static fleets keep their
        # zero-probe fast path.
        pending = bool(self.cfg.route.watch_discovery and self._booted)
        replica = Replica(name, url, pid=pid, run_id=run_id,
                          fail_threshold=self.cfg.route.fail_threshold,
                          open_secs=self.cfg.route.open_secs,
                          clock=self._clock, pending=pending)
        self._replicas[name] = replica
        if cur is not None:
            log.info("route: replica %s re-resolved %s -> %s", name,
                     cur.url, replica.url)
            # pid_target, NOT pid: a bare "pid" attr would overwrite the
            # span record's writer-pid field (SpanTracer stamps it, then
            # merges attrs) and fabricate a phantom router lane in
            # trace-export.
            self.spans.event("replica_resolved", replica=name,
                             url=replica.url, pid_target=pid)

    def refresh_discovery(self) -> None:
        if not self.cfg.route.discover_dir:
            return
        records = discover_replicas(self.cfg.route.discover_dir)
        with self._lock:
            for rec in records:
                self._upsert_replica(rec["name"], rec["url"],
                                     rec.get("pid"), rec.get("run_id"))
        if self.run_id is None:
            # Written under the replica lock: the prober thread and a
            # direct probe_once() caller both come through here, and the
            # first discovered run_id must win exactly once (bare reads
            # elsewhere are the atomic-publish pattern the concurrency
            # engine documents).
            with self._lock:
                if self.run_id is None:
                    for rec in records:
                        if rec.get("run_id"):
                            self.run_id = rec["run_id"]
                            self.spans.run_id = self.run_id
                            break

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def pick(self, exclude: Tuple[str, ...] = ()) -> Optional[Replica]:
        """Least-loaded healthy replica (in-flight, then the passive
        queue-depth signal); strict round-robin among the tied."""
        with self._lock:
            healthy = sorted((r for r in self._replicas.values()
                              if r.healthy and r.name not in exclude),
                             key=lambda r: r.name)
            self._rr += 1
            rr = self._rr
        if not healthy:
            return None
        load = {r.name: (r.inflight, r.queue_depth) for r in healthy}
        best = min(load.values())
        tied = [r for r in healthy if load[r.name] == best]
        return tied[rr % len(tied)]

    # ---------------------------------------------------------- probing
    def probe_replica(self, r: Replica) -> bool:
        """One active health round: /healthz then /info (queue depth +
        model step). True = replica answered healthy."""
        timeout = self.cfg.route.probe_timeout_secs
        try:
            with urllib.request.urlopen(r.url + "/healthz",
                                        timeout=timeout) as resp:
                ok = bool(json.loads(resp.read()).get("ok"))
        except urllib.error.HTTPError as e:
            e.read()
            ok = False
            r.last_error = f"healthz {e.code}"
        except (OSError, ValueError) as e:
            ok = False
            r.last_error = f"{type(e).__name__}: {e}"
        if not ok:
            return False
        try:
            with urllib.request.urlopen(r.url + "/info",
                                        timeout=timeout) as resp:
                info = json.loads(resp.read())
            r.queue_depth = int(info.get("queue_depth", 0))
            r.model_step = int(info.get("model_step", -1))
            r.image_shape = info.get("image_shape") or r.image_shape
        except (OSError, ValueError, TypeError):
            pass  # health said ok; depth is advisory
        r.last_error = None
        return True

    def _probe_loop(self) -> None:
        interval = max(0.05, self.cfg.route.probe_interval_secs)
        while not self._stop.is_set():
            self.probe_once()
            self._stop.wait(interval)

    def probe_once(self) -> None:
        """One full prober round: re-scan discovery, probe every replica
        whose breaker allows traffic or a half-open trial, publish
        gauges. Callable directly from tests (no thread/clock needed)."""
        self.refresh_discovery()
        for r in self.replicas():
            state = r.breaker.state
            if state == CircuitBreaker.OPEN:
                continue  # holding; no probe until half-open
            ok = self.probe_replica(r)
            if ok:
                if r.draining and state == CircuitBreaker.HALF_OPEN:
                    # Came back after a drain-kill cycle (rolling
                    # upgrade): clear the admin exclusion on readmit.
                    r.draining = False
                if r.pending:
                    # First successful probe of a watch-discovery
                    # arrival: probation over, admitted on merit.
                    r.pending = False
                    log.info("route: replica %s admitted on merit "
                             "(watch-discovery probation cleared)",
                             r.name)
                    self.spans.event("replica_admitted", replica=r.name,
                                     url=r.url)
                r.breaker.record_success()
            else:
                r.breaker.record_failure()
        self.publish_gauges()

    def publish_gauges(self) -> None:
        reps = self.replicas()
        healthy = sum(1 for r in reps if r.healthy)
        # Rotation-transition spans are emitted HERE, off the observed
        # healthy state, so passive exclusions (an in-flight connect
        # failure opening the breaker between probe rounds) land on the
        # timeline exactly like probe-driven ones.
        for r in reps:
            prev = self._last_health.get(r.name)
            cur = r.healthy
            if prev is not None and prev != cur:
                if cur:
                    log.info("route: replica %s readmitted", r.name)
                    self.spans.event("replica_up", replica=r.name,
                                     url=r.url)
                else:
                    reason = "draining" if r.draining else r.last_error
                    log.warning("route: replica %s excluded (%s)",
                                r.name, reason)
                    self.spans.event("replica_down", replica=r.name,
                                     url=r.url, reason=reason)
            self._last_health[r.name] = cur
        p50, p99 = self._percentiles()
        with self._lock:
            c = dict(self._counters)
        self.registry.update({
            "route_requests_total": c["requests"],
            "route_requests_ok": c["ok"],
            "route_requests_failed": c["failed"],
            "route_retries_total": c["retries"],
            "route_hedges_total": c["hedges"],
            "route_hedge_wins_total": c["hedge_wins"],
            "route_shed_total": c["shed"],
            "route_shed_batch_total": c["shed_batch"],
            "route_shed_interactive_total": c["shed_interactive"],
            "route_replica_errors_total": c["replica_errors"],
            "route_lane_interactive_total": c["lane_interactive"],
            "route_lane_batch_total": c["lane_batch"],
            "route_replicas_total": len(reps),
            "route_replicas_healthy": healthy,
            "route_inflight": sum(r.inflight for r in reps),
            "route_p50_ms": p50,
            "route_p99_ms": p99,
            "route_slo_ms": self.cfg.route.slo_ms,
        })
        self.registry.heartbeat(0)
        if healthy and self._accepting:
            self.registry.clear_unhealthy()
        else:
            self.registry.mark_unhealthy(
                "draining" if not self._accepting
                else "no healthy replicas")

    # ------------------------------------------------------- latencies
    def _record_latency(self, ms: float) -> None:
        with self._lat_lock:
            self._latencies.append(ms)
            self._last_latency_at = self._clock()
            ring = max(1, self.cfg.route.latency_ring)
            if len(self._latencies) > ring:
                del self._latencies[:-ring]
        self.registry.observe("route_latency_ms", ms)

    def _percentiles(self) -> Tuple[float, float]:
        """(p50, p99) over the rolling ring, recomputed at most every
        100 ms — the shed check runs per request and must not sort a
        2k ring per predict."""
        now = self._clock()
        asof, p50, p99 = self._p_cache
        if now - asof < 0.1:
            return p50, p99
        with self._lat_lock:
            lat = sorted(self._latencies)
            p50, p99 = percentile(lat, 0.50), percentile(lat, 0.99)
            # Cache written under the same lock as the ring it is
            # derived from: the shed check (handler threads) and the
            # prober both recompute here, and an unlocked write could
            # publish a stale (asof, p50, p99) over a fresher one.
            self._p_cache = (now, p50, p99)
        return p50, p99

    def _count(self, **deltas) -> None:
        with self._lock:
            for k, v in deltas.items():
                self._counters[k] += v

    # ------------------------------------------------------- admission
    def _maybe_shed(self, lane: str) -> Optional[dict]:
        """SLO admission: shed decision for one request, or None. Only
        consulted with enough ring samples to make p99 meaningful."""
        slo = self.cfg.route.slo_ms
        if slo <= 0:
            return None
        with self._lat_lock:
            enough = len(self._latencies) >= 20
            stale = (enough and self._clock() - self._last_latency_at
                     > _SHED_STALE_SEC)
            if stale:
                # No completions for a while (possibly because we shed
                # everything): the ring is evidence of the PAST fleet,
                # not this one. Reset and admit. The cache reset rides
                # inside the same lock as the ring it mirrors.
                self._latencies.clear()
                self._p_cache = (0.0, 0.0, 0.0)
        if stale:
            return None
        if not enough:
            return None
        _, p99 = self._percentiles()
        if p99 <= slo:
            return None
        hard = slo * max(1.0, self.cfg.route.shed_hard_factor)
        if lane == "batch":
            self._count(shed=1, shed_batch=1)
        elif p99 > hard:
            self._count(shed=1, shed_interactive=1)
        else:
            return None
        return {"error": f"shedding {lane} lane: rolling p99 "
                         f"{p99:.1f}ms over SLO {slo:.1f}ms",
                "retryable": True, "lane": lane,
                "p99_ms": round(p99, 1), "slo_ms": slo}

    # ------------------------------------------------------ forwarding
    def _forward_once(self, r: Replica, body: bytes, headers: dict,
                      timeout: float, query: str = ""
                      ) -> Tuple[int, bytes, dict]:
        """One upstream attempt, the client's query string (``logits=1``)
        forwarded. Returns (status, payload, headers); raises OSError on
        connect failure / timeout."""
        req = urllib.request.Request(
            r.url + "/predict" + (f"?{query}" if query else ""), data=body,
            headers=headers)
        r.note_inflight(1)
        t0 = self._clock()
        try:
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    return resp.status, resp.read(), dict(resp.headers)
            except urllib.error.HTTPError as e:
                return e.code, e.read(), dict(e.headers)
        finally:
            r.note_inflight(-1)
            self.registry.observe("route_upstream_ms",
                                  (self._clock() - t0) * 1e3)

    def _attempt(self, r: Replica, body: bytes, headers: dict,
                 remaining: float, exclude: Tuple[str, ...],
                 used: Optional[list] = None, query: str = ""
                 ) -> Tuple[int, bytes, dict, Replica]:
        """One routed attempt, hedged when configured: the primary send
        gets ``hedge delay`` to answer before a duplicate goes to a
        second healthy replica; first result wins (predicts are
        idempotent — the loser's work is wasted, not wrong). Returns
        ``(status, payload, headers, answered)`` where ``answered`` is
        the replica whose response this is — the caller attributes
        breaker bookkeeping to IT, not to the primary. Every replica
        name this attempt touched is appended to ``used`` (even on
        raise) so a failover retry never re-tries a leg that just
        failed."""
        if used is None:
            used = []
        used.append(r.name)
        hedge_cfg = self.cfg.route.hedge_ms
        if hedge_cfg == 0:
            status, payload, up = self._forward_once(r, body, headers,
                                                     remaining, query)
            return status, payload, up, r
        # The whole hedged attempt — delay, both legs, all waits — is
        # anchored on ONE deadline so it can never overshoot the
        # caller's remaining budget (take() after the hedge delay must
        # not get a fresh full `remaining`).
        attempt_deadline = self._clock() + remaining
        _, p99 = self._percentiles()
        delay_ms = hedge_cfg if hedge_cfg > 0 else max(10.0, p99)
        delay = min(delay_ms / 1e3, remaining / 2)
        results: "queue.Queue" = queue.Queue()

        def call(rep: Replica, who: str) -> None:
            try:
                results.put((who, rep, self._forward_once(
                    rep, body, headers, remaining, query)))
            except OSError as e:
                results.put((who, rep, e))

        def charge(rep: Replica, err: OSError) -> None:
            rep.breaker.record_failure()
            rep.last_error = f"{type(err).__name__}: {err}"[:160]
            self._count(replica_errors=1)

        def take():
            budget = attempt_deadline - self._clock()
            try:
                return results.get(timeout=max(0.0, budget))
            except queue.Empty:
                raise _AttributedError(  # hung legs: probes evict them
                    f"no replica answered within {remaining:.2f}s")

        threading.Thread(target=call, args=(r, "primary"),
                         daemon=True).start()
        outstanding = 1
        try:
            who, rep, res = results.get(timeout=delay)
        except queue.Empty:
            hedge_rep = self.pick(exclude=exclude + tuple(used))
            if hedge_rep is not None:
                self._count(hedges=1)
                used.append(hedge_rep.name)
                threading.Thread(target=call,
                                 args=(hedge_rep, "hedge"),
                                 daemon=True).start()
                outstanding += 1
            who, rep, res = take()
        while isinstance(res, OSError) and outstanding > 1:
            # First finisher failed; give the other leg its chance.
            # Attribution is to the leg that failed, not the primary.
            charge(rep, res)
            outstanding -= 1
            who, rep, res = take()
        if isinstance(res, OSError):
            # The last leg failed too: charge IT here and raise the
            # already-attributed marker — route_predict must not charge
            # the primary again (the first failure above may already
            # have been the primary's).
            charge(rep, res)
            raise _AttributedError(f"{rep.name}: {type(res).__name__}: "
                                   f"{res}")
        if who == "hedge":
            self._count(hedge_wins=1)
        return res[0], res[1], res[2], rep

    def _trace_request(self, trace_id: str, lane: str, status: int,
                       legs: list, t0: float, shed: bool = False,
                       retried: bool = False, hedged: bool = False,
                       replica: Optional[str] = None,
                       **extra) -> None:
        """Tail-sampled ``route_request`` span: the router's hop of a
        distributed trace, carrying per-leg attribution (which replica
        answered, which legs failed and how long each burned) plus the
        admission verdict. The sampler decision is pure in-memory; the
        span write happens here with no lock held."""
        end = time.time()
        latency_ms = (end - t0) * 1e3
        reason = self.sampler.observe(latency_ms, error=(status >= 500),
                                      shed=shed, retried=retried,
                                      hedged=hedged)
        if reason is None:
            return
        attrs = {"trace_id": trace_id, "lane": lane, "status": int(status),
                 "sampled": reason, "latency_ms": round(latency_ms, 3)}
        if replica:
            attrs["replica"] = replica
        if legs:
            attrs["legs"] = legs
        if retried:
            attrs["retried"] = True
        if hedged:
            attrs["hedged"] = True
        attrs.update(extra)
        self.spans.record("route_request", t0, end, **attrs)

    def route_predict(self, body: bytes, headers: dict, query: str = ""
                      ) -> Tuple[int, bytes, dict]:
        """Route one predict: shed check, then up to two attempts on
        distinct replicas under the deadline budget. Returns
        (status, payload_bytes, response_headers).

        Distributed-tracing contract: the router mints a trace id when
        the client didn't send one (X-Trace-Id), forwards it on EVERY
        leg, and echoes it on every response path — success, shed,
        drain, 5xx — so the client, the router span, and each replica
        span all name the same request."""
        lane = (headers.get("X-Lane") or "interactive").strip().lower()
        if lane not in LANES:
            lane = "interactive"
        trace_id = (headers.get("X-Trace-Id") or "").strip() \
            or uuid.uuid4().hex[:16]
        t0_wall = time.time()
        self._count(requests=1, **{f"lane_{lane}": 1})
        if not self._accepting:
            self._trace_request(trace_id, lane, 503, [], t0_wall,
                                decision="draining")
            return 503, json.dumps(
                {"error": "router is draining"}).encode(), \
                {"X-Trace-Id": trace_id}
        shed = self._maybe_shed(lane)
        if shed is not None:
            self._trace_request(trace_id, lane, 429, [], t0_wall,
                                shed=True, decision="shed",
                                p99_ms=shed.get("p99_ms"),
                                slo_ms=shed.get("slo_ms"))
            return 429, json.dumps(shed).encode(), \
                {"Retry-After": "1", "X-Trace-Id": trace_id}
        try:
            deadline_ms = float(headers.get("X-Deadline-Ms") or
                                self.cfg.route.deadline_ms)
        except ValueError:
            deadline_ms = self.cfg.route.deadline_ms
        fwd_headers = {k: headers[k] for k in _FORWARD_HEADERS
                       if headers.get(k)}
        fwd_headers["X-Trace-Id"] = trace_id
        t_start = self._clock()
        tried: Tuple[str, ...] = ()
        legs: List[dict] = []
        retried = hedged = False
        last_err = "no healthy replicas"
        for attempt in range(2):
            remaining = deadline_ms / 1e3 - (self._clock() - t_start)
            if remaining <= _MIN_ATTEMPT_SEC:
                break
            r = self.pick(exclude=tried)
            if r is None:
                if not tried:
                    self._count(failed=1)
                    self._trace_request(trace_id, lane, 503, legs,
                                        t0_wall,
                                        decision="no_healthy_replicas")
                    return 503, json.dumps(
                        {"error": "no healthy replicas",
                         "retryable": True}).encode(), \
                        {"Retry-After": "1", "X-Trace-Id": trace_id}
                break
            if attempt:
                self._count(retries=1)
                retried = True
            used: list = []
            leg_t0 = self._clock()
            try:
                status, payload, up_headers, answered = self._attempt(
                    r, body, fwd_headers, remaining, tried, used, query)
            except _AttributedError as e:
                # Hedged attempt: every failed leg's breaker was charged
                # inside _attempt (the last failure may have been the
                # hedge's, not the primary's) — only the retry exclusion
                # is left to do here.
                tried = tried + tuple(used)
                hedged = hedged or len(used) > 1
                last_err = str(e)
                legs.append({"replicas": list(used), "error":
                             last_err[:160], "ms": round(
                                 (self._clock() - leg_t0) * 1e3, 3)})
                log.warning("route: attempt %d failed (%s)",
                            attempt + 1, last_err)
                continue
            except OSError as e:
                # Non-hedged path: the (single) primary leg failed.
                r.breaker.record_failure()
                r.last_error = f"{type(e).__name__}: {e}"[:160]
                self._count(replica_errors=1)
                tried = tried + tuple(used)
                last_err = f"{r.name}: {type(e).__name__}: {e}"
                legs.append({"replicas": list(used), "error":
                             last_err[:160], "ms": round(
                                 (self._clock() - leg_t0) * 1e3, 3)})
                log.warning("route: attempt %d on %s failed (%s)",
                            attempt + 1, r.name, last_err)
                continue
            tried = tried + tuple(used)
            hedged = hedged or len(used) > 1
            legs.append({"replicas": list(used), "status": int(status),
                         "answered": answered.name, "ms": round(
                             (self._clock() - leg_t0) * 1e3, 3)})
            if status >= 500:
                # Charged to the replica that ANSWERED 5xx — with
                # hedging on, that may be the hedge leg, not r.
                answered.breaker.record_failure()
                answered.last_error = f"upstream {status}"
                self._count(replica_errors=1)
                last_err = f"{answered.name}: upstream {status}"
                continue
            answered.breaker.record_success()
            out_headers = {"X-Replica": answered.name,
                           "X-Trace-Id": trace_id}
            if status == 429 and up_headers.get("Retry-After"):
                out_headers["Retry-After"] = up_headers["Retry-After"]
            if status < 400:
                self._count(ok=1)
                self._record_latency((self._clock() - t_start) * 1e3)
            self._trace_request(trace_id, lane, status, legs, t0_wall,
                                shed=(status == 429), retried=retried,
                                hedged=hedged, replica=answered.name,
                                deadline_ms=deadline_ms)
            return status, payload, out_headers
        self._count(failed=1)
        elapsed_ms = (self._clock() - t_start) * 1e3
        if elapsed_ms >= deadline_ms - _MIN_ATTEMPT_SEC * 1e3:
            self._trace_request(trace_id, lane, 504, legs, t0_wall,
                                retried=retried, hedged=hedged,
                                decision="deadline",
                                deadline_ms=deadline_ms)
            return 504, json.dumps(
                {"error": f"deadline {deadline_ms:.0f}ms exhausted "
                          f"after {elapsed_ms:.0f}ms ({last_err})",
                 "retryable": True}).encode(), {"X-Trace-Id": trace_id}
        self._trace_request(trace_id, lane, 502, legs, t0_wall,
                            retried=retried, hedged=hedged,
                            deadline_ms=deadline_ms)
        return 502, json.dumps(
            {"error": f"all replicas failed: {last_err}",
             "retryable": True}).encode(), \
            {"Retry-After": "1", "X-Trace-Id": trace_id}

    # ----------------------------------------------------------- drain
    def drain_replica(self, name: str, kill: bool = True,
                      timeout: Optional[float] = None) -> dict:
        """Rolling-operations drain: exclude ``name`` from rotation,
        wait out its in-flight requests, then deliver the replica's drain
        contract (SIGTERM to the discovery pid) and wait for the process
        to go. ``kill=False`` stops after the exclusion+quiesce (the
        caller owns the replica's lifecycle — in-process tests, or an
        operator draining a remote replica by hand)."""
        timeout = self.cfg.route.drain_timeout_secs if timeout is None \
            else timeout
        with self._lock:
            r = self._replicas.get(name)
        if r is None:
            return {"ok": False, "error": f"unknown replica {name!r}",
                    "replicas": sorted(self._replicas)}
        result = {"ok": True, "replica": name, "pid": r.pid}
        with self.spans.span("route_drain", replica=name,
                             pid_target=r.pid) as attrs:
            r.draining = True
            deadline = self._clock() + timeout
            while r.inflight > 0 and self._clock() < deadline:
                time.sleep(0.05)
            attrs["inflight_at_signal"] = result["inflight_at_signal"] \
                = r.inflight
            if kill and r.pid and r.pid != os.getpid():
                try:
                    os.kill(int(r.pid), signal.SIGTERM)
                    attrs["signalled"] = result["signalled"] = True
                except (OSError, ValueError) as e:
                    attrs["signalled"] = result["signalled"] = False
                    result.update(ok=False,
                                  error=f"SIGTERM failed: {e}")
                    return result
                # Wait for the replica's graceful drain to complete.
                # The signal is its HTTP endpoint going away (connection
                # refused), NOT the process table: the replica may be
                # another supervisor's child — a zombie awaiting its
                # parent's reap still "exists" to os.kill(pid, 0), and a
                # remote replica has no local pid semantics at all.
                gone = False
                while self._clock() < deadline:
                    try:
                        with urllib.request.urlopen(r.url + "/healthz",
                                                    timeout=1) as resp:
                            resp.read()
                    except urllib.error.HTTPError as e:
                        e.read()      # 503 while draining: still up
                    except OSError:
                        gone = True
                        break
                    time.sleep(0.1)
                attrs["replica_gone"] = result["replica_gone"] = gone
                if not gone:
                    result.update(ok=False,
                                  error=f"replica {name} still serving "
                                        f"{timeout}s after SIGTERM")
            elif kill:
                result["signalled"] = False
                result["note"] = "no signalable pid (static replica or " \
                                 "in-process); excluded from rotation only"
        self.publish_gauges()
        return result

    # ------------------------------------------------------- lifecycle
    def start(self) -> "Router":
        self._http_thread.start()
        self._prober.start()
        self.spans.event("route_start", port=self.port,
                         replicas=[r.name for r in self.replicas()])
        return self

    def drain(self) -> None:
        """Stop accepting new predicts (503); in-flight forwards finish
        on their own handler threads — callers that are about to exit
        the process must :meth:`quiesce` before :meth:`close`, or those
        threads die with it."""
        # Flag flip under the lock (the batcher's admission discipline):
        # handler threads read the flag bare — the documented
        # atomic-publish pattern — but the write itself is serialized
        # so the concurrency engine can prove one consistent writer.
        with self._lock:
            self._accepting = False
        self.registry.mark_unhealthy("draining")

    def quiesce(self, timeout: float) -> bool:
        """Wait for every in-flight upstream forward to complete (or
        ``timeout``). Returns True when the router went idle."""
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            if sum(r.inflight for r in self.replicas()) == 0:
                return True
            time.sleep(0.05)
        return False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        # shutdown() handshakes with serve_forever and blocks forever if
        # the HTTP thread never ran (a Router driven synchronously via
        # refresh_discovery()/probe_once() without start()).
        if self._http_thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()
        self.spans.close()

    def info(self) -> dict:
        p50, p99 = self._percentiles()
        with self._lock:
            counters = dict(self._counters)
        reps = self.replicas()
        # Fleet-wide model facts forwarded from the probed replicas so a
        # client (loadgen) can treat the router exactly like a replica.
        shape = next((r.image_shape for r in reps if r.image_shape), None)
        step = max((r.model_step for r in reps), default=-1)
        return {"run_id": self.run_id,
                "image_shape": shape,
                "model_step": step,
                "port": self.port,
                "slo_ms": self.cfg.route.slo_ms,
                "hedge_ms": self.cfg.route.hedge_ms,
                "deadline_ms": self.cfg.route.deadline_ms,
                "p50_ms": round(p50, 3), "p99_ms": round(p99, 3),
                "counters": counters,
                "replicas": [r.describe() for r in self.replicas()]}

    # ------------------------------------------------------ HTTP layer
    def _make_handler(self):
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, code: int, payload, ctype="application/json",
                      extra_headers: Optional[dict] = None):
                send_json(self, code, payload, ctype, extra_headers)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._send(200, router.registry.render().encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    health = router.registry.health()
                    health["replicas_healthy"] = sum(
                        1 for r in router.replicas() if r.healthy)
                    self._send(200 if health["ok"] else 503, health)
                elif path in ("/", "/info", "/replicas"):
                    self._send(200, router.info())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                path, _, query = self.path.partition("?")
                if path == "/admin/drain":
                    params = dict(p.split("=", 1) for p in query.split("&")
                                  if "=" in p)
                    name = params.get("replica", "")
                    result = router.drain_replica(name)
                    self._send(200 if result.get("ok") else 409, result)
                    return
                if path != "/predict":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    length = 0
                if length <= 0:
                    self._send(400, {"error": "empty body"})
                    return
                body = self.rfile.read(length)
                # Title-case the header keys: urllib clients send
                # "X-lane", curl sends "X-Lane" — route_predict looks
                # keys up in one canonical casing.
                code, payload, headers = router.route_predict(
                    body, {k.title(): v for k, v in self.headers.items()},
                    query=query)
                self._send(code, payload, extra_headers=headers)

            def log_message(self, *args):  # per-request logs would swamp
                pass

        return Handler


def write_route_discovery(directory: str, port: int,
                          run_id: Optional[str] = None) -> None:
    """Atomic ``<dir>/route.json`` — the serve.json analog for the
    router (loadgen --train-dir and ``route --drain`` dial from here)."""
    write_record(directory, ROUTE_DISCOVERY, port,
                 extra={"run_id": run_id})


def read_route_port(directory: str) -> Optional[int]:
    return read_port(directory, ROUTE_DISCOVERY)


def request_drain(router_url: str, replica: str,
                  timeout: float = 60.0) -> dict:
    """Client half of the rolling drain: POST the admin endpoint of a
    RUNNING router (``tpu_resnet_torch route --drain <replica>`` and the
    loadgen rolling-drain scenario both come through here)."""
    req = urllib.request.Request(
        router_url.rstrip("/") + f"/admin/drain?replica={replica}",
        data=b"{}", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            return json.loads(e.read())
        except ValueError:
            return {"ok": False, "error": f"admin drain HTTP {e.code}"}
    except OSError as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def route(cfg: RunConfig) -> int:
    """CLI entry: start the router, announce route.json, block until
    SIGTERM/SIGINT (flag-only ShutdownCoordinator: the handler only
    sets a flag), stop accepting, exit 0."""
    from tpu_resnet_torch.resilience import exitcodes
    from tpu_resnet_torch.resilience.shutdown import ShutdownCoordinator

    if not cfg.route.replicas and not cfg.route.discover_dir:
        log.error("route: need route.replicas=[urls...] or "
                  "route.discover_dir=<dir with serve*.json>")
        return exitcodes.USAGE_ERROR
    coordinator = ShutdownCoordinator(
        enabled=cfg.resilience.graceful_shutdown,
        action_desc="stopping the router (new predicts get 503, "
                    "in-flight forwards finish), then exiting 0")
    router = Router(cfg)
    with coordinator:
        router.start()
        announce_dir = cfg.route.discover_dir or cfg.train.train_dir
        if announce_dir:
            write_route_discovery(announce_dir, router.port,
                                  run_id=router.run_id)
        log.info("route: ready on :%d — %d replica(s) known, probe "
                 "every %.1fs, SLO %.0fms (POST /predict; /metrics; "
                 "/healthz; POST /admin/drain?replica=NAME)",
                 router.port, len(router.replicas()),
                 cfg.route.probe_interval_secs, cfg.route.slo_ms)
        try:
            while not coordinator.event.wait(0.5):
                pass
            log.info("route: shutdown requested (%s)", coordinator.signum)
            router.drain()
            # In-flight forwards run on daemon handler threads — they
            # must finish before the process exit kills them mid-reply.
            clean = router.quiesce(cfg.route.drain_timeout_secs)
            if not clean:
                log.warning("route: %ss quiesce elapsed with requests "
                            "still in flight — closing anyway",
                            cfg.route.drain_timeout_secs)
        except KeyboardInterrupt:
            log.warning("route: immediate abort requested")
        finally:
            router.close()
    log.info("route: exited cleanly")
    return exitcodes.DONE
