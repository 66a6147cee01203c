"""The fleet telemetry aggregator — ``python -m tpu_resnet_torch fleetmon``
(port of ``tpu_resnet/obs/fleet.py``: the same discovery, merge, burn
math, files and gauges).

- **discovery**: every endpoint announces itself — ``serve.json`` /
  ``serve-<name>.json`` (replicas), ``route.json`` (router),
  ``telemetry*.json`` (trainer) — so one directory scan per round finds
  the whole fleet, replicas restarted on new ports included.
- **scrape → timeseries**: every ``/metrics`` endpoint scraped each
  ``fleet.scrape_interval_secs``, one JSON line per round appended to
  ``<dir>/fleet_timeseries.jsonl``.
- **exact fleet percentiles**: the replicas' ``serve_latency_ms``
  histograms share fixed bucket edges, so ``merge_histograms`` pools them
  bucket-wise and ``histogram_quantile`` over the merge is the quantile
  of the pooled samples — never an average of per-replica percentiles.
- **SLO burn rate**: requests slower than ``fleet.slo_ms`` spend error
  budget; burn rates over a fast and a slow window gate a
  ``fleet_burn_alert`` event in ``fleet_events.jsonl`` (and
  ``fleet_burn_clear`` when it ends).
- **snapshot**: every round also atomically replaces
  ``<dir>/fleet_snapshot.json``, digest-stamped (``read_fleet_snapshot``).
- **its own /metrics + /healthz**: ``FLEET_GAUGES`` on ``fleet.port``,
  announced in ``<dir>/fleetmon.json``.

Host code: importing this module imports no torch and nothing of JAX.
Scrapes happen with no lock held; only the in-memory ring and counters
ride under the lock, and the timeseries file has a single writer.
"""

from __future__ import annotations

import glob
import json
import logging
import math
import os
import threading
import time
from typing import Dict, List, Optional

from tpu_resnet_torch.config import RunConfig
from tpu_resnet_torch.obs.manifest import read_run_id
from tpu_resnet_torch.obs.server import (FLEET_GAUGES, NAMESPACE,
                                         TelemetryRegistry, TelemetryServer,
                                         histogram_quantile, merge_histograms,
                                         scrape)
from tpu_resnet_torch.obs.spans import SpanTracer
from tpu_resnet_torch.obs.trace import FLEET_EVENTS_FILE
from tpu_resnet_torch.serve.discovery import read_port, write_record

log = logging.getLogger("tpu_resnet_torch")

FLEET_DISCOVERY = "fleetmon.json"
FLEET_TIMESERIES_FILE = "fleet_timeseries.jsonl"
# Latest merged round as one atomically-replaced, digest-stamped file —
# the consumer API for control loops and obs_scrape --fleet: read ONE
# file instead of re-parsing the timeseries stream.
FLEET_SNAPSHOT_FILE = "fleet_snapshot.json"
# Scraped series carry the exposition namespace — the key a /metrics
# consumer must use, distinct from the bare declaration name.
SERVE_LATENCY_SERIES = f"{NAMESPACE}_serve_latency_ms"
HBM_IN_USE_SERIES = f"{NAMESPACE}_hbm_bytes_in_use"
HBM_LIMIT_SERIES = f"{NAMESPACE}_hbm_bytes_limit"


def discover_endpoints(directory: str) -> List[dict]:
    """Every scrapable endpoint announced under ``directory``:
    serve replicas, the router, and trainer telemetry servers. Torn or
    unreadable files are skipped (the scraper re-reads every round);
    duplicate ports (telemetry.json + its hostname-keyed twin) collapse
    to one endpoint; fleetmon's own announcement is excluded."""
    out: List[dict] = []
    seen_ports = set()
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        base = os.path.basename(path)
        if base == "route.json":
            kind, name = "route", "router"
        elif base == "serve.json":
            kind, name = "serve", "default"
        elif base.startswith("serve-") and base.endswith(".json"):
            kind, name = "serve", base[len("serve-"):-len(".json")]
        elif base == "telemetry.json":
            kind, name = "train", "train"
        elif base.startswith("telemetry-") and base.endswith(".json"):
            kind, name = "train", base[len("telemetry-"):-len(".json")]
        else:
            continue
        try:
            with open(path) as f:
                rec = json.load(f)
            port = int(rec["port"])
        except (OSError, ValueError, KeyError, TypeError):
            continue
        if port in seen_ports:
            continue
        seen_ports.add(port)
        out.append({"kind": kind, "name": str(rec.get("name") or name),
                    "port": port, "pid": rec.get("pid"),
                    "run_id": rec.get("run_id"),
                    "url": f"http://127.0.0.1:{port}"})
    return out


def cumulative_at(snapshot: dict, x: float) -> float:
    """Interpolated count of observations <= ``x`` in a histogram
    snapshot — the inverse read of :func:`histogram_quantile`, and the
    "requests that met the SLO" numerator of the burn-rate math.
    Overflow-bucket samples are all slower than the largest finite edge,
    so they never count as good."""
    prev_edge, prev_cum = 0.0, 0.0
    for edge, cum in snapshot.get("buckets", []):
        if math.isinf(edge):
            break
        if x <= edge:
            span = edge - prev_edge
            frac = 1.0 if span <= 0 else \
                max(0.0, min(1.0, (x - prev_edge) / span))
            return prev_cum + (float(cum) - prev_cum) * frac
        prev_edge, prev_cum = edge, float(cum)
    return prev_cum


def burn_rate(cur: dict, old: dict, slo_ms: float,
              slo_target: float) -> float:
    """Error-budget burn rate between two merged snapshots: the
    fraction of the window's requests that blew ``slo_ms``, divided by
    the budget fraction ``1 - slo_target``. 1.0 = burning exactly the
    budget; 14 over a fast window is the classic page threshold. 0.0
    when the window saw no requests."""
    d_count = int(cur.get("count", 0)) - int(old.get("count", 0))
    if d_count <= 0:
        return 0.0
    d_good = cumulative_at(cur, slo_ms) - cumulative_at(old, slo_ms)
    bad_frac = min(1.0, max(0.0, 1.0 - d_good / d_count))
    budget = max(1e-9, 1.0 - float(slo_target))
    return bad_frac / budget


class FleetAggregator:
    """Scrape loop + in-memory round ring + burn-rate alerting.

    Threading contract: all
    network I/O and file appends happen on the scraper thread with NO
    lock held; ``self._lock`` guards only the round ring and counters
    that :meth:`snapshot` reads from other threads. The timeseries file
    has exactly one writer (the scraper); ``scrape_once`` must only ever
    be called from one thread at a time (the loop, or a test driving it
    directly before :meth:`start`)."""

    def __init__(self, cfg: RunConfig,
                 registry: Optional[TelemetryRegistry] = None,
                 clock=time.time):
        self.cfg = cfg
        self.directory = cfg.fleet.discover_dir or cfg.train.train_dir
        if not self.directory:
            raise ValueError("fleetmon needs fleet.discover_dir or "
                             "train.train_dir")
        self._clock = clock
        self.registry = registry if registry is not None else \
            TelemetryRegistry(gauges=FLEET_GAUGES)
        self.registry.set("fleet_slo_ms", cfg.fleet.slo_ms)
        self.registry.mark_unhealthy("starting: no scrape round yet")
        self.run_id = read_run_id(self.directory)
        self.spans = SpanTracer(self.directory,
                                filename=FLEET_EVENTS_FILE,
                                run_id=self.run_id)
        os.makedirs(self.directory, exist_ok=True)
        self._ts_f = open(os.path.join(self.directory,
                                       FLEET_TIMESERIES_FILE),
                          "a", buffering=1)
        self._lock = threading.Lock()
        self._rounds: List[dict] = []   # ring of per-round summaries
        self._scrapes = 0
        self._scrape_errors = 0
        self._alerts = 0
        self._alert_active = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="tpu-resnet-torch-fleetmon-scraper",
            daemon=True)

    # ------------------------------------------------------------ scraping
    def scrape_once(self) -> dict:
        """One full round: discover, scrape every endpoint (no lock
        held), merge serve histograms, append the timeseries line,
        update the ring, evaluate the burn alert, publish gauges.
        Returns the round record (the timeseries line's dict)."""
        endpoints = discover_endpoints(self.directory)
        reports: Dict[str, dict] = {}
        errors = 0
        for ep in endpoints:
            try:
                reports[ep["name"]] = scrape(
                    ep["url"], timeout=self.cfg.fleet.scrape_timeout_secs)
            except (OSError, ValueError) as e:
                errors += 1
                reports[ep["name"]] = {"error":
                                       f"{type(e).__name__}: {e}"[:160]}
        serve_hists = [
            r.get("histograms", {}).get(SERVE_LATENCY_SERIES)
            for ep, r in ((e, reports[e["name"]]) for e in endpoints)
            if ep["kind"] == "serve" and "error" not in r]
        try:
            merged = merge_histograms(serve_hists)
        except ValueError as e:
            # Mismatched bucket edges across replicas (a version skew):
            # surface loudly, never fabricate a pooled quantile.
            log.error("fleetmon: histogram merge failed: %s", e)
            self.spans.event("fleet_merge_error", error=str(e)[:200])
            errors += 1
            merged = {"buckets": [], "sum": 0.0, "count": 0}
        quantiles = {q: histogram_quantile(merged, q)
                     for q in (0.50, 0.95, 0.99)}
        now = self._clock()
        record = {
            "wall": round(now, 3),
            "endpoints": len(endpoints),
            "up": len(endpoints) - errors if endpoints else 0,
            "errors": errors,
            "fleet": {"count": merged["count"],
                      "p50_ms": round(quantiles[0.50], 3),
                      "p95_ms": round(quantiles[0.95], 3),
                      "p99_ms": round(quantiles[0.99], 3)},
            "per": {
                name: ({"error": r["error"]} if "error" in r else {
                    "healthy": bool(r.get("health", {}).get("ok")),
                    "serve_p99_ms": round(histogram_quantile(
                        r.get("histograms", {}).get(
                            SERVE_LATENCY_SERIES, {}), 0.99), 3),
                    "requests": int(r.get("histograms", {}).get(
                        SERVE_LATENCY_SERIES, {}).get("count", 0)),
                    # Per-replica device memory, when the endpoint
                    # exports it — the colocation headroom signal.
                    **({"hbm_bytes_in_use":
                        r["metrics"][HBM_IN_USE_SERIES],
                        "hbm_bytes_limit":
                        r["metrics"].get(HBM_LIMIT_SERIES, 0.0)}
                       if HBM_IN_USE_SERIES in r.get("metrics", {})
                       else {}),
                }) for name, r in sorted(reports.items())},
        }
        fast, slow, fired, cleared, active, scrapes = \
            self._note_round(now, merged)
        record["burn_rate_fast"] = round(fast, 3)
        record["burn_rate_slow"] = round(slow, 3)
        try:
            self._ts_f.write(json.dumps(record) + "\n")
        except ValueError:  # closed in a shutdown race
            pass
        # Snapshot satellite of the timeseries line: same fields plus
        # the round ordinal and alert state, replaced atomically and
        # digest-stamped so a reader can never act on a torn or
        # hand-edited file. Single writer (this scraper thread), I/O
        # with no lock held.
        write_fleet_snapshot(self.directory, {
            **record, "round": scrapes, "alert_active": active,
            "slo_ms": self.cfg.fleet.slo_ms,
            "slo_target": self.cfg.fleet.slo_target})
        if fired:
            self.spans.event(
                "fleet_burn_alert", burn_rate_fast=round(fast, 3),
                burn_rate_slow=round(slow, 3),
                slo_ms=self.cfg.fleet.slo_ms,
                fast_window_secs=self.cfg.fleet.fast_window_secs,
                slow_window_secs=self.cfg.fleet.slow_window_secs,
                fleet_p99_ms=record["fleet"]["p99_ms"])
            log.warning("fleetmon: burn-rate alert — fast %.1fx / slow "
                        "%.1fx over SLO %.0fms", fast, slow,
                        self.cfg.fleet.slo_ms)
        if cleared:
            self.spans.event("fleet_burn_clear",
                             burn_rate_fast=round(fast, 3),
                             burn_rate_slow=round(slow, 3))
            log.info("fleetmon: burn-rate alert cleared")
        self._publish(record)
        return record

    def _note_round(self, now: float, merged: dict):
        """Ring append + burn evaluation + alert transition, all under
        the lock (pure in-memory — the I/O stays outside). Returns
        ``(burn_fast, burn_slow, fired, cleared, active, scrapes)``."""
        cfg = self.cfg.fleet
        with self._lock:
            self._scrapes += 1
            self._rounds.append({"wall": now, "merged": merged})
            ring = max(2, int(cfg.ring))
            if len(self._rounds) > ring:
                del self._rounds[:-ring]
            fast = slow = 0.0
            if cfg.slo_ms > 0:
                fast = burn_rate(merged,
                                 self._window_base(now,
                                                   cfg.fast_window_secs),
                                 cfg.slo_ms, cfg.slo_target)
                slow = burn_rate(merged,
                                 self._window_base(now,
                                                   cfg.slow_window_secs),
                                 cfg.slo_ms, cfg.slo_target)
            hot = (cfg.slo_ms > 0 and fast >= cfg.burn_alert_fast
                   and slow >= cfg.burn_alert_slow)
            fired = hot and not self._alert_active
            cleared = self._alert_active and not hot
            self._alert_active = hot
            if fired:
                self._alerts += 1
            scrapes = self._scrapes
        return fast, slow, fired, cleared, hot, scrapes

    def _window_base(self, now: float, window_secs: float) -> dict:
        """Oldest ring round inside the window (lock held by caller).
        The first round of a young process anchors every window — burn
        is then computed over all available history, which is the
        honest read when the window hasn't filled yet."""
        base = {"buckets": [], "sum": 0.0, "count": 0}
        cutoff = now - window_secs
        for r in self._rounds[:-1]:
            if r["wall"] >= cutoff:
                return r["merged"]
            base = r["merged"]
        return base if self._rounds[:-1] else \
            {"buckets": [], "sum": 0.0, "count": 0}

    def _publish(self, record: dict) -> None:
        with self._lock:
            scrapes, errors = self._scrapes, self._scrape_errors
            alerts, active = self._alerts, self._alert_active
        self.registry.update({
            "fleet_endpoints_total": record["endpoints"],
            "fleet_endpoints_up": record["up"],
            "fleet_scrapes_total": scrapes,
            "fleet_scrape_errors_total": errors,
            "fleet_requests_total": record["fleet"]["count"],
            "fleet_serve_p50_ms": record["fleet"]["p50_ms"],
            "fleet_serve_p95_ms": record["fleet"]["p95_ms"],
            "fleet_serve_p99_ms": record["fleet"]["p99_ms"],
            "fleet_slo_ms": self.cfg.fleet.slo_ms,
            "fleet_burn_rate_fast": record["burn_rate_fast"],
            "fleet_burn_rate_slow": record["burn_rate_slow"],
            "fleet_alerts_total": alerts,
            "fleet_alert_active": 1.0 if active else 0.0,
        })
        self.registry.heartbeat(scrapes)
        self.registry.clear_unhealthy()

    def _loop(self) -> None:
        interval = max(0.05, self.cfg.fleet.scrape_interval_secs)
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 - the sensor must outlive
                log.exception("fleetmon: scrape round failed")
                with self._lock:
                    self._scrape_errors += 1
            self._stop.wait(interval)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "FleetAggregator":
        self.spans.event("fleet_start", directory=self.directory,
                         scrape_interval_secs=
                         self.cfg.fleet.scrape_interval_secs,
                         slo_ms=self.cfg.fleet.slo_ms)
        self._thread.start()
        return self

    def snapshot(self) -> dict:
        """Newest round summary + counters (thread-safe read)."""
        with self._lock:
            last = dict(self._rounds[-1]) if self._rounds else None
            return {"rounds": len(self._rounds),
                    "scrapes": self._scrapes,
                    "scrape_errors": self._scrape_errors,
                    "alerts": self._alerts,
                    "alert_active": self._alert_active,
                    "last": last}

    def close(self) -> None:
        """Stop and JOIN the scraper (a daemon thread left running at
        interpreter teardown would race the file closes below), then
        close the timeseries and span writers."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
        try:
            self._ts_f.close()
        except OSError:  # pragma: no cover - fs-specific
            pass
        self.spans.close()


def write_fleet_snapshot(directory: str, payload: dict) -> None:
    """Atomic ``<dir>/fleet_snapshot.json``: the payload plus a sha256
    ``digest`` over its canonical JSON. tmp + ``os.replace`` means a
    reader sees the previous complete snapshot or this one, never a
    torn write — and the digest catches everything replace can't
    (a partial copy, a hand edit)."""
    import hashlib

    body = dict(payload)
    body.pop("digest", None)
    canon = json.dumps(body, sort_keys=True)
    body["digest"] = hashlib.sha256(canon.encode()).hexdigest()
    path = os.path.join(directory, FLEET_SNAPSHOT_FILE)
    tmp = path + f".tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(body, f, indent=2)
        os.replace(tmp, path)
    except OSError as e:  # the sensor must outlive a full disk
        log.warning("fleetmon: snapshot write failed: %s", e)


def read_fleet_snapshot(directory: str) -> Optional[dict]:
    """Digest-verified read of the latest fleet snapshot. None when the
    file is absent, unparseable, or fails its digest — a control loop
    treats all three the same: no trustworthy fleet signal this round."""
    import hashlib

    path = os.path.join(directory, FLEET_SNAPSHOT_FILE)
    try:
        with open(path) as f:
            body = json.load(f)
        digest = body.pop("digest")
    except (OSError, ValueError, KeyError):
        return None
    canon = json.dumps(body, sort_keys=True)
    if hashlib.sha256(canon.encode()).hexdigest() != digest:
        log.warning("fleetmon: snapshot digest mismatch — ignoring %s",
                    path)
        return None
    body["digest"] = digest
    return body


def write_fleet_discovery(directory: str, port: int,
                          run_id: Optional[str] = None) -> None:
    """Atomic ``<dir>/fleetmon.json`` — the route.json analog for the
    aggregator (obs_scrape --fleet and the doctor probe dial from
    here)."""
    write_record(directory, FLEET_DISCOVERY, port,
                 extra={"run_id": run_id, "kind": "fleetmon"})


def read_fleet_port(directory: str) -> Optional[int]:
    return read_port(directory, FLEET_DISCOVERY)


def fleetmon(cfg: RunConfig) -> int:
    """CLI entry: start the aggregator + its telemetry server, announce
    fleetmon.json, block until SIGTERM/SIGINT (flag-only
    ShutdownCoordinator), stop the scraper, exit 0."""
    from tpu_resnet_torch.resilience.shutdown import ShutdownCoordinator

    directory = cfg.fleet.discover_dir or cfg.train.train_dir
    if not directory:
        log.error("fleetmon: need fleet.discover_dir=<dir with "
                  "serve*.json/route.json> or train.train_dir")
        return 2
    coordinator = ShutdownCoordinator(
        enabled=cfg.resilience.graceful_shutdown,
        action_desc="stopping the fleet scraper and closing the "
                    "timeseries, then exiting 0")
    agg = FleetAggregator(cfg)
    server = None
    with coordinator:
        agg.start()
        if cfg.fleet.port >= 0:
            server = TelemetryServer(agg.registry, cfg.fleet.port,
                                     cfg.fleet.host)
            write_fleet_discovery(directory, server.port,
                                  run_id=agg.run_id)
            log.info("fleetmon: ready on :%d — scraping %s every %.1fs "
                     "(SLO %.0fms; /metrics; /healthz)", server.port,
                     directory, cfg.fleet.scrape_interval_secs,
                     cfg.fleet.slo_ms)
        try:
            while not coordinator.event.wait(0.5):
                pass
            log.info("fleetmon: shutdown requested (%s)",
                     coordinator.signum)
        except KeyboardInterrupt:
            log.warning("fleetmon: immediate abort requested")
        finally:
            if server is not None:
                server.close()
            agg.close()
    log.info("fleetmon: exited cleanly")
    return 0
