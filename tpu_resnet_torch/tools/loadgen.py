"""Load generator and scenario suite for the port's serving stack (one
replica, or the fleet behind ``python -m tpu_resnet_torch route``) — the
port's own copy of ``tools/loadgen.py``, which imports the reference.

Hammers ``POST /predict`` with concurrent clients and prints one
machine-parseable ``RESULT_JSON:`` line (a single write and flush, so a
killed run leaves a whole line or a truncated one, never a corrupt but
parseable one), with the reference's keys.

Two traffic models:

``--mode closed`` (default)  N clients in a closed loop: each fires its
    next request the moment the previous one returns (capacity).
``--mode open``  N clients paced to a global ``--qps`` arrival rate,
    independent of response times (latency under a fixed offered load).

Scenarios (``--scenario``; the result carries a sweep-shaped ``points``
list):

``steady``        the plain load above (default).
``burst``         open-loop square wave: offered qps alternates between
                  0.25x and 2x ``--qps`` in quarter-duration phases.
``ramp``          offered qps follows a half-sine from 0.2x up through
                  1x and back down over the run.
``diurnal``       a 0.3x->1x rising baseline carrying two full sine
                  cycles (a pure function of the run fraction).
``slow_client``   2 byte-trickling clients (raw sockets, body sent in
                  delayed chunks) beside the normal traffic, tallied
                  apart.
``mixed_lane``    odd clients send ``X-Lane: batch``, even clients stay
                  interactive; per-lane p50/p99 in the result.
``replica_kill``  SIGKILL one replica (pid from ``--fleet-dir``
                  discovery) at half-duration while traffic runs.
``rolling_drain`` drain each replica in turn through the router's admin
                  endpoint (``--router-url`` or the ``--url`` target)
                  while traffic runs.

Client-side failure classes are distinct in the result: ``failed``
(unexpected HTTP status), ``timeouts`` (request exceeded
``--deadline-ms`` / ``--timeout``), ``connect_failures``
(refused/reset). Every request carries a client-minted ``X-Trace-Id``;
the slowest are reported as ``slowest_traces``.

Usage:
    python -m tpu_resnet_torch.tools.loadgen --url http://127.0.0.1:PORT \
        [--clients 8] [--duration 10] [--mode closed|open] [--qps 100] \
        [--scenario steady] [--deadline-ms 0] [--fleet-dir DIR] \
        [--images-per-request 1] [--out result.json]
    python -m tpu_resnet_torch.tools.loadgen --train-dir /tmp/run
        # port from route.json, else serve.json

Exit code 0 = ran with zero failures/timeouts/connect-failures, 1 = any
(``--allow-rejects`` downgrades 429s to a count), 2 = could not reach
the server. Imports numpy and the standard library: no torch, nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from tpu_resnet_torch.obs.server import parse_prometheus
from tpu_resnet_torch.serve.batcher import percentile
from tpu_resnet_torch.serve.discovery import read_port
from tpu_resnet_torch.serve.router import (discover_replicas, read_route_port,
                                           request_drain)

SCENARIOS = ("steady", "burst", "ramp", "diurnal", "slow_client",
             "mixed_lane", "replica_kill", "rolling_drain")


def _print_line(text: str) -> None:
    """One stdout line as a single write + flush: a write under PIPE_BUF
    is atomic on a pipe, so a killed emitter leaves the whole line or a
    truncated one."""
    sys.stdout.write(text + "\n")
    sys.stdout.flush()


def _get_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _scrape_metrics(base: str) -> dict:
    try:
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            return parse_prometheus(r.read().decode())
    except (OSError, ValueError):
        return {}


def qps_factor(scenario: str, frac: float) -> float:
    """Offered-load multiplier at run fraction ``frac`` (0..1). Pure —
    the scenario schedules are unit-tested against this directly."""
    frac = min(max(frac, 0.0), 1.0)
    if scenario == "burst":
        # Quarter-duration square wave: calm, burst, calm, burst.
        return 2.0 if int(frac * 4) % 2 else 0.25
    if scenario == "ramp":
        # Diurnal half-sine: trough -> peak -> trough.
        return 0.2 + 0.8 * math.sin(math.pi * frac)
    if scenario == "diurnal":
        # Sine-on-a-ramp: a rising baseline (the "growing user base")
        # carrying two full day/night cycles: repeated up AND down
        # swings with a drifting mean. Pure function of frac: the
        # schedule is deterministic and resumable.
        ramp = 0.3 + 0.7 * frac
        wave = 1.0 + 0.6 * math.sin(2.0 * math.pi * 2.0 * frac)
        return max(0.05, ramp * wave)
    return 1.0


class ClientStats:
    """Per-client tally merged at the end (no cross-thread locking in the
    request path)."""

    SLOWEST_K = 8

    def __init__(self, lane: str = "interactive", client_id: int = 0):
        self.lane = lane
        self.client_id = client_id
        self.latencies_ms = []
        self.ok = 0
        self.rejected = 0          # 429 backpressure / shed
        self.failed = 0            # unexpected HTTP status
        self.timeouts = 0          # blew the per-request deadline
        self.connect_failures = 0  # refused / reset / unreachable
        self.images = 0
        self.seq = 0
        self.slowest = []          # (latency_ms, trace_id) worst-K heap

    def mint_trace(self) -> str:
        """Client-side trace id, stamped on the request as X-Trace-Id so
        the router/replica span lanes and this client's latency tally
        name the same request. Deterministic per (client, seq) — rerun
        the same seed and the ids line up."""
        self.seq += 1
        return f"lg{self.client_id:x}-{self.seq:x}"

    def note_trace(self, trace_id: str, dt_ms: float) -> None:
        """Track the worst-K requests this client saw (timeouts count —
        they ARE the tail). Merged and reported as
        ``slowest_traces`` in RESULT_JSON: the ids to grep for in
        ``trace-export``'s request lanes."""
        self.slowest.append((dt_ms, trace_id))
        if len(self.slowest) > self.SLOWEST_K:
            self.slowest.sort(reverse=True)
            del self.slowest[self.SLOWEST_K:]


def _fire(url: str, body: bytes, shape: str, timeout: float,
          lane: str = "interactive", trace_id: str = "") -> int:
    """One predict. Returns the HTTP status, -2 for a client-side
    timeout, -1 for a connect failure."""
    headers = {"Content-Type": "application/octet-stream",
               "X-Shape": shape}
    if lane != "interactive":
        headers["X-Lane"] = lane
    if trace_id:
        headers["X-Trace-Id"] = trace_id
    req = urllib.request.Request(url + "/predict", data=body,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            r.read()
            return r.status
    except urllib.error.HTTPError as e:
        e.read()
        return e.code
    except urllib.error.URLError as e:
        reason = getattr(e, "reason", None)
        return -2 if isinstance(reason, TimeoutError) else -1
    except TimeoutError:     # socket.timeout is an alias since 3.10
        return -2
    except OSError:
        return -1


def _note(stats: ClientStats, status: int, n: int, dt_ms: float) -> None:
    if status == 200:
        stats.ok += 1
        stats.images += n
        stats.latencies_ms.append(dt_ms)
    elif status == 429:
        stats.rejected += 1
    elif status == -2:
        stats.timeouts += 1
    elif status == -1:
        stats.connect_failures += 1
    else:
        stats.failed += 1


def _client_loop(url: str, images: np.ndarray, t_start: float,
                 duration: float, stats: ClientStats, interval: float,
                 start_at: float, timeout: float, scenario: str) -> None:
    body = images.tobytes()
    shape = ",".join(str(d) for d in images.shape)
    n = images.shape[0]
    deadline = t_start + duration
    next_at = start_at
    while True:
        now = time.monotonic()
        if now >= deadline:
            return
        if interval > 0:      # open loop: scenario-shaped arrival rate
            if next_at > now:
                time.sleep(min(next_at - now, deadline - now))
                if time.monotonic() >= deadline:
                    return
            factor = max(qps_factor(scenario,
                                    (time.monotonic() - t_start)
                                    / duration), 1e-3)
            next_at += interval / factor
        t0 = time.monotonic()
        trace_id = stats.mint_trace()
        status = _fire(url, body, shape, timeout, lane=stats.lane,
                       trace_id=trace_id)
        dt_ms = (time.monotonic() - t0) * 1e3
        _note(stats, status, n, dt_ms)
        stats.note_trace(trace_id, dt_ms)


def _slow_client_loop(host: str, port: int, body: bytes, shape: str,
                      deadline: float, stats: ClientStats,
                      chunk_delay: float = 0.25) -> None:
    """A byte-trickling client: sends the request body in delayed chunks
    over a raw socket, holding a server handler thread open the whole
    time — the classic slowloris-shaped tenant a fleet must tolerate."""
    step = max(1, len(body) // 8)
    while time.monotonic() < deadline:
        t0 = time.monotonic()
        trace_id = stats.mint_trace()
        head = (f"POST /predict HTTP/1.1\r\nHost: {host}\r\n"
                f"Content-Type: application/octet-stream\r\n"
                f"X-Shape: {shape}\r\nX-Trace-Id: {trace_id}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n").encode()
        try:
            with socket.create_connection((host, port), timeout=10) as s:
                s.sendall(head)
                for i in range(0, len(body), step):
                    if time.monotonic() >= deadline:
                        return
                    s.sendall(body[i:i + step])
                    time.sleep(chunk_delay)
                s.settimeout(30)
                resp = b""
                while b"\r\n" not in resp:
                    chunk = s.recv(65536)
                    if not chunk:
                        break
                    resp += chunk
                status_line = resp.split(b"\r\n", 1)[0].split()
                status = int(status_line[1]) if len(status_line) > 1 else 0
                dt_ms = (time.monotonic() - t0) * 1e3
                _note(stats, status if status else -1, 1, dt_ms)
                stats.note_trace(trace_id, dt_ms)
        except TimeoutError:
            stats.timeouts += 1
        except (OSError, ValueError, IndexError):
            stats.connect_failures += 1


# ------------------------------------------------------------ fleet chaos
def _fleet_records(fleet_dir: str):
    return discover_replicas(fleet_dir) if fleet_dir else []


def _kill_one_replica(fleet_dir: str):
    """SIGKILL the first live replica found in the fleet discovery —
    the hard mid-traffic death the failover drill rides."""
    for rec in _fleet_records(fleet_dir):
        pid = rec.get("pid")
        if not pid:
            continue
        try:
            os.kill(int(pid), 0)
        except (OSError, ValueError):
            continue
        os.kill(int(pid), signal.SIGKILL)
        return {"replica": rec["name"], "pid": pid}
    return None


def _chaos_thread(scenario: str, fleet_dir: str, router_url: str,
                  t_start: float, duration: float, drain_interval: float,
                  record: dict) -> None:
    if scenario == "replica_kill":
        time.sleep(max(0.0, t_start + duration / 2 - time.monotonic()))
        record["killed"] = _kill_one_replica(fleet_dir)
        record["killed_at_sec"] = round(time.monotonic() - t_start, 2)
    elif scenario == "rolling_drain":
        names = [r["name"] for r in _fleet_records(fleet_dir)]
        record["drains"] = []
        interval = drain_interval or duration / (len(names) + 1)
        for name in names:
            time.sleep(interval)
            if time.monotonic() >= t_start + duration:
                break
            out = request_drain(router_url, name)
            record["drains"].append(
                {"replica": name, "at_sec":
                 round(time.monotonic() - t_start, 2), **out})


def _lane_summary(stats_list) -> dict:
    out = {}
    for lane in sorted({st.lane for st in stats_list}):
        group = [st for st in stats_list if st.lane == lane]
        lat = sorted(x for st in group for x in st.latencies_ms)
        out[lane] = {
            "requests_ok": sum(st.ok for st in group),
            "rejected_429": sum(st.rejected for st in group),
            "failed": sum(st.failed for st in group),
            "timeouts": sum(st.timeouts for st in group),
            "connect_failures": sum(st.connect_failures for st in group),
            "p50_ms": round(percentile(lat, 0.50), 2),
            "p99_ms": round(percentile(lat, 0.99), 2),
        }
    return out


def run_load(url: str, clients: int = 8, duration: float = 10.0,
             mode: str = "closed", qps: float = 100.0,
             images_per_request: int = 1, image_size: int = 0,
             timeout: float = 30.0, seed: int = 0,
             scenario: str = "steady", deadline_ms: float = 0.0,
             fleet_dir: str = "", router_url: str = "",
             drain_interval: float = 0.0, slow_clients: int = 2) -> dict:
    """Drive the server; returns the result dict (see RESULT_JSON)."""
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; have "
                         f"{SCENARIOS}")
    if scenario in ("burst", "ramp", "diurnal"):
        mode = "open"  # a shaped offered load needs open-loop pacing
    if scenario in ("replica_kill", "rolling_drain") and not fleet_dir:
        raise ValueError(f"scenario {scenario} needs --fleet-dir (the "
                         f"replicas' discovery directory)")
    url = url.rstrip("/")
    if scenario == "rolling_drain" and not router_url:
        router_url = url  # drains go through the router we're driving
    info = _get_json(url + "/info")
    # A replica /info carries image_shape directly; the router forwards
    # the shape its probes learned (None until the first healthy probe).
    if info.get("image_shape"):
        h, w, c = info["image_shape"]
    elif image_size:
        h = w = image_size
        c = 3
    else:
        raise ValueError("target /info carries no image_shape yet — "
                         "pass --image-size")
    if image_size and image_size != h:
        raise ValueError(f"--image-size {image_size} != server model "
                         f"input {h}")
    request_timeout = deadline_ms / 1e3 if deadline_ms > 0 else timeout
    metrics_before = _scrape_metrics(url)
    rng = np.random.RandomState(seed)
    interval = clients / qps if mode == "open" else 0.0
    t_start = time.monotonic()
    deadline = t_start + duration
    stats, threads = [], []
    chaos_record: dict = {}
    for i in range(clients):
        lane = ("batch" if scenario == "mixed_lane" and i % 2
                else "interactive")
        st = ClientStats(lane=lane, client_id=i)
        stats.append(st)
        images = rng.randint(0, 255, (images_per_request, h, w, c)
                             ).astype(np.uint8)
        # Open loop: stagger client phases so the aggregate arrival
        # process is uniform at ``qps``, not ``clients`` synchronized
        # bursts.
        start_at = t_start + (interval * i / clients if interval else 0.0)
        threads.append(threading.Thread(
            target=_client_loop,
            args=(url, images, t_start, duration, st, interval, start_at,
                  request_timeout, scenario), daemon=True))
    slow_stats = []
    if scenario == "slow_client":
        host = url.split("://", 1)[-1].rsplit(":", 1)[0]
        port = int(url.rsplit(":", 1)[-1])
        body = rng.randint(0, 255, (1, h, w, c)).astype(np.uint8).tobytes()
        for j in range(max(1, slow_clients)):
            st = ClientStats(lane="slow", client_id=clients + j)
            slow_stats.append(st)
            threads.append(threading.Thread(
                target=_slow_client_loop,
                args=(host, port, body, f"1,{h},{w},{c}", deadline, st),
                daemon=True))
    if scenario in ("replica_kill", "rolling_drain"):
        threads.append(threading.Thread(
            target=_chaos_thread,
            args=(scenario, fleet_dir, router_url, t_start, duration,
                  drain_interval, chaos_record), daemon=True))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration + request_timeout + 30)
    wall = time.monotonic() - t_start

    lat = sorted(x for st in stats for x in st.latencies_ms)
    ok = sum(st.ok for st in stats)
    rejected = sum(st.rejected for st in stats)
    failed = sum(st.failed for st in stats)
    timeouts = sum(st.timeouts for st in stats)
    connect_failures = sum(st.connect_failures for st in stats)
    images = sum(st.images for st in stats)
    metrics = _scrape_metrics(url)
    ns = "tpu_resnet_"
    throughput = round(ok / max(wall, 1e-9), 2)
    hard_failures = failed + timeouts + connect_failures
    result = {
        "scenario": scenario,
        "mode": mode, "clients": clients, "duration_sec": round(wall, 2),
        # Correlation id of the served train_dir (serve /info exposes the
        # run id obs/manifest.py minted) — joins this RESULT_JSON to the
        # trace-export timeline of the same directory.
        "run_id": info.get("run_id"),
        "images_per_request": images_per_request,
        "offered_qps": qps if mode == "open" else None,
        "deadline_ms": deadline_ms or None,
        "requests_ok": ok, "rejected_429": rejected, "failed": failed,
        "timeouts": timeouts, "connect_failures": connect_failures,
        "throughput_rps": throughput,
        "images_per_sec": round(images / max(wall, 1e-9), 2),
        "latency_ms": {
            "p50": round(percentile(lat, 0.50), 2),
            "p95": round(percentile(lat, 0.95), 2),
            "p99": round(percentile(lat, 0.99), 2),
            "mean": round(float(np.mean(lat)), 2) if lat else 0.0,
            "max": round(lat[-1], 2) if lat else 0.0,
        },
        # Sweep-shaped point: the point id cohorts runs of the same
        # scenario across runs.
        "points": [{
            "id": f"scenario={scenario}", "status":
                "ok" if hard_failures == 0 and ok > 0 else "error",
            "backend": "serve", "steps_per_sec": throughput,
        }],
        "backend": "serve",
        # Worst requests by client-observed latency, by the trace ids
        # this client stamped — paste one into trace-export's request
        # lanes to see where that exact request spent its time.
        "slowest_traces": [
            {"trace_id": tid, "latency_ms": round(ms, 2)}
            for ms, tid in sorted(
                (p for st in stats + slow_stats for p in st.slowest),
                reverse=True)[:5]],
        "server": {
            "model_step": info.get("model_step"),
            "observed_mean_batch": round(
                metrics.get(ns + "serve_batch_size_mean", 0.0), 3),
            "pad_fraction": round(
                metrics.get(ns + "serve_pad_fraction", 0.0), 4),
            "reloads": int(metrics.get(ns + "serve_reloads_total", 0)),
            "requests_total": int(
                metrics.get(ns + "serve_requests_total", 0)
                - metrics_before.get(ns + "serve_requests_total", 0)),
        },
    }
    if scenario == "mixed_lane":
        result["lanes"] = _lane_summary(stats)
    if slow_stats:
        result["slow_clients"] = _lane_summary(slow_stats).get("slow", {})
    if chaos_record:
        result["chaos"] = chaos_record
    # Router-side view when the target IS the router (route_* series).
    if ns + "route_requests_total" in metrics:
        result["router"] = {
            "retries": int(metrics.get(ns + "route_retries_total", 0)),
            "hedges": int(metrics.get(ns + "route_hedges_total", 0)),
            "shed": int(metrics.get(ns + "route_shed_total", 0)),
            "replicas_healthy": int(
                metrics.get(ns + "route_replicas_healthy", 0)),
            "p99_ms": round(metrics.get(ns + "route_p99_ms", 0.0), 2),
        }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", default="",
                    help="server/router base url (http://host:port)")
    ap.add_argument("--train-dir", default="",
                    help="discover the port from <train-dir>/route.json "
                         "(router, preferred) or serve.json")
    ap.add_argument("--name", default="",
                    help="drive a NAMED replica instead: discover its "
                         "port from <train-dir>/serve-<name>.json")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--mode", choices=["closed", "open"], default="closed")
    ap.add_argument("--qps", type=float, default=100.0,
                    help="open-loop aggregate arrival rate")
    ap.add_argument("--scenario", choices=list(SCENARIOS),
                    default="steady",
                    help="traffic/chaos scenario (see module docstring)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request client budget; a reply past it "
                         "counts in the distinct 'timeouts' field "
                         "(0 = use --timeout)")
    ap.add_argument("--fleet-dir", default="",
                    help="replica discovery dir (serve-*.json) for the "
                         "chaos scenarios; defaults to --train-dir")
    ap.add_argument("--router-url", default="",
                    help="rolling_drain: router admin base url (default: "
                         "the --url target)")
    ap.add_argument("--drain-interval", type=float, default=0.0,
                    help="rolling_drain: seconds between drains "
                         "(0 = duration/(replicas+1))")
    ap.add_argument("--slow-clients", type=int, default=2,
                    help="slow_client scenario: byte-trickling clients")
    ap.add_argument("--images-per-request", type=int, default=1)
    ap.add_argument("--image-size", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--allow-rejects", action="store_true",
                    help="429s don't fail the run (backpressure/shed "
                         "probes)")
    ap.add_argument("--out", default="",
                    help="also write the result json to this path "
                         "(atomic tmp+rename)")
    args = ap.parse_args(argv)

    url = args.url
    fleet_dir = args.fleet_dir or args.train_dir
    if not url:
        if not args.train_dir:
            ap.error("need --url or --train-dir")
        if args.name:
            port = read_port(args.train_dir, f"serve-{args.name}.json")
        else:
            port = read_route_port(args.train_dir)
            if port is None:
                port = read_port(args.train_dir, "serve.json")
        if port is None:
            print(f"[loadgen] no discovery file under "
                  f"{args.train_dir}"
                  + (f" for replica {args.name!r}" if args.name else ""),
                  file=sys.stderr)
            return 2
        url = f"http://127.0.0.1:{port}"

    kw = dict(clients=args.clients, duration=args.duration,
              mode=args.mode, qps=args.qps, scenario=args.scenario,
              deadline_ms=args.deadline_ms, fleet_dir=fleet_dir,
              router_url=args.router_url,
              drain_interval=args.drain_interval,
              slow_clients=args.slow_clients,
              images_per_request=args.images_per_request,
              image_size=args.image_size, timeout=args.timeout,
              seed=args.seed)
    try:
        result = run_load(url, **kw)
    except (OSError, ValueError) as e:
        print(f"[loadgen] cannot drive {url}: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2

    if args.out:
        tmp = args.out + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(result, f, indent=2)
        os.replace(tmp, args.out)
    _print_line("RESULT_JSON: " + json.dumps(result))
    bad = (result["failed"] + result["timeouts"]
           + result["connect_failures"]
           + (0 if args.allow_rejects else result["rejected_429"]))
    return 0 if bad == 0 and result["requests_ok"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
