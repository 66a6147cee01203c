"""One-shot telemetry scrape — pretty-print a host's /metrics + /healthz
(port of ``tpu_resnet/tools/obs_scrape.py``):

    python -m tpu_resnet_torch.tools.obs_scrape --dir /tmp/run1
    python -m tpu_resnet_torch.tools.obs_scrape --url 10.0.0.7:9200
    python -m tpu_resnet_torch.tools.obs_scrape --dir /tmp/run1 --json
    python -m tpu_resnet_torch.tools.obs_scrape --fleet /tmp/run1

``--dir`` reads the port the trainer recorded in
``<train_dir>/telemetry.json``; ``--url`` scrapes a host directly.
``--fleet DIR`` scrapes EVERY endpoint announced in DIR (serve replicas,
the router, trainer telemetry — the discovery ``fleetmon`` runs) and
prints one table: a row per endpoint plus a fleet rollup whose
percentiles come from the bucket-wise histogram merge, and fleetmon's
snapshot when its digest holds. Imports no torch and nothing of JAX.

Exit codes: 0 healthy, 1 unreachable, 2 no telemetry.json (or no
discovery files with --fleet), 3 reachable but stale (/healthz ok=false,
or any fleet endpoint down/stale).
"""

from __future__ import annotations

import argparse
import json
import sys

from tpu_resnet_torch.obs.server import (histogram_quantile,
                                         read_telemetry_port, scrape)


def _strict_jsonable(x):
    """Replace non-finite floats (the +Inf histogram bucket edge) with
    their Prometheus spellings — json.dumps would otherwise emit bare
    ``Infinity``, which strict parsers (jq, JSON.parse) reject."""
    import math

    if isinstance(x, float) and not math.isfinite(x):
        return "+Inf" if x > 0 else ("-Inf" if x < 0 else "NaN")
    if isinstance(x, dict):
        return {k: _strict_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_strict_jsonable(v) for v in x]
    return x


def format_report(report: dict, as_json: bool = False) -> str:
    if as_json:
        return json.dumps(_strict_jsonable(report), indent=1,
                          sort_keys=True)
    health = report["health"]
    lines = [
        "health: {} (HTTP {})  step={}  heartbeat_age={}s".format(
            "ok" if health.get("ok") else "STALE",
            report["health_status"], health.get("step"),
            health.get("heartbeat_age_sec")),
    ]
    hists = report.get("histograms") or {}
    hist_components = {f"{n}{suffix}" for n in hists
                       for suffix in ("_bucket", "_sum", "_count")}
    for name, value in sorted(report["metrics"].items()):
        if name in hist_components:
            continue  # summarized below with real percentiles
        lines.append(f"  {name:<42s} {value:g}")
    for name, h in sorted(hists.items()):
        qs = {q: histogram_quantile(h, q) for q in (0.50, 0.95, 0.99)}
        lines.append(
            f"  {name:<42s} n={h.get('count', 0)} "
            f"p50={qs[0.50]:g} p95={qs[0.95]:g} p99={qs[0.99]:g}")
    return "\n".join(lines)


def scrape_fleet(directory: str, timeout: float = 5.0) -> dict:
    """Scrape every endpoint announced under ``directory`` and attach
    the bucket-wise fleet rollup. Unreachable endpoints become
    ``{"error": ...}`` rows, not exceptions — a half-up fleet is
    exactly when you run this."""
    from tpu_resnet_torch.obs.fleet import (SERVE_LATENCY_SERIES,
                                            discover_endpoints,
                                            read_fleet_snapshot)
    from tpu_resnet_torch.obs.server import merge_histograms

    endpoints = discover_endpoints(directory)
    rows = []
    for ep in endpoints:
        row = dict(ep)
        try:
            row["report"] = scrape(ep["url"], timeout=timeout)
        except (OSError, ValueError) as e:
            row["error"] = f"{type(e).__name__}: {e}"[:160]
        rows.append(row)
    serve_hists = [r["report"]["histograms"].get(SERVE_LATENCY_SERIES)
                   for r in rows
                   if r["kind"] == "serve" and "report" in r]
    try:
        merged = merge_histograms(serve_hists)
    except ValueError as e:
        merged = {"buckets": [], "sum": 0.0, "count": 0,
                  "merge_error": str(e)}
    # fleetmon's latest merged round (digest-verified), or None when
    # fleetmon isn't running (or the file failed its digest) — the live
    # scrape above stands alone.
    snapshot = read_fleet_snapshot(directory)
    return {"directory": directory, "endpoints": rows, "fleet": merged,
            "snapshot": snapshot}


def format_fleet_report(report: dict, as_json: bool = False) -> str:
    from tpu_resnet_torch.obs.fleet import SERVE_LATENCY_SERIES

    if as_json:
        return json.dumps(_strict_jsonable(report), indent=1,
                          sort_keys=True)
    lines = [f"fleet @ {report['directory']} — "
             f"{len(report['endpoints'])} endpoint(s)"]
    fmt = "  {:<7s} {:<18s} {:>6s} {:>8s} {:>9s} {:>9s} {:>9s}  {}"
    lines.append(fmt.format("kind", "name", "port", "n", "p50_ms",
                            "p95_ms", "p99_ms", "health"))
    for row in report["endpoints"]:
        if "error" in row:
            lines.append(fmt.format(
                row["kind"], row["name"], str(row["port"]), "-", "-",
                "-", "-", f"DOWN ({row['error']})"))
            continue
        rep = row["report"]
        h = (rep.get("histograms") or {}).get(SERVE_LATENCY_SERIES) or {}
        qs = {q: histogram_quantile(h, q) for q in (0.50, 0.95, 0.99)}
        health = rep.get("health", {})
        lines.append(fmt.format(
            row["kind"], row["name"], str(row["port"]),
            str(h.get("count", 0)), f"{qs[0.50]:g}", f"{qs[0.95]:g}",
            f"{qs[0.99]:g}",
            "ok" if health.get("ok") else "STALE"))
    merged = report["fleet"]
    if merged.get("merge_error"):
        lines.append(f"  fleet rollup UNAVAILABLE: "
                     f"{merged['merge_error']}")
    else:
        qs = {q: histogram_quantile(merged, q)
              for q in (0.50, 0.95, 0.99)}
        lines.append(fmt.format(
            "fleet", "(histogram merge)", "-",
            str(merged.get("count", 0)), f"{qs[0.50]:g}",
            f"{qs[0.95]:g}", f"{qs[0.99]:g}", ""))
    snap = report.get("snapshot")
    if snap:
        lines.append(
            f"  fleetmon snapshot: round {snap.get('round')} "
            f"p99={snap.get('fleet', {}).get('p99_ms', 0):g}ms "
            f"burn fast/slow="
            f"{snap.get('burn_rate_fast', 0):g}/"
            f"{snap.get('burn_rate_slow', 0):g} "
            f"(digest ok)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="obs_scrape",
        description="one-shot scrape of a tpu_resnet_torch telemetry "
                    "server")
    ap.add_argument("--dir", default="",
                    help="train dir: port read from its telemetry.json")
    ap.add_argument("--url", default="",
                    help="host[:port] or full http URL to scrape directly")
    ap.add_argument("--fleet", default="",
                    help="discovery dir: scrape EVERY announced endpoint "
                         "(serve*.json / route.json / telemetry*.json) "
                         "and print a merged fleet table")
    ap.add_argument("--host", default="127.0.0.1",
                    help="host to combine with the --dir port")
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--json", action="store_true",
                    help="emit the raw report as JSON")
    args = ap.parse_args(argv)
    if sum(map(bool, (args.dir, args.url, args.fleet))) != 1:
        ap.error("exactly one of --dir / --url / --fleet is required")

    if args.fleet:
        report = scrape_fleet(args.fleet, timeout=args.timeout)
        if not report["endpoints"]:
            print(f"no discovery files (serve*.json / route.json / "
                  f"telemetry*.json) under {args.fleet}",
                  file=sys.stderr)
            return 2
        print(format_fleet_report(report, as_json=args.json))
        reachable = [r for r in report["endpoints"] if "report" in r]
        if not reachable:
            return 1
        all_ok = all(r["report"].get("health", {}).get("ok")
                     for r in reachable) and \
            len(reachable) == len(report["endpoints"])
        return 0 if all_ok else 3

    if args.dir:
        port = read_telemetry_port(args.dir)
        if port is None:
            print(f"no telemetry.json under {args.dir} — is the trainer "
                  "running with train.telemetry_port >= 0?",
                  file=sys.stderr)
            return 2
        url = f"http://{args.host}:{port}"
    else:
        url = args.url
    try:
        report = scrape(url, timeout=args.timeout)
    except (OSError, ValueError) as e:
        print(f"scrape {url} failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    print(format_report(report, as_json=args.json))
    return 0 if report["health"].get("ok") else 3


if __name__ == "__main__":
    sys.exit(main())
