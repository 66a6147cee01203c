"""Unified run timeline: every observability file of a train dir merged
into one Chrome-trace/Perfetto JSON (port of ``tpu_resnet/obs/trace.py``,
stdlib only):

    python -m tpu_resnet_torch trace-export --dir /tmp/run1
    # -> /tmp/run1/trace.json; open in https://ui.perfetto.dev or
    #    chrome://tracing (Perfetto parses it locally)

Lanes (Chrome trace "processes"/"threads"), the reference's pids, tids and
caps:

- **trainer** (pid from its spans): the spans of ``events.jsonl`` (run,
  compile, checkpoints, nan_rollback, preempt_stop, profiler_trace, ...),
  and counter threads from ``metrics.jsonl``: the step breakdown
  (data_wait_frac, steps_per_sec, mfu, model_flops_per_sec), the decode
  engine's ring, the staged transfer (``h2d_*``) and device memory
  (``hbm_*``). Logged intervals render as ``train_interval`` slices that
  carry the breakdown in their args.
- **eval sidecar** (``eval/events.jsonl``): eval_pass and restore spans.
- **serve**, **router**, **fleetmon**, **autopilot** (``serve_events.jsonl``,
  ``route_events.jsonl``, ``fleet_events.jsonl``,
  ``autopilot_events.jsonl``), one lane per writer pid for serve and
  route, and the tail-sampled **requests** lanes from their
  ``route_request``/``serve_request`` spans, when a directory holds those
  files (the port writes none of them yet).
- **device trace** (``--device-trace``): the ``torch.profiler`` capture of
  a step window (``tools/profiling.py`` ``StepTracer``,
  ``train.profile_steps``), ``<dir>/profile/<timestamp>/*.json[.gz]``. Its
  device events (kernels, copies, memsets) go one lane per CUDA stream of
  each device; a capture with no device event (a CPU run) keeps its
  operator events, one lane per thread, the CPU being the device. Host
  events (runtime calls, Python functions, annotations) are dropped: the
  host's story is on the trainer lane as spans. The profiler's timebase
  is re-anchored on the wall clock of the trainer's ``profiler_trace``
  span, which wraps the profiler's session: the session's start (its
  ``Trace`` event, else its first event) lands on the span's start, so
  every kept event falls inside the span.

Correlation key: the ``run_id`` every writer stamps (``obs/manifest.py``),
recorded in the trace metadata and appended to each lane's process name;
mismatched run_ids are kept and reported under
``metadata.source_run_ids``.

The output is deterministic (same inputs, same bytes), and for a
directory without a profiler capture it is byte for byte the reference
exporter's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from tpu_resnet_torch.obs.spans import load_jsonl, load_spans

SERVE_EVENTS_FILE = "serve_events.jsonl"
ROUTE_EVENTS_FILE = "route_events.jsonl"
FLEET_EVENTS_FILE = "fleet_events.jsonl"
AUTOPILOT_EVENTS_FILE = "autopilot_events.jsonl"
TRACE_FILE = "trace.json"

# Synthetic lane ids used when a source file predates pid stamping.
_FALLBACK_PID = {"train": 1, "eval": 2, "serve": 3, "route": 4,
                 "fleet": 5, "autopilot": 6}
# Thread ids within a lane (Chrome traces key threads by (pid, tid)).
_TID_SPANS = {"train": 1, "eval": 11, "serve": 21, "route": 31,
              "fleet": 41, "autopilot": 51}
_TID_BREAKDOWN = 2
_TID_ENGINE = 3
# Dedicated transfer lane: h2d_transfer spans (the double-buffered
# staged superbatch copies, data/pipeline.py::DoubleBufferedH2D) render
# on their own thread so the overlap with the train/compile spans above
# is visible at a glance in Perfetto.
_TID_H2D = 4
_H2D_SPAN = "h2d_transfer"
# Device-memory counter thread: the hbm_* gauges obs/memory.py samples
# at log boundaries, rendered as their own lane so HBM pressure lines up
# against the spans (compile, checkpoint, eval) that move it.
_TID_MEMORY = 5
# Merged profiler lanes keep their own pid space well away from the
# host lanes (real host pids are ~1e3-1e6; profiler pids are small ints
# that would collide with the synthetic fallbacks).
_DEVICE_TRACE_PID_BASE = 9000000
_DEVICE_TRACE_EVENT_CAP = 200000
_PROFILER_SPAN = "profiler_trace"
# Per-request distributed-trace lanes: a synthetic process well below
# the device-trace pid space, one thread per tail-sampled trace id.
_REQUEST_PID = 7000000
_REQUEST_LANE_CAP = 100
_REQUEST_SPANS = ("route_request", "serve_request")

# Counter series lifted from metrics.jsonl records onto counter threads:
# (record key, counter thread, counter name).
_COUNTER_KEYS = (
    ("steps_per_sec", _TID_BREAKDOWN, "steps_per_sec"),
    ("data_wait_frac", _TID_BREAKDOWN, "data_wait_frac"),
    ("model_flops_per_sec", _TID_BREAKDOWN, "model_flops_per_sec"),
    ("mfu", _TID_BREAKDOWN, "mfu"),
    ("data_ring_occupancy", _TID_ENGINE, "data_ring_occupancy"),
    ("data_decode_images_per_sec", _TID_ENGINE,
     "data_decode_images_per_sec"),
    ("h2d_bytes_per_sec", _TID_H2D, "h2d_bytes_per_sec"),
    ("h2d_overlap_frac", _TID_H2D, "h2d_overlap_frac"),
    ("hbm_bytes_in_use", _TID_MEMORY, "hbm_bytes_in_use"),
    ("hbm_bytes_peak", _TID_MEMORY, "hbm_bytes_peak"),
    ("hbm_utilization", _TID_MEMORY, "hbm_utilization"),
)

_INTERVAL_ARG_KEYS = (
    "loss", "precision", "learning_rate", "steps_per_sec",
    "images_per_sec", "data_wait_sec", "data_wait_frac", "dispatch_sec",
    "device_sync_sec", "device_step_sec_sampled", "compile_seconds",
    "model_flops_per_sec", "mfu", "train_step_ms_p50", "train_step_ms_p95",
    "train_step_ms_p99", "data_ring_occupancy",
    "data_decode_images_per_sec", "h2d_bytes_per_sec",
    "h2d_overlap_frac", "hbm_bytes_in_use", "hbm_utilization",
)


def _us(wall: float, base: float) -> float:
    """Wall-clock seconds → trace microseconds relative to ``base``,
    rounded so float formatting is stable across platforms."""
    return round((wall - base) * 1e6, 1)


def _span_events(spans: List[dict], source: str, base: float,
                 pid_of: Dict[str, int]) -> List[dict]:
    events = []
    default_pid = pid_of[source]
    for s in spans:
        try:
            start, end = float(s["start"]), float(s["end"])
        except (KeyError, TypeError, ValueError):
            continue
        if end < start:
            continue
        name = str(s.get("span", "span"))
        tid = (_TID_H2D if source == "train" and name == _H2D_SPAN
               else _TID_SPANS[source])
        # Fleet sources (serve replicas sharing one serve_events.jsonl,
        # the router): each writer pid keeps its OWN lane so a rolling
        # drain renders as N replica lanes + a router lane, not one
        # merged smear. Train/eval keep the single-lane behavior (their
        # multi-pid case is supervised restarts of the same logical
        # process, reviewed as one lane on purpose).
        pid = (s["pid"] if source in ("serve", "route")
               and isinstance(s.get("pid"), int) else default_pid)
        args = {k: v for k, v in s.items()
                if k not in ("span", "start", "end", "pid")}
        common = {"name": name, "cat": source,
                  "pid": pid, "tid": tid, "ts": _us(start, base),
                  "args": args}
        if end == start:
            events.append({**common, "ph": "i", "s": "t"})
        else:
            events.append({**common, "ph": "X",
                           "dur": round((end - start) * 1e6, 1)})
    return events


def _metrics_events(records: List[dict], base: float, pid: int
                    ) -> List[dict]:
    """metrics.jsonl → counter samples + per-interval slices on the
    trainer lane."""
    events = []
    prev = None
    for rec in sorted(records, key=lambda r: r.get("wall", 0.0)):
        wall = rec.get("wall")
        if wall is None:
            continue
        ts = _us(wall, base)
        for key, tid, name in _COUNTER_KEYS:
            if key in rec:
                events.append({"name": name, "ph": "C", "pid": pid,
                               "tid": tid, "ts": ts,
                               "args": {"value": rec[key]}})
        if prev is not None and "data_wait_sec" in rec:
            args = {k: rec[k] for k in _INTERVAL_ARG_KEYS if k in rec}
            args["step"] = rec.get("step")
            events.append({
                "name": f"train_interval@{rec.get('step')}",
                "cat": "train", "ph": "X", "pid": pid,
                "tid": _TID_BREAKDOWN, "ts": _us(prev, base),
                "dur": round((wall - prev) * 1e6, 1), "args": args})
        prev = wall
    return events


def _serve_segments(s: dict, start: float, end: float, tid: int,
                    base: float) -> List[dict]:
    """Break one ``serve_request`` span into nested timing segments from
    the batcher-stamped attrs: ``queue_wait`` (enqueue → batch formed),
    ``infer`` (batch dispatch → logits), and ``stall`` — the unaccounted
    remainder (hot-reload stalls, HTTP/parse overhead). Segments are
    clamped inside the parent span so containment nesting holds."""
    segs: List[dict] = []
    cursor = start

    def push(name: str, dur_ms) -> None:
        nonlocal cursor
        if not isinstance(dur_ms, (int, float)) or dur_ms <= 0:
            return
        seg_end = min(end, cursor + float(dur_ms) / 1e3)
        if seg_end <= cursor:
            return
        segs.append({"name": name, "cat": "request", "ph": "X",
                     "pid": _REQUEST_PID, "tid": tid,
                     "ts": _us(cursor, base),
                     "dur": round((seg_end - cursor) * 1e6, 1),
                     "args": {}})
        cursor = seg_end

    push("queue_wait", s.get("queue_wait_ms"))
    push("infer", s.get("infer_ms"))
    push("stall", (end - cursor) * 1e3)
    return segs


def _request_lane_events(sources: Dict[str, List[dict]], base: float
                         ) -> Tuple[List[dict], Optional[dict]]:
    """Per-request lanes from the tail-sampled route_request /
    serve_request spans: group by trace id, render the slowest
    :data:`_REQUEST_LANE_CAP` traces one thread each (router span with
    the replica span nested inside by containment), report any drop in
    the returned info dict (never a silent cap)."""
    traced: Dict[str, List[dict]] = {}
    for src in ("route", "serve"):
        for s in sources.get(src, []):
            if s.get("span") not in _REQUEST_SPANS or not s.get("trace_id"):
                continue
            try:
                float(s["start"]), float(s["end"])
            except (KeyError, TypeError, ValueError):
                continue
            traced.setdefault(str(s["trace_id"]), []).append(s)
    if not traced:
        return [], None

    def cost(key: str) -> float:
        return max(float(s.get("duration_sec") or 0.0)
                   for s in traced[key])

    order = sorted(traced, key=lambda k: (-cost(k), k))
    keep = order[:_REQUEST_LANE_CAP]
    events = [_meta("process_name", _REQUEST_PID,
                    label="requests (tail-sampled)")]
    for tid, key in enumerate(keep, start=1):
        events.append(_meta("thread_name", _REQUEST_PID, tid,
                            f"req {key}"))
        for s in sorted(traced[key],
                        key=lambda s: (float(s["start"]),
                                       str(s.get("span")))):
            start, end = float(s["start"]), float(s["end"])
            if end < start:
                continue
            args = {k: v for k, v in s.items()
                    if k not in ("span", "start", "end", "pid")}
            events.append({"name": str(s["span"]), "cat": "request",
                           "ph": "X", "pid": _REQUEST_PID, "tid": tid,
                           "ts": _us(start, base),
                           "dur": round((end - start) * 1e6, 1),
                           "args": args})
            if s.get("span") == "serve_request":
                events.extend(_serve_segments(s, start, end, tid, base))
    info = {"traces": len(traced), "rendered": len(keep),
            "dropped": len(traced) - len(keep)}
    return events, info


def _meta(name: str, pid: int, tid: Optional[int] = None,
          label: str = "") -> dict:
    ev = {"name": name, "ph": "M", "pid": pid, "ts": 0.0,
          "args": {"name": label}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def _source_pid(spans: List[dict], source: str) -> int:
    for s in spans:
        pid = s.get("pid")
        if isinstance(pid, int):
            return pid
    return _FALLBACK_PID[source]


def _run_ids(spans: List[dict]) -> List[str]:
    return sorted({str(s["run_id"]) for s in spans if s.get("run_id")})


def find_device_trace_files(train_dir: str) -> List[str]:
    """Chrome-trace exports of the NEWEST ``torch.profiler`` capture under
    ``<train_dir>/profile`` (``tools/profiling.py`` ``StepTracer`` layout:
    ``profile/<timestamp>/<name>.json[.gz]``). Capture dirs are named by
    timestamp, so lexical order is capture order; files within a capture
    sort by name."""
    root = os.path.join(train_dir, "profile")
    try:
        captures = sorted(d for d in os.listdir(root)
                          if os.path.isdir(os.path.join(root, d)))
    except OSError:
        return []
    for cap in reversed(captures):
        files = sorted(
            os.path.join(root, cap, f)
            for f in os.listdir(os.path.join(root, cap))
            if f.endswith(".json") or f.endswith(".json.gz"))
        if files:
            return files
    return []


def _load_profiler_json(path: str) -> dict:
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


# torch.profiler's categories of work that ran on a CUDA device.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Its operators: a capture of a CPU run has no device event, and keeps
# these, the CPU being the device.
_CPU_OP_CAT = "cpu_op"
# Its Python-function events (the reference drops jax's ``$``-prefixed
# ones the same way).
_PYTHON_CAT = "python_function"
# Its session-wide event: starts when the profiler starts.
_SESSION_CAT = "Trace"


def _device_trace_events(train_dir: str, train_spans: List[dict],
                         base: float) -> Tuple[List[dict], dict]:
    """Merge the newest profiler capture as lanes: one a (device, stream)
    for device events, or one a (process, thread) for a CPU capture's
    operators. Returns ``(events, info)`` where ``info`` lands in trace
    metadata.

    Timebase: each file's ``ts`` are microseconds on the profiler's own
    clock. The trainer's ``profiler_trace`` span wraps the session
    (``StepTracer`` opens it before the profiler starts and closes it
    after the profiler stopped), so an event lands at the span's start
    plus its time since the session's start, inside the span. Without
    the span (a capture taken out of band) the newest file's mtime
    end-anchors the capture, stable for fixed inputs, so exports stay
    deterministic either way."""
    files = find_device_trace_files(train_dir)
    if not files:
        raise FileNotFoundError(
            f"--device-trace: no profiler capture under "
            f"{os.path.join(train_dir, 'profile')}: capture one with "
            f"train.profile_steps='A:B' (tools/profiling.py)")
    anchor = None
    for s in train_spans:  # newest capture <-> newest profiler span
        if s.get("span") == _PROFILER_SPAN and s.get("start") is not None:
            anchor = float(s["start"])
    device: List[Tuple[int, dict, float]] = []
    cpu_ops: List[Tuple[int, dict, float]] = []
    dropped = python_tracer = host = 0
    max_rel = 0.0
    for i, path in enumerate(files):
        try:
            payload = _load_profiler_json(path)
        except (OSError, ValueError) as e:
            raise ValueError(f"--device-trace: unreadable profiler "
                             f"export {path}: {e}")
        session, timed = None, []
        for ev in payload.get("traceEvents", []):
            if not isinstance(ev, dict):
                dropped += 1
                continue
            ts, cat = ev.get("ts"), ev.get("cat")
            if ev.get("ph") != "X" or not isinstance(ts, (int, float)):
                dropped += 1  # metadata, flows, instants: lanes named here
                continue
            if cat == _SESSION_CAT:
                session = (float(ts) if session is None
                           else min(session, float(ts)))
            elif cat in _DEVICE_CATS or cat == _CPU_OP_CAT:
                timed.append(ev)
            elif cat == _PYTHON_CAT:
                python_tracer += 1
            else:
                host += 1
        if session is None:
            session = min((float(ev["ts"]) for ev in timed), default=0.0)
        for ev in timed:
            rel = float(ev["ts"]) - session
            try:
                dur = max(0.0, float(ev.get("dur", 0.0)))
            except (TypeError, ValueError):
                dur = 0.0
            max_rel = max(max_rel, rel + dur)
            (device if ev.get("cat") in _DEVICE_CATS
             else cpu_ops).append((i, ev, rel))
    kept = device or cpu_ops
    if device:
        host += len(cpu_ops)
    if anchor is None:
        # End-anchor on the newest file's mtime: the export follows the
        # stop, so the session started about its length before.
        anchor = max(os.path.getmtime(p) for p in files) - max_rel / 1e6
    offset = _us(anchor, base)

    def lane(i: int, ev: dict) -> Tuple[int, int, int]:
        """(file, profiler pid, stream or thread id): the profiler numbers
        devices, streams and threads with ints."""
        try:
            return i, int(ev.get("pid")), int(ev.get("tid"))
        except (TypeError, ValueError):
            raise ValueError(f"--device-trace: {files[i]}: event "
                             f"{ev.get('name')!r} has no numeric pid/tid")

    lanes = sorted({lane(i, ev) for i, ev, _ in kept})
    pid_of: Dict[Tuple[int, int], int] = {}
    out: List[dict] = []
    for i, pid, tid in lanes:
        if (i, pid) not in pid_of:
            pid_of[(i, pid)] = _DEVICE_TRACE_PID_BASE + len(pid_of)
            label = (f"device-trace: cuda:{pid}" if device
                     else f"device-trace: cpu (pid {pid})")
            out.append(_meta("process_name", pid_of[(i, pid)],
                             label=label))
        out.append(_meta("thread_name", pid_of[(i, pid)], tid,
                         f"stream {tid}" if device else f"thread {tid}"))
    slices = []
    for i, ev, rel in kept:
        _, pid, tid = lane(i, ev)
        mapped = {"name": str(ev.get("name", "")), "ph": "X",
                  "cat": "device", "pid": pid_of[(i, pid)], "tid": tid,
                  "ts": max(0.0, round(offset + rel, 1))}
        try:
            mapped["dur"] = round(max(0.0, float(ev.get("dur", 0.0))), 1)
        except (TypeError, ValueError):
            mapped["dur"] = 0.0
        if ev.get("args"):
            mapped["args"] = ev["args"]
        slices.append(mapped)
    if len(slices) > _DEVICE_TRACE_EVENT_CAP:
        # Never a silent cap: keep the earliest slices (the window start
        # is where dispatch<->device attribution is read) and report the
        # drop in metadata.
        slices.sort(key=lambda e: e["ts"])
        dropped += len(slices) - _DEVICE_TRACE_EVENT_CAP
        slices = slices[:_DEVICE_TRACE_EVENT_CAP]
    out.extend(slices)
    info = {"files": [os.path.relpath(p, train_dir) for p in files],
            "anchor_unix": round(anchor, 6),
            "anchored_by": ("profiler_trace_span" if any(
                s.get("span") == _PROFILER_SPAN for s in train_spans)
                else "file_mtime"),
            "device": "cuda" if device else "cpu",
            "lanes": len(lanes),
            "events": len(slices),
            "python_tracer_events_dropped": python_tracer,
            "host_events_dropped": host,
            "events_dropped": dropped}
    return out, info


def build_trace(train_dir: str, device_trace: bool = False) -> dict:
    """Assemble the merged Chrome-trace dict (pure read; no writes)."""
    sources: Dict[str, List[dict]] = {
        "train": load_spans(os.path.join(train_dir, "events.jsonl")),
        "eval": load_spans(os.path.join(train_dir, "eval",
                                        "events.jsonl")),
        "serve": load_spans(os.path.join(train_dir, SERVE_EVENTS_FILE)),
        "route": load_spans(os.path.join(train_dir, ROUTE_EVENTS_FILE)),
        "fleet": load_spans(os.path.join(train_dir, FLEET_EVENTS_FILE)),
        "autopilot": load_spans(os.path.join(train_dir,
                                             AUTOPILOT_EVENTS_FILE)),
    }
    metrics = load_jsonl(os.path.join(train_dir, "metrics.jsonl"), "step")

    manifest_run_id = None
    try:
        with open(os.path.join(train_dir, "manifest.json")) as f:
            manifest_run_id = json.load(f).get("run_id")
    except (OSError, ValueError):
        pass
    if manifest_run_id is None:
        try:
            with open(os.path.join(train_dir, "run_id.json")) as f:
                manifest_run_id = json.load(f).get("run_id")
        except (OSError, ValueError):
            pass

    walls = [float(s[k]) for spans in sources.values() for s in spans
             for k in ("start", "end") if isinstance(s.get(k), (int, float))]
    walls += [float(r["wall"]) for r in metrics
              if isinstance(r.get("wall"), (int, float))]
    if not walls:
        raise FileNotFoundError(
            f"no observability artifacts under {train_dir} — need "
            "events.jsonl and/or metrics.jsonl (train with "
            "train.telemetry-enabled defaults)")
    base = min(walls)

    pid_of = {src: _source_pid(spans, src)
              for src, spans in sources.items()}
    # Distinct sources that fell back to the same synthetic pid must not
    # merge lanes; the real-pid collision (in-process eval sidecar) is a
    # true shared process and keeps one lane on purpose.
    events: List[dict] = []
    source_run_ids = {src: _run_ids(spans)
                      for src, spans in sources.items() if spans}
    run_id = manifest_run_id or next(
        (ids[0] for ids in source_run_ids.values() if ids), None)

    labels = {"train": "trainer", "eval": "eval-sidecar",
              "serve": "serve", "route": "router", "fleet": "fleetmon",
              "autopilot": "autopilot"}
    for src, spans in sources.items():
        if not spans and not (src == "train" and metrics):
            continue
        pid = pid_of[src]
        rid = (source_run_ids.get(src) or [run_id or ""])[0]
        suffix = f" run={rid}" if rid else ""
        if src in ("serve", "route"):
            # One lane per writer pid (replica): labels carry the pid
            # when more than one replica appended to the shared file.
            pids = sorted({s["pid"] for s in spans
                           if isinstance(s.get("pid"), int)}) or [pid]
            for p in pids:
                label = (labels[src] if len(pids) == 1
                         else f"{labels[src]}[{p}]")
                events.append(_meta("process_name", p,
                                    label=f"{label}{suffix}"))
                events.append(_meta("thread_name", p, _TID_SPANS[src],
                                    f"{labels[src]}-spans"))
        else:
            events.append(_meta("process_name", pid,
                                label=f"{labels[src]}{suffix}"))
            events.append(_meta("thread_name", pid, _TID_SPANS[src],
                                f"{labels[src]}-spans"))
        if src == "train" and any(s.get("span") == _H2D_SPAN
                                  for s in spans):
            events.append(_meta("thread_name", pid, _TID_H2D,
                                "h2d-transfer"))
        events.extend(_span_events(spans, src, base, pid_of))
    if metrics:
        pid = pid_of["train"]
        events.append(_meta("thread_name", pid, _TID_BREAKDOWN,
                            "step-breakdown"))
        if any("data_ring_occupancy" in r for r in metrics):
            events.append(_meta("thread_name", pid, _TID_ENGINE,
                                "data-engine"))
        if any("hbm_bytes_in_use" in r for r in metrics):
            events.append(_meta("thread_name", pid, _TID_MEMORY,
                                "device-memory"))
        events.extend(_metrics_events(metrics, base, pid))

    req_events, request_info = _request_lane_events(sources, base)
    events.extend(req_events)

    device_trace_info = None
    if device_trace:
        dev_events, device_trace_info = _device_trace_events(
            train_dir, sources["train"], base)
        events.extend(dev_events)

    events.sort(key=lambda e: (e["ts"], e["pid"], e.get("tid", 0),
                               e["ph"], e["name"]))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "tool": "tpu_resnet trace-export",
            "train_dir": os.path.abspath(train_dir),
            "run_id": run_id,
            "source_run_ids": source_run_ids,
            "base_time_unix": base,
            **({"request_lanes": request_info} if request_info else {}),
            **({"device_trace": device_trace_info}
               if device_trace_info else {}),
        },
    }


def validate_trace(trace: dict) -> List[str]:
    """Chrome-trace schema check shared by the tests and
    ``doctor --trace-probe``. Returns a list of problems (empty = valid):
    required top-level keys, per-event required fields, known phases,
    non-negative monotonically ordered ``ts``, non-negative ``dur``."""
    problems: List[str] = []
    if not isinstance(trace, dict):
        return ["trace is not a JSON object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    if not events:
        problems.append("traceEvents is empty")
    known_ph = {"X", "i", "C", "M", "B", "E"}
    last_ts = None
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        for key in ("name", "ph", "pid", "ts"):
            if key not in ev:
                problems.append(f"{where}: missing required key {key!r}")
        ph = ev.get("ph")
        if ph not in known_ph:
            problems.append(f"{where}: unknown phase {ph!r}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: ts must be a non-negative number, "
                            f"got {ts!r}")
        elif last_ts is not None and ts < last_ts:
            problems.append(f"{where}: ts {ts} < previous {last_ts} — "
                            "events must be sorted")
        else:
            last_ts = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X event needs dur >= 0, "
                                f"got {dur!r}")
        if len(problems) > 50:
            problems.append("... (truncated)")
            break
    return problems


def export_trace(train_dir: str, out: Optional[str] = None,
                 device_trace: bool = False) -> Tuple[str, dict]:
    """Build + write the merged trace. Deterministic output (atomic
    tmp+rename, sorted keys) so a re-export over unchanged inputs is
    byte-identical. Returns ``(path, trace)``."""
    trace = build_trace(train_dir, device_trace=device_trace)
    problems = validate_trace(trace)
    if problems:  # exporting an invalid trace would hide the bug
        raise ValueError("trace-export produced an invalid trace: "
                         + "; ".join(problems[:5]))
    out = out or os.path.join(train_dir, TRACE_FILE)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(trace, f, indent=None, sort_keys=True,
                  separators=(",", ":"))
        f.write("\n")
    os.replace(tmp, out)
    return out, trace


def main(argv=None) -> int:
    """CLI: ``python -m tpu_resnet_torch trace-export --dir D [--out F]
    [--device-trace]``."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="trace-export",
        description="merge a run's events/metrics/eval/serve artifacts "
                    "into one Chrome-trace JSON (open in ui.perfetto.dev)")
    ap.add_argument("--dir", required=True, help="train dir of the run")
    ap.add_argument("--out", default="",
                    help="output path (default <dir>/trace.json)")
    ap.add_argument("--device-trace", action="store_true",
                    help="also merge the newest torch.profiler capture "
                         "(<dir>/profile, train.profile_steps) as "
                         "per-stream device lanes re-anchored on the "
                         "trainer's profiler_trace span")
    args = ap.parse_args(argv)
    try:
        path, trace = export_trace(args.dir, out=args.out or None,
                                   device_trace=args.device_trace)
    except (OSError, ValueError) as e:
        print(f"trace-export failed: {e}")
        return 1
    n = len(trace["traceEvents"])
    meta = trace["metadata"]
    print(f"wrote {path} ({n} events, run_id={meta['run_id']})")
    if meta.get("device_trace"):
        dt = meta["device_trace"]
        print(f"device-trace: {dt['events']} events from "
              f"{len(dt['files'])} file(s), anchored by "
              f"{dt['anchored_by']}")
    return 0
