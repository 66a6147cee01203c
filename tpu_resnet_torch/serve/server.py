"""Online inference HTTP server — ``python -m tpu_resnet_torch serve``.

Port of ``tpu_resnet/serve/server.py``: a stdlib ``ThreadingHTTPServer``
over the dynamic micro-batcher (``batcher.py``) and a weight backend
(``backend.py``: a train dir's checkpoints, float32 or int8, or a frozen
export), with the same wire protocol and run contracts:

- ``POST /predict``: ``application/octet-stream`` raw uint8 pixels with an
  ``X-Shape: N,H,W,C`` header (N may be omitted), or ``application/json``
  ``{"instances": [...]}`` holding one ``[H,W,C]`` image or ``[N,H,W,C]``.
  Response ``{"predictions", "model_step", "count"}`` (plus ``"logits"``
  with ``?logits=1``). A request with ``X-Trace-Id`` gets it echoed, and a
  tail-sampled ``serve_request`` span (``obs.spans.TailSampler``);
- ``GET /metrics``: the reference's ``SERVE_GAUGES`` and
  ``SERVE_HISTOGRAMS`` (Prometheus text); ``GET /healthz``: 503 until
  every bucket is warm, while draining, and when the batcher's heartbeat
  is older than ``serve.healthz_stale_sec``, else 200; ``GET /info``:
  backend, arm (``quantize``, calibration digest, weight bytes), buckets,
  model step, stats;
- backpressure: a full queue is HTTP 429, a draining server 503;
- ``serve_events.jsonl`` in the train dir: ``colocation_admission``,
  ``serve_warmup`` with a ``serve_warmup_bucket`` span a bucket,
  ``serve_ready``, ``serve_reload``, ``serve_drain``, ``oom``, stamped
  with the run id;
- the serve faults (``resilience/faultinject.py``), free when none is
  planned;
- colocation admission at :func:`serve` start with
  ``serve.admission_hbm_bytes`` > 0: exit 3 (``NO_CAPACITY``) when the
  card has no room;
- ``serve.json`` (``serve-<name>.json`` with ``serve.replica_name``)
  announces the bound port in the train dir;
- SIGTERM drains: stop accepting, flush the queue, exit 0.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from tpu_resnet_torch.obs import memory as memory_obs
from tpu_resnet_torch.obs.manifest import read_run_id
from tpu_resnet_torch.obs.server import (SERVE_GAUGES, SERVE_HISTOGRAMS,
                                         TelemetryRegistry)
from tpu_resnet_torch.obs.spans import SpanTracer, TailSampler
from tpu_resnet_torch.resilience.faultinject import FaultInjector, FaultPlan
from tpu_resnet_torch.serve.batcher import (LANES, Draining, MicroBatcher,
                                            QueueFull, default_buckets)
from tpu_resnet_torch.serve.discovery import send_json, write_record

log = logging.getLogger("tpu_resnet_torch")

# Upper bound a handler thread waits for its batched result; queued work
# survives a drain, so this only fires if the batcher thread died.
REQUEST_WAIT_SEC = 120.0
SERVE_DISCOVERY = "serve.json"


def parse_predict_body(body: bytes, content_type: str,
                       shape_header: Optional[str],
                       image_shape: Tuple[int, int, int]) -> np.ndarray:
    """Request body → uint8 [N,H,W,C]. Raises ValueError on anything that
    should be an HTTP 400."""
    h, w, c = image_shape
    if content_type.startswith("application/octet-stream"):
        item = h * w * c
        if shape_header:
            try:
                dims = tuple(int(x) for x in shape_header.split(","))
            except ValueError:
                raise ValueError(f"bad X-Shape header {shape_header!r}")
            if len(dims) == 3:
                dims = (len(body) // item,) + dims
            if len(dims) != 4 or dims[1:] != image_shape:
                raise ValueError(f"X-Shape {dims} does not match model "
                                 f"input [N,{h},{w},{c}]")
            n = dims[0]
        else:
            n = len(body) // item
        if n < 1 or len(body) != n * item:
            raise ValueError(f"body of {len(body)} bytes is not a whole "
                             f"number of {h}x{w}x{c} uint8 images")
        return np.frombuffer(body, np.uint8).reshape(n, h, w, c)
    if content_type.startswith("application/json"):
        try:
            payload = json.loads(body.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"bad JSON body: {e}")
        if not isinstance(payload, dict) or "instances" not in payload:
            raise ValueError('JSON body must be {"instances": [...]}')
        try:
            arr = np.asarray(payload["instances"], np.uint8)
        except (TypeError, ValueError) as e:
            raise ValueError(f"instances not uint8-coercible: {e}")
        if arr.ndim == 3:
            arr = arr[None]
        if arr.ndim != 4 or arr.shape[1:] != image_shape:
            raise ValueError(f"instances shape {arr.shape} does not match "
                             f"model input [N,{h},{w},{c}]")
        return arr
    raise ValueError(f"unsupported Content-Type {content_type!r} (use "
                     f"application/octet-stream or application/json)")


class PredictServer:
    """Backend + micro-batcher + HTTP front end, drivable in-process
    (tests, the chip smoke) or via :func:`serve` (CLI). ``device`` is
    resolved by :func:`tpu_resnet_torch.device.resolve_device`: CUDA
    unless ``"cpu"`` is asked for."""

    def __init__(self, cfg, backend=None, device: Optional[str] = None,
                 registry: Optional[TelemetryRegistry] = None,
                 spans: Optional[SpanTracer] = None):
        from tpu_resnet_torch.device import resolve_device
        from tpu_resnet_torch.serve.backend import build_backend

        # Time-to-ready counts from before the backend's build: restore,
        # quantization and bucket warmup.
        self._t_init = time.monotonic()
        self.cfg = cfg
        self.backend = backend if backend is not None \
            else build_backend(cfg, resolve_device(device))
        raw = cfg.serve.batch_buckets or default_buckets(cfg.serve.max_batch)
        self.buckets = self.backend.constrain_buckets(
            tuple(sorted({int(b) for b in raw})))
        self.image_shape = (self.backend.image_size,
                            self.backend.image_size, 3)
        # The batcher thread ticks the heartbeat per batch and per idle
        # tick, so a wedged inference goes stale within
        # serve.healthz_stale_sec.
        self.registry = registry if registry is not None \
            else TelemetryRegistry(
                stale_after_sec=cfg.serve.healthz_stale_sec,
                gauges=SERVE_GAUGES, histograms=SERVE_HISTOGRAMS)
        self.run_id = read_run_id(cfg.train.train_dir)
        self.spans = spans if spans is not None else SpanTracer(
            cfg.train.train_dir, enabled=False)
        self.sampler = TailSampler()
        self.registry.mark_unhealthy("loading: warming bucketed batch "
                                     "shapes")
        self._reload_every = float(cfg.serve.reload_interval_secs)
        self._next_reload = time.monotonic() + self._reload_every
        self._injector = FaultInjector(
            FaultPlan.from_config(cfg.resilience), cfg.train.train_dir)
        self.batcher = MicroBatcher(
            self._injector.wrap_serve_infer(self.backend.infer),
            self.image_shape,
            max_batch=max(self.buckets), max_wait_ms=cfg.serve.max_wait_ms,
            buckets=self.buckets, max_queue=cfg.serve.max_queue,
            between_batches=self._between_batches,
            on_stats=self._publish_stats,
            observe=self._observe_sample,
            latency_ring=cfg.serve.latency_ring)
        self._httpd = ThreadingHTTPServer((cfg.serve.host, cfg.serve.port),
                                          self._make_handler())
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="tpu-resnet-torch-serve-http", daemon=True)
        self._closed = False
        self._oom_reported = False
        self._weight_bytes = 0  # published at start()

    def note_oom(self, error, phase: str = "infer") -> None:
        """The first out-of-memory error (a bucket's warmup, a batch on a
        card another process fills) writes ``oom_report.json`` into the
        train dir, once, and an ``oom`` event; never raises."""
        if self._oom_reported or not memory_obs.is_oom_error(error):
            return
        self._oom_reported = True
        memory_obs.write_oom_report(
            self.cfg.train.train_dir, error, context=f"serve-{phase}",
            program_key=f"serve|buckets{list(map(int, self.buckets))}"
                        f"|step{int(self.backend.model_step)}",
            run_id=self.run_id, device=getattr(self.backend, "device", None))
        self.spans.event("oom", phase=phase)

    # ---------------------------------------------------------- health
    def health(self) -> dict:
        """The registry's health (heartbeat age and unhealthy mark), the
        model step, and ``reason`` when not ok."""
        out = self.registry.health()
        out["model_step"] = int(self.backend.model_step)
        if not out["ok"]:
            out["reason"] = out.get("unhealthy_reason") or (
                f"stale: no batcher heartbeat for "
                f"{out['heartbeat_age_sec']}s (> {out['stale_after_sec']}s)")
        return out

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "PredictServer":
        """Warm every bucket smallest-first, each in a
        ``serve_warmup_bucket`` span, then go ready. The socket is already
        serving: /healthz answers 503 during warmup."""
        self._http_thread.start()
        bind = getattr(self.backend, "bind_obs", None)
        if bind is not None:
            bind(telemetry=self.registry, spans=self.spans)
        t0 = time.monotonic()
        warm_bucket = getattr(self.backend, "warmup_bucket", None)
        with self.spans.span("serve_warmup",
                             buckets=list(map(int, self.buckets)),
                             model_step=int(self.backend.model_step)):
            if warm_bucket is None:  # minimal test backends
                self.backend.warmup(self.buckets)
                self.registry.set("serve_buckets_warm",
                                  float(len(self.buckets)))
            else:
                for n, b in enumerate(sorted(self.buckets), start=1):
                    tb = time.time()
                    info = warm_bucket(int(b)) or {}
                    self.spans.record(
                        "serve_warmup_bucket", tb, time.time(),
                        bucket=int(b),
                        cache_hit=bool(info.get("cache_hit")))
                    self.registry.set("serve_buckets_warm", float(n))
        wb_fn = getattr(self.backend, "weight_argument_bytes", None)
        if wb_fn is not None:
            self._weight_bytes = int(wb_fn())
            self.registry.set("serve_weight_bytes",
                              float(self._weight_bytes))
        ttr = time.monotonic() - self._t_init
        self.registry.set("serve_time_to_ready_seconds", round(ttr, 3))
        self.registry.observe("serve_time_to_ready_s", ttr)
        self.spans.event("serve_ready", seconds=round(ttr, 3),
                         buckets=len(self.buckets), cache_hits_total=0,
                         compile_cache_hits=0, compile_cache_misses=0)
        log.info("serve: warmed %d bucket shapes %s in %.1fs "
                 "(time-to-ready %.1fs)", len(self.buckets),
                 list(self.buckets), time.monotonic() - t0, ttr)
        self.batcher.start()
        self.registry.heartbeat(max(0, self.backend.model_step))
        self._publish_stats(self.batcher.stats())
        self.registry.clear_unhealthy()
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop accepting, flush the queue, stop the batcher. The HTTP
        server keeps answering (healthz reports draining) until
        :meth:`close`."""
        self.registry.mark_unhealthy("draining")
        with self.spans.span("serve_drain") as attrs:
            clean = self.batcher.drain(
                self.cfg.serve.drain_timeout_secs if timeout is None
                else timeout)
            attrs["clean"] = clean
        return clean

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._http_thread.is_alive():
            # shutdown() waits for serve_forever, which only start() runs.
            self._httpd.shutdown()
        self._httpd.server_close()
        self.backend.close()

    # ---------------------------------------------------------- batch hooks
    def _between_batches(self) -> None:
        """Runs on the batcher thread strictly between inferences: the
        heartbeat, and the rate-limited hot-reload poll, so that a weight
        swap can never interleave with an in-flight batch."""
        self.registry.heartbeat(max(0, self.backend.model_step))
        if self._reload_every <= 0:
            return
        now = time.monotonic()
        if now < self._next_reload:
            return
        self._next_reload = now + self._reload_every
        t0 = time.time()
        if self.backend.maybe_reload():
            self.registry.set("serve_model_step", self.backend.model_step)
            self.registry.set("serve_reloads_total", self.backend.reloads)
            self.spans.record("serve_reload", t0, time.time(),
                              model_step=int(self.backend.model_step),
                              reloads=int(self.backend.reloads))

    def _observe_sample(self, name: str, value: float) -> None:
        """The batcher's samples → the serve histograms."""
        self.registry.observe({
            "latency_ms": "serve_latency_ms",
            "queue_wait_ms": "serve_queue_wait_ms",
            "pad_fraction": "serve_pad_fraction",
        }.get(name, f"serve_{name}"), value)

    def _publish_stats(self, stats: dict) -> None:
        self.registry.update({
            "serve_requests_total": stats["requests"],
            "serve_requests_rejected": stats["rejected"],
            "serve_requests_failed": stats["failed"],
            "serve_images_total": stats["images"],
            "serve_batches_total": stats["batches"],
            "serve_queue_depth": stats["queue_depth"],
            "serve_batch_size_last": stats["batch_size_last"],
            "serve_batch_size_mean": stats["batch_size_mean"],
            "serve_pad_fraction": stats["pad_fraction"],
            "serve_latency_p50_ms": stats["latency_p50_ms"],
            "serve_latency_p95_ms": stats["latency_p95_ms"],
            "serve_latency_p99_ms": stats["latency_p99_ms"],
            "serve_model_step": self.backend.model_step,
            "serve_reloads_total": self.backend.reloads,
        })

    # ---------------------------------------------------------- predict
    def predict(self, images: np.ndarray,
                lane: str = "interactive") -> np.ndarray:
        """Submit ``images`` through the batcher (split into chunks of at
        most the largest bucket, admitted atomically) and block for the
        logits."""
        return self._predict_pending(images, lane, [])

    def _predict_pending(self, images: np.ndarray, lane: str,
                         pending: list) -> np.ndarray:
        """:meth:`predict`, appending the submitted requests to
        ``pending`` (even when a wait raises), whose timing segments the
        request span reads."""
        max_b = self.batcher.max_batch
        pending.extend(self.batcher.submit_many(
            [images[i:i + max_b] for i in range(0, images.shape[0], max_b)],
            lane=lane))
        return np.concatenate([p.wait(REQUEST_WAIT_SEC) for p in pending])

    def retry_after_secs(self) -> int:
        """Seconds a full queue needs to drain at the recent per-request
        service rate, floored at 1 (the 429 Retry-After hint)."""
        stats = self.batcher.stats()
        p50_sec = stats["latency_p50_ms"] / 1e3
        mean_batch = max(1.0, stats["batch_size_mean"])
        return max(1, int(round(stats["queue_depth"] * p50_sec
                                / mean_batch)))

    def handle_predict(self, body: bytes, content_type: str,
                       shape_header: Optional[str], want_logits: bool,
                       lane: str = "interactive",
                       trace_id: str = "") -> Tuple[int, dict]:
        """(status, response-json) for one predict call; with a
        ``trace_id`` (X-Trace-Id) the call may keep a ``serve_request``
        span."""
        if lane not in LANES:
            lane = "interactive"
        self._injector.note_serve_request()
        t0 = time.time()
        pending: list = []
        status, out = self._handle_predict_inner(
            body, content_type, shape_header, want_logits, lane, pending)
        if trace_id:
            self._trace_request(trace_id, lane, status, pending, t0)
        return status, out

    def _handle_predict_inner(self, body, content_type, shape_header,
                              want_logits, lane, pending) -> Tuple[int, dict]:
        try:
            images = parse_predict_body(body, content_type, shape_header,
                                        self.image_shape)
        except ValueError as e:
            return 400, {"error": str(e)}
        try:
            logits = self._predict_pending(images, lane, pending)
        except QueueFull as e:
            return 429, {"error": str(e), "retryable": True,
                         "retry_after_secs": self.retry_after_secs()}
        except Draining as e:
            return 503, {"error": str(e)}
        except TimeoutError as e:
            return 504, {"error": str(e)}
        except ValueError as e:
            return 400, {"error": str(e)}
        except Exception as e:  # noqa: BLE001 - backend failure → HTTP 500
            log.exception("serve: inference failed")
            self.note_oom(e)
            return 500, {"error": f"{type(e).__name__}: {e}"}
        out = {"predictions": np.argmax(logits, axis=-1).tolist(),
               "model_step": int(self.backend.model_step),
               "count": int(images.shape[0])}
        if want_logits:
            out["logits"] = np.asarray(logits, np.float64).tolist()
        return 200, out

    def _trace_request(self, trace_id: str, lane: str, status: int,
                       pending: list, t0: float) -> None:
        """The tail-sampled ``serve_request`` span with the batcher's
        timing segments; the sampler decides in memory, the span is
        written here, outside its lock."""
        end = time.time()
        latency_ms = (end - t0) * 1e3
        reason = self.sampler.observe(
            latency_ms, error=(status >= 400 and status != 429),
            shed=(status == 429))
        if reason is None:
            return
        attrs = {"trace_id": trace_id, "lane": lane, "status": int(status),
                 "sampled": reason,
                 "replica": self.cfg.serve.replica_name or "serve",
                 "latency_ms": round(latency_ms, 3),
                 "model_step": int(self.backend.model_step)}
        if pending:
            qw = [p.queue_wait_ms for p in pending
                  if p.queue_wait_ms is not None]
            inf = [p.infer_ms for p in pending if p.infer_ms is not None]
            pads = [p.pad_fraction for p in pending
                    if p.pad_fraction is not None]
            sizes = [p.batch_size for p in pending
                     if p.batch_size is not None]
            attrs["n"] = sum(p.n for p in pending)
            if qw:
                attrs["queue_wait_ms"] = round(max(qw), 3)
            if inf:  # chunks ride separate batches: their times add
                attrs["infer_ms"] = round(sum(inf), 3)
            if pads:
                attrs["pad_fraction"] = round(max(pads), 4)
            if sizes:
                attrs["batch_size"] = max(sizes)
        self.spans.record("serve_request", t0, end, **attrs)

    def info(self) -> dict:
        stats = self.batcher.stats()
        return {
            "backend": type(self.backend).__name__,
            "run_id": self.run_id,
            "device": str(getattr(self.backend, "device", "")),
            "replica_name": self.cfg.serve.replica_name,
            "model_step": int(self.backend.model_step),
            "reloads": int(self.backend.reloads),
            "image_shape": list(self.image_shape),
            "num_classes": int(self.backend.num_classes),
            "buckets": list(self.buckets),
            "compute_dtype": self.cfg.model.compute_dtype,
            "quantize": getattr(self.backend, "quantize", "off"),
            "calibration_digest": getattr(self.backend,
                                          "calibration_digest", ""),
            "weight_bytes": int(self._weight_bytes),
            "max_wait_ms": self.cfg.serve.max_wait_ms,
            "max_queue": self.cfg.serve.max_queue,
            "queue_depth": stats["queue_depth"],
            "stats": stats,
        }

    # ---------------------------------------------------------- HTTP layer
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, code: int, payload,
                      ctype: str = "application/json",
                      extra_headers: Optional[dict] = None):
                send_json(self, code, payload, ctype, extra_headers)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._send(200, server.registry.render().encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    health = server.health()
                    self._send(200 if health["ok"] else 503, health)
                elif path in ("/", "/info"):
                    self._send(200, server.info())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                path, _, query = self.path.partition("?")
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
                if server._injector.should_drop_connection():
                    # The connection-drop fault: close with no response.
                    self.close_connection = True
                    try:
                        self.connection.close()
                    except OSError:
                        pass
                    return
                trace_id = (self.headers.get("X-Trace-Id") or "").strip()
                code, payload = server.handle_predict(
                    body, self.headers.get("Content-Type", ""),
                    self.headers.get("X-Shape"),
                    want_logits="logits=1" in query,
                    lane=(self.headers.get("X-Lane")
                          or "interactive").strip().lower(),
                    trace_id=trace_id)
                headers = {}
                if code == 429:
                    headers["Retry-After"] = payload.get(
                        "retry_after_secs", 1)
                if trace_id:
                    headers["X-Trace-Id"] = trace_id
                self._send(code, payload, extra_headers=headers or None)

            def log_message(self, *args):  # request logs would swamp stderr
                pass

        return Handler


def write_discovery(train_dir: str, port: int, run_id: Optional[str] = None,
                    name: str = "", extra: Optional[dict] = None) -> None:
    """Atomic ``<train_dir>/serve.json`` (``serve-<name>.json`` for a named
    replica) announcing the bound port, the run id and ``extra`` (the arm:
    compute dtype, quantize, device)."""
    record = {"run_id": run_id, "name": name or None, **(extra or {})}
    write_record(train_dir, f"serve-{name}.json" if name else SERVE_DISCOVERY,
                 port, extra=record)


def serve(cfg, device: Optional[str] = None) -> int:
    """CLI entry: admission, start, announce, block until SIGTERM/SIGINT,
    drain; 0 on a clean drain, 3 (``NO_CAPACITY``) when admission denies."""
    from tpu_resnet_torch.device import resolve_device
    from tpu_resnet_torch.obs.trace import SERVE_EVENTS_FILE
    from tpu_resnet_torch.resilience.shutdown import ShutdownCoordinator

    device = resolve_device(device)
    coordinator = ShutdownCoordinator(
        enabled=cfg.resilience.graceful_shutdown,
        action_desc="draining the predict server (stop accepting, flush "
                    "the request queue), then exiting 0")
    spans = SpanTracer(cfg.train.train_dir, filename=SERVE_EVENTS_FILE,
                       run_id=read_run_id(cfg.train.train_dir))
    if cfg.serve.admission_hbm_bytes > 0:
        # A replica joining a card that another process (a trainer) uses
        # starts only where its estimated footprint fits the headroom.
        from tpu_resnet_torch.resilience import elastic, exitcodes

        verdict = elastic.colocation_admission(
            cfg.serve.admission_hbm_bytes, device=device)
        spans.event("colocation_admission", **verdict)
        if not verdict["admit"]:
            log.error("serve: colocation admission denied — %s",
                      verdict["reason"])
            spans.close()
            return exitcodes.NO_CAPACITY
        log.info("serve: colocation admission ok — %s", verdict["reason"])
    server = PredictServer(cfg, device=device, spans=spans)
    clean = True
    with coordinator:
        try:
            server.start()
        except Exception as e:
            server.note_oom(e, phase="warmup")
            server.close()
            spans.close()
            raise
        write_discovery(cfg.train.train_dir, server.port,
                        run_id=server.run_id, name=cfg.serve.replica_name,
                        extra={"compute_dtype": cfg.model.compute_dtype,
                               "quantize": getattr(server.backend,
                                                   "quantize", "off"),
                               "device": str(server.backend.device)})
        log.info("serve: ready on :%d — backend=%s model_step=%d "
                 "buckets=%s (POST /predict; /metrics; /healthz; /info)",
                 server.port, cfg.serve.backend, server.backend.model_step,
                 list(server.buckets))
        try:
            while not coordinator.event.wait(0.5):
                pass
            log.info("serve: shutdown requested (%s) — draining",
                     coordinator.signum)
            clean = server.drain()
        except KeyboardInterrupt:
            log.warning("serve: immediate abort requested")
            clean = False
        finally:
            server.close()
            spans.close()
    if clean:
        log.info("serve: drained cleanly, exiting 0")
    return 0 if clean else 1
