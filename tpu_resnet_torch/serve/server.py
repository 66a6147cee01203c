"""Online inference HTTP server — ``python -m tpu_resnet_torch serve``.

Port of ``tpu_resnet/serve/server.py``: a stdlib ``ThreadingHTTPServer``
over the dynamic micro-batcher (``batcher.py``) and the checkpoint backend
(``backend.py``), with the same wire protocol and run contracts:

- ``POST /predict``: ``application/octet-stream`` raw uint8 pixels with an
  ``X-Shape: N,H,W,C`` header (N may be omitted), or ``application/json``
  ``{"instances": [...]}`` holding one ``[H,W,C]`` image or ``[N,H,W,C]``.
  Response ``{"predictions", "model_step", "count"}`` (plus ``"logits"``
  with ``?logits=1``);
- ``GET /healthz``: 503 until every bucket is warm, 503 again while
  draining, else 200; ``GET /info``: backend, buckets, model step, stats;
- backpressure: a full queue is HTTP 429, a draining server 503;
- ``serve.json`` (``serve-<name>.json`` with ``serve.replica_name``)
  announces the bound port in the train dir;
- SIGTERM drains: stop accepting, flush the queue, exit 0.

``/metrics``, request spans, fault injection and colocation admission are
the reference's, not yet the port's.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

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

    def __init__(self, cfg, backend=None, device: Optional[str] = None):
        from tpu_resnet_torch.device import resolve_device
        from tpu_resnet_torch.serve.backend import build_backend

        self._t_init = time.monotonic()
        self.cfg = cfg
        self.backend = backend if backend is not None \
            else build_backend(cfg, resolve_device(device))
        raw = cfg.serve.batch_buckets or default_buckets(cfg.serve.max_batch)
        self.buckets = self.backend.constrain_buckets(
            tuple(sorted({int(b) for b in raw})))
        self.image_shape = (self.backend.image_size,
                            self.backend.image_size, 3)
        # Readiness: None = healthy, else the reason /healthz reports.
        self._health_lock = threading.Lock()
        self._unhealthy: Optional[str] = "loading: warming bucketed batch " \
                                         "shapes"
        self._reload_every = float(cfg.serve.reload_interval_secs)
        self._next_reload = time.monotonic() + self._reload_every
        self.batcher = MicroBatcher(
            self.backend.infer, self.image_shape,
            max_batch=max(self.buckets), max_wait_ms=cfg.serve.max_wait_ms,
            buckets=self.buckets, max_queue=cfg.serve.max_queue,
            between_batches=self._between_batches,
            latency_ring=cfg.serve.latency_ring)
        self._httpd = ThreadingHTTPServer((cfg.serve.host, cfg.serve.port),
                                          self._make_handler())
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="tpu-resnet-torch-serve-http", daemon=True)
        self._closed = False

    # ---------------------------------------------------------- health
    def _set_unhealthy(self, reason: Optional[str]) -> None:
        with self._health_lock:
            self._unhealthy = reason

    def health(self) -> dict:
        with self._health_lock:
            reason = self._unhealthy
        out = {"ok": reason is None,
               "model_step": int(self.backend.model_step)}
        if reason is not None:
            out["reason"] = reason
        return out

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "PredictServer":
        """Warm every bucket smallest-first, then go ready. The socket is
        already serving: /healthz answers 503 during warmup."""
        self._http_thread.start()
        t0 = time.monotonic()
        self.backend.warmup(self.buckets)
        log.info("serve: warmed %d bucket shapes %s in %.1fs "
                 "(time-to-ready %.1fs)", len(self.buckets),
                 list(self.buckets), time.monotonic() - t0,
                 time.monotonic() - self._t_init)
        self.batcher.start()
        self._set_unhealthy(None)
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop accepting, flush the queue, stop the batcher. The HTTP
        server keeps answering (healthz reports draining) until
        :meth:`close`."""
        self._set_unhealthy("draining")
        return self.batcher.drain(self.cfg.serve.drain_timeout_secs
                                  if timeout is None else timeout)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._http_thread.is_alive():
            # shutdown() waits for serve_forever, which only start() runs.
            self._httpd.shutdown()
        self._httpd.server_close()
        self.backend.close()

    # ---------------------------------------------------------- batch hook
    def _between_batches(self) -> None:
        """Runs on the batcher thread strictly between inferences: the
        rate-limited hot-reload poll, so a weight swap can never
        interleave with an in-flight batch."""
        if self._reload_every <= 0:
            return
        now = time.monotonic()
        if now < self._next_reload:
            return
        self._next_reload = now + self._reload_every
        self.backend.maybe_reload()

    # ---------------------------------------------------------- predict
    def predict(self, images: np.ndarray,
                lane: str = "interactive") -> np.ndarray:
        """Submit ``images`` through the batcher (split into chunks of at
        most the largest bucket, admitted atomically) and block for the
        logits."""
        max_b = self.batcher.max_batch
        pending = self.batcher.submit_many(
            [images[i:i + max_b] for i in range(0, images.shape[0], max_b)],
            lane=lane)
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
                       lane: str = "interactive") -> Tuple[int, dict]:
        """(status, response-json) for one predict call."""
        if lane not in LANES:
            lane = "interactive"
        try:
            images = parse_predict_body(body, content_type, shape_header,
                                        self.image_shape)
        except ValueError as e:
            return 400, {"error": str(e)}
        try:
            logits = self.predict(images, lane)
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
            return 500, {"error": f"{type(e).__name__}: {e}"}
        out = {"predictions": np.argmax(logits, axis=-1).tolist(),
               "model_step": int(self.backend.model_step),
               "count": int(images.shape[0])}
        if want_logits:
            out["logits"] = np.asarray(logits, np.float64).tolist()
        return 200, out

    def info(self) -> dict:
        stats = self.batcher.stats()
        return {
            "backend": type(self.backend).__name__,
            "device": str(getattr(self.backend, "device", "")),
            "replica_name": self.cfg.serve.replica_name,
            "model_step": int(self.backend.model_step),
            "reloads": int(self.backend.reloads),
            "image_shape": list(self.image_shape),
            "num_classes": int(self.backend.num_classes),
            "buckets": list(self.buckets),
            "compute_dtype": self.cfg.model.compute_dtype,
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
                      extra_headers: Optional[dict] = None):
                send_json(self, code, payload,
                          extra_headers=extra_headers)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
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
                code, payload = server.handle_predict(
                    body, self.headers.get("Content-Type", ""),
                    self.headers.get("X-Shape"),
                    want_logits="logits=1" in query,
                    lane=(self.headers.get("X-Lane")
                          or "interactive").strip().lower())
                headers = None
                if code == 429:
                    headers = {"Retry-After":
                               payload.get("retry_after_secs", 1)}
                self._send(code, payload, extra_headers=headers)

            def log_message(self, *args):  # request logs would swamp stderr
                pass

        return Handler


def write_discovery(train_dir: str, port: int, name: str = "",
                    extra: Optional[dict] = None) -> None:
    """Atomic ``<train_dir>/serve.json`` (``serve-<name>.json`` for a named
    replica) announcing the bound port."""
    record = {"name": name or None, **(extra or {})}
    write_record(train_dir, f"serve-{name}.json" if name else SERVE_DISCOVERY,
                 port, extra=record)


def serve(cfg, device: Optional[str] = None) -> int:
    """CLI entry: start, announce, block until SIGTERM/SIGINT, drain; 0 on
    a clean drain."""
    from tpu_resnet_torch.resilience.shutdown import ShutdownCoordinator

    coordinator = ShutdownCoordinator(
        enabled=cfg.resilience.graceful_shutdown,
        action_desc="draining the predict server (stop accepting, flush "
                    "the request queue), then exiting 0")
    server = PredictServer(cfg, device=device)
    clean = True
    with coordinator:
        try:
            server.start()
        except BaseException:
            server.close()
            raise
        write_discovery(cfg.train.train_dir, server.port,
                        name=cfg.serve.replica_name,
                        extra={"compute_dtype": cfg.model.compute_dtype,
                               "device": str(server.backend.device)})
        log.info("serve: ready on :%d — model_step=%d buckets=%s "
                 "(POST /predict; /healthz; /info)", server.port,
                 server.backend.model_step, list(server.buckets))
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
    if clean:
        log.info("serve: drained cleanly, exiting 0")
    return 0 if clean else 1
