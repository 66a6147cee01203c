# Verbatim copy of tpu_resnet/serve/batcher.py: the port imports nothing of the reference.
"""Dynamic micro-batcher — the serving-side queue→batch coalescer.

Training feeds the chip fixed-shape batches by construction; online
serving gets requests one at a time. The batcher closes the gap the way
TPU serving systems do (PAPERS: the TF-Serving lineage): queued requests
are coalesced until ``max_batch`` images or ``max_wait_ms`` since the
first queued request — whichever comes first — then padded up to one of a
small set of **bucketed batch shapes** that the backend compiled at
startup, so no client traffic mix can ever trigger a mid-traffic
recompile (the pad cost is tracked as a gauge instead).

Admission control is part of the contract: the queue is bounded
(``max_queue``); a full queue raises :class:`QueueFull` at submit time —
which the HTTP layer maps to 429 backpressure — instead of letting tail
latency grow without bound. ``drain()`` implements the SIGTERM half:
stop admitting, flush everything already queued, then stop the worker.

Pure host code: stdlib + numpy only, no jax, no sockets — the whole
coalescing/padding/rejection/drain behavior is unit-testable with a fake
``infer_fn`` (tests/test_serve.py).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class QueueFull(Exception):
    """Admission control: the request queue is at ``max_queue`` — the
    server maps this to HTTP 429 (retryable backpressure)."""


class Draining(Exception):
    """The batcher is draining (SIGTERM) or closed — the server maps this
    to HTTP 503."""


# QoS lanes, highest priority first. An "interactive" tenant's requests
# always coalesce ahead of queued "batch" work (the router threads the
# X-Lane header through to here), so a bulk tenant can fill the queue
# without adding a single batch-service-time of latency to the
# interactive lane — the lane the SLO is written against.
LANES = ("interactive", "batch")


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch`` (plus ``max_batch`` itself when
    it is not one) — a handful of compiled shapes covers every coalesced
    batch size with bounded padding (< 2x worst case)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n. Callers never form batches larger than the
    largest bucket, so this always resolves."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch of {n} exceeds largest bucket {buckets[-1]}")


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sequence."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return float(sorted_vals[idx])


class PendingRequest:
    """One submitted request: ``wait()`` blocks until the batcher filled
    in the result (or error) and returns the logits for this request's
    images only."""

    __slots__ = ("images", "n", "enqueued_at", "latency_ms",
                 "queue_wait_ms", "infer_ms", "pad_fraction", "batch_size",
                 "_event", "_result", "_error")

    def __init__(self, images: np.ndarray):
        self.images = images
        self.n = int(images.shape[0])
        self.enqueued_at = time.monotonic()
        self.latency_ms: Optional[float] = None
        # Per-request trace segments, filled in by _run_batch before the
        # completion event — the replica-side timing breakdown the
        # distributed-tracing spans (serve_request) attribute latency
        # with: how long this request sat queued, how long its batch's
        # inference took, and what batch it rode in.
        self.queue_wait_ms: Optional[float] = None
        self.infer_ms: Optional[float] = None
        self.pad_fraction: Optional[float] = None
        self.batch_size: Optional[int] = None
        self._event = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    def set_result(self, logits: np.ndarray) -> None:
        self.latency_ms = (time.monotonic() - self.enqueued_at) * 1e3
        self._result = logits
        self._event.set()

    def set_error(self, err: BaseException) -> None:
        self.latency_ms = (time.monotonic() - self.enqueued_at) * 1e3
        self._error = err
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request not served within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class MicroBatcher:
    """Request queue + one worker thread that coalesces, pads, infers.

    ``infer_fn(images_uint8[B,H,W,C]) -> logits[B,classes]`` is only ever
    called from the worker thread with ``B`` in ``buckets`` — which is
    also what makes checkpoint hot-reload safe: ``between_batches`` (the
    reload hook) runs on the same thread strictly between inferences, so
    a weight swap can never interleave with an in-flight batch.
    """

    def __init__(self, infer_fn: Callable[[np.ndarray], np.ndarray],
                 image_shape: Tuple[int, int, int],
                 max_batch: int = 16, max_wait_ms: float = 5.0,
                 buckets: Optional[Sequence[int]] = None,
                 max_queue: int = 256,
                 between_batches: Optional[Callable[[], None]] = None,
                 on_stats: Optional[Callable[[Dict], None]] = None,
                 observe: Optional[Callable[[str, float], None]] = None,
                 latency_ring: int = 1024,
                 idle_tick_sec: float = 0.05):
        """``observe(name, value)`` receives per-request/per-batch
        distribution samples — ``latency_ms`` and ``queue_wait_ms`` per
        request, ``pad_fraction`` per dispatched batch — which the
        server feeds into its Prometheus histograms (obs/server.py).
        Called from the worker thread; exceptions are swallowed."""
        self._infer = infer_fn
        self._observe = observe
        self.image_shape = tuple(image_shape)
        self.buckets = tuple(sorted(set(buckets))) if buckets \
            else default_buckets(max_batch)
        self.max_batch = self.buckets[-1]
        self.max_wait_sec = max_wait_ms / 1e3
        self._between = between_batches
        self._on_stats = on_stats
        self._idle_tick = idle_tick_sec
        # Priority queue of (lane_priority, seq, request): the seq
        # tiebreak keeps FIFO order inside a lane and guarantees two
        # entries never compare their PendingRequest payloads.
        self._queue: "queue.PriorityQueue" = queue.PriorityQueue(
            maxsize=max_queue)
        self._seq = 0  # monotonically increasing under _admit_lock
        self._carry: Optional[PendingRequest] = None  # worker-thread only
        self._accepting = True
        # Serializes admission against the drain flip: every put happens
        # strictly before the flag flips, so drain's final flush is
        # guaranteed to see any racing submit (no request can land after
        # the flush and sit unserved until the handler's wait timeout).
        self._admit_lock = threading.Lock()
        self._stop = threading.Event()
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._counters = dict(requests=0, images=0, batches=0, failed=0,
                              rejected=0, padded_images=0, batched_images=0)
        self._lane_counts = {lane: 0 for lane in LANES}
        self._last_batch = 0
        self._latencies: List[float] = []
        self._latency_ring = max(1, int(latency_ring))
        self._thread = threading.Thread(target=self._run,
                                        name="tpu-resnet-serve-batcher",
                                        daemon=True)

    # ------------------------------------------------------------ producer
    def _validate(self, images: np.ndarray) -> None:
        if images.ndim != 4 or images.shape[1:] != self.image_shape:
            raise ValueError(f"expected [n,{','.join(map(str, self.image_shape))}] "
                             f"images, got {images.shape}")
        if not 1 <= images.shape[0] <= self.max_batch:
            raise ValueError(f"request must carry 1..{self.max_batch} "
                             f"images, got {images.shape[0]} "
                             f"(split larger requests)")

    def submit(self, images: np.ndarray,
               lane: str = "interactive") -> PendingRequest:
        """Enqueue ``images`` (uint8 [n,H,W,C], 1 <= n <= max_batch).
        Raises :class:`Draining` when shut down, :class:`QueueFull` when
        the bounded queue is at capacity (backpressure, not latency)."""
        return self.submit_many([images], lane=lane)[0]

    def submit_many(self, chunks: Sequence[np.ndarray],
                    lane: str = "interactive") -> List[PendingRequest]:
        """Admit several requests atomically: either every chunk gets a
        queue slot or none does (QueueFull). This is how an oversize
        request split across batches is admitted — a partial admission
        would run the admitted chunks' inference only to throw the
        results away when the client sees the 429 and retries the whole
        request. ``lane`` is the QoS class (:data:`LANES`): interactive
        work coalesces ahead of everything queued in the batch lane."""
        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r} (have {LANES})")
        for images in chunks:
            self._validate(images)
        priority = LANES.index(lane)
        with self._admit_lock:
            if not self._accepting:
                raise Draining("server is draining")
            # Only the admit lock holder puts; the worker only takes —
            # so free-slot arithmetic here can only underestimate.
            if self._queue.maxsize - self._queue.qsize() < len(chunks):
                with self._lock:
                    self._counters["rejected"] += len(chunks)
                raise QueueFull(f"request queue at capacity "
                                f"({self._queue.maxsize})")
            reqs = [PendingRequest(images) for images in chunks]
            for req in reqs:
                self._seq += 1
                self._queue.put_nowait((priority, self._seq, req))
        with self._lock:
            self._counters["requests"] += len(reqs)
            self._counters["images"] += sum(r.n for r in reqs)
            self._lane_counts[lane] += len(reqs)
        return reqs

    def queue_depth(self) -> int:
        return self._queue.qsize() + (1 if self._carry is not None else 0)

    # ------------------------------------------------------------ worker
    def start(self) -> "MicroBatcher":
        self._thread.start()
        return self

    def _gather(self) -> List[PendingRequest]:
        """One coalescing round: block for a first request (short tick so
        stop/idle hooks run), then keep collecting until the batch is
        full or ``max_wait_ms`` has passed since the first request was
        taken. A request that would overflow the batch is carried into
        the next round (never split — its images stay contiguous)."""
        if self._carry is not None:
            # Deliberate lock-free handoff: _carry is worker-thread-only
            # during normal operation; drain() touches it ONLY after the
            # worker failed to exit (stuck mid-inference, so not here).
            first, self._carry = self._carry, None  # check: disable=unguarded-shared-write
        else:
            try:
                first = self._queue.get(timeout=self._idle_tick)[2]
            except queue.Empty:
                return []
        reqs, total = [first], first.n
        # Anchored to the first request's ENQUEUE time (the documented
        # contract): a request that already aged in the queue behind a
        # long inference dispatches immediately with whatever coalesces
        # non-blockingly, instead of paying a fresh full wait on top.
        deadline = first.enqueued_at + self.max_wait_sec
        while total < self.max_batch:
            remaining = deadline - time.monotonic()
            if self._stop.is_set():
                remaining = 0.0  # draining: flush, don't dawdle
            try:
                nxt = (self._queue.get(timeout=max(0.0, remaining))
                       if remaining > 0 else self._queue.get_nowait())[2]
            except queue.Empty:
                break
            if total + nxt.n > self.max_batch:
                self._carry = nxt
                break
            reqs.append(nxt)
            total += nxt.n
        return reqs

    def _observe_safe(self, name: str, value: float) -> None:
        if self._observe is None:
            return
        try:
            self._observe(name, value)
        except Exception:  # noqa: BLE001 - telemetry must not kill serving
            pass

    def _run_batch(self, reqs: List[PendingRequest]) -> None:
        total = sum(r.n for r in reqs)
        bucket = pick_bucket(total, self.buckets)
        batch = np.zeros((bucket,) + self.image_shape, np.uint8)
        off = 0
        formed_at = time.monotonic()
        pad = (bucket - total) / bucket
        for r in reqs:
            batch[off:off + r.n] = r.images
            off += r.n
            r.queue_wait_ms = (formed_at - r.enqueued_at) * 1e3
            r.pad_fraction = pad
            r.batch_size = total
            self._observe_safe("queue_wait_ms", r.queue_wait_ms)
        self._observe_safe("pad_fraction", pad)
        try:
            logits = np.asarray(self._infer(batch))
        except Exception as e:  # noqa: BLE001 - per-batch failure domain
            infer_ms = (time.monotonic() - formed_at) * 1e3
            with self._lock:
                self._counters["failed"] += len(reqs)
                self._counters["batches"] += 1
            for r in reqs:
                r.infer_ms = infer_ms
                r.set_error(e)
            return
        infer_ms = (time.monotonic() - formed_at) * 1e3
        for r in reqs:
            r.infer_ms = infer_ms
        off = 0
        for r in reqs:
            r.set_result(logits[off:off + r.n])
            off += r.n
            self._observe_safe("latency_ms", r.latency_ms)
        with self._lock:
            self._counters["batches"] += 1
            self._counters["batched_images"] += total
            self._counters["padded_images"] += bucket - total
            self._last_batch = total
            self._latencies.extend(r.latency_ms for r in reqs)
            if len(self._latencies) > self._latency_ring:
                del self._latencies[:-self._latency_ring]

    def _run(self) -> None:
        try:
            while True:
                reqs = self._gather()
                if reqs:
                    self._run_batch(reqs)
                elif self._stop.is_set():
                    break
                # Strictly-between-batches hook: hot-reload checks swap
                # weights here, so no in-flight inference ever sees a
                # half-swapped model. Runs on idle ticks too, so reloads
                # happen even with zero traffic.
                if self._between is not None:
                    try:
                        self._between()
                    except Exception:  # noqa: BLE001 - reload must not
                        pass           # kill the serving loop
                if self._on_stats is not None:
                    try:
                        self._on_stats(self.stats())
                    except Exception:  # noqa: BLE001
                        pass
        finally:
            self._done.set()

    # ------------------------------------------------------------ shutdown
    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting, flush everything queued, stop the worker.
        Returns True on a clean drain; on timeout, still-queued requests
        are failed with :class:`Draining` so no client hangs forever."""
        with self._admit_lock:
            # Under the admit lock: every racing submit either completed
            # its put (the flush below sees it) or will observe the flag
            # and raise Draining — no request can land post-flush.
            self._accepting = False
        self._stop.set()
        clean = self._done.wait(timeout)
        # Flush unconditionally: the worker exits on stop+empty, but a
        # submit admitted just before the flag flipped may have landed
        # after its final gather — without this it would sit unserved
        # until the handler's wait timeout instead of an immediate 503.
        while True:
            try:
                req = self._queue.get_nowait()[2]
            except queue.Empty:
                break
            req.set_error(Draining("server shut down before this "
                                   "request was served"))
        if self._thread.is_alive():
            self._thread.join(timeout=min(timeout, 5.0))
        alive = self._thread.is_alive()
        if alive:
            # Worker stuck mid-inference: a request carried out of the
            # queue for the NEXT batch would otherwise hang its client
            # for the full request-wait timeout. The worker only touches
            # _carry between batches, which a stuck worker is not.
            # Deliberate unlocked touch (see _gather): the worker only
            # moves _carry between batches, which a stuck worker — the
            # only path reaching this line — is not doing.
            carried, self._carry = self._carry, None  # check: disable=unguarded-shared-write
            if carried is not None:
                carried.set_error(Draining("server shut down before this "
                                           "request was served"))
        return clean and not alive

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict:
        with self._lock:
            c = dict(self._counters)
            lanes = dict(self._lane_counts)
            lat = sorted(self._latencies)
            last = self._last_batch
        batches = max(1, c["batches"])
        denom = max(1, c["batched_images"] + c["padded_images"])
        return {
            **c,
            **{f"lane_{lane}": n for lane, n in lanes.items()},
            "queue_depth": self.queue_depth(),
            "batch_size_last": last,
            "batch_size_mean": c["batched_images"] / batches,
            "pad_fraction": c["padded_images"] / denom,
            "latency_p50_ms": percentile(lat, 0.50),
            "latency_p95_ms": percentile(lat, 0.95),
            "latency_p99_ms": percentile(lat, 0.99),
        }
