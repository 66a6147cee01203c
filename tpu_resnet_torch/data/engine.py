"""The decode engine: ordered per-batch work orders → batches on the device
(port of ``tpu_resnet/data/engine.py``, thread mode).

- The parent slices the deterministic record stream into work orders
  ``(seq, entries)``, entries ``(file_idx, offset, length)``; batch ``i``
  gets ``seq = first_seq + i``.
- N worker threads pull orders, read and parse the records, verify their
  CRC (``verify_records``) and take each image's draws on the host from
  ``default_rng((seed, 0x1DEC0DE, seq, j))``, so a batch's contents are a
  pure function of (seed, seq) whatever the worker count or the resume
  point. The decode and the resize run in :class:`DecodeStage`: on the
  card nvJPEG and ``tr_resize_crop`` on the worker's own stream, on the CPU
  the plain versions.
- The consumer yields strictly in ``seq`` order. A batch from the card
  comes with an event recorded on its worker's stream after its last
  launch: the consumer makes its current stream wait on it and records
  that stream on the batch's memory (``record_stream``), so the step reads
  the batch after it is written and its memory is not reused before the
  step has read it. Each batch is a fresh tensor that the engine never
  writes again, so a caller may keep it as long as it likes.
- A finite stream's last partial batch is zero-padded, labels -1.

``ring_slots`` bounds the batches dispatched and not yet consumed (the
prefetch depth). A decode error is raised at its batch's turn with the
record's file and offset; a worker thread that dies raises within one
poll; a set ``external_stop`` ends iteration within ``RESULT_POLL_SEC``;
``close()`` is idempotent. ``data.engine=process``, the reference's
GIL-free CPU decode, is not ported: decode runs on the card.

:func:`decode_scaling_probe` (``doctor --data-bench``) times the engine on
synthetic JPEGs by worker count.
"""

from __future__ import annotations

# check: disable-file=unguarded-shared-write
# Justification: the engine is single-consumer by contract: every
# consumer-side field (_next_dispatch, _next_yield, _ready, _closed,
# _broken, the stats counters) is touched only from the thread that
# iterates it, which also runs close(). Workers communicate through the
# task and result queues and the decode counter (its own lock).

import os
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_resnet_torch.data import tfrecord
from tpu_resnet_torch.device import resolve_device

# RNG stream tag separating per-image decode draws from every other
# (seed, ...)-keyed stream (the reference's).
_DECODE_STREAM = 0x1DEC0DE

# Consumer poll interval between worker-liveness checks.
RESULT_POLL_SEC = 0.5

# Open shard handles kept per worker (LRU).
_FH_CACHE_SIZE = 64

Entry = Tuple[int, int, int]  # (file_idx, payload_offset, payload_length)


class Aborted(Exception):
    """The engine was closed while a worker decoded."""


def _indexed(device) -> torch.device:
    """``device`` with its CUDA index written out (the current device's
    where it has none), so that worker threads set the same device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class DecodeStage:
    """One thread's decode stage: serialized records and draws → a batch of
    ``batch`` images (uint8 [batch, S, S, 3]) and labels (int32, ``label -
    1``; the tail past the records zero images, labels -1) on ``device``.
    On CUDA it owns an nvJPEG decoder and a side stream; ``batch`` returns
    with the work queued there and the batch's event recorded."""

    def __init__(self, device, image_size: int, batch: int):
        self.device = _indexed(device)
        self.image_size = image_size
        self.size = batch
        self.decoder = self.stream = None
        if self.device.type == "cuda":
            from tpu_resnet_torch.ops.jpeg_decode import NvJpegDecoder
            torch.cuda.set_device(self.device)
            self.stream = torch.cuda.Stream(self.device)
            self.decoder = NvJpegDecoder(self.device)

    def batch(self, records: Sequence[Tuple[bytes, str]], draws,
              should_abort=None):
        """(images, labels, ready event or None) of ``records`` (payload,
        what to call it in an error) with ``draws`` (side, fx, fy)."""
        from tpu_resnet_torch.data.imagenet import parse_record
        from tpu_resnet_torch.ops.jpeg_decode import decode_crop_batch

        jpegs, labels, names = [], np.full(self.size, -1, np.int32), []
        for j, (payload, what) in enumerate(records):
            jpeg, label = parse_record(payload)
            jpegs.append(jpeg)
            labels[j] = label - 1  # 1-based shard labels → 0-based
            names.append(what)
        s, n = self.image_size, len(jpegs)
        if self.stream is None:
            images = torch.zeros(self.size, s, s, 3, dtype=torch.uint8)
            for j in range(n):
                if should_abort is not None and should_abort():
                    raise Aborted
                images[j] = decode_crop_batch([jpegs[j]], [draws[j]], s,
                                              self.device, names=[names[j]])[0]
            return images, torch.from_numpy(labels), None
        with torch.cuda.stream(self.stream):
            labels_dev = torch.from_numpy(labels).to(self.device)
            images = decode_crop_batch(jpegs, draws, s, self.device,
                                       self.decoder, names)
            if n < self.size:
                images = torch.cat([images, images.new_zeros(
                    self.size - n, s, s, 3)])
            event = torch.cuda.Event()
            event.record(self.stream)
        return images, labels_dev, event

    def close(self) -> None:
        if self.decoder is not None:
            self.decoder.close()
            self.decoder = None


def handoff(images: torch.Tensor, labels: torch.Tensor, event
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Make the current stream wait for a batch's event, and keep the
    batch's memory from reuse until that stream has read it."""
    if event is not None:
        cur = torch.cuda.current_stream(images.device)
        cur.wait_event(event)
        images.record_stream(cur)
        labels.record_stream(cur)
    return images, labels


def read_order(entries: Sequence[Entry], files: Sequence[str],
               verify: bool = False, fh_cache: Optional[dict] = None
               ) -> List[Tuple[bytes, str]]:
    """The payloads of one order's records, with their file and offset;
    ``fh_cache`` keeps open shard handles across calls (closed by the
    caller), without it each handle is closed on return."""
    if fh_cache is None:
        fh_cache = {}
        try:
            return read_order(entries, files, verify, fh_cache)
        finally:
            for fh in fh_cache.values():
                fh.close()
    out = []
    for fi, off, length in entries:
        path = files[fi]
        fh = fh_cache.pop(path, None)  # re-inserted: LRU recency order
        if fh is None:
            if len(fh_cache) >= _FH_CACHE_SIZE:
                fh_cache.pop(next(iter(fh_cache))).close()
            fh = open(path, "rb")
        fh_cache[path] = fh
        fh.seek(off)
        payload = fh.read(length)
        what = f"{path} record at offset {off}"
        if len(payload) != length:
            raise ValueError(f"{what}: truncated")
        if verify:
            (want,) = np.frombuffer(fh.read(4), "<u4")
            if tfrecord.masked_crc32c_fast(payload) != int(want):
                raise ValueError(f"{what}: CRC mismatch")
        out.append((payload, what))
    return out


def order_draws(params: dict, seq: int, count: int) -> List[tuple]:
    """(side, fx, fy) of each image of batch ``seq`` (its rows from
    ``params["row_offset"]`` on)."""
    from tpu_resnet_torch.data.imagenet import crop_draws
    first = params.get("row_offset", 0)
    return [crop_draws(params["train"],
                       np.random.default_rng((params["seed"], _DECODE_STREAM,
                                              seq, j)),
                       params["resize_min"], params["resize_max"],
                       params["eval_resize"])
            for j in range(first, first + count)]


def _worker_loop(device, params, files, task_q, result_q, should_abort,
                 decoded_add) -> None:
    """Pull orders until a ``None`` sentinel or abort; report each."""
    fh_cache: dict = {}
    stage = None
    try:
        stage = DecodeStage(device, params["image_size"],
                            params["local_batch"])
        while True:
            try:
                order = task_q.get(timeout=1.0)
            except queue.Empty:
                if should_abort():
                    break
                continue
            if order is None or should_abort():
                break
            seq, entries = order
            try:
                records = read_order(entries, files,
                                     params["verify_records"], fh_cache)
                out = stage.batch(records, order_draws(params, seq,
                                                       len(records)),
                                  should_abort)
            except Aborted:
                break
            except Exception as e:  # reported against its seq, in order
                result_q.put(("error", seq, f"{type(e).__name__}: {e}"))
                continue
            decoded_add(len(entries))
            result_q.put(("ok", seq, out))
    except Exception as e:  # the stage did not start: fail every order
        result_q.put(("dead", -1, f"{type(e).__name__}: {e}"))
    finally:
        for fh in fh_cache.values():
            fh.close()
        if stage is not None:
            stage.close()


class HostDataEngine:
    """Sequence-ordered batch stream over N decode workers.

    ``orders``: iterator of entry lists (each at most ``local_batch``
    long), finite for eval, infinite for training. Pass the resume step as
    ``first_seq`` so the draws line up with the uninterrupted run, and a
    rank's first row of each batch as ``row_offset`` where the orders hold
    a rank's rows only.
    ``device``: where batches are decoded and returned (CUDA unless the
    caller asks for the CPU)."""

    def __init__(self, orders, *, files: Sequence[str], local_batch: int,
                 image_size: int, seed: int = 0, train: bool = True,
                 resize_min: int = 256, resize_max: int = 512,
                 eval_resize: int = 256, verify_records: bool = False,
                 device="cuda", mode: str = "thread", workers: int = 2,
                 ring_slots: int = 0, first_seq: int = 0,
                 external_stop: Optional[threading.Event] = None,
                 row_offset: int = 0):
        if mode == "process":
            raise NotImplementedError(
                "data.engine=process (GIL-free CPU decode processes) is not "
                "ported: the port decodes on the card (ROADMAP Queue 1); use "
                "data.engine=thread")
        if mode != "thread":
            raise ValueError(f"engine mode must be thread|process: {mode!r}")
        self.device = _indexed(resolve_device(str(device)))
        self.mode = mode
        self.workers = max(1, int(workers))
        self.ring_slots = int(ring_slots) or 2 * self.workers + 1
        self.local_batch = int(local_batch)
        self._orders = iter(orders)
        self._files = list(files)
        self._params = dict(seed=seed, train=train, resize_min=resize_min,
                            resize_max=resize_max, eval_resize=eval_resize,
                            verify_records=verify_records,
                            image_size=image_size, local_batch=local_batch,
                            row_offset=row_offset)
        self._external_stop = external_stop
        self._next_dispatch = first_seq
        self._next_yield = first_seq
        self._orders_done = False
        self._ready: Dict[int, tuple] = {}
        self._closed = False
        self._broken: Optional[str] = None
        self._stats_wall = time.monotonic()
        self._stats_decoded = 0
        self._task_q: queue.Queue = queue.Queue()
        self._result_q: queue.Queue = queue.Queue()
        self._stop_evt = threading.Event()
        self._counter_lock = threading.Lock()
        self._counter_val = 0

        def add(n):
            with self._counter_lock:
                self._counter_val += n

        self._threads = [
            threading.Thread(
                target=_worker_loop,
                args=(self.device, self._params, self._files, self._task_q,
                      self._result_q, self._stop_evt.is_set, add),
                daemon=True, name=f"tpures-decode-{i}")
            for i in range(self.workers)]
        for t in self._threads:
            t.start()
        self._pump()

    def _pump(self) -> None:
        """Hand out orders while fewer than ``ring_slots`` are pending."""
        while (self._next_dispatch - self._next_yield < self.ring_slots
               and not self._orders_done):
            try:
                entries = next(self._orders)
            except StopIteration:
                self._orders_done = True
                break
            self._task_q.put((self._next_dispatch, list(entries)))
            self._next_dispatch += 1

    def _decoded_total(self) -> int:
        with self._counter_lock:
            return self._counter_val

    def _check_workers(self) -> None:
        for t in self._threads:
            if not t.is_alive() and not self._stop_evt.is_set():
                raise RuntimeError(
                    f"data engine worker thread {t.name} died")

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._closed or self._broken:
            raise StopIteration
        self._pump()
        seq = self._next_yield
        while seq not in self._ready:
            if self._orders_done and seq >= self._next_dispatch:
                self.close()  # finite stream fully drained
                raise StopIteration
            if (self._external_stop is not None
                    and self._external_stop.is_set()):
                raise StopIteration  # preemption: stop waiting for data
            try:
                kind, rseq, info = self._result_q.get(
                    timeout=RESULT_POLL_SEC)
            except queue.Empty:
                try:
                    self._check_workers()
                except RuntimeError:
                    self.close()
                    raise
                continue
            if kind == "dead":
                self._broken = info
                self.close()
                raise RuntimeError(f"data engine worker failed to start: "
                                   f"{info}")
            self._ready[rseq] = (kind, info)
        kind, info = self._ready.pop(seq)
        self._next_yield += 1
        if kind == "error":
            self._broken = str(info)
            self.close()
            raise RuntimeError(f"data engine decode failed at batch "
                               f"{seq}: {info}")
        self._pump()
        return handoff(*info)

    def stats(self) -> Dict[str, float]:
        """Telemetry snapshot; the decode rate covers the interval since
        the previous stats() call."""
        now = time.monotonic()
        decoded = self._decoded_total()
        dt = max(now - self._stats_wall, 1e-9)
        rate = (decoded - self._stats_decoded) / dt
        self._stats_wall, self._stats_decoded = now, decoded
        return {
            "data_ring_occupancy": float(len(self._ready)
                                         + self._result_q.qsize()),
            "data_ring_slots": float(self.ring_slots),
            "data_decode_images_per_sec": round(rate, 1),
            # The next batch's seq: the deterministic-stream position.
            "data_stream_seq": float(self._next_yield),
        }

    def close(self) -> None:
        """Stop the workers. Idempotent; fires on end of stream and on
        error."""
        if self._closed:
            return
        self._closed = True
        self._stop_evt.set()
        for _ in range(self.workers):  # one sentinel per worker
            self._task_q.put(None)
        deadline = time.monotonic() + 5.0
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        self._ready.clear()

    def __del__(self):  # abandoned-iterator hygiene; close() is the API
        try:
            self.close()
        except Exception:
            pass


def _cycled_orders(n_records: int, local_batch: int):
    """Infinite order stream cycling over one probe shard's records."""
    pos = 0
    while True:
        idxs = [(i % n_records) for i in range(pos, pos + local_batch)]
        pos = (pos + local_batch) % n_records
        yield idxs


def decode_scaling_probe(worker_counts: Sequence[int] = (1, 0),
                         seconds: float = 4.0, local_batch: int = 32,
                         image_size: int = 224, n_records: int = 48,
                         warmup_batches: int = 2, device="cuda",
                         photo_size: Tuple[int, int] = (640, 480)) -> dict:
    """Decode throughput by worker count (port of the reference's probe,
    with worker threads where it has processes; a ``0`` in
    ``worker_counts`` means ``os.cpu_count()``, at most 8): images/s
    through :class:`HostDataEngine` on ``device`` over about ``seconds``
    each, after ``warmup_batches``; beside them one :class:`DecodeStage`
    run inline on the caller's thread, no engine. Each timing ends with
    the device drained. The photos are :func:`synthetic_photo_jpeg`'s,
    in one shard of ``n_records`` records.
    ``implied_max_steps_per_sec_b128``: the train steps/s that the best
    rate could feed at a global batch of 128. The keys are the
    reference's (``engine_images_per_sec_by_procs`` counts threads)."""
    import tempfile

    from tpu_resnet_torch.data.jpeg_encode import synthetic_photo_jpeg

    device = _indexed(resolve_device(str(device)))

    def drain():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cpu = os.cpu_count() or 1
    counts = sorted({(c if c > 0 else min(8, cpu)) for c in worker_counts})
    rng = np.random.default_rng(0)
    jpegs = [synthetic_photo_jpeg(photo_size, rng=rng) for _ in range(4)]
    out = {"cpu_count": cpu, "local_batch": local_batch,
           "jpeg_kind": "synthetic_photo_%dx%d" % photo_size,
           "mode": "thread", "device": str(device)}
    with tempfile.TemporaryDirectory(prefix="tpures_databench_") as d:
        shard = os.path.join(d, "probe-shard")
        tfrecord.write_records(shard, [tfrecord.encode_example({
            "image/encoded": [jpegs[i % 4]],
            "image/class/label": [1 + (i % 1000)],
        }) for i in range(n_records)])
        index = tfrecord.record_index(shard)
        params = dict(seed=0, train=True, resize_min=256, resize_max=512,
                      eval_resize=256)
        records = read_order([(0,) + index[i % n_records]
                              for i in range(local_batch)], [shard])
        stage = DecodeStage(device, image_size, local_batch)
        try:  # the inline baseline: no engine, no worker thread
            def inline():
                _, _, event = stage.batch(
                    records, order_draws(params, 0, len(records)))
                if event is not None:
                    event.synchronize()

            for _ in range(warmup_batches):
                inline()
            t0, n = time.perf_counter(), 0
            while time.perf_counter() - t0 < min(seconds, 3.0):
                inline()
                n += local_batch
            base_rate = n / (time.perf_counter() - t0)
        finally:
            stage.close()
        out["single_process_images_per_sec"] = round(base_rate, 1)
        scaling = {}
        for workers in counts:
            orders = ([(0,) + index[i] for i in idxs]
                      for idxs in _cycled_orders(len(index), local_batch))
            eng = HostDataEngine(
                orders, files=[shard], local_batch=local_batch,
                image_size=image_size, seed=0, train=True, device=device,
                mode="thread", workers=workers)
            try:
                for _ in range(warmup_batches):  # thread start, first IO
                    next(eng)
                drain()
                t0, images = time.perf_counter(), 0
                while time.perf_counter() - t0 < seconds:
                    next(eng)
                    images += local_batch
                drain()
                scaling[str(workers)] = round(
                    images / (time.perf_counter() - t0), 1)
            finally:
                eng.close()
        out["engine_images_per_sec_by_procs"] = scaling
    best = max(scaling.values()) if scaling else base_rate
    out["best_images_per_sec"] = best
    out["scaling_vs_single_process"] = round(best / max(base_rate, 1e-9), 2)
    out["implied_max_steps_per_sec_b128"] = round(best / 128.0, 2)
    return out
