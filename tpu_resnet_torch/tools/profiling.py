"""Device time on a CUDA card, from ``torch.profiler``.

:func:`device_profile` runs a callable ``iters`` times under the profiler
and reads every device event (kernels and copies) with its stream and its
interval. Streams that ran a kernel of the ImageNet decode stage
(``DECODE_KERNELS``) are the decode engine's, and every event on them,
copies included, is the decode's; the other streams are the step's. Busy
times are unions of intervals, so that work overlapping on two streams
counts once: the device's busy time over all streams, the step's over its
own. The rows by name (launches, device ms) are the profiler's per-name
averages. :func:`profile_train_step` times the train loop's eager step
that way, :func:`profile_train_chunks` its chunked dispatch (CUDA graph
replays), each fed by any iterator of batches on the device (seeded ones
copied in by :func:`host_batches`, or the decode engine's); figures are
per step; ``tools/profile_torch_train.py`` and ``chip_smoke.py`` print
them.

:class:`StepTracer` is the train loop's profiler window
(``train.profile_steps = "start:stop"``, :func:`parse_window`; port of the
reference's ``StepTracer``): ``torch.profiler`` runs from the chunk that
begins inside the window to the first step at or past its stop, and its
Chrome trace lands in ``<train_dir>/profile/<timestamp>/trace.json.gz``,
which ``trace-export --device-trace`` lays on the run's timeline
(``obs/trace.py``).
"""

from __future__ import annotations

import logging
import os
import time
from typing import (Callable, Dict, Iterable, Iterator, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

log = logging.getLogger("tpu_resnet_torch")

# The port's kernels on the train paths, by a substring of their names: the
# fused block's stats are two launches on the tensor cores,
# ``block_stats_kernel`` (c1 and the tiles' sums) and
# ``block_stats_sum_kernel``; its training forward one,
# ``block_fwd_kernel`` from the stats' c1 (from x, as serving runs it, two:
# ``block_fwd_r2_kernel`` and ``block_fwd_kernel``); its first backward pass
# two, ``block_bwd1_kernel`` and ``block_bwd1_sum_kernel``, its second
# three, ``block_bwd2_dc1_kernel``, ``block_bwd2_kernel`` and
# ``block_bwd2_sum_kernel``; ``sbr_bwd_kernel`` is one launch with its
# sums. The fused bottleneck's training kernels all run on the tensor
# cores: one for the first moment pass and passes 3 and 4, two for each of
# the forward, the second moment pass and passes 1 and 2:
# ``bottleneck_fwd_p2_kernel`` and ``bottleneck_fwd_kernel``,
# ``bottleneck_stats_b_p2_kernel`` and ``bottleneck_stats_b_kernel``,
# ``bottleneck_bwd1_p2_kernel`` and ``bottleneck_bwd1_kernel``,
# ``bottleneck_bwd2_dmid_kernel`` and ``bottleneck_bwd2_kernel``;
# ``bottleneck_wgrad`` for dw1..3, and ``bottleneck_sum`` adds their
# partial rows in order.
TRAIN_KERNELS = {"sbr": "sbr_kernel", "sbr_bwd": "sbr_bwd_kernel",
                 "xent_fwd": "xent_fwd_kernel", "xent_bwd": "xent_bwd_kernel",
                 "block_fwd": "block_fwd_",
                 "block_stats": "block_stats_",
                 "block_bwd1": "block_bwd1_",
                 "block_bwd2": "block_bwd2_",
                 "block_bwd3": "block_bwd3_kernel",
                 "bottleneck_fwd": "bottleneck_fwd_",
                 "bottleneck_stats_a": "bottleneck_stats_a_kernel",
                 "bottleneck_stats_b": "bottleneck_stats_b_",
                 "bottleneck_bwd1": "bottleneck_bwd1_",
                 "bottleneck_bwd2": "bottleneck_bwd2_",
                 "bottleneck_bwd3": "bottleneck_bwd3_kernel",
                 "bottleneck_bwd4": "bottleneck_bwd4_kernel",
                 "bottleneck_wgrad": "bottleneck_wgrad_kernel",
                 "bottleneck_sum": "bottleneck_sum_kernel"}


# The ImageNet decode stage's kernels, by a lowercase substring of their
# names: tr_resize_crop and nvJPEG's own. A stream that ran one is a decode
# worker's.
DECODE_KERNELS = ("resize_crop", "jpeg", "idct", "huffman")

# A device event: (name, stream, start µs, end µs).
Event = Tuple[str, int, float, float]


def union_ms(intervals: Iterable[Tuple[float, float]]) -> float:
    """The time covered by (start µs, end µs) intervals, in ms; an interval
    that does not end after it starts covers nothing."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end and b > a:
            total += b - max(a, end)
            end = b
    return total / 1e3


def kernel_rows(averages: Iterable[Tuple[str, int, float]], iters: int
                ) -> list:
    """[{"name", "ms_per_call", "launches_per_call"}, ...] by device time,
    from the profiler's per-name (name, events, device µs); a name whose
    events took no device time is left out (the profiler now and then
    stamps a launch with none, and counts it under its name)."""
    rows = [{"name": name[:90], "ms_per_call": us / 1e3 / iters,
             "launches_per_call": count / iters}
            for name, count, us in averages if us > 0]
    return sorted(rows, key=lambda k: -k["ms_per_call"])


def split_streams(events: Sequence[Event], iters: int) -> Dict:
    """Per call: the device's busy ms (all streams), the step's (the
    streams that ran no ``DECODE_KERNELS`` kernel) and the decode's (the
    streams that did, every event on them), unions of intervals, None when
    there was no device event; each stream's events and ms; and the names
    whose events all ran on the decode's streams."""
    decode_streams = {s for name, s, _, _ in events
                      if any(k in name.lower() for k in DECODE_KERNELS)}
    step = [e for e in events if e[1] not in decode_streams]
    decode = [e for e in events if e[1] in decode_streams]
    streams = []
    for s in sorted({e[1] for e in events}):
        mine = [e for e in events if e[1] == s]
        streams.append({"stream": s, "decode": s in decode_streams,
                        "events_per_call": len(mine) / iters,
                        "busy_ms_per_call": union_ms(
                            (a, b) for _, _, a, b in mine) / iters})

    def busy(evts):
        return (union_ms((a, b) for _, _, a, b in evts) / iters
                if events else None)

    return {"device_busy_ms": busy(events), "step_busy_ms": busy(step),
            "decode_ms": busy(decode), "streams": streams,
            "decode_names": ({e[0] for e in decode}
                             - {e[0] for e in step})}


def device_profile(fn: Callable[[], object], iters: int) -> Dict:
    """``iters`` calls of ``fn`` under the profiler: {"device_busy_ms",
    "step_busy_ms", "decode_ms", "streams"} (:func:`split_streams` of its
    device events), "kernels": the step's :func:`kernel_rows` (every name
    but the decode's), "decode_kernels": the decode's}."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    def device_work(evt) -> bool:
        # A user range (e.g. the optimizer's step) is not device work.
        return (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False))

    out = split_streams([
        (evt.name, int(getattr(evt, "device_resource_id", 0)),
         float(evt.time_range.start), float(evt.time_range.end))
        for evt in prof.events() if device_work(evt)], iters)
    decode = out.pop("decode_names")
    averages = [evt for evt in prof.key_averages() if device_work(evt)]
    for key, names in (("kernels", False), ("decode_kernels", True)):
        out[key] = kernel_rows(((evt.key, evt.count, _device_us(evt))
                                for evt in averages
                                if (evt.key in decode) == names), iters)
    return out


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def host_batches(images: np.ndarray, labels: np.ndarray, device
                 ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """One seeded host batch, copied to ``device`` at every step as the
    loop's streaming path copies it (the labels once)."""
    lab = torch.from_numpy(labels).to(device)
    while True:
        yield torch.from_numpy(images).to(device), lab


def device_batches(images: np.ndarray, labels: np.ndarray, device
                   ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """One seeded batch copied to ``device`` once and fed at every step,
    as the device-resident split feeds its views."""
    batch = (torch.from_numpy(images).to(device),
             torch.from_numpy(labels).to(device))
    while True:
        yield batch


def profile_train_step(state, step_fn, batches, iters: int = 20,
                       warmup: int = 5, probe=None) -> Dict:
    """Wall and device time per step of ``step_fn(state, images, labels)``,
    each step fed by ``next(batches)`` (batches on the device), after
    ``warmup`` steps: the host clock over ``iters`` steps ending in a
    synchronize, then ``iters`` more under the profiler. The idle shares
    are the wall's share that the device (all streams) and the step's own
    streams leave idle; a decode engine's work on its streams is counted
    apart (``decode_device_ms_per_step``). ``probe()``, where given, is
    read at the host clock's window's start and end (``probe``: the
    two readings), e.g. the decode engine's ``stats``."""
    def one_step():
        images, labels = next(batches)
        step_fn(state, images, labels)
        return len(images)

    return _profile_calls(one_step, 1, iters, warmup, probe)


def profile_train_chunks(state, runner, batches, steps_per_call: int,
                         chunks: int = 4, warmup: int = 2,
                         probe=None) -> Dict:
    """:func:`profile_train_step` for the loop's chunked dispatch: each
    call is one chunk of ``steps_per_call`` steps through ``runner``
    (``data/device_data.py`` ``ChunkRunner.run_batches``: CUDA graph
    replays where the runner is graphed), fed ``steps_per_call`` batches
    of ``batches``; ``chunks`` chunks timed by the host clock, as many
    profiled; every figure per step. ``warmup`` chunks run first (they
    capture the step)."""
    def one_chunk():
        fed = [next(batches) for _ in range(steps_per_call)]
        runner.run_batches(state, fed)
        return len(fed[0][0])

    out = _profile_calls(one_chunk, steps_per_call, chunks, warmup, probe)
    out.update(steps_per_call=steps_per_call,
               graphed=bool(getattr(runner, "graphed", False)))
    return out


def _profile_calls(call: Callable[[], int], steps: int, iters: int,
                   warmup: int, probe) -> Dict:
    """``call()`` runs ``steps`` train steps and returns the batch size;
    the figures of :func:`profile_train_step`, per step."""
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    probed = [probe()] if probe is not None else None
    t0 = time.perf_counter()
    for _ in range(iters):
        batch = call()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (iters * steps)
    if probe is not None:
        probed.append(probe())
    prof = device_profile(call, iters)
    kernels = [{**k, "ms_per_call": k["ms_per_call"] / steps,
                "launches_per_call": k["launches_per_call"] / steps}
               for k in prof["kernels"]]
    ours = {}
    for name, key in TRAIN_KERNELS.items():
        rows = [k for k in kernels if key in k["name"]]
        ours[name] = {"ms_per_step": sum(k["ms_per_call"] for k in rows),
                      "launches_per_step": sum(k["launches_per_call"]
                                               for k in rows)}

    def per_step(ms):
        return None if ms is None else ms / steps

    def idle(busy):
        return None if busy is None else 1 - busy / wall_ms

    busy = {k: per_step(prof[k]) for k in ("device_busy_ms", "step_busy_ms",
                                            "decode_ms")}
    return {"batch": batch, "iters": iters * steps,
            "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy["device_busy_ms"],
            "device_idle_share": idle(busy["device_busy_ms"]),
            "step_busy_ms_per_step": busy["step_busy_ms"],
            "step_idle_share": idle(busy["step_busy_ms"]),
            "decode_device_ms_per_step": busy["decode_ms"],
            "images_per_s": batch * 1e3 / wall_ms,
            "launches_per_step": sum(k["launches_per_call"]
                                     for k in kernels),
            "port_kernels": ours, "kernels": kernels[:30],
            "decode_kernels": prof["decode_kernels"][:8],
            "streams": prof["streams"], "probe": probed}


def parse_window(spec: str) -> Optional[Tuple[int, int]]:
    """``"start:stop"`` -> (start, stop) step window, or None when empty."""
    if not spec:
        return None
    try:
        a, b = spec.split(":")
        start, stop = int(a), int(b)
    except ValueError:
        raise ValueError(
            f"train.profile_steps must be 'start:stop', got {spec!r}")
    if not 0 <= start < stop:
        raise ValueError(
            f"bad profile window {spec!r}: need 0 <= start < stop")
    return start, stop


class StepTracer:
    """Drives ``torch.profiler`` start and stop at training-step
    boundaries.

    The loop calls ``before(step)`` ahead of dispatching the chunk that
    begins at ``step`` and ``after(step)`` once its step counter has
    advanced past it. ``boundaries()`` feeds the loop's chunk clipper, so
    that no chunk (no run of CUDA graph replays) straddles the window.
    The profiler records the CPU's operators, and on a CUDA ``device`` the
    device's kernels, copies and memsets too; ``after`` drains the device
    before it stops the profiler, so that the window's device work is in
    the trace. ``spans`` (an ``obs.SpanTracer``) gets a ``profiler_trace``
    span that opens before the profiler starts and closes after its trace
    is written: ``obs/trace.py`` anchors the trace on it.
    """

    FILE = "trace.json.gz"

    def __init__(self, train_dir: str, spec: str = "", spans=None,
                 device=None):
        self.window = parse_window(spec)
        self.dir = os.path.join(train_dir, "profile")
        self.device = torch.device(device or "cpu")
        self._spans = spans
        self._prof = None
        self._t0 = None

    def boundaries(self) -> Tuple[int, ...]:
        return self.window or ()

    def before(self, step: int) -> None:
        if (self.window and self._prof is None and
                self.window[0] <= step < self.window[1]):
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._t0 = time.time()
            self._prof = profile(activities=activities)
            self._prof.start()
            log.info("profiler: tracing steps %d..%d into %s",
                     self.window[0], self.window[1], self.dir)

    def _stop(self) -> str:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        prof.stop()
        # Named by the start's UTC time to the microsecond: lexical order
        # is capture order.
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(self._t0))
        capture = os.path.join(
            self.dir, f"{stamp}.{int(self._t0 * 1e6) % 1000000:06d}")
        os.makedirs(capture, exist_ok=True)
        prof.export_chrome_trace(os.path.join(capture, self.FILE))
        if self._spans is not None:
            self._spans.record("profiler_trace", self._t0, time.time(),
                               start_step=self.window[0],
                               stop_step=self.window[1], dir=capture)
        return capture

    def after(self, step: int) -> bool:
        """True when this call closed the window: the device is then
        drained (the loop's device-backlog sampler takes ``step`` as its
        new sync point)."""
        if self._prof is not None and step >= self.window[1]:
            log.info("profiler: trace written to %s", self._stop())
            return True
        return False

    def close(self) -> None:
        if self._prof is not None:  # training ended inside the window
            self._stop()
