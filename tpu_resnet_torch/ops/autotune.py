"""Per-(op, shape) timed A/B between a kernel and its plain version (port
of ``tpu_resnet/ops/autotune.py``).

``probe(op, key, kernel_fn, plain_fn, args)`` times both arms of the same
math on the same inputs and records a :class:`Decision`; a kernel stays
chosen only where ``speedup = plain_us / kernel_us >= threshold`` (1.0 by
default), as the reference decides (its comment says ties go to the plain
arm; its code, and so this one, keeps the kernel on an exact tie). Call
sites dispatch with :func:`use_kernel`, a dict lookup that gives
``default`` (False: the plain arm) for a shape nobody probed. The decisions persist as
``<train_dir>/autotune.json`` in the reference's format (``format: 1``,
fields ``pallas_us``, ``xla_us``, ``speedup``, ``use_pallas``, ``error``),
so each package can :func:`load` the other's file; ``pallas_us`` is the
port's kernel arm and ``xla_us`` its plain arm.

Timing: on the card, one warm-up call, then CUDA events around ``iters``
back-to-back calls, divided by ``iters``; on the CPU, ``perf_counter`` the
same way. Each arm is timed as the caller hands it over (the train step
times value and gradient). On the card the calls are queued behind a
device spin that outlasts the host's enqueue of them (checked with a
third event, and lengthened until it does), so the events time the device
alone, as the reference's one-dispatch ``lax.scan`` loop does: timed with
the host's launch gaps, both arms of every probe shape of the CIFAR and
ImageNet ResNet-50 took 0.8–1.7 ms per call on an NVIDIA H100 80GB HBM3
at 700 W (PERF.md §6), and the choice fell on noise.

Inside a CUDA graph capture (the loop's graphed train step) nothing may
be timed and no choice may be frozen that no probe made: a probe, or a
dispatch on a shape no probe covered, raises :class:`UnprobedUnderCapture`.

One departure from the reference: there, a kernel candidate that fails to
compile or run is recorded as a plain-arm decision and training goes on.
Here it raises. A kernel that does not build or launch is a fault to see,
not a timing to record, and no fallback hides it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

log = logging.getLogger("tpu_resnet_torch")

AUTOTUNE_FILE = "autotune.json"
DEFAULT_THRESHOLD = 1.0


@dataclasses.dataclass
class Decision:
    """One probed (op, shape): both arms' times and the verdict."""

    op: str
    key: str
    pallas_us: float        # the kernel arm, in the reference's field name
    xla_us: float           # the plain arm
    speedup: float          # xla_us / pallas_us; > 1 means the kernel wins
    use_pallas: bool
    error: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_lock = threading.Lock()
_decisions: Dict[Tuple[str, str], Decision] = {}


def shape_key(*dims) -> str:
    """Canonical shape-key spelling, e.g. ``128x1000``: the reference's
    ``programs.spell_shape``."""
    return "x".join(str(int(d)) for d in dims)


def decision(op: str, key: str) -> Optional[Decision]:
    with _lock:
        return _decisions.get((op, key))


def decisions() -> Dict[str, dict]:
    """Every decision, keyed ``op|key`` (the persisted form)."""
    with _lock:
        return {f"{op}|{key}": d.to_dict()
                for (op, key), d in sorted(_decisions.items())}


def reset() -> None:
    """Drop every decision."""
    with _lock:
        _decisions.clear()


def capturing() -> bool:
    """True while this thread's current CUDA stream is capturing a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


class UnprobedUnderCapture(RuntimeError):
    """An ``auto`` dispatch met a shape no probe covered while a CUDA graph
    was being captured: a probe cannot be timed inside a capture, and a
    graph must not freeze a choice nobody made."""


def use_kernel(op: str, key: str, default: bool = False) -> bool:
    """True only where a probe chose the kernel for (op, key); an unprobed
    shape takes ``default``, and raises :class:`UnprobedUnderCapture`
    inside a CUDA graph capture."""
    d = decision(op, key)
    if d is None:
        if capturing():
            raise UnprobedUnderCapture(
                f"autotune: no probe covered {op}[{key}] before the train "
                f"step was captured; probe it first (the loop probes every "
                f"shape of the configured model), or run "
                f"train.steps_per_call=1")
        return default
    return d.use_pallas


def _record(d: Decision) -> Decision:
    with _lock:
        _decisions[(d.op, d.key)] = d
    return d


def _on_cuda(args: tuple) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


# Device spin before the timed calls: cycles per second of host enqueue
# time (a 2 GHz clock, with a factor of 2 to spare), its bounds, and how
# many timings are tried before one whose spin outlasted the host's
# enqueue is given up on.
SPIN_CYCLES_PER_S = 4e9
SPIN_CYCLES = (2_000_000, 4_000_000_000)
SPIN_ATTEMPTS = 3


def timed_us(fn: Callable, args: tuple, iters: int) -> Tuple[float, bool]:
    """Mean microseconds per call of ``fn(*args)`` over ``iters`` calls
    back to back, after one warm-up call, and whether the time is
    host-paced. On the card the calls queue behind a device spin sized from
    the warm-up call's host time; a spin that ended before the host had
    enqueued the last call (the events then took in the host's gaps) is
    lengthened and the timing repeated. If no attempt's spin held, the last
    time is returned with ``True``: it is the host's pace, not the
    device's. On the CPU the time is the host's and the flag False."""
    t0 = time.perf_counter()
    fn(*args)
    enqueue_s = time.perf_counter() - t0
    if not _on_cuda(args):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) * 1e6 / iters, False
    lo, hi = SPIN_CYCLES
    cycles = iters * enqueue_s * SPIN_CYCLES_PER_S
    host_paced = True
    for _ in range(SPIN_ATTEMPTS):
        cycles = min(max(cycles, lo), hi)
        spin, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        torch.cuda.synchronize()
        spin.record()
        torch.cuda._sleep(int(cycles))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        spin_ms = spin.elapsed_time(start)
        if enqueue_ms < spin_ms:
            host_paced = False
            break
        cycles *= 2 * enqueue_ms / max(spin_ms, 1e-3)
    if host_paced:
        log.warning("autotune: %d calls took %.1f ms to enqueue, longer than "
                    "the spin (%.1f ms); timed with the host's gaps", iters,
                    enqueue_ms, spin_ms)
    return start.elapsed_time(end) * 1e3 / iters, host_paced


def _timed_us(fn: Callable, args: tuple, iters: int) -> float:
    """:func:`timed_us`'s time alone (the probe's timer)."""
    return timed_us(fn, args, iters)[0]


def probe(op: str, key: str, kernel_fn: Callable, plain_fn: Callable,
          args: tuple, iters: int = 50, threshold: float = DEFAULT_THRESHOLD,
          force: bool = False) -> Decision:
    """Time both arms on the same ``args`` and record the verdict, taken
    on the recorded (4-digit) speedup so that every record satisfies
    ``use_pallas == (speedup >= threshold)``. A recorded (op, key) is
    returned as it is unless ``force``. An error in ``kernel_fn``
    propagates (no fallback decision)."""
    existing = decision(op, key)
    if existing is not None and not force:
        return existing
    if capturing():
        raise UnprobedUnderCapture(
            f"autotune: a timed probe of {op}[{key}] was asked for inside a "
            f"CUDA graph capture")
    plain_us = _timed_us(plain_fn, args, iters)
    kernel_us = _timed_us(kernel_fn, args, iters)
    speedup = round(plain_us / kernel_us, 4) if kernel_us > 0 else 0.0
    d = _record(Decision(op, key, round(kernel_us, 3), round(plain_us, 3),
                         speedup, speedup >= threshold))
    log.info("autotune %s[%s]: kernel %.1fus vs plain %.1fus (%.3fx) -> %s",
             op, key, d.pallas_us, d.xla_us, d.speedup,
             "kernel" if d.use_pallas else "plain")
    return d


def dump(train_dir: str) -> Optional[str]:
    """Write the decisions to ``<train_dir>/autotune.json`` (atomic
    rename); returns the path, or None without a train dir."""
    if not train_dir:
        return None
    os.makedirs(train_dir, exist_ok=True)
    path = os.path.join(train_dir, AUTOTUNE_FILE)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"format": 1, "decisions": decisions()}, f, indent=1)
    os.replace(tmp, path)
    return path


def load(path: str) -> int:
    """Add the decisions of a dumped file (either package's); returns how
    many loaded. An unreadable file loads none, a malformed entry is
    skipped."""
    try:
        with open(path) as f:
            entries = json.load(f).get("decisions", {})
    except (OSError, ValueError, AttributeError):
        return 0
    return install(entries)


def install(entries: Dict[str, dict]) -> int:
    """Add decisions in :func:`decisions`' form (the ranks of a run take
    rank 0's); returns how many; a malformed entry is skipped."""
    n = 0
    for joint, rec in entries.items():
        op, _, key = joint.partition("|")
        try:
            _record(Decision(op, key, float(rec["pallas_us"]),
                             float(rec["xla_us"]), float(rec["speedup"]),
                             bool(rec["use_pallas"]), rec.get("error")))
        except (KeyError, TypeError, ValueError):
            continue
        n += 1
    return n
