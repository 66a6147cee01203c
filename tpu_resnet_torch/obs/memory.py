"""Device memory: the train step's ledger, live gauges and OOM forensics
(port of ``tpu_resnet/obs/memory.py``).

``MemoryLedger``          one entry a program key (the FLOPs registry's
                          spelling) in ``<train_dir>/memory.json``. The
                          reference reads a compiled program's
                          ``memory_analysis``; the port measures one
                          dispatch instead: ``torch.cuda.
                          reset_peak_memory_stats`` before it,
                          ``max_memory_allocated`` after it, split into
                          parameter bytes, optimizer-state bytes and the
                          dispatch's transient peak. The measured dispatch
                          is the run's first chunk, where a graphed run
                          warms up and captures its step: the graph's
                          private pool is allocated there, so it counts.
``sample_device_memory``  live gauges from ``torch.cuda.memory_stats`` (the
                          caching allocator's host-side counters: no
                          device sync) at log boundaries; ``{}`` on the
                          CPU, where the gauges stay at their zeros.
``write_oom_report``      ``<train_dir>/oom_report.json`` on an out-of-memory
                          error: the ledger, the recent samples, a census
                          of the live tensors and the allocator's stats,
                          in the reference's schema
                          (``validate_oom_report``).
"""

from __future__ import annotations

import collections
import gc
import json
import logging
import os
import time
import warnings
from typing import Dict, List, Optional

log = logging.getLogger("tpu_resnet_torch")

LEDGER_FILE = "memory.json"
OOM_REPORT_FILE = "oom_report.json"
# The status the reference's readers key on (XLA's out-of-memory status).
OOM_STATUS = "RESOURCE_EXHAUSTED"


def _cuda(device) -> bool:
    import torch

    return device is not None and torch.device(device).type == "cuda"


def device_limit_bytes(device) -> Optional[int]:
    """The card's memory (``total_memory``); None off CUDA."""
    import torch

    if not _cuda(device):
        return None
    return int(torch.cuda.get_device_properties(
        torch.device(device)).total_memory)


class MemoryLedger:
    """Per-program memory entries, persisted as ``<train_dir>/memory.json``
    (the reference's format)."""

    def __init__(self):
        self._entries: Dict[str, dict] = {}

    def register(self, key: str, budget: Optional[dict], **extra) -> dict:
        entry = dict(budget) if budget else {"budget_source": "none"}
        if budget:
            entry["budget_source"] = "torch_cuda_allocator"
        entry.update(extra)
        self._entries[key] = entry
        return entry

    def get(self, key: str) -> Optional[dict]:
        return self._entries.get(key)

    def keys(self) -> List[str]:
        return sorted(self._entries)

    def to_dict(self) -> dict:
        return {"format": 1, "entries": dict(self._entries)}

    def save(self, train_dir: str) -> Optional[str]:
        """Atomic ``<train_dir>/memory.json``."""
        try:
            os.makedirs(train_dir, exist_ok=True)
            path = os.path.join(train_dir, LEDGER_FILE)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self.to_dict(), f, indent=1)
            os.replace(tmp, path)
            return path
        except OSError as e:
            log.warning("could not write %s: %s", LEDGER_FILE, e)
            return None

    @classmethod
    def load(cls, train_dir: str) -> "MemoryLedger":
        ledger = cls()
        try:
            with open(os.path.join(train_dir, LEDGER_FILE)) as f:
                payload = json.load(f)
            ledger._entries.update(payload.get("entries", {}))
        except (OSError, ValueError):
            pass
        return ledger


def start_dispatch_measure(device) -> Optional[int]:
    """Before the measured dispatch: reset the allocator's peak and return
    the bytes allocated now (None off CUDA)."""
    import torch

    if not _cuda(device):
        return None
    torch.cuda.reset_peak_memory_stats(device)
    return int(torch.cuda.memory_allocated(device))


def state_bytes(state) -> Dict[str, int]:
    """Parameter, BN-statistic and optimizer-state (momentum) bytes of a
    ``TrainState`` on this rank (under zero1 its momentum shards)."""
    def nbytes(tensors):
        return int(sum(t.numel() * t.element_size() for t in tensors))

    return {"params_bytes": nbytes(state.model.parameters()),
            "batch_stats_bytes": nbytes(state.model.buffers()),
            "opt_state_bytes": nbytes(
                state.momentum_buffers(local=True).values())}


def account_train_step(cfg, state, device, baseline_bytes: Optional[int],
                       dispatch: str,
                       ledger: Optional[MemoryLedger] = None,
                       train_dir: Optional[str] = None) -> dict:
    """Register the measured dispatch (``start_dispatch_measure`` before
    it; call after it has finished): its peak, the bytes allocated before
    it, its transient peak (peak − before), and the state's parts. Off
    CUDA the entry has the state's parts only (``budget_source: none``)."""
    import torch

    from tpu_resnet_torch.obs.mfu import device_kind, train_program_key

    ledger = ledger if ledger is not None else MemoryLedger()
    key = train_program_key(cfg)
    budget = None
    if _cuda(device) and baseline_bytes is not None:
        peak = int(torch.cuda.max_memory_allocated(device))
        budget = {"peak_bytes": peak, "baseline_bytes": baseline_bytes,
                  "transient_peak_bytes": peak - baseline_bytes}
    entry = ledger.register(
        key, budget, program_key=key, program=dispatch,
        global_batch=cfg.train.global_batch_size,
        device_kind=device_kind(device), n_devices=1,
        hbm_bytes_per_chip=device_limit_bytes(device), **state_bytes(state))
    if train_dir:
        ledger.save(train_dir)
    return entry


# ------------------------------------------------------------ live gauges
def sample_device_memory(device=None) -> Dict[str, float]:
    """One live sample of ``device`` (host-side allocator counters, no
    sync): ``hbm_bytes_in_use`` (allocated now), ``hbm_bytes_peak`` (the
    allocator's peak since its last reset), ``hbm_bytes_limit`` (the
    card's memory) and ``hbm_utilization``; ``{}`` off CUDA."""
    import torch

    if not _cuda(device):
        return {}
    stats = torch.cuda.memory_stats(device)
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    peak = int(stats.get("allocated_bytes.all.peak", in_use))
    limit = device_limit_bytes(device)
    return {"hbm_bytes_in_use": float(in_use),
            "hbm_bytes_peak": float(peak),
            "hbm_bytes_limit": float(limit),
            "hbm_utilization": round(in_use / limit, 4)}


def device_memory_detail(device=None) -> List[dict]:
    """The allocator's numeric stats of ``device`` (``stats: null`` off
    CUDA): the OOM report's device section."""
    import torch

    if not _cuda(device):
        return [{"id": -1, "device_kind": "cpu", "stats": None}]
    device = torch.device(device)
    stats = torch.cuda.memory_stats(device)
    return [{"id": device.index if device.index is not None
             else torch.cuda.current_device(),
             "device_kind": torch.cuda.get_device_name(device),
             "stats": {k: int(v) for k, v in stats.items()
                       if isinstance(v, (int, float))}}]


class MemorySampleRing:
    """The last ``capacity`` (wall, step, gauges) samples, so that an OOM
    report shows the minutes before the failure."""

    def __init__(self, capacity: int = 32):
        self._ring = collections.deque(maxlen=max(1, int(capacity)))

    def add(self, step: int, sample: Dict[str, float]) -> None:
        if sample:
            self._ring.append({"wall": round(time.time(), 3),
                               "step": int(step), **sample})

    def snapshot(self) -> List[dict]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)


# ------------------------------------------------------------ OOM forensics
def is_oom_error(exc) -> bool:
    """True for ``torch.cuda.OutOfMemoryError`` and for an error carrying
    the ``RESOURCE_EXHAUSTED`` status (the fault injector's synthetic
    OOM)."""
    if exc is None:
        return False
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return (OOM_STATUS in str(exc)
            and isinstance(exc, (RuntimeError, MemoryError)))


def live_array_census(max_buckets: int = 50) -> dict:
    """The live tensors the garbage collector tracks, bucketed by (shape,
    dtype, device): count and bytes, largest first, at most
    ``max_buckets`` buckets (the dropped count is reported)."""
    import torch

    buckets: Dict[tuple, dict] = {}
    total_bytes = 0
    try:
        objects = gc.get_objects()
    except Exception as e:  # noqa: BLE001 - forensics must never raise
        return {"error": f"{type(e).__name__}: {e}", "buckets": [],
                "total_arrays": 0, "total_bytes": 0}
    with warnings.catch_warnings():  # deprecated proxies warn on isinstance
        warnings.simplefilter("ignore")
        tensors = [o for o in objects if isinstance(o, torch.Tensor)]
    for obj in tensors:
        try:
            if obj.is_meta:
                continue
            shape = tuple(int(s) for s in obj.shape)
            dtype = str(obj.dtype)
            device = str(obj.device)
            nbytes = int(obj.numel() * obj.element_size())
        except Exception:  # noqa: BLE001 - a freed or exotic object
            continue
        key = (shape, dtype, device)
        b = buckets.setdefault(key, {"shape": list(shape), "dtype": dtype,
                                     "device": device, "count": 0,
                                     "bytes": 0})
        b["count"] += 1
        b["bytes"] += nbytes
        total_bytes += nbytes
    ranked = sorted(buckets.values(),
                    key=lambda b: (-b["bytes"], -b["count"],
                                   b["dtype"], b["shape"]))
    return {"buckets": ranked[:max_buckets],
            "dropped_buckets": max(0, len(ranked) - max_buckets),
            "total_arrays": sum(b["count"] for b in ranked),
            "total_bytes": total_bytes}


def write_oom_report(train_dir: str, error, context: str = "train",
                     step: Optional[int] = None,
                     program_key: Optional[str] = None,
                     ledger: Optional[MemoryLedger] = None,
                     samples: Optional[List[dict]] = None,
                     run_id: Optional[str] = None,
                     device=None) -> Optional[str]:
    """Write ``<train_dir>/oom_report.json`` for an out-of-memory error:
    the error (its message prefixed with ``RESOURCE_EXHAUSTED`` where it
    lacks it, as the reference's readers expect), the program key, the
    ledger, the recent samples, a live-tensor census and the allocator's
    stats. Never raises (forensics must not mask the error); returns the
    path or None."""
    try:
        message = str(error)
        if OOM_STATUS not in message:
            message = f"{OOM_STATUS}: {message}"
        report = {
            "format": 1,
            "written_at": time.time(),
            "context": str(context),
            "step": int(step) if step is not None else None,
            "run_id": run_id,
            "error": {"type": type(error).__name__,
                      "message": message[:4000]},
            "program_key": program_key,
            "ledger": (ledger.to_dict().get("entries", {})
                       if ledger is not None else
                       MemoryLedger.load(train_dir).to_dict()["entries"]),
            "memory_samples": list(samples or []),
            "live_arrays": live_array_census(),
            "devices": device_memory_detail(device),
        }
        os.makedirs(train_dir, exist_ok=True)
        path = os.path.join(train_dir, OOM_REPORT_FILE)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp, path)
        log.error("out of memory: forensics written to %s (program %s, %d "
                  "live-tensor buckets)", path, program_key,
                  len(report["live_arrays"]["buckets"]))
        return path
    except Exception as e:  # noqa: BLE001 - never mask the real failure
        log.warning("could not write %s: %s", OOM_REPORT_FILE, e)
        return None


def validate_oom_report(report: dict) -> List[str]:
    """Schema check of an ``oom_report.json`` payload (the reference's
    rules); returns the problems (empty = valid)."""
    problems: List[str] = []
    if not isinstance(report, dict):
        return ["report is not a JSON object"]
    for key, types in (("format", int), ("written_at", (int, float)),
                       ("context", str), ("error", dict),
                       ("ledger", dict), ("memory_samples", list),
                       ("live_arrays", dict), ("devices", list)):
        if key not in report:
            problems.append(f"missing required key {key!r}")
        elif not isinstance(report[key], types):
            problems.append(f"{key!r} has wrong type "
                            f"{type(report[key]).__name__}")
    err = report.get("error")
    if isinstance(err, dict):
        if not err.get("type") or not err.get("message"):
            problems.append("error must carry type and message")
        elif OOM_STATUS not in err["message"]:
            problems.append("error.message does not mention "
                            "RESOURCE_EXHAUSTED")
    census = report.get("live_arrays")
    if isinstance(census, dict):
        for key in ("buckets", "total_arrays", "total_bytes"):
            if key not in census:
                problems.append(f"live_arrays missing {key!r}")
        for i, b in enumerate(census.get("buckets", [])):
            if not isinstance(b, dict) or not {"shape", "dtype", "count",
                                               "bytes"} <= set(b):
                problems.append(f"live_arrays.buckets[{i}] malformed")
                break
    for i, s in enumerate(report.get("memory_samples", [])):
        if not isinstance(s, dict) or "wall" not in s or "step" not in s:
            problems.append(f"memory_samples[{i}] malformed")
            break
    return problems
