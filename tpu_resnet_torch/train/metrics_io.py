"""Training metrics: ``metrics.jsonl`` and a throughput meter (port of
``tpu_resnet/train/metrics_io.py`` without its TensorBoard and image
channels)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsWriter:
    """Append-only ``<directory>/metrics.jsonl``: one JSON object per write,
    ``{"step", "wall", <scalars>}``. ``enabled=False`` (a rank that is not
    the primary) writes nothing."""

    def __init__(self, directory: str, enabled: bool = True):
        self.directory = directory
        self._jsonl = None
        if enabled:
            os.makedirs(directory, exist_ok=True)
            self._jsonl = open(os.path.join(directory, "metrics.jsonl"), "a",
                               buffering=1)

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        if self._jsonl is None:
            return
        rec = {"step": int(step), "wall": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        """Idempotent; a write after close is a no-op."""
        if self._jsonl is not None:
            jsonl, self._jsonl = self._jsonl, None
            jsonl.close()


class ThroughputMeter:
    """steps/s and images/s between calls of ``rate``."""

    def __init__(self, global_batch: int):
        self.global_batch = global_batch
        self._t = time.perf_counter()
        self._step: Optional[int] = None

    def rate(self, step: int) -> Optional[Dict[str, float]]:
        now = time.perf_counter()
        out = None
        if self._step is not None and step > self._step and now > self._t:
            sps = (step - self._step) / (now - self._t)
            out = {"steps_per_sec": sps,
                   "images_per_sec": sps * self.global_batch}
        self._t = now
        self._step = step
        return out
