"""The predict server's model backend: live weights from a train dir.

``CheckpointBackend`` restores the newest checkpoint of
``cfg.train.train_dir`` (the port's ``state.pt`` format) onto the device,
and hot-reloads: ``maybe_reload()`` polls for a newer step and swaps in a
freshly built model, a single reference assignment made between batches.
Its surface is the reference backend's: ``infer``, ``warmup_bucket``,
``warmup``, ``maybe_reload``, ``constrain_buckets``, ``close``,
``model_step``, ``num_classes``, ``image_size``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Sequence, Tuple

import numpy as np
import torch

from tpu_resnet_torch.models import build_model
from tpu_resnet_torch.serve.infer import make_serve_infer
from tpu_resnet_torch.train import checkpoint as ckpt

log = logging.getLogger("tpu_resnet_torch")


class CheckpointBackend:
    """Live weights from ``cfg.train.train_dir`` with hot-reload."""

    def __init__(self, cfg, device: torch.device):
        self._cfg = cfg
        self.device = device
        self.num_classes = cfg.data.num_classes
        self.image_size = cfg.data.resolved_image_size
        self.model_step = -1
        self.reloads = 0
        self._infer_fn = make_serve_infer(cfg, device)
        self._poller = ckpt.CheckpointPoller(cfg.train.train_dir)
        # Serializes a hot-reload swap (batcher thread) against close()
        # (drain path); infer reads the already-swapped _model reference
        # and never takes it.
        self._swap_lock = threading.Lock()
        self._closed = False
        self._model = None
        step = ckpt.latest_step_in(cfg.train.train_dir)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint in {cfg.train.train_dir} — write one first "
                f"(tpu_resnet_torch.train.checkpoint.save)")
        if not self._load(step):
            raise RuntimeError(f"checkpoint step {step} in "
                               f"{cfg.train.train_dir} failed to load")

    def _load(self, step: int) -> bool:
        t0 = time.monotonic()
        with self._swap_lock:
            if self._closed:
                return False
            model = build_model(self._cfg)
            ckpt.load_state(model, ckpt.restore(self._cfg.train.train_dir,
                                                step))
            self._model = model.to(self.device).eval()
            self.model_step = int(step)
        self._poller.mark_seen(step)
        log.info("serve: loaded checkpoint step %d (%.2fs)", step,
                 time.monotonic() - t0)
        return True

    def constrain_buckets(self, buckets: Sequence[int]) -> Tuple[int, ...]:
        return tuple(buckets)

    def warmup_bucket(self, b: int) -> dict:
        """Run one bucket shape once on the device (builds the kernels on
        first use and lets cuDNN pick its algorithms)."""
        t0 = time.monotonic()
        s = self.image_size
        self.infer(np.zeros((int(b), s, s, 3), np.uint8))
        return {"bucket": int(b), "cache_hit": False,
                "seconds": round(time.monotonic() - t0, 4)}

    def warmup(self, buckets: Sequence[int]) -> None:
        for b in sorted(buckets):
            self.warmup_bucket(b)

    def infer(self, images: np.ndarray) -> np.ndarray:
        logits = self._infer_fn(self._model, images)
        return logits.cpu().numpy()

    def maybe_reload(self) -> bool:
        """Poll for a newer checkpoint and swap it in; True on a swap. A
        step that fails to load is marked seen, logged, and skipped."""
        step = self._poller.poll()
        if step is None:
            return False
        try:
            loaded = self._load(step)
        except (OSError, RuntimeError, KeyError) as e:
            log.error("serve: skipping hot-reload to checkpoint step %d "
                      "(%s); still serving step %d", step, e,
                      self.model_step)
            self._poller.mark_seen(step)
            return False
        if loaded:
            self.reloads += 1
        return loaded

    def close(self) -> None:
        """Waits for an in-flight swap, then refuses further ones."""
        with self._swap_lock:
            self._closed = True


def build_backend(cfg, device: torch.device) -> CheckpointBackend:
    if cfg.serve.backend == "checkpoint":
        return CheckpointBackend(cfg, device)
    if cfg.serve.backend == "export":
        raise NotImplementedError("serve.backend=export (frozen artifacts) "
                                  "is a later slice of the port")
    raise ValueError(f"unknown serve.backend {cfg.serve.backend!r} "
                     f"(checkpoint | export)")
