"""Model backends of the predict server (port of
``tpu_resnet/serve/backend.py``), one calling convention:

``ExportBackend``      a frozen ``torch.export`` bundle
                       (``export.save_inference``; the kernels inside the
                       program). No reload; a fixed-batch artifact pins the
                       buckets to its batch.
``CheckpointBackend``  live weights from ``cfg.train.train_dir`` (the
                       port's ``state.pt`` format) with hot-reload:
                       ``maybe_reload()`` polls for a newer step and swaps
                       in a freshly built model, a single reference
                       assignment made between batches. With
                       ``serve.quantize=int8`` every load (the first and
                       each hot-reload) quantizes the weights, with the
                       input scale of ``ensure_calibration``, fixed for
                       the process.

Both expose the reference backend's surface: ``infer``,
``warmup_bucket``, ``warmup``, ``maybe_reload``, ``constrain_buckets``,
``weight_argument_bytes``, ``bind_obs``, ``close``, and ``model_step``,
``num_classes``, ``image_size``, ``quantize``, ``calibration_digest``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Sequence, Tuple

import numpy as np
import torch

from tpu_resnet_torch.models import build_model
from tpu_resnet_torch.ops import quant as quant_lib
from tpu_resnet_torch.serve.infer import make_serve_infer, serve_model
from tpu_resnet_torch.train import checkpoint as ckpt

log = logging.getLogger("tpu_resnet_torch")


class ExportBackend:
    """A frozen bundle (``tpu_resnet_torch export``) on ``device``."""

    def __init__(self, export_dir: str, device: torch.device):
        from tpu_resnet_torch.export import load_inference

        self.device = device
        self._bundle = load_inference(export_dir, device)
        m = self._bundle.manifest
        self.num_classes = int(m["num_classes"])
        self.image_size = int(m["image_size"])
        fixed = m.get("batch_size")
        self.fixed_batch = fixed if isinstance(fixed, int) and fixed > 0 \
            else 0
        step = m.get("step")
        self.model_step = step if isinstance(step, int) else -1
        self.reloads = 0
        # The quantization's provenance travels in the manifest.
        self.quantize = m.get("quantize", "off")
        self.calibration_digest = m.get("calibration_digest", "")
        self._weight_bytes = int(m.get("weight_bytes", 0))

    def weight_argument_bytes(self) -> int:
        """The weights' bytes as the manifest recorded them."""
        return self._weight_bytes

    def bind_obs(self, telemetry=None, spans=None) -> None:
        """No program cache to report to."""

    def constrain_buckets(self, buckets: Sequence[int]) -> Tuple[int, ...]:
        """A fixed-batch artifact takes calls of exactly its batch: one
        bucket. A dynamic-batch artifact serves any bucket set."""
        if self.fixed_batch:
            return (self.fixed_batch,)
        return tuple(buckets)

    def warmup_bucket(self, b: int) -> dict:
        """Run one bucket shape once on the device; the logits must come
        back from it (a program that ran elsewhere raises here, before
        traffic)."""
        t0 = time.monotonic()
        s = self.image_size
        out = self._bundle.logits(np.zeros((int(b), s, s, 3), np.uint8))
        if out.device != self._bundle.device:
            raise RuntimeError(f"the exported program ran on {out.device}, "
                               f"not {self._bundle.device}")
        return {"bucket": int(b), "cache_hit": False,
                "seconds": round(time.monotonic() - t0, 4)}

    def warmup(self, buckets: Sequence[int]) -> None:
        for b in sorted(buckets):
            self.warmup_bucket(b)

    def infer(self, images: np.ndarray) -> np.ndarray:
        return self._bundle(images)

    def maybe_reload(self) -> bool:
        return False

    def close(self) -> None:
        pass


class CheckpointBackend:
    """Live weights from ``cfg.train.train_dir`` with hot-reload."""

    def __init__(self, cfg, device: torch.device):
        self._cfg = cfg
        self.device = device
        self.num_classes = cfg.data.num_classes
        self.image_size = cfg.data.resolved_image_size
        self.fixed_batch = 0
        self.model_step = -1
        self.reloads = 0
        # The int8 arm: the guards first, then load or collect the
        # calibration; its input scale holds for the process, and each
        # load quantizes the new weights with it.
        quant_lib.check_quantize_config(cfg)
        self.quantize = cfg.serve.quantize
        self.calibration_digest = ""
        self._act_max = None
        if self.quantize == "int8":
            from tpu_resnet_torch.serve import calibrate

            record = calibrate.ensure_calibration(cfg, cfg.train.train_dir,
                                                  device=device)
            self._act_max = float(record["act_max"]["input"])
            self.calibration_digest = record["digest"]
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
            model = ckpt.load_state(build_model(self._cfg), ckpt.restore(
                self._cfg.train.train_dir, step))
            # Quantized before the swap: a batch sees one arm's model.
            self._model = serve_model(self._cfg, model, self.device,
                                      act_max=self._act_max)
            self.model_step = int(step)
        self._poller.mark_seen(step)
        log.info("serve: loaded checkpoint step %d (%.2fs)", step,
                 time.monotonic() - t0)
        return True

    def constrain_buckets(self, buckets: Sequence[int]) -> Tuple[int, ...]:
        return tuple(buckets)

    def weight_argument_bytes(self) -> int:
        """Bytes of the weights the served model holds: the float32 state,
        or the int8 arm's tree (about 0.25x); the ``serve_weight_bytes``
        gauge."""
        model = self._model
        return quant_lib.tree_argument_bytes(
            model.qvars() if isinstance(model, quant_lib.QuantizedModel)
            else model.state_dict())

    def bind_obs(self, telemetry=None, spans=None) -> None:
        """No program cache to report to."""

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


def build_backend(cfg, device: torch.device):
    if cfg.serve.backend == "export":
        if not cfg.serve.export_dir:
            raise ValueError("serve.backend=export requires "
                             "serve.export_dir=<frozen artifact dir>")
        return ExportBackend(cfg.serve.export_dir, device)
    if cfg.serve.backend == "checkpoint":
        return CheckpointBackend(cfg, device)
    raise ValueError(f"unknown serve.backend {cfg.serve.backend!r} "
                     f"(checkpoint | export)")
