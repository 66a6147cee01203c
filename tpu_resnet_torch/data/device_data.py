"""Device-resident training split (port of ``tpu_resnet/data/device_data.py``).

An in-memory split small enough to keep twice on the device (the flat
split and one shuffled epoch) is copied there once, as uint8, and every
batch is cut on the device: no per-step host-to-device copy of images.

The order is the reference's: epoch ``e`` is
``jax.random.permutation(fold_in(PRNGKey(seed), e), n)`` cut to
``steps_per_epoch · B`` indices, computed on the host with
``data/prng.py``'s numpy copy of ``jax.random`` (a few ms for n = 50 000)
and applied with one ``index_select`` per epoch on the device. Step ``s``
takes slice ``s % steps_per_epoch`` of epoch ``s // steps_per_epoch``, so
a run resumed at any step gets the batch the uninterrupted run got.

One step per call: the reference's ``train.steps_per_call`` chunking is not
ported (the train loop lists it among the knobs it ignores).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpu_resnet_torch.data import prng

RESIDENT_DATASETS = ("cifar10", "cifar100", "synthetic")


def should_use(data_cfg) -> bool:
    """True when the resident path applies: policy ``on``/``auto``, an
    in-memory dataset, and a split small enough for double residency (flat
    split + epoch buffer) under ``data.resident_max_bytes``. Policy ``on``
    raises where the path is impossible rather than silently streaming.
    The port runs one process, so the reference's multi-process refusal
    never applies."""
    policy = getattr(data_cfg, "device_resident", "auto")
    if policy == "off":
        return False
    forced = policy == "on"
    if data_cfg.dataset not in RESIDENT_DATASETS:
        if forced:
            raise ValueError(
                f"data.device_resident=on is unsupported for dataset "
                f"{data_cfg.dataset!r} (streams from TFRecord shards)")
        return False
    size = data_cfg.resolved_image_size
    nbytes = 2 * data_cfg.train_examples * size * size * 3
    return forced or nbytes <= data_cfg.resident_max_bytes


class DeviceDataset:
    """A training split resident on ``device`` with the reference's
    per-epoch order."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch: int,
                 device: torch.device, seed: int = 0):
        n = len(images)
        if n < batch:  # tile tiny (smoke/synthetic) splits up to one batch
            reps = -(-batch // n)
            images = np.concatenate([images] * reps)
            labels = np.concatenate([labels] * reps)
            n = len(images)
        self.n = n
        self.batch = batch
        self.steps_per_epoch = n // batch
        self.seed = seed
        self.device = torch.device(device)
        self._images = torch.from_numpy(np.ascontiguousarray(images)).to(
            self.device)
        self._labels = torch.from_numpy(labels.astype(np.int32)).to(
            self.device)
        self._epoch: Optional[int] = None
        self.images = self.labels = None

    def order(self, epoch: int) -> np.ndarray:
        """Epoch ``epoch``'s indices into the split, int32
        [steps_per_epoch · batch]."""
        key = prng.fold_in(prng.prng_key(self.seed), epoch)
        return prng.permutation(key, self.n)[:self.steps_per_epoch
                                             * self.batch]

    def ensure_epoch(self, epoch: int) -> None:
        """(Re)build the shuffled epoch buffer if ``epoch`` changed."""
        if epoch != self._epoch:
            idx = torch.from_numpy(self.order(epoch).astype(np.int64)).to(
                self.device)
            self.images = self._images.index_select(0, idx)
            self.labels = self._labels.index_select(0, idx)
            self._epoch = epoch

    def batch_at(self, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Step ``step``'s (uint8 images [B,H,W,3], int32 labels [B]) on
        the device: views into the epoch buffer."""
        self.ensure_epoch(step // self.steps_per_epoch)
        lo = (step % self.steps_per_epoch) * self.batch
        return (self.images[lo:lo + self.batch],
                self.labels[lo:lo + self.batch])
