"""CIFAR-10/100 binary-format readers and synthetic data (port of
``tpu_resnet/data/cifar.py``; numpy only, the native reader is not ported).

Formats:
- cifar10: records of 1 label byte + 3072 image bytes (depth-major
  3×32×32), files ``cifar-10-batches-bin/data_batch_{1..5}.bin`` and
  ``test_batch.bin``;
- cifar100: records of 1 coarse + 1 fine label byte + 3072 image bytes, the
  fine label read; files ``cifar-100-binary/train.bin``, ``test.bin``.

The whole split is loaded into host memory once as uint8 NHWC.
``synthetic_data`` reproduces the reference's seeded stand-in bit for bit.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

_IMAGE_BYTES = 32 * 32 * 3


def _decode_records(raw: np.ndarray, label_offset: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """raw uint8 [N, record_bytes] → (images NHWC uint8, labels int32)."""
    labels = raw[:, label_offset].astype(np.int32)
    images = raw[:, label_offset + 1:label_offset + 1 + _IMAGE_BYTES]
    images = images.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(images), labels


def _read_files(files: List[str], record_bytes: int) -> np.ndarray:
    parts = []
    for f in files:
        buf = np.fromfile(f, dtype=np.uint8)
        if buf.size % record_bytes:
            raise ValueError(f"{f}: size {buf.size} not a multiple of "
                             f"record_bytes {record_bytes}")
        parts.append(buf.reshape(-1, record_bytes))
    return np.concatenate(parts)


def cifar_files(dataset: str, data_dir: str, train: bool) -> List[str]:
    if dataset == "cifar10":
        d = os.path.join(data_dir, "cifar-10-batches-bin")
        if not os.path.isdir(d):
            d = data_dir
        names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else ["test_batch.bin"])
    elif dataset == "cifar100":
        d = os.path.join(data_dir, "cifar-100-binary")
        if not os.path.isdir(d):
            d = data_dir
        names = ["train.bin"] if train else ["test.bin"]
    else:
        raise ValueError(f"not a cifar dataset: {dataset}")
    files = [os.path.join(d, n) for n in names]
    missing = [f for f in files if not os.path.exists(f)]
    if missing:
        raise FileNotFoundError(f"missing CIFAR files: {missing}")
    return files


def load_cifar(dataset: str, data_dir: str,
               train: bool) -> Tuple[np.ndarray, np.ndarray]:
    label_offset = 1 if dataset == "cifar100" else 0
    record_bytes = 1 + label_offset + _IMAGE_BYTES
    return _decode_records(
        _read_files(cifar_files(dataset, data_dir, train), record_bytes),
        label_offset)


def synthetic_data(num_examples: int, image_size: int = 32,
                   num_classes: int = 10, seed: int = 0,
                   learnable: bool = False, task: str = "bands",
                   label_noise: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic random images, the reference's stand-in for CIFAR.
    ``learnable=True`` derives labels from image content: ``bands`` (which
    horizontal band is brightened) or ``freq100`` (the spatial-frequency
    pair of a low-contrast sinusoid with random phase over noise, up to 100
    classes, with ``label_noise`` of the labels resampled)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (num_examples, image_size, image_size, 3),
                          dtype=np.uint8)
    labels = rng.integers(0, num_classes, (num_examples,), dtype=np.int32)
    if learnable and task == "bands":
        if num_classes > image_size:
            raise ValueError(f"bands task needs num_classes "
                             f"({num_classes}) <= image_size "
                             f"({image_size}) for distinct bands")
        band = max(1, image_size // num_classes)
        for i, lab in enumerate(labels):
            y0 = int(lab) * band
            sl = images[i, y0:y0 + band]
            images[i, y0:y0 + band] = np.minimum(
                sl.astype(np.int32) + 120, 255).astype(np.uint8)
    elif learnable and task == "freq100":
        if num_classes > 100:
            raise ValueError(f"freq100 task supports <= 100 classes, "
                             f"got {num_classes}")
        max_f = max(((num_classes - 1) // 10) + 1,
                    min(num_classes, 10))
        if image_size < 2 * max_f + 1:
            raise ValueError(
                f"freq100 with {num_classes} classes uses frequencies up "
                f"to {max_f} cycles; image_size {image_size} aliases them "
                f"(needs >= {2 * max_f + 1})")
        amp = 30.0
        grid = np.arange(image_size, dtype=np.float64)
        for i, lab in enumerate(labels):
            fy, fx = divmod(int(lab), 10)
            py, px = rng.uniform(0, 2 * np.pi, 2)
            wave = (np.sin(2 * np.pi * (fy + 1) * grid / image_size + py)
                    [:, None]
                    + np.sin(2 * np.pi * (fx + 1) * grid / image_size + px)
                    [None, :])
            images[i] = np.clip(images[i].astype(np.float64)
                                + amp * wave[..., None], 0, 255
                                ).astype(np.uint8)
        if label_noise > 0:
            n_noise = int(round(label_noise * num_examples))
            idx = rng.choice(num_examples, n_noise, replace=False)
            labels[idx] = rng.integers(0, num_classes, n_noise,
                                       dtype=np.int32)
    elif learnable:
        raise ValueError(f"unknown synthetic task {task!r}")
    return images, labels


def load_split(cfg, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The in-memory split of a DataConfig (cifar10, cifar100, synthetic)."""
    if cfg.dataset in ("cifar10", "cifar100"):
        return load_cifar(cfg.dataset, cfg.data_dir, train)
    if cfg.dataset == "synthetic":
        n = cfg.train_examples if train else cfg.eval_examples
        return synthetic_data(n, cfg.resolved_image_size, cfg.num_classes,
                              seed=0 if train else 1,
                              learnable=cfg.synthetic_learnable,
                              task=cfg.synthetic_task,
                              label_noise=(cfg.synthetic_label_noise
                                           if train else 0.0))
    raise ValueError(f"load_split does not handle {cfg.dataset!r}")
