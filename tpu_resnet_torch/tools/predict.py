"""Predictions of a frozen artifact over the eval split (port of
``tpu_resnet/tools/predict.py``): the precision, ``predictions.json`` and a
``mispredictions.png`` grid (red border: wrong, green: right) in the output
directory. The PNG is written by a small encoder here (``zlib``), since the
card's machine has no PIL.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Optional

import numpy as np

CIFAR10_LABELS = ["airplane", "automobile", "bird", "cat", "deer",
                  "dog", "frog", "horse", "ship", "truck"]


def load_label_map(cfg, label_file: str = "") -> list:
    """Class names by index: from an ``imagenet1000_clsidx_to_labels.txt``
    style file (``{0: 'name, synonym',`` ... ``999: 'name'}``), CIFAR-10's
    names, or the indices."""
    if label_file:
        names = {}
        with open(label_file) as f:
            for line in f:
                line = line.strip().rstrip(",")
                if ":" in line:
                    idx, name = line.split(":", 1)
                    name = name.strip().rstrip("}").strip().strip("'\"")
                    names[int(idx.strip(" {"))] = name
        return [names.get(i, str(i)) for i in range(cfg.data.num_classes)]
    if cfg.data.dataset == "cifar10":
        return CIFAR10_LABELS
    return [str(i) for i in range(cfg.data.num_classes)]


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``rgb`` [H,W,3] uint8."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),   # filter 0 a row
                           np.ascontiguousarray(rgb, np.uint8).reshape(h, -1)],
                          axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def misprediction_grid(images: np.ndarray, labels: np.ndarray,
                       preds: np.ndarray, path: str, max_images: int = 64,
                       label_names: Optional[list] = None) -> None:
    """A PNG grid of 8 columns; a mispredicted image gets a red border, a
    right one green (the reference's grid, cell for cell)."""
    n = min(len(images), max_images)
    cols = 8
    rows = (n + cols - 1) // cols
    cell = images.shape[1] + 6
    canvas = np.full((rows * cell, cols * cell, 3), 255, np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        y, x = r * cell, c * cell
        color = (220, 20, 20) if preds[i] != labels[i] else (20, 160, 20)
        canvas[y:y + cell, x:x + cell] = color
        canvas[y + 3:y + cell - 3, x + 3:x + cell - 3] = images[i]
    write_png(path, canvas)


def predict_from_export(cfg, export_dir: str, out_dir: str,
                        num_examples: int = 256, label_file: str = "",
                        device=None) -> float:
    """A frozen artifact over the first ``num_examples`` of the eval split,
    on ``device`` (CUDA unless ``"cpu"``); returns the precision."""
    import torch

    from tpu_resnet_torch import data as data_lib
    from tpu_resnet_torch.device import resolve_device
    from tpu_resnet_torch.export import load_inference

    device = resolve_device(device)
    bundle = load_inference(export_dir, device)
    names = load_label_map(cfg, label_file)
    os.makedirs(out_dir, exist_ok=True)
    # A fixed-batch artifact takes calls of exactly its batch: the split
    # comes in chunks of that size (its last one zero-padded, labels -1).
    fixed = bundle.manifest.get("batch_size")
    fixed = fixed if isinstance(fixed, int) and fixed > 0 else 0
    chunk = fixed or min(64, num_examples)

    all_images, all_labels, all_preds = [], [], []
    seen = 0
    it = data_lib.eval_split_batches(cfg.data, chunk, device=device)
    try:
        for images, labels in it:
            preds = bundle.predict(images)
            images = torch.as_tensor(images).cpu().numpy()
            labels = torch.as_tensor(labels).cpu().numpy()
            valid = labels >= 0
            all_images.append(images[valid])
            all_labels.append(labels[valid])
            all_preds.append(preds[valid])
            seen += int(valid.sum())
            if seen >= num_examples:
                break
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    images = np.concatenate(all_images)[:num_examples]
    labels = np.concatenate(all_labels)[:num_examples]
    preds = np.concatenate(all_preds)[:num_examples]

    precision = float((preds == labels).mean())
    wrong = np.flatnonzero(preds != labels)
    results = {
        "precision": precision,
        "num_examples": int(len(labels)),
        "mispredicted": [
            {"index": int(i), "label": names[labels[i]],
             "pred": names[preds[i]]} for i in wrong[:100]
        ],
    }
    with open(os.path.join(out_dir, "predictions.json"), "w") as f:
        json.dump(results, f, indent=2)
    misprediction_grid(images, labels, preds,
                       os.path.join(out_dir, "mispredictions.png"),
                       label_names=names)
    print(f"precision over {len(labels)} examples: {precision:.4f} "
          f"({len(wrong)} mispredicted)")
    print(f"wrote {out_dir}/predictions.json and mispredictions.png")
    return precision
