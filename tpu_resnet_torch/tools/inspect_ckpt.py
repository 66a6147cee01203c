"""Checkpoint inspector (port of ``tpu_resnet/tools/inspect_ckpt.py``):
list every tensor of a checkpoint, or peek at one, with no model code.

    python -m tpu_resnet_torch inspect --dir /tmp/run [--step N] \
        [--peek params/initial_conv.weight]

Reads the port's format, ``<train_dir>/<step>/state.pt``
(``train/checkpoint.py``), on the CPU. Rows are ``params/<name>``,
``batch_stats/<name>`` and ``opt_state/<name>`` under the model's
``state_dict`` names, and ``step``; the newest complete step is read
unless ``step`` is given.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_resnet_torch.train.checkpoint import STATE_FILE, latest_step_in


def _flatten(tree, prefix: str = "") -> List[Tuple[str, object]]:
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}/{k}" if prefix else k))
    else:
        out.append((prefix, tree))
    return out


def _state_path(train_dir: str, step: Optional[int]) -> Tuple[int, str]:
    train_dir = os.path.abspath(train_dir)
    if step is None:
        step = latest_step_in(train_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {train_dir}")
    path = os.path.join(train_dir, str(int(step)), STATE_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at step {step}: {path}")
    return int(step), path


def restore_raw(train_dir: str, step: Optional[int] = None
                ) -> Tuple[int, Dict]:
    """(step, the checkpoint's dict as saved), its tensors on the CPU."""
    step, path = _state_path(train_dir, step)
    return step, torch.load(path, map_location="cpu", weights_only=True)


def _shape_dtype(leaf) -> Tuple[tuple, str]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    return (), type(leaf).__name__


def list_arrays(train_dir: str, step: Optional[int] = None
                ) -> Tuple[int, List[Tuple[str, tuple, str]]]:
    """(step, [(name, shape, dtype)]) for every entry of the checkpoint."""
    step, tree = restore_raw(train_dir, step)
    return step, [(name, *_shape_dtype(leaf))
                  for name, leaf in _flatten(tree)]


def main(train_dir: str, step: Optional[int] = None,
         peek: Optional[str] = None) -> None:
    step, rows = list_arrays(train_dir, step)
    total = 0
    print(f"checkpoint step {step} in {train_dir}: {len(rows)} arrays")
    for name, shape, dtype in rows:
        total += int(np.prod(shape)) if shape else 1
        print(f"  {name:<70} {str(shape):<20} {dtype}")
    print(f"total elements: {total:,}")
    if peek:
        _, tree = restore_raw(train_dir, step)
        flat = dict(_flatten(tree))
        if peek not in flat:
            matches = [k for k in flat if peek in k]
            raise KeyError(f"{peek!r} not found; close matches: "
                           f"{matches[:5]}")
        arr = torch.as_tensor(flat[peek]).detach().double().numpy()
        dtype = _shape_dtype(flat[peek])[1]
        print(f"\n{peek}: shape={arr.shape} dtype={dtype} "
              f"mean={arr.mean():.6g} std={arr.std():.6g}")
        print(arr.ravel()[:16])
