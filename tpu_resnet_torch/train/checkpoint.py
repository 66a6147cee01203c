"""The port's checkpoint format: ``<train_dir>/<step>/state.pt``.

One file per step, holding ``{"params": {name: tensor}, "batch_stats":
{name: tensor}, "step": int}`` with the model's ``state_dict`` names
(parameters under ``params``, BN running statistics under
``batch_stats``), all on the CPU. A save writes a temporary file in the
step directory and renames it, so a reader sees a whole file or none;
only step directories that hold ``state.pt`` count as checkpoints.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.nn as nn

STATE_FILE = "state.pt"


def load_state(model: nn.Module, state: Dict) -> nn.Module:
    """Load a checkpoint's tensors into ``model`` (every name must match)."""
    model.load_state_dict({**state["params"], **state["batch_stats"]},
                          strict=True)
    return model


def save(train_dir: str, step: int, model: nn.Module) -> str:
    """Atomically write ``model``'s state as checkpoint ``step``; returns
    the file's path."""
    step_dir = os.path.join(train_dir, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, STATE_FILE)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({
        "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
        "batch_stats": {n: b.detach().cpu()
                        for n, b in model.named_buffers()},
        "step": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def latest_step_in(train_dir: str) -> Optional[int]:
    """Newest step with a complete checkpoint, or None."""
    if not os.path.isdir(train_dir):
        return None
    steps = [int(d) for d in os.listdir(train_dir) if d.isdigit()
             and os.path.isfile(os.path.join(train_dir, d, STATE_FILE))]
    return max(steps) if steps else None


def restore(train_dir: str, step: int) -> Dict:
    """Checkpoint ``step`` as saved (tensors on the CPU)."""
    path = os.path.join(train_dir, str(int(step)), STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointPoller:
    """Newest-step watcher over a train dir (the serve hot-reload poll):
    ``poll()`` reports the newest step while it has not been marked seen."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        self.last_seen: Optional[int] = None

    def poll(self) -> Optional[int]:
        step = latest_step_in(self.directory)
        if step is not None and step != self.last_seen:
            return step
        return None

    def mark_seen(self, step: int) -> None:
        self.last_seen = int(step)
