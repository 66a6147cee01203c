"""The port's checkpoint format: ``<train_dir>/<step>/state.pt``.

One file per step, holding ``{"params": {name: tensor}, "batch_stats":
{name: tensor}, "opt_state": {name: momentum buffer}, "step": int}`` with
the model's ``state_dict`` names (parameters under ``params``, BN running
statistics under ``batch_stats``, momentum buffers by parameter name under
``opt_state``), all on the CPU. A save writes a temporary file in the step
directory and renames it, so a reader sees a whole file or none; only step
directories that hold ``state.pt`` count as checkpoints. Readers that serve
(``load_state``) take ``params`` and ``batch_stats`` only, so a trained
checkpoint serves as it is.

Across ranks the file stays the one a one-card run writes: only the
primary rank writes (and prunes), after a zero1 run has gathered the
momentum shards (``TrainState.momentum_buffers``, a collective), and every
rank then meets at a barrier; a restore reads the whole file on every rank
and each keeps its shards. So a checkpoint moves across rank counts and
``mesh.partition`` modes in both directions.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Dict, List, Optional

import torch
import torch.nn as nn

STATE_FILE = "state.pt"

log = logging.getLogger("tpu_resnet_torch")


def load_state(model: nn.Module, state: Dict) -> nn.Module:
    """Load a checkpoint's tensors into ``model`` (every name must match)."""
    model.load_state_dict({**state["params"], **state["batch_stats"]},
                          strict=True)
    return model


def save(train_dir: str, step: int, model: nn.Module,
         opt_state: Optional[Dict[str, torch.Tensor]] = None) -> str:
    """Atomically write ``model``'s state (and ``opt_state``, momentum
    buffers by parameter name) as checkpoint ``step``; returns the file's
    path."""
    step_dir = os.path.join(train_dir, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, STATE_FILE)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({
        "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
        "batch_stats": {n: b.detach().cpu()
                        for n, b in model.named_buffers()},
        "opt_state": {n: t.detach().cpu()
                      for n, t in (opt_state or {}).items()},
        "step": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def all_steps_in(train_dir: str) -> List[int]:
    """Steps with a complete checkpoint, ascending."""
    if not os.path.isdir(train_dir):
        return []
    return sorted(int(d) for d in os.listdir(train_dir) if d.isdigit()
                  and os.path.isfile(os.path.join(train_dir, d, STATE_FILE)))


def latest_step_in(train_dir: str) -> Optional[int]:
    """Newest step with a complete checkpoint, or None."""
    steps = all_steps_in(train_dir)
    return steps[-1] if steps else None


def restore(train_dir: str, step: int) -> Dict:
    """Checkpoint ``step`` as saved (tensors on the CPU)."""
    path = os.path.join(train_dir, str(int(step)), STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """The trainer's view of a train dir: save a train state, keep the
    newest ``keep`` checkpoints, restore the newest for resume. ``spans``
    (an ``obs.SpanTracer``) records ``checkpoint_save``,
    ``checkpoint_restore`` and ``checkpoint_restore_failed`` spans, as
    the reference's manager does. Across ranks: ``primary`` says whether
    this rank writes, ``barrier`` (every rank calls it) follows each save
    and restore."""

    def __init__(self, directory: str, keep: int = 5, spans=None,
                 primary: bool = True, barrier=None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self._spans = spans
        self.primary = primary
        self._barrier = barrier or (lambda: None)
        if primary:
            os.makedirs(self.directory, exist_ok=True)
        self._barrier()

    def _span(self, kind: str, t0: float, **attrs) -> None:
        if self._spans is not None:
            self._spans.record(kind, t0, time.time(), **attrs)

    def latest_step(self) -> Optional[int]:
        return latest_step_in(self.directory)

    def save(self, state) -> str:
        """Checkpoint ``state`` (a ``TrainState``) at its step, then prune
        to the newest ``keep``. The save is synchronous: its span covers
        the write (``async: false``). Every rank calls it."""
        t0 = time.time()
        slots = state.momentum_buffers()
        path = os.path.join(self.directory, str(int(state.step)), STATE_FILE)
        if self.primary:
            path = save(self.directory, state.step, state.model, slots)
            self._span("checkpoint_save", t0, step=int(state.step),
                       **{"async": False})
            if self.keep > 0:
                for old in all_steps_in(self.directory)[:-self.keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)),
                                  ignore_errors=True)
        self._barrier()
        return path

    def restore(self, state, discard_failed: bool = False):
        """Load the newest restorable checkpoint into ``state``:
        parameters, running statistics, momentum buffers and step, each
        written into the tensor that holds it (a CUDA graph captured on
        them stays valid across a rollback or a resume). A step
        that fails to load (a torn or corrupt file) is logged and the next
        older one tried, as the reference's fallback does; if none loads,
        raise with the newest error. ``discard_failed`` (the trainer's
        resume, which will reach those steps again and save over them)
        deletes the steps that failed once an older one loaded."""
        steps = all_steps_in(self.directory)[::-1]
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        failed, first_err = [], None
        for step in steps:
            t0 = time.time()
            try:
                saved = restore(self.directory, step)
                load_state(state.model, saved)
                state.load_momentum_buffers(saved.get("opt_state", {}))
            except Exception as e:  # noqa: BLE001 - any unreadable step
                first_err = first_err or e
                failed.append(step)
                log.warning("checkpoint step %d failed to restore (%s: %s)",
                            step, type(e).__name__, e)
                self._span("checkpoint_restore_failed", t0, step=int(step),
                           error=f"{type(e).__name__}: {e}"[:200])
                continue
            state.step = int(saved["step"])
            self._span("checkpoint_restore", t0, step=int(step),
                       **({"fallback_from_step": int(steps[0])}
                          if failed else {}))
            if failed:
                log.warning("restored step %d instead of %s", step, failed)
                if discard_failed and self.primary:
                    for bad in failed:
                        shutil.rmtree(os.path.join(self.directory, str(bad)),
                                      ignore_errors=True)
            self._barrier()
            return state
        raise RuntimeError(
            f"no restorable checkpoint in {self.directory}: all of {steps} "
            f"failed; newest error: {type(first_err).__name__}: {first_err}")


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


def restore_with_retry(train_dir: str, step: int, retries: int = 3,
                       backoff_sec: float = 0.5) -> Optional[Dict]:
    """Checkpoint ``step`` as saved, with up to ``retries`` attempts and
    exponential backoff between them; None when every attempt failed (the
    caller skips the step and logs it, as the reference's evaluator
    does)."""
    attempts = max(1, retries)
    for attempt in range(attempts):
        try:
            return restore(train_dir, step)
        except Exception as e:  # noqa: BLE001 - any unreadable step
            wait = backoff_sec * 2 ** attempt
            last = attempt + 1 == attempts
            log.warning("restore of checkpoint step %d failed (attempt "
                        "%d/%d, %s: %s)%s", step, attempt + 1, attempts,
                        type(e).__name__, e,
                        "" if last else f"; retrying in {wait:.1f}s")
            if not last:
                time.sleep(wait)
    return None
