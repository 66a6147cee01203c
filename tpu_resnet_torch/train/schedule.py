"""Learning-rate schedules as plain ``step -> float`` functions (port of
``tpu_resnet/train/schedule.py``). The train step reads ``schedule(step)``
before the step counter moves, as optax's ``scale_by_schedule`` does.
Values are rounded to float32, as the reference's are."""

from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence

import numpy as np

Schedule = Callable[[int], float]


def _f32(v: float) -> float:
    return float(np.float32(v))


def piecewise_constant(boundaries: Sequence[int],
                       values: Sequence[float]) -> Schedule:
    """lr = values[i] for boundaries[i-1] <= step < boundaries[i]."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("need len(values) == len(boundaries) + 1")
    b = [int(x) for x in boundaries]
    v = [_f32(x) for x in values]

    def schedule(step: int) -> float:
        return v[bisect.bisect_right(b, int(step))]

    return schedule


def cifar_piecewise(base_lr: float = 0.1) -> Schedule:
    """0.1 → 0.01 → 0.001 → 0.0001 at steps 40k/60k/80k."""
    scale = base_lr / 0.1
    return piecewise_constant(
        (40_000, 60_000, 80_000),
        tuple(scale * x for x in (0.1, 0.01, 0.001, 0.0001)))


def imagenet_warmup(warmup_steps: int = 6240,
                    warmup_init_lr: float = 0.1,
                    peak_lr: float = 0.4,
                    boundaries: Sequence[int] = (37_440, 74_880, 99_840)
                    ) -> Schedule:
    """Linear warmup 0.1→0.4 over ``warmup_steps``, then 0.4 / 0.04 / 0.004
    / 0.0004 at the boundaries."""
    after = piecewise_constant(boundaries, [peak_lr, peak_lr * 0.1,
                                            peak_lr * 0.01, peak_lr * 0.001])

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = min(step, warmup_steps) / max(warmup_steps, 1)
            return _f32(warmup_init_lr + (peak_lr - warmup_init_lr) * frac)
        return after(step)

    return schedule


def constant(lr: float) -> Schedule:
    value = _f32(lr)

    def schedule(step: int) -> float:
        del step
        return value

    return schedule


def cosine(base_lr: float, total_steps: int, warmup_steps: int = 0,
           final_frac: float = 0.0) -> Schedule:
    """Linear warmup then cosine decay."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return _f32(base_lr * step / max(warmup_steps, 1))
        progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        progress = min(max(progress, 0.0), 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + math.cos(math.pi * progress))
        return _f32(base_lr * cos)

    return schedule


def build_schedule(optim_cfg, train_cfg) -> Schedule:
    """Build from OptimConfig (+ TrainConfig for totals)."""
    name = optim_cfg.schedule
    if name == "cifar_piecewise":
        if optim_cfg.boundaries:
            return piecewise_constant(optim_cfg.boundaries, optim_cfg.values)
        return cifar_piecewise(optim_cfg.base_lr)
    if name == "imagenet_warmup":
        kwargs = {}
        if optim_cfg.boundaries:
            kwargs["boundaries"] = optim_cfg.boundaries
        return imagenet_warmup(optim_cfg.warmup_steps,
                               optim_cfg.warmup_init_lr,
                               peak_lr=optim_cfg.base_lr * 4, **kwargs)
    if name == "constant":
        return constant(optim_cfg.base_lr)
    if name == "cosine":
        return cosine(optim_cfg.base_lr, train_cfg.train_steps,
                      optim_cfg.warmup_steps)
    raise ValueError(f"unknown schedule {name!r}")
