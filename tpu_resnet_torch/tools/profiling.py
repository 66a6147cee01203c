"""Device time on a CUDA card, from ``torch.profiler``.

:func:`device_profile` runs a callable ``iters`` times under the profiler
and sums the kernels' own device times by name; one stream, so the kernels
do not overlap and their sum is the time the device was busy.
:func:`profile_train_step` times the train loop's step that way
(``tools/profile_torch_train.py`` and ``chip_smoke.py`` print it).
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch
from torch.profiler import ProfilerActivity, profile

# The port's kernels on the train paths, by a substring of their names: the
# fused block's stats are two launches on the tensor cores,
# ``block_stats_kernel`` (c1 and the tiles' sums) and
# ``block_stats_sum_kernel``; its training forward one,
# ``block_fwd_kernel`` from the stats' c1 (from x, as serving runs it, two:
# ``block_fwd_r2_kernel`` and ``block_fwd_kernel``); its first backward pass
# two, ``block_bwd1_kernel`` and ``block_bwd1_sum_kernel``, its second
# three, ``block_bwd2_dc1_kernel``, ``block_bwd2_kernel`` and
# ``block_bwd2_sum_kernel``; ``sbr_bwd_kernel`` is one launch with its
# sums. The fused bottleneck's training kernels all run on the tensor
# cores: one for the first moment pass and passes 3 and 4, two for each of
# the forward, the second moment pass and passes 1 and 2:
# ``bottleneck_fwd_p2_kernel`` and ``bottleneck_fwd_kernel``,
# ``bottleneck_stats_b_p2_kernel`` and ``bottleneck_stats_b_kernel``,
# ``bottleneck_bwd1_p2_kernel`` and ``bottleneck_bwd1_kernel``,
# ``bottleneck_bwd2_dmid_kernel`` and ``bottleneck_bwd2_kernel``;
# ``bottleneck_wgrad`` for dw1..3, and ``bottleneck_sum`` adds their
# partial rows in order.
TRAIN_KERNELS = {"sbr": "sbr_kernel", "sbr_bwd": "sbr_bwd_kernel",
                 "xent_fwd": "xent_fwd_kernel", "xent_bwd": "xent_bwd_kernel",
                 "block_fwd": "block_fwd_",
                 "block_stats": "block_stats_",
                 "block_bwd1": "block_bwd1_",
                 "block_bwd2": "block_bwd2_",
                 "block_bwd3": "block_bwd3_kernel",
                 "bottleneck_fwd": "bottleneck_fwd_",
                 "bottleneck_stats_a": "bottleneck_stats_a_kernel",
                 "bottleneck_stats_b": "bottleneck_stats_b_",
                 "bottleneck_bwd1": "bottleneck_bwd1_",
                 "bottleneck_bwd2": "bottleneck_bwd2_",
                 "bottleneck_bwd3": "bottleneck_bwd3_kernel",
                 "bottleneck_bwd4": "bottleneck_bwd4_kernel",
                 "bottleneck_wgrad": "bottleneck_wgrad_kernel",
                 "bottleneck_sum": "bottleneck_sum_kernel"}


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_profile(fn: Callable[[], object], iters: int) -> Dict:
    """{"device_busy_ms": device ms per call, "kernels": [{"name",
    "ms_per_call", "launches_per_call"}, ...] by device time}; busy is None
    when the profiler saw no device time."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        # A user range (e.g. the optimizer's step) is not a kernel.
        if (us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            kernels.append({"name": evt.key[:90],
                            "ms_per_call": us / 1e3 / iters,
                            "launches_per_call": evt.count / iters})
    kernels.sort(key=lambda k: -k["ms_per_call"])
    busy = sum(k["ms_per_call"] for k in kernels)
    return {"device_busy_ms": busy if kernels else None, "kernels": kernels}


def profile_train_step(state, step_fn, images, labels, iters: int = 20
                       ) -> Dict:
    """Wall and device time per step of ``step_fn(state, images, labels)``
    (the loop's step: host-to-device copy of the uint8 batch included)
    after 5 warm-up steps: the host clock over ``iters`` steps ending in a
    synchronize, then ``iters`` more under the profiler."""
    device = next(state.model.parameters()).device
    lab = torch.from_numpy(labels).to(device)

    def one_step():
        return step_fn(state, torch.from_numpy(images).to(device), lab)

    for _ in range(5):
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        one_step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    prof = device_profile(one_step, iters)
    busy = prof["device_busy_ms"]
    ours = {}
    for name, key in TRAIN_KERNELS.items():
        rows = [k for k in prof["kernels"] if key in k["name"]]
        ours[name] = {"ms_per_step": sum(k["ms_per_call"] for k in rows),
                      "launches_per_step": sum(k["launches_per_call"]
                                               for k in rows)}
    batch = len(images)
    return {"batch": batch, "iters": iters, "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy,
            "device_idle_share": None if busy is None else 1 - busy / wall_ms,
            "images_per_s": batch * 1e3 / wall_ms,
            "launches_per_step": sum(k["launches_per_call"]
                                     for k in prof["kernels"]),
            "port_kernels": ours, "kernels": prof["kernels"][:30]}
