"""The process group (port of ``tpu_resnet/parallel/multihost.py``).

The reference starts one process per host and points it at a coordinator
(``jax.distributed.initialize``). The port starts one process per card
(``main.py`` spawns a node's ranks) and joins them in one
``torch.distributed`` process group: NCCL on CUDA, gloo on the CPU.

:func:`initialize` keeps the reference's environment protocol and its
resolution order: explicit arguments, then ``TPU_COORDINATOR_ADDRESS``,
``TPU_NUM_PROCESSES`` and ``TPU_PROCESS_ID`` (set by ``launch/``), and
``TPU_PROCS_PER_NODE`` / ``TPU_LOCAL_RANK`` / ``TPU_CHIPS_PER_NODE`` for
several processes on one node, each taking its own slice of the node's
cards. Each process starts ``local_world`` ranks, one per card of its
slice: the world is ``processes x local_world`` and a rank's number
``process_id · local_world + local_rank``. A single process with no
cluster configured opens no group: the one-card path is untouched.

Beside the default group, a CUDA run opens a gloo group over the same
ranks for the host's agreements (:func:`agree_any`, :func:`broadcast_object`,
:func:`barrier`), so that they never wait on the device. Every collective
has a timeout (``timeout_sec``): an eager one raises when it runs out
(gloo) or is aborted by NCCL's watchdog (its asynchronous error handling,
left at PyTorch's default). NCCL's watchdog does not see the collectives
that a CUDA graph replays, so the train loop's hang watchdog ends a rank
whose chunk makes no progress for :func:`collective_timeout` seconds
(``resilience/watchdog.py``); a rank that fails ends its process, and the
launcher ends the others of its node (``main.py``).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from tpu_resnet_torch.parallel.mesh import Mesh, create_mesh

log = logging.getLogger("tpu_resnet_torch")

COLLECTIVE_TIMEOUT_SEC = 600

_layout: Optional[Mesh] = None
_host_group = None
_timeout_sec: Optional[float] = None


def _card_offset(device_type: str) -> int:
    """The first card of this process's slice of its node
    (``TPU_PROCS_PER_NODE`` > 1 with ``TPU_LOCAL_RANK``), else 0."""
    procs_per_node = int(os.environ.get("TPU_PROCS_PER_NODE", "1"))
    if procs_per_node <= 1 or "TPU_LOCAL_RANK" not in os.environ:
        return 0
    node_rank = int(os.environ["TPU_LOCAL_RANK"])
    default = (torch.cuda.device_count() if device_type == "cuda" else 0)
    chips = int(os.environ.get("TPU_CHIPS_PER_NODE", str(default or 4)))
    per_proc = chips // procs_per_node
    if per_proc < 1:
        raise ValueError(
            f"TPU_PROCS_PER_NODE={procs_per_node} exceeds "
            f"TPU_CHIPS_PER_NODE={chips}")
    return node_rank * per_proc


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               local_rank: int = 0, local_world: int = 1,
               device_type: str = "cuda", backend: Optional[str] = None,
               card: Optional[int] = None,
               timeout_sec: float = COLLECTIVE_TIMEOUT_SEC) -> Optional[Mesh]:
    """Open the run's process group if a cluster is configured; returns
    its layout, or None for a single process (no group).

    Resolution order: 1. explicit arguments, 2. the ``TPU_*`` launcher
    variables. ``local_rank`` of ``local_world`` is this rank among the
    ranks its process started (one per card). On CUDA the rank's card is
    made current before anything is allocated. ``backend`` overrides the
    device's (NCCL for CUDA, gloo for the CPU): gloo on CUDA tensors runs
    several ranks on one card (``card``: the one they share), which NCCL
    refuses."""
    global _layout, _host_group, _timeout_sec
    coordinator_address = coordinator_address or os.environ.get(
        "TPU_COORDINATOR_ADDRESS")
    if num_processes is None and "TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TPU_NUM_PROCESSES"])
    if process_id is None and "TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TPU_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        log.info("single-process run; no process group")
        return None
    num_processes = num_processes or 1
    process_id = process_id or 0
    if card is None:
        card = _card_offset(device_type) + local_rank
    world = num_processes * local_world
    rank = process_id * local_world + local_rank
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        torch.cuda.set_device(card)
    timeout = datetime.timedelta(seconds=timeout_sec)
    dist.init_process_group(
        backend=backend, init_method=_init_method(coordinator_address),
        world_size=world, rank=rank, timeout=timeout)
    _host_group = (dist.new_group(backend="gloo", timeout=timeout)
                   if backend != "gloo" else None)
    _timeout_sec = timeout_sec
    _layout = create_mesh(None, world, rank=rank, local_rank=local_rank,
                          process_index=process_id,
                          process_count=num_processes)
    log.info("process group: rank %d/%d (process %d/%d, local rank %d, "
             "%s)", rank, world, process_id, num_processes, local_rank,
             dist.get_backend())
    return _layout


def layout() -> Mesh:
    """This run's layout: the open group's, else one rank."""
    if _layout is not None and dist.is_initialized():
        return _layout
    return Mesh()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def collective_timeout() -> Optional[float]:
    """The open group's collective timeout in seconds; None without one."""
    return _timeout_sec if dist.is_initialized() else None


def capturable_collectives() -> bool:
    """True unless the group's collectives are gloo's, which a CUDA graph
    cannot capture."""
    return not dist.is_initialized() or dist.get_backend() != "gloo"


def is_primary() -> bool:
    """True on the rank that owns checkpoints and logs: global rank 0
    (the reference's process 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Every rank meets here (on the host group); a no-op alone."""
    if world_size() > 1:
        dist.barrier(group=_host_group)


def agree_any(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any rank."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group)
    return bool(t.item())


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_host_group)
    return box[0]


def shutdown() -> None:
    """Tear the group down (idempotent)."""
    global _layout, _host_group, _timeout_sec
    if dist.is_initialized():
        dist.destroy_process_group()
    _layout = _host_group = _timeout_sec = None
