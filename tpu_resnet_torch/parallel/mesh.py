"""The data-parallel layout (port of ``tpu_resnet/parallel/mesh.py``).

A JAX program sees every chip of the slice in one ``Mesh``; the port runs
one process (a *rank*) per card, joined in one ``torch.distributed``
process group (``parallel/multihost.py``). :class:`Mesh` is that group's
layout in the reference's terms: the ``data`` and ``model`` axis sizes,
this rank, its index among its node's ranks (``local_rank``) and its node
(``process_index`` of ``process_count``: a JAX *process* is a host that
drives its local chips, a port rank is one card).

The input is split as the reference's is: each process (node) reads its
``local_batch_size`` rows of the global batch, and its local ranks split
those rows in device order, as a process's JAX devices split them. Ranks
are numbered node by node, so rank ``r`` takes rows
``[r·b, (r+1)·b)`` of the global batch (:meth:`Mesh.rank_rows`), and N
ranks on one node feed exactly what the reference's single-process
N-device mesh feeds.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One run's layout: ``data`` x ``model`` ranks, seen from ``rank``."""

    data: int = 1
    model: int = 1
    rank: int = 0
    local_rank: int = 0
    process_index: int = 0
    process_count: int = 1

    @property
    def shape(self) -> dict:
        """``{"data": N, "model": M}``, as ``jax.sharding.Mesh.shape``."""
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def rank_rows(self, global_batch: int) -> Tuple[int, int]:
        """``(lo, hi)``: this rank's rows of a global batch."""
        check_divisible(global_batch, self)
        b = global_batch // self.data
        return self.rank * b, (self.rank + 1) * b

    def local_rows(self, global_batch: int) -> Tuple[int, int]:
        """``(lo, hi)``: this rank's rows of its process's local batch
        (:func:`local_batch_size` rows)."""
        lo, hi = self.rank_rows(global_batch)
        first = self.process_index * local_batch_size(global_batch, self)
        return lo - first, hi - first


def create_mesh(mesh_cfg=None, n_devices: int = 1, rank: int = 0,
                local_rank: int = 0, process_index: int = 0,
                process_count: int = 1) -> Mesh:
    """A (data, model) layout of ``n_devices`` ranks from MeshConfig:
    ``data=-1`` takes every rank the model axis leaves, as the
    reference's ``create_mesh`` does."""
    model = getattr(mesh_cfg, "model", 1) if mesh_cfg is not None else 1
    data = getattr(mesh_cfg, "data", -1) if mesh_cfg is not None else -1
    if data == -1:
        if n_devices % model:
            raise ValueError(f"{n_devices} devices not divisible by "
                             f"model={model}")
        data = n_devices // model
    if data * model != n_devices:
        raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
    return Mesh(data=data, model=model, rank=rank, local_rank=local_rank,
                process_index=process_index, process_count=process_count)


def fit_mesh(mesh_cfg, n_devices: int):
    """``(data, model, downsized)`` axis sizes that fit on ``n_devices``
    (the reference's elastic primitive): ``-1`` follows the hardware (a
    count the model axis does not divide drops the remainder, reported as
    downsized), an explicit ``data`` that no longer fits shrinks to the
    largest the devices support, and never grows."""
    model = getattr(mesh_cfg, "model", 1) if mesh_cfg is not None else 1
    data = getattr(mesh_cfg, "data", -1) if mesh_cfg is not None else -1
    if model < 1 or n_devices < model:
        raise ValueError(
            f"mesh model axis {model} cannot fit on {n_devices} "
            f"device(s) — the model axis is not elastic")
    if data != -1 and data < 1:
        raise ValueError(
            f"mesh.data must be -1 (all remaining devices) or >= 1, "
            f"got {data}")
    avail = n_devices // model
    if data == -1:
        return avail, model, avail * model != n_devices
    if data <= avail:
        return data, model, False
    return avail, model, True


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Per-process batch for the host input: the global batch must split
    over the processes and over the data axis; both are checked here, with
    the mesh named."""
    n_proc = mesh.process_count
    if global_batch % n_proc:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n_proc} "
            f"processes (mesh {dict(mesh.shape)})")
    check_divisible(global_batch, mesh)
    return global_batch // n_proc


def check_divisible(global_batch: int, mesh: Mesh) -> None:
    n_data = mesh.shape["data"]
    if global_batch % n_data:
        raise ValueError(
            f"global batch {global_batch} not divisible by data axis {n_data}")
