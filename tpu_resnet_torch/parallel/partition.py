"""State partitioner (port of ``tpu_resnet/parallel/partition.py``): where
each train-state tensor lives across the ranks.

Two modes, the ``mesh.partition`` knob:

``replicated``  every rank holds the whole state (the default);
``zero1``       parameters and BN statistics stay whole on every rank,
                while each momentum buffer, and the update that reads it
                (``parallel/zero.py``), is split over the ``data`` axis:
                each rank keeps and updates its shard only.

The zero1 per-leaf rule is the reference's: a leaf shards along its FIRST
axis whose size the data-axis size divides; a leaf with none stays
replicated when it is at most :data:`ZERO1_SMALL_LEAF_BYTES`, and is a
``ValueError`` naming it otherwise. The rule is applied in the reference's
layout (``convert.reference_layout``: a conv kernel is HWIO there and
OIHW here, a dense kernel (in, out) and (out, in)), so that both packages
shard, replicate or refuse the same leaves, each along the same axis.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch.nn as nn

from tpu_resnet_torch.convert import reference_layout

PARTITION_MODES = ("replicated", "zero1")

# zero1: a slot leaf with no data-divisible axis stays replicated up to
# this many bytes; a larger one must shard, or the run is refused.
ZERO1_SMALL_LEAF_BYTES = 65536


def check_partition_mode(mode: str) -> str:
    """A typo must not mean 'replicated'."""
    if mode not in PARTITION_MODES:
        raise ValueError(
            f"mesh.partition must be one of {PARTITION_MODES}, got "
            f"{mode!r}")
    return mode


class StatePartitioner:
    """The per-leaf layout of a train state over ``mesh``'s data axis
    (``mesh``: a ``parallel.Mesh``)."""

    def __init__(self, mesh, mode: str = "replicated", axis: str = "data"):
        self.mesh = mesh
        self.mode = check_partition_mode(mode)
        self.axis = axis

    @property
    def data_size(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def is_sharded(self) -> bool:
        """zero1 over a 1-way data axis is the identity: the plain
        update."""
        return self.mode == "zero1" and self.data_size > 1

    def slot_spec(self, shape: Tuple[int, ...],
                  nbytes: Optional[int] = None) -> Optional[tuple]:
        """The reference's spec of one slot leaf of ``shape`` (reference
        layout), as a tuple: ``()`` replicated, ``(None, …, "data")``
        sharded on the first data-divisible axis, None when the leaf is
        large and indivisible (the caller raises)."""
        if not self.is_sharded or len(shape) == 0:
            return ()
        n = self.data_size
        for i, d in enumerate(shape):
            if d % n == 0 and d > 0:
                return (None,) * i + (self.axis,)
        if nbytes is not None and nbytes > ZERO1_SMALL_LEAF_BYTES:
            return None
        return ()

    def slot_axes(self, model: nn.Module) -> Dict[str, Optional[int]]:
        """{parameter name: the port axis its slot shards along, or None
        (replicated)}; raises with every leaf that can do neither."""
        axes, problems = {}, []
        for name, p in model.named_parameters():
            path, ref_shape, port_axes = reference_layout(name, p.shape)
            nbytes = p.numel() * p.element_size()
            spec = self.slot_spec(ref_shape, nbytes)
            if spec is None:
                problems.append(
                    f"  opt_state['{name}'] (reference {path}): shape "
                    f"{tuple(p.shape)} ({nbytes:,} bytes) has no axis "
                    f"divisible by the {self.axis}-axis size "
                    f"{self.data_size}")
                axes[name] = None
            else:
                axes[name] = port_axes[len(spec) - 1] if spec else None
        if problems:
            raise ValueError(
                f"mesh.partition=zero1 cannot shard "
                f"{len(problems)} optimizer-slot leaf/leaves over the "
                f"{self.data_size}-way '{self.axis}' axis:\n"
                + "\n".join(problems)
                + f"\n(leaves ≤ {ZERO1_SMALL_LEAF_BYTES} bytes stay "
                f"replicated automatically; pick a mesh whose "
                f"{self.axis} axis divides the slot shapes, or use "
                f"mesh.partition=replicated)")
        return axes

    def validate(self, model: nn.Module) -> None:
        """Every zero1 rule applied to the real model at startup, with a
        message per leaf that cannot be laid out."""
        self.slot_axes(model)

    def describe(self) -> str:
        return self.mode


def make_partitioner(mesh_cfg, mesh) -> StatePartitioner:
    """The run's partitioner: ``mesh.partition`` of ``mesh_cfg`` (None →
    replicated) over ``mesh``."""
    mode = (getattr(mesh_cfg, "partition", "replicated")
            if mesh_cfg is not None else "replicated")
    return StatePartitioner(mesh, mode)
