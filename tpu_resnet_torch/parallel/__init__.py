"""Data parallelism across ranks (port of ``tpu_resnet/parallel``): the
layout, the process group, the state partitioner and the zero1 update."""

from tpu_resnet_torch.parallel.mesh import (
    Mesh,
    check_divisible,
    create_mesh,
    fit_mesh,
    local_batch_size,
)
from tpu_resnet_torch.parallel.multihost import initialize, is_primary
from tpu_resnet_torch.parallel.partition import (
    PARTITION_MODES,
    StatePartitioner,
    check_partition_mode,
    make_partitioner,
)

__all__ = [
    "Mesh",
    "check_divisible",
    "create_mesh",
    "fit_mesh",
    "local_batch_size",
    "initialize",
    "is_primary",
    "PARTITION_MODES",
    "StatePartitioner",
    "check_partition_mode",
    "make_partitioner",
]
