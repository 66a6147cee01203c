"""The run's topology record and its resolution on (re)start, and serve
colocation admission (port of ``tpu_resnet/resilience/elastic.py``).

Every run records the layout it trains on in ``<train_dir>/topology.json``
(:func:`write_topology`, the primary rank, at the run's first save) with
the reference's schema; ``device_kind`` is the card's name (``"cpu"`` on
the CPU). :func:`resolve` derives this start's layout from the ranks that
exist: an explicit ``mesh.data`` that no longer fits is downsized
(``parallel.fit_mesh``), a global batch the data axis does not divide is
refused with both topologies named, and a changed global batch is marked
``stream_compatible=False``. Checkpoints are topology-free
(``train/checkpoint.py``), so a resume on another layout restores as it
is.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional

from tpu_resnet_torch.parallel.mesh import create_mesh, fit_mesh

log = logging.getLogger("tpu_resnet_torch")

TOPOLOGY_FILE = "topology.json"


def topology_record(mesh, partition: str, global_batch: int,
                    device_kind: str = "") -> dict:
    """The one constructor of the record's schema (``mesh``: a
    ``parallel.Mesh``)."""
    return {
        "devices": int(mesh.size),
        "mesh_shape": dict(mesh.shape),
        "partition": str(partition),
        "global_batch": int(global_batch),
        "device_kind": device_kind,
    }


def write_topology(train_dir: str, mesh, partition: str, global_batch: int,
                   device_kind: str = "") -> Optional[str]:
    """Record the topology writing this directory's checkpoints (primary
    rank only, atomic); None elsewhere or when the write fails."""
    from tpu_resnet_torch.parallel import multihost

    if not multihost.is_primary():
        return None
    record = topology_record(mesh, partition, global_batch, device_kind)
    os.makedirs(train_dir, exist_ok=True)
    path = os.path.join(train_dir, TOPOLOGY_FILE)
    tmp = path + f".tmp{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1)
        os.replace(tmp, path)
    except OSError as e:  # recording is best-effort; training must not die
        log.warning("could not write %s: %s", path, e)
        return None
    return path


def read_topology(train_dir: str) -> Optional[dict]:
    """The record of the run that last trained in ``train_dir``; None for
    a fresh directory."""
    try:
        with open(os.path.join(train_dir, TOPOLOGY_FILE)) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) and "mesh_shape" in rec else None


def describe(topology: Optional[dict]) -> str:
    """One-line form of a record ('unknown' when None)."""
    if not topology:
        return "unknown (no topology record)"
    return (f"mesh {topology.get('mesh_shape')} "
            f"partition={topology.get('partition')} "
            f"({topology.get('devices')} device(s), "
            f"global batch {topology.get('global_batch')})")


@dataclasses.dataclass
class ElasticResume:
    """The resolved topology of one (re)start."""

    mesh: object                    # the parallel.Mesh to train on
    current: dict                   # the record this run will write
    prior: Optional[dict] = None    # the record of the run that saved
    downsized: bool = False         # the requested mesh.data did not fit
    requested_data: int = -1        # cfg.mesh.data as configured
    stream_compatible: bool = True  # global batch unchanged vs prior

    @property
    def changed(self) -> bool:
        if self.prior is None:
            return False
        return any(self.prior.get(k) != self.current.get(k)
                   for k in ("mesh_shape", "partition", "global_batch"))

    def attrs(self) -> dict:
        out = {
            "from_mesh": (self.prior or {}).get("mesh_shape"),
            "to_mesh": self.current["mesh_shape"],
            "from_partition": (self.prior or {}).get("partition"),
            "to_partition": self.current["partition"],
            "from_devices": (self.prior or {}).get("devices"),
            "to_devices": self.current["devices"],
            "global_batch": self.current["global_batch"],
            "stream_compatible": self.stream_compatible,
        }
        if self.downsized:
            out["downsized_from_requested_data"] = self.requested_data
        return out


def resolve(cfg, n_devices: int, train_dir: Optional[str] = None,
            layout=None, device_kind: str = "") -> ElasticResume:
    """This start's layout on ``n_devices`` ranks, and whether it
    reshapes the recorded run. ``layout`` (the open group's
    ``parallel.Mesh``) supplies this rank's place in it."""
    train_dir = train_dir or cfg.train.train_dir
    requested_data = getattr(cfg.mesh, "data", -1)
    data, model, downsized = fit_mesh(cfg.mesh, n_devices)
    mesh_cfg = dataclasses.replace(cfg.mesh, data=data, model=model)
    place = {} if layout is None else dict(
        rank=layout.rank, local_rank=layout.local_rank,
        process_index=layout.process_index,
        process_count=layout.process_count)
    mesh = create_mesh(mesh_cfg, data * model, **place)
    prior = read_topology(train_dir)
    if cfg.train.global_batch_size % data:
        raise ValueError(
            f"elastic resume: global batch {cfg.train.global_batch_size} "
            f"does not divide the {data}-way data axis of the mesh this "
            f"host supports ({n_devices} device(s)); checkpoint "
            f"topology: {describe(prior)}. The global batch is the "
            f"deterministic-stream invariant and never rescales "
            f"implicitly — pick a device count whose data axis divides "
            f"it, or change train.global_batch_size knowingly.")
    current = topology_record(mesh,
                              getattr(cfg.mesh, "partition", "replicated"),
                              cfg.train.global_batch_size, device_kind)
    resume = ElasticResume(
        mesh=mesh, current=current, prior=prior, downsized=downsized,
        requested_data=requested_data,
        stream_compatible=(prior is None or prior.get("global_batch")
                           == current["global_batch"]))
    if downsized:
        log.warning(
            "elastic resume: mesh.data=%d does not fit on %d device(s) — "
            "downsizing to a %dx%d mesh (checkpoint topology: %s)",
            requested_data, n_devices, data, model, describe(prior))
    if resume.changed:
        log.warning(
            "topology change on resume: %s -> %s — checkpoints are "
            "topology-free and restore as they are%s",
            describe(prior), describe(current),
            "" if resume.stream_compatible else
            "; GLOBAL BATCH CHANGED: the deterministic (seed, step) batch "
            "stream does NOT continue bit-compatibly")
    return resume


# ------------------------------------------------------ colocation admission
HBM_BYTES_ENV = "TPU_RESNET_HBM_BYTES"


def _env_limit_bytes() -> Optional[int]:
    env = os.environ.get(HBM_BYTES_ENV)
    if not env:
        return None
    try:
        return int(float(env))
    except ValueError:
        log.warning("ignoring non-numeric %s=%r", HBM_BYTES_ENV, env)
        return None


def colocation_admission(required_bytes: int, device=None,
                         reserve_frac: float = 0.05) -> dict:
    """May a new workload (a serve replica) join this card? The
    reference's verdict: ``{"admit", "reason", "required_bytes",
    "headroom_bytes", "in_use_bytes", "limit_bytes"}``, with its reasons.

    On CUDA the card's own counts: the incumbent is another process (a
    trainer), which this process's allocator does not see, so in use is
    ``total - free`` of ``torch.cuda.mem_get_info`` and the limit the
    total. Elsewhere (the CPU) the limit is ``TPU_RESNET_HBM_BYTES`` and in
    use 0; with no limit at all the workload is admitted with a "not
    arbitrated" reason. ``reserve_frac`` of the limit is held back for the
    allocator's slack and the incumbent's transient peaks."""
    import torch

    in_use, limit = 0, None
    if device is not None and torch.device(device).type == "cuda":
        free, total = torch.cuda.mem_get_info(torch.device(device))
        in_use, limit = int(total - free), int(total)
    else:
        limit = _env_limit_bytes()
    verdict = {"required_bytes": int(required_bytes),
               "in_use_bytes": in_use,
               "limit_bytes": int(limit) if limit else None,
               "headroom_bytes": None}
    if not limit:
        verdict.update(admit=True,
                       reason="no device memory limit known — admission "
                              "not arbitrated (set TPU_RESNET_HBM_BYTES "
                              "to arbitrate on this backend)")
        return verdict
    headroom = int(limit * (1.0 - reserve_frac)) - in_use
    verdict["headroom_bytes"] = headroom
    if required_bytes <= headroom:
        verdict.update(admit=True,
                       reason=f"fits: {int(required_bytes):,} B required "
                              f"<= {headroom:,} B headroom")
    else:
        verdict.update(admit=False,
                       reason=f"denied: {int(required_bytes):,} B required "
                              f"> {headroom:,} B headroom "
                              f"({in_use:,} B in use of {int(limit):,} B, "
                              f"{reserve_frac:.0%} reserved)")
    return verdict
