"""Run manifest: one ``<train_dir>/manifest.json`` a run, written at
startup (port of ``tpu_resnet/obs/manifest.py``), with the reference's
keys: the resolved config (``mesh.partition`` in it), the mesh (one card:
``{"data": 1}``; N ranks: ``{"data": N}``), the device count (the ranks),
kinds and platform (``"gpu"`` or ``"cpu"``), the process (node) count and
index,
the versions (python, torch, CUDA, the port), the git revision where
there is one, the host name and argv. Written atomically (a temporary
file, then a rename). ``run_id.json`` holds the run's correlation id,
shared by every process that reads the train dir and kept across
resumes.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import uuid
from typing import Optional

SCHEMA_VERSION = 2
RUN_ID_FILE = "run_id.json"


def ensure_run_id(train_dir: str, create: bool = True) -> Optional[str]:
    """The run's correlation id from ``<train_dir>/run_id.json``, minted
    there when missing (``create``); None when missing and not
    ``create``."""
    path = os.path.join(train_dir, RUN_ID_FILE)
    try:
        with open(path) as f:
            rid = json.load(f).get("run_id")
            if rid:
                return str(rid)
    except (OSError, ValueError):
        pass
    if not create:
        return None
    rid = uuid.uuid4().hex[:12]
    try:
        os.makedirs(train_dir, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"run_id": rid, "created_at": time.time(),
                       "hostname": socket.gethostname()}, f)
        os.replace(tmp, path)
    except OSError:
        pass  # the id is best-effort; the run must not die for it
    return rid


def read_run_id(train_dir: str) -> Optional[str]:
    """Read-only run_id lookup (eval, tools); None before the trainer made
    one."""
    return ensure_run_id(train_dir, create=False)


def _git_rev() -> Optional[str]:
    """The checkout's git revision; None outside a work tree."""
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        proc = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=here,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, timeout=5)
    except (OSError, subprocess.TimeoutExpired):
        return None
    rev = proc.stdout.strip()
    return rev if proc.returncode == 0 and rev else None


def build_manifest(cfg, device, run_id: Optional[str] = None,
                   extra: Optional[dict] = None, mesh=None) -> dict:
    """The manifest dict for a run of ``cfg`` on ``device`` (no file
    written); ``mesh`` is the run's ``parallel.Mesh`` (None: one rank)."""
    import torch

    import tpu_resnet_torch

    device = torch.device(device)
    cuda = device.type == "cuda"
    manifest = {
        "schema": SCHEMA_VERSION,
        "run_id": run_id,
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "config": cfg.to_dict(),
        "mesh": {"shape": {"data": mesh.data if mesh else 1},
                 "axis_names": ["data"]},
        "devices": {
            "count": mesh.size if mesh else 1,
            "kinds": [torch.cuda.get_device_name(device) if cuda
                      else "cpu"],
            "platform": "gpu" if cuda else "cpu",
        },
        "processes": {"count": mesh.process_count if mesh else 1,
                      "index": mesh.process_index if mesh else 0},
        "versions": {
            "tpu_resnet_torch": getattr(tpu_resnet_torch, "__version__",
                                        None),
            "python": sys.version.split()[0],
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        },
        "git_rev": _git_rev(),
        "hostname": socket.gethostname(),
        "argv": list(sys.argv),
    }
    if extra:
        manifest.update(extra)
    return manifest


def write_manifest(train_dir: str, cfg, device,
                   run_id: Optional[str] = None,
                   extra: Optional[dict] = None, mesh=None) -> str:
    """Write ``<train_dir>/manifest.json`` atomically; returns its path.
    Across ranks only the primary calls it."""
    os.makedirs(train_dir, exist_ok=True)
    path = os.path.join(train_dir, "manifest.json")
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(build_manifest(cfg, device, run_id=run_id, extra=extra,
                                 mesh=mesh),
                  f, indent=1, default=list)
    os.replace(tmp, path)
    return path
