"""The environment of the port's child processes (the doctor's drills,
the chip smoke's replicas): the counterpart of the reference's
``tpu_resnet/hostenv.py``.

Unlike the reference's ``scrubbed_cpu_env``, nothing here hides the card:
a child runs on CUDA unless its command line asks for the CPU (the serve
and train children take ``--device cpu``, as the tests pass it). What a
child needs is to import this checkout's package, so the repository root
leads its ``PYTHONPATH``. Imports no torch.
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional, Sequence, Tuple

from tpu_resnet_torch.resilience import exitcodes

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child_env(extra: Optional[dict] = None) -> dict:
    """A copy of this process's environment with the repository root
    first on ``PYTHONPATH``, updated with ``extra`` (a fault plan's
    ``TPU_RESNET_FAULT_*`` variables, say)."""
    env = dict(os.environ)
    paths = [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
             if p and p != REPO_ROOT]
    env["PYTHONPATH"] = os.pathsep.join([REPO_ROOT] + paths)
    env.update(extra or {})
    return env


def run_subprocess(argv: Sequence[str], timeout: float,
                   extra_env: Optional[dict] = None) -> Tuple[int, str]:
    """Run ``argv`` from the repository root under :func:`child_env` with
    stdout and stderr merged. Returns ``(rc, output)``: 124 and the
    partial output when ``timeout`` runs out, 127 when it cannot start."""
    try:
        proc = subprocess.run(list(argv), env=child_env(extra_env),
                              cwd=REPO_ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=timeout)
        return proc.returncode, proc.stdout
    except subprocess.TimeoutExpired as e:
        out = e.stdout or b""
        if isinstance(out, bytes):
            out = out.decode(errors="replace")
        return exitcodes.HOSTENV_TIMEOUT, \
            out + f"\n[parent] timeout after {timeout}s"
    except OSError as e:
        return exitcodes.HOSTENV_SPAWN_FAILED, f"spawn failed: {e}"
