# Verbatim copy of tpu_resnet/serve/discovery.py: the port imports nothing of the reference.
"""Shared host-side plumbing for the serving stack.

Every serving process announces its bound port the same way —
``serve.json`` / ``serve-<name>.json`` per replica (server.py),
``route.json`` for the router — and every consumer (loadgen, doctor,
``route --drain``) reads the port back the same way. One writer + one
reader here so the atomic-write and torn-file tolerance can never drift
between the three call sites (telemetry.json in obs/server.py predates
this module and keeps its multi-host-per-hostname variant). The JSON
HTTP reply helper both the replica's and the router's request handlers
use lives here too, for the same no-drift reason.

Stdlib-only, jax-free: imported by the host-isolated router.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Optional


def send_json(handler, code: int, payload,
              ctype: str = "application/json",
              extra_headers: Optional[dict] = None) -> None:
    """Write one framed JSON (or pre-encoded bytes) reply on a
    ``BaseHTTPRequestHandler`` — the single response-framing path of the
    replica and router HTTP layers."""
    body = payload if isinstance(payload, bytes) \
        else json.dumps(payload).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(body)))
    for k, v in (extra_headers or {}).items():
        handler.send_header(k, str(v))
    handler.end_headers()
    handler.wfile.write(body)


def write_record(directory: str, filename: str, port: int,
                 extra: Optional[dict] = None) -> None:
    """Atomic ``<directory>/<filename>`` announcement:
    ``{port, pid, hostname, started_at, **extra}``."""
    os.makedirs(directory, exist_ok=True)
    record = {"port": port, "pid": os.getpid(),
              "hostname": socket.gethostname(),
              "started_at": time.time(), **(extra or {})}
    path = os.path.join(directory, filename)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(record, f)
    os.replace(tmp, path)


def read_port(directory: str, filename: str) -> Optional[int]:
    """Port from an announcement file; None when absent/torn."""
    try:
        with open(os.path.join(directory, filename)) as f:
            return int(json.load(f)["port"])
    except (OSError, ValueError, KeyError, TypeError):
        return None
