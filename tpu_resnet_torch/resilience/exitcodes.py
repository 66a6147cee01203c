"""The process exit codes of the port's run contracts (the reference's
``tpu_resnet/resilience/exitcodes.py``, value for value), so that a
supervisor or a placement loop reads a port process as it reads the
reference's.

``PREEMPTED`` (42)
    Graceful preemption: SIGTERM honoured, final checkpoint on disk; a
    supervisor resumes instead of backing off.
``NO_CAPACITY`` (3)
    Serve colocation admission denied: the card has no memory headroom
    for this replica; the placement layer tries another host
    (``serve/server.py``).
``DONE`` / ``DRAINED`` (0)
    A trainer's 0 means finished; a serve replica's 0 means it honoured a
    drain.
``USAGE_ERROR`` (2)
    CLI contract errors (argparse's convention).
``HOSTENV_TIMEOUT`` (124) / ``HOSTENV_SPAWN_FAILED`` (127)
    ``timeout(1)``'s codes for a command that ran out of time or did not
    start.
"""

from __future__ import annotations

PREEMPTED = 42
NO_CAPACITY = 3
DONE = 0
DRAINED = 0
USAGE_ERROR = 2
HOSTENV_TIMEOUT = 124
HOSTENV_SPAWN_FAILED = 127
