"""Restart supervisor of the port's preemptible processes (the
reference's ``tools/supervise.py``, flag for flag and default for
default):

    python -m tpu_resnet_torch.tools.supervise [options] -- \
        python -m tpu_resnet_torch train --preset cifar10 \
        train.train_dir=/data/run1

The trainer's graceful shutdown (``resilience/shutdown.py``) turns
SIGTERM/SIGINT into: finish the chunk, save a final checkpoint, exit 42
(``exitcodes.PREEMPTED``). This wrapper reruns the command so the run
resumes from that checkpoint, with a policy by exit code:

- **the preempt code**: restart after a short fixed delay; these are
  expected and do not count against the crash backoff.
- **any other nonzero code** (a crash): restart with capped,
  decorrelated-jitter exponential backoff (each delay drawn uniformly
  from [base, 3 · previous], capped at ``--backoff-cap``), so a fleet
  that shares a fault does not restart in synchronized waves; the crash
  streak resets on any clean interval. The delay is logged.
- **0**: done, exit 0.

**Downsize** (``resilience/elastic.py``): with ``--downsize-after N
--mesh-ladder 4,2``, N preemptions inside ``--downsize-window`` seconds
make the next restart append ``mesh.data=<rung>`` (the next ladder
entry); the trainer's elastic resume reshards the checkpoint onto the
smaller mesh. A later override wins, so the base command stays as it is.

**Fleet mode** (serving): ``--fleet N`` supervises N children of one
command template, ``{i}`` in the args replaced by the child index
(``serve.replica_name=r{i}``), each child with its own backoff;
``--stop-codes 3`` honours the serve colocation-admission verdict (exit
3, ``exitcodes.NO_CAPACITY``: no capacity on this host, so no restart
here), and ``--restart-clean-exits`` restarts children that exit 0 (a
drained replica comes back for the router to readmit), unlike a
trainer's 0, which means done.

    python -m tpu_resnet_torch.tools.supervise --fleet 2 --stop-codes 3 \
        --restart-clean-exits -- \
        python -m tpu_resnet_torch serve --preset cifar10 \
        train.train_dir=/data/run1 serve.replica_name=r{i}

The autopilot (``autopilot/actuator.py``) wraps each replica it spawns
in this supervisor with ``--stop-codes 3``. Standard library only (and
``resilience/exitcodes.py``, which is): it must keep working on a host
whose accelerator stack is the thing that crashes.
"""

from __future__ import annotations

import argparse
import logging
import random
import subprocess
import sys
import time

from tpu_resnet_torch.resilience import exitcodes

log = logging.getLogger("tpu_resnet_torch.supervise")

DEFAULT_PREEMPT_CODE = exitcodes.PREEMPTED


def _run_id_of(cmd) -> str:
    """Best-effort run_id of the supervised trainer: find the
    ``train.train_dir=...`` override in ``cmd`` and read the run_id.json
    the trainer minted there (``obs/manifest.py``). Stdlib-only; '' when
    unknown. Logged with every restart so a supervisor log line can be
    joined to the run's trace-export timeline."""
    import json
    import os

    train_dir = None
    for arg in cmd:
        if isinstance(arg, str) and arg.startswith("train.train_dir="):
            train_dir = arg.split("=", 1)[1]
    if not train_dir:
        return ""
    try:
        with open(os.path.join(train_dir, "run_id.json")) as f:
            return str(json.load(f).get("run_id") or "")
    except (OSError, ValueError):
        return ""


class DownsizePolicy:
    """Restart with a smaller mesh after repeated preemptions.

    ``threshold`` preemptions inside ``window_sec`` pop the next rung of
    ``ladder`` (data-axis sizes, largest first, e.g. ``(4, 2)``) — the
    signal that this host's capacity is churning and the run should ride
    the wave at a smaller shape instead of thrashing at the original
    one. The preemption history clears on each downsize (the new shape
    gets a fresh window) and on any crash-free completion. ``clock`` is
    injectable for tests."""

    def __init__(self, threshold: int, window_sec: float, ladder,
                 clock=time.time):
        self.threshold = int(threshold)
        self.window_sec = float(window_sec)
        self.ladder = [int(x) for x in ladder]
        self.clock = clock
        self.events = []  # preemption timestamps inside the window

    def note_preempt(self):
        """Record one preemption; returns the new ``mesh.data`` size when
        the policy triggers, else None."""
        if self.threshold <= 0:
            return None
        now = self.clock()
        self.events.append(now)
        self.events = [t for t in self.events
                       if now - t <= self.window_sec]
        if len(self.events) >= self.threshold and self.ladder:
            self.events.clear()
            return self.ladder.pop(0)
        return None


def supervise(cmd, max_restarts: int = 100, preempt_code: int =
              DEFAULT_PREEMPT_CODE, backoff_base: float = 1.0,
              backoff_cap: float = 300.0, preempt_delay: float = 1.0,
              jitter: bool = True, rng=None,
              downsize_after: int = 0, downsize_window: float = 600.0,
              mesh_ladder=(), stop_codes=(), restart_clean: bool = False,
              run=None, sleep=time.sleep) -> int:
    """Run ``cmd`` under the restart policy; returns the final exit code.
    ``run``/``sleep``/``rng`` are injectable for tests; ``jitter=False``
    restores the deterministic base·2^crashes schedule. ``stop_codes``
    are exit codes that END supervision immediately (no restart) while
    still reporting the code — the serve fleet uses 3 here, the
    colocation-admission "placed elsewhere" verdict (resilience/
    elastic.py): restarting on the same host would just be denied
    again. ``restart_clean=True`` restarts exit-0 children too (after
    ``preempt_delay``, no crash backoff): serving-fleet semantics, where
    a replica's clean exit means it was DRAINED for a rolling
    hot-reload/upgrade (``route --drain``) and the upgrade contract is
    that it comes back and the router readmits it — without this the
    documented rolling drain would permanently shrink the fleet."""
    if run is None:
        run = lambda c: subprocess.call(c)  # noqa: E731
    if rng is None:
        rng = random.Random()
    stop_codes = set(stop_codes)
    policy = (DownsizePolicy(downsize_after, downsize_window, mesh_ladder)
              if downsize_after > 0 and mesh_ladder else None)
    mesh_override = None  # appended last: later config overrides win
    restarts = 0
    crash_streak = 0
    prev_delay = backoff_base
    while True:
        rc = run(list(cmd) + ([mesh_override] if mesh_override else []))
        run_id = _run_id_of(cmd)
        if run_id:
            log.info("supervised run_id=%s exited %d", run_id, rc)
        if rc == 0 and not restart_clean:
            log.info("command exited 0 after %d restart(s)", restarts)
            return 0
        if rc in stop_codes:
            log.warning("exit code %d is a stop code (e.g. colocation "
                        "admission denied) — not restarting", rc)
            return rc
        if restarts >= max_restarts:
            log.error("giving up after %d restart(s); last exit code %d",
                      restarts, rc)
            return rc
        restarts += 1
        if rc == 0:
            # Clean exit under restart_clean = a drained serve replica
            # in a rolling upgrade: bring it straight back (preempt-
            # style fixed delay, no crash backoff) so the router's
            # probe readmits it and the fleet regains capacity.
            crash_streak = 0
            prev_delay = backoff_base
            delay = preempt_delay
            log.info("clean exit (drained) — restarting in %.1fs for "
                     "the rolling-upgrade readmit (restart %d/%d)",
                     delay, restarts, max_restarts)
        elif rc == preempt_code:
            crash_streak = 0
            prev_delay = backoff_base
            delay = preempt_delay
            rung = policy.note_preempt() if policy is not None else None
            if rung is not None:
                mesh_override = f"mesh.data={rung}"
                log.warning(
                    "downsize policy: %d preemption(s) within %.0fs — "
                    "restarting with %s (elastic resume reshards the "
                    "checkpoint onto the smaller mesh)",
                    downsize_after, downsize_window, mesh_override)
            log.warning("preempted (exit %d) — resuming from the final "
                        "checkpoint in %.1fs (restart %d/%d)%s", rc, delay,
                        restarts, max_restarts,
                        f" with {mesh_override}" if mesh_override else "")
        else:
            crash_streak += 1
            if jitter:
                # Decorrelated jitter: uniform in [base, 3·previous],
                # capped — a fleet restarting after a shared fault
                # spreads out instead of stampeding in lockstep.
                delay = min(backoff_cap,
                            rng.uniform(backoff_base,
                                        max(backoff_base, prev_delay) * 3))
            else:
                delay = min(backoff_cap,
                            backoff_base * (2 ** (crash_streak - 1)))
            prev_delay = delay
            log.warning("crashed (exit %d) — restart %d/%d in %.1fs "
                        "(crash streak %d%s)", rc, restarts, max_restarts,
                        delay, crash_streak,
                        ", decorrelated jitter" if jitter else "")
        sleep(delay)


def supervise_fleet(cmd, fleet: int, placeholder: str = "{i}",
                    **kwargs) -> int:
    """Fleet mode: supervise ``fleet`` children of ``cmd`` from ONE
    invocation, each under its own independent restart policy (the
    decorrelated-jitter crash backoff per child is exactly what keeps a
    fleet that shares a fault from restarting in stampede lockstep).

    ``placeholder`` occurrences in the command args are substituted with
    the child index, so one template names per-replica identities:

        supervise --fleet 3 -- python -m tpu_resnet_torch serve \\
            train.train_dir=/data/run1 serve.replica_name=r{i}

    Returns 0 when every child ends 0, else the first nonzero child
    code. Stdlib-only, one thread per child (the children are processes;
    the threads just run their restart loops)."""
    import threading

    rcs = [None] * fleet
    threads = []
    for i in range(fleet):
        child_cmd = [a.replace(placeholder, str(i))
                     if isinstance(a, str) else a for a in cmd]

        def runner(idx=i, c=child_cmd):
            log.info("fleet child %d: %s", idx, " ".join(map(str, c)))
            rcs[idx] = supervise(c, **kwargs)
            log.info("fleet child %d finished rc=%s", idx, rcs[idx])

        t = threading.Thread(target=runner, name=f"supervise-fleet-{i}",
                             daemon=True)
        threads.append(t)
        t.start()
    for t in threads:
        t.join()
    bad = [rc for rc in rcs if rc not in (0, None)]
    log.info("fleet done: rcs=%s", rcs)
    return bad[0] if bad else 0


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        datefmt="%H:%M:%S", stream=sys.stderr)
    p = argparse.ArgumentParser(
        prog="python -m tpu_resnet_torch.tools.supervise",
        description="restart wrapper: auto-resume on the trainer's "
                    "preemption exit code, capped exponential backoff on "
                    "crashes")
    p.add_argument("--max-restarts", type=int, default=100)
    p.add_argument("--preempt-code", type=int, default=DEFAULT_PREEMPT_CODE,
                   help="exit code meaning 'preempted, resume me' "
                        "(resilience.preempt_exit_code)")
    p.add_argument("--backoff-base", type=float, default=1.0,
                   help="first crash-restart delay, seconds")
    p.add_argument("--backoff-cap", type=float, default=300.0,
                   help="max crash-restart delay, seconds")
    p.add_argument("--preempt-delay", type=float, default=1.0,
                   help="fixed delay before resuming after a preemption")
    p.add_argument("--no-jitter", action="store_true",
                   help="disable the decorrelated crash-backoff jitter "
                        "(deterministic base*2^crashes schedule)")
    p.add_argument("--downsize-after", type=int, default=0,
                   help="preemptions inside --downsize-window that "
                        "trigger a mesh downsize (0 = policy off)")
    p.add_argument("--downsize-window", type=float, default=600.0,
                   help="downsize-policy window, seconds")
    p.add_argument("--mesh-ladder", default="",
                   help="comma-separated mesh.data sizes to step down "
                        "through on downsize, largest first (e.g. 4,2)")
    p.add_argument("--fleet", type=int, default=0,
                   help="fleet mode: supervise N children of the same "
                        "command template, '{i}' in args replaced by "
                        "the child index (serve.replica_name=r{i}); "
                        "each child keeps its own restart policy")
    p.add_argument("--stop-codes", default="",
                   help="comma-separated exit codes that stop "
                        "supervision without a restart (e.g. 3 = serve "
                        "colocation admission denied: this host has no "
                        "capacity, restarting here is pointless)")
    p.add_argument("--restart-clean-exits", action="store_true",
                   help="restart exit-0 children too (serving fleets: a "
                        "replica's clean exit means it was DRAINED for "
                        "a rolling upgrade and must come back for the "
                        "router to readmit; trainers keep the default "
                        "'0 = done')")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="command to supervise (prefix with --)")
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        p.error("no command given; usage: python -m "
                "tpu_resnet_torch.tools.supervise [options] -- cmd ...")
    try:
        ladder = tuple(int(x) for x in args.mesh_ladder.split(",")
                       if x.strip())
    except ValueError:
        p.error(f"--mesh-ladder must be comma-separated integers "
                f"(e.g. 4,2): {args.mesh_ladder!r}")
    try:
        stop_codes = tuple(int(x) for x in args.stop_codes.split(",")
                           if x.strip())
    except ValueError:
        p.error(f"--stop-codes must be comma-separated integers: "
                f"{args.stop_codes!r}")
    if args.downsize_after > 0 and not ladder:
        p.error("--downsize-after requires --mesh-ladder")
    kwargs = dict(max_restarts=args.max_restarts,
                  preempt_code=args.preempt_code,
                  backoff_base=args.backoff_base,
                  backoff_cap=args.backoff_cap,
                  preempt_delay=args.preempt_delay,
                  jitter=not args.no_jitter,
                  downsize_after=args.downsize_after,
                  downsize_window=args.downsize_window,
                  mesh_ladder=ladder, stop_codes=stop_codes,
                  restart_clean=args.restart_clean_exits)
    if args.fleet > 0:
        return supervise_fleet(cmd, args.fleet, **kwargs)
    return supervise(cmd, **kwargs)


if __name__ == "__main__":
    sys.exit(main())
