"""Deterministic fault injection for drills (port of
``tpu_resnet/resilience/faultinject.py``).

Each planned fault fires once, at an exact step, so that a drill proves a
recovery path end to end: a NaN batch → the sentinel's rollback; a data
stall → the watchdog fires and the stream recovers; SIGTERM → a final
save, ``Preempted`` and an exact resume; a corrupt newest checkpoint → the
restore falls back; a synthetic ``RESOURCE_EXHAUSTED`` → the OOM report.
The serve faults point the same idea at the predict server, counted in
predict requests: slow inference (``serve_slow_ms`` a batch), accept then
hang at request K, SIGKILL at request K, and a dropped connection at
request K.
Everything is off by default: an empty plan wraps nothing and costs
nothing. Sources, in order of precedence: the ``TPU_RESNET_FAULT_*``
environment variables, then the ``resilience.inject_*`` config fields.
Each fault is one-shot per injector, and the injector outlives a rollback's
rebuilt stream, so a recovered run does not hit the fault it survived.

Data faults wrap the streamed batches, as the reference's do; the
device-resident split is not wrapped there, and is not here. A batch that
is poisoned or late enters the step as any other: on a graphed loop the
late one through the same slot copies; the poisoned one, float NaN where
the stream is uint8, as one eager step of the captured step's state
(``data/device_data.py`` ``ChunkRunner``), with no recapture.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np

log = logging.getLogger("tpu_resnet_torch")

ENV_PREFIX = "TPU_RESNET_FAULT_"

# The preemption burst's count survives the process deaths it causes.
BURST_STATE_FILE = "fault_burst_state.json"


@dataclasses.dataclass
class FaultPlan:
    nan_at_step: int = -1        # poison the batch consumed at this step
    stall_at_step: int = -1      # the source sleeps before this batch
    stall_seconds: float = 0.0
    sigterm_at_step: int = -1    # SIGTERM to self at this chunk boundary
    corrupt_ckpt_at_start: bool = False  # corrupt newest ckpt before restore
    oom_at_step: int = -1        # synthetic RESOURCE_EXHAUSTED at boundary
    preempt_burst: int = 0       # K SIGTERMs total across supervised runs
    preempt_burst_every: int = 10  # each fires this many steps after start
    # The serve faults (serve/server.py).
    serve_slow_ms: float = 0.0       # extra latency per inference batch
    serve_hang_at_request: int = -1  # accept, then hang at request K
    serve_kill_at_request: int = -1  # SIGKILL self at request K
    serve_drop_at_request: int = -1  # close the connection at request K

    @property
    def active(self) -> bool:
        return (self.nan_at_step >= 0 or self.sigterm_at_step >= 0
                or (self.stall_at_step >= 0 and self.stall_seconds > 0)
                or self.corrupt_ckpt_at_start or self.oom_at_step >= 0
                or self.preempt_burst > 0 or self.serves_faults)

    @property
    def serves_faults(self) -> bool:
        return (self.serve_slow_ms > 0 or self.serve_hang_at_request >= 0
                or self.serve_kill_at_request >= 0
                or self.serve_drop_at_request >= 0)

    @classmethod
    def from_config(cls, resilience_cfg, env=None) -> "FaultPlan":
        """Config fields overridden by ``TPU_RESNET_FAULT_*``: NAN_STEP,
        STALL_STEP, STALL_SEC, SIGTERM_STEP, CORRUPT_CKPT, OOM_STEP,
        PREEMPT_BURST, PREEMPT_BURST_EVERY, SERVE_SLOW_MS, SERVE_HANG_REQ,
        SERVE_KILL_REQ, SERVE_DROP_REQ."""
        env = os.environ if env is None else env
        r = resilience_cfg

        def pick(env_key, cfg_val, cast):
            raw = env.get(ENV_PREFIX + env_key)
            return cast(raw) if raw not in (None, "") else cfg_val

        return cls(
            nan_at_step=pick("NAN_STEP", r.inject_nan_at_step, int),
            stall_at_step=pick("STALL_STEP", r.inject_stall_at_step, int),
            stall_seconds=pick("STALL_SEC", r.inject_stall_seconds, float),
            sigterm_at_step=pick("SIGTERM_STEP", r.inject_sigterm_at_step,
                                 int),
            corrupt_ckpt_at_start=pick(
                "CORRUPT_CKPT", r.inject_corrupt_ckpt,
                lambda v: v.lower() in ("1", "true", "yes")),
            oom_at_step=pick("OOM_STEP", r.inject_oom_at_step, int),
            preempt_burst=pick("PREEMPT_BURST",
                               r.inject_preempt_burst, int),
            preempt_burst_every=pick("PREEMPT_BURST_EVERY",
                                     r.inject_preempt_burst_every, int),
            serve_slow_ms=pick("SERVE_SLOW_MS",
                               r.inject_serve_slow_ms, float),
            serve_hang_at_request=pick("SERVE_HANG_REQ",
                                       r.inject_serve_hang_at_request,
                                       int),
            serve_kill_at_request=pick("SERVE_KILL_REQ",
                                       r.inject_serve_kill_at_request,
                                       int),
            serve_drop_at_request=pick("SERVE_DROP_REQ",
                                       r.inject_serve_drop_at_request,
                                       int),
        )


def _nan_like(images):
    """An all-NaN float32 batch of ``images``' shape, where they are (a
    host array as the reference makes it, or a tensor on its device)."""
    if isinstance(images, np.ndarray):
        return np.full_like(np.asarray(images, np.float32), np.nan)
    import torch

    return torch.full(tuple(images.shape), float("nan"),
                      dtype=torch.float32, device=images.device)


class FaultInjector:
    """Applies a :class:`FaultPlan`, once a fault, at exact steps.
    ``train_dir`` holds the preemption burst's count."""

    def __init__(self, plan: FaultPlan, train_dir: str = None):
        self.plan = plan
        self.train_dir = train_dir
        self._nan_fired = False
        self._stall_fired = False
        self._sigterm_fired = False
        self._corrupt_fired = False
        self._oom_fired = False
        self._burst_start_step = None  # first boundary this process saw
        self._burst_spent = False      # fired >= K (no more re-reads)
        self._serve_requests = 0       # predict requests admitted so far
        self._serve_hung = False
        self._serve_dropped = False
        if plan.active:
            log.warning("FAULT INJECTION ACTIVE: %s", plan)

    @property
    def wraps_data(self) -> bool:
        return self.plan.nan_at_step >= 0 or (
            self.plan.stall_at_step >= 0 and self.plan.stall_seconds > 0)

    def wrap_host_batches(self, it, start_step: int = 0):
        """Wrap a batch stream whose batch ``i`` is the one consumed at
        step ``start_step + i``; ``it`` itself when no data fault is
        planned."""
        if not self.wraps_data:
            return it

        def wrapped():
            for i, (images, labels) in enumerate(it):
                step = start_step + i
                if (self.plan.stall_at_step == step
                        and not self._stall_fired):
                    self._stall_fired = True
                    log.warning("injecting %.1fs data stall before the "
                                "step-%d batch", self.plan.stall_seconds,
                                step)
                    time.sleep(self.plan.stall_seconds)
                if self.plan.nan_at_step == step and not self._nan_fired:
                    self._nan_fired = True
                    log.warning("injecting NaN batch at step %d", step)
                    images = _nan_like(images)
                yield images, labels

        return wrapped()

    def maybe_sigterm(self, step: int) -> None:
        """SIGTERM this process at the first chunk boundary >= the planned
        step (where a real preemption would land)."""
        if (self.plan.sigterm_at_step >= 0 and not self._sigterm_fired
                and step >= self.plan.sigterm_at_step):
            self._sigterm_fired = True
            import signal

            log.warning("injecting SIGTERM at step %d", step)
            os.kill(os.getpid(), signal.SIGTERM)
        self._maybe_burst_sigterm(step)

    @property
    def burst_fired(self) -> int:
        """SIGTERMs the burst has delivered so far, across restarts (the
        ``fault_preempt_burst`` gauge)."""
        if self.plan.preempt_burst <= 0 or not self.train_dir:
            return 0
        try:
            with open(os.path.join(self.train_dir, BURST_STATE_FILE)) as f:
                return int(json.load(f).get("fired", 0))
        except (OSError, ValueError):
            return 0

    def _maybe_burst_sigterm(self, step: int) -> None:
        """K SIGTERMs across supervised restarts: each process preempts
        itself ``preempt_burst_every`` steps after its first chunk boundary
        until K have fired in all (counted in ``fault_burst_state.json``,
        since each firing kills the process that would remember it)."""
        if self.plan.preempt_burst <= 0 or self._sigterm_fired \
                or self._burst_spent or not self.train_dir:
            return
        if self._burst_start_step is None:
            self._burst_start_step = step
        if step < self._burst_start_step + self.plan.preempt_burst_every:
            return
        fired = self.burst_fired
        if fired >= self.plan.preempt_burst:
            self._burst_spent = True
            return
        self._sigterm_fired = True  # at most one per process, either path
        path = os.path.join(self.train_dir, BURST_STATE_FILE)
        try:
            os.makedirs(self.train_dir, exist_ok=True)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"fired": fired + 1,
                           "of": self.plan.preempt_burst}, f)
            os.replace(tmp, path)
        except OSError as e:
            log.warning("preempt burst: could not persist state (%s); not "
                        "firing (an unbounded burst would never converge)",
                        e)
            return
        import signal

        log.warning("injecting preemption burst SIGTERM %d/%d at step %d",
                    fired + 1, self.plan.preempt_burst, step)
        os.kill(os.getpid(), signal.SIGTERM)

    # ---------------------------------------------------- serve faults
    def wrap_serve_infer(self, infer_fn):
        """The predict server's inference callable with the planned slow
        and hang faults (the batcher thread is the one that sleeps or
        hangs, so requests keep being accepted); ``infer_fn`` itself when
        no serve fault is planned."""
        if not self.plan.serves_faults:
            return infer_fn

        def wrapped(images):
            if (self.plan.serve_hang_at_request >= 0
                    and self._serve_requests
                    >= self.plan.serve_hang_at_request):
                if not self._serve_hung:
                    self._serve_hung = True
                    log.warning("injecting serve hang at request %d "
                                "(batcher thread sleeps; requests keep "
                                "being accepted and time out)",
                                self._serve_requests)
                while True:          # hung for good: the drill is about
                    time.sleep(60)   # eviction, not recovery
            if self.plan.serve_slow_ms > 0:
                time.sleep(self.plan.serve_slow_ms / 1e3)
            return infer_fn(images)

        return wrapped

    def note_serve_request(self) -> None:
        """Count one admitted predict request; SIGKILL this process (no
        drain, no exit handler) at the planned request K."""
        self._serve_requests += 1
        if (self.plan.serve_kill_at_request >= 0
                and self._serve_requests
                >= self.plan.serve_kill_at_request):
            import signal

            log.warning("injecting serve SIGKILL at request %d",
                        self._serve_requests)
            os.kill(os.getpid(), signal.SIGKILL)

    def should_drop_connection(self) -> bool:
        """True once, for the first incoming predict request >= the planned
        request K: the handler then closes the socket with no response
        (before the request is admitted, so it is not counted)."""
        if (self.plan.serve_drop_at_request < 0 or self._serve_dropped
                or self._serve_requests + 1
                < self.plan.serve_drop_at_request):
            return False
        self._serve_dropped = True
        log.warning("injecting serve connection drop at request %d "
                    "(no HTTP response; the client sees an abrupt "
                    "disconnect)", self._serve_requests + 1)
        return True

    def maybe_oom(self, step: int) -> None:
        """Raise a synthetic out-of-memory error, carrying the
        ``RESOURCE_EXHAUSTED`` status, at the first chunk boundary >= the
        planned step: the drill of the loop's OOM report."""
        if (self.plan.oom_at_step < 0 or self._oom_fired
                or step < self.plan.oom_at_step):
            return
        self._oom_fired = True
        log.warning("injecting RESOURCE_EXHAUSTED at step %d", step)
        raise RuntimeError(
            f"RESOURCE_EXHAUSTED: injected OOM drill at step {step} "
            f"(resilience.inject_oom_at_step) — out of memory while "
            f"trying to allocate 18446744073709551615 bytes")

    def maybe_corrupt_checkpoint(self, train_dir: str) -> None:
        """Corrupt the newest checkpoint before the startup restore."""
        if self.plan.corrupt_ckpt_at_start and not self._corrupt_fired:
            self._corrupt_fired = True
            step = corrupt_checkpoint(train_dir)
            log.warning("injected corruption into checkpoint step %s under "
                        "%s", step, train_dir)


def corrupt_checkpoint(directory: str, step=None):
    """Overwrite every file of one checkpoint step (the newest by default)
    with garbage; returns that step, or None when there is none."""
    directory = os.path.abspath(directory)
    steps = sorted(int(name) for name in os.listdir(directory)
                   if name.isdigit()) if os.path.isdir(directory) else []
    if not steps:
        return None
    step = max(steps) if step is None else int(step)
    step_dir = os.path.join(directory, str(step))
    for root, _, files in os.walk(step_dir):
        for name in files:
            path = os.path.join(root, name)
            try:
                size = max(os.path.getsize(path), 16)
                with open(path, "wb") as f:
                    f.write(b"\xde\xad\xbe\xef" * ((size + 3) // 4))
            except OSError:
                pass
    return step
