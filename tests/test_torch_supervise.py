"""The port's restart supervisor (``tpu_resnet_torch/tools/supervise.py``)
against the reference's ``tools/supervise.py``: seeded sequences of child
exit codes through both ``supervise`` (and ``supervise_fleet``) with the
same seeded ``rng`` and recording ``run``/``sleep`` give the same argv
lists, delays and return codes; both CLIs parse the same flags into the
same arguments; the supervisor loads nothing beyond the standard library;
and, end to end on the CPU, it carries the port's trainer across a
preemption burst to its final step."""

import json
import os
import random
import subprocess
import sys
import threading

import pytest

from tools import supervise as ref_sup
from tpu_resnet_torch.tools import supervise as port_sup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CMD = ["python", "-m", "tpu_resnet_torch", "train", "--preset", "smoke"]
# Exit codes a child may end with: done, crashes, the colocation denial,
# the preemption code, a signal's negative code.
CODES = (0, 1, 2, 3, 42, 137, -9)


def _drive(mod, codes, **kwargs):
    """``mod.supervise`` over a child that exits ``codes`` in turn (then
    0): the argv of every run, the delays slept and the return code."""
    runs, delays = [], []
    it = iter(codes)

    def run(argv):
        runs.append(list(argv))
        return next(it, 0)

    rc = mod.supervise(CMD, run=run, sleep=delays.append, **kwargs)
    return {"rc": rc, "runs": runs, "delays": delays}


# Each case: its supervisor arguments (``rng`` seeded per sequence) and the
# codes it draws from.
CASES = {
    "crash_jitter": (dict(backoff_base=0.5, backoff_cap=20.0), CODES),
    "crash_no_jitter": (dict(backoff_base=0.25, jitter=False,
                             backoff_cap=4.0), (0, 1, 2, 42, 137)),
    "preempt_code": (dict(preempt_code=7, preempt_delay=0.3),
                     (7, 7, 1, 42, 0)),
    "stop_codes": (dict(stop_codes=(3, 5), max_restarts=6),
                   (1, 42, 137, 3, 5)),
    "restart_clean": (dict(restart_clean=True, max_restarts=5,
                           preempt_delay=0.2), (0, 0, 1, 42)),
    "max_restarts": (dict(max_restarts=3), (1, 2, 137, -9)),
    "downsize_ladder": (dict(downsize_after=2, mesh_ladder=(4, 2, 1),
                             max_restarts=12), (42, 42, 1, 42, 0)),
    "downsize_off_without_ladder": (dict(downsize_after=2),
                                    (42, 42, 42, 0)),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", sorted(CASES))
def test_supervise_matches_reference(case, seed):
    kwargs, pool = CASES[case]
    gen = random.Random(1000 * seed + len(case))
    codes = [gen.choice(pool) for _ in range(gen.randint(3, 14))]
    got = _drive(port_sup, codes, rng=random.Random(seed), **kwargs)
    want = _drive(ref_sup, codes, rng=random.Random(seed), **kwargs)
    assert got == want
    assert got["runs"] and all(r[:len(CMD)] == CMD for r in got["runs"])


def test_supervise_downsize_appends_the_next_rung():
    """Two preemptions pop the ladder's next rung, appended last."""
    got = _drive(port_sup, [42, 42, 42, 42, 0], downsize_after=2,
                 mesh_ladder=(4, 2), rng=random.Random(0))
    assert [r[len(CMD):] for r in got["runs"]] == [
        [], [], ["mesh.data=4"], ["mesh.data=4"], ["mesh.data=2"]]
    assert got["rc"] == 0 and got["delays"] == [1.0] * 4


def _drive_fleet(mod, fleet, codes_by_child, **kwargs):
    """``mod.supervise_fleet`` over children whose codes depend on their
    index (read back from the ``{i}`` substitution)."""
    lock = threading.Lock()
    runs, delays, left = {}, {}, {}

    def run(argv):
        i = int(argv[-1].split("=r", 1)[1])
        with lock:
            runs.setdefault(i, []).append(list(argv))
            seq = left.setdefault(i, list(codes_by_child[i]))
            return seq.pop(0) if seq else 0

    def sleep(sec):
        with lock:
            delays.setdefault(threading.current_thread().name,
                              []).append(sec)

    rc = mod.supervise_fleet(CMD + ["serve.replica_name=r{i}"], fleet,
                             run=run, sleep=sleep, **kwargs)
    return {"rc": rc, "runs": runs, "delays": delays}


@pytest.mark.parametrize("codes,kwargs", [
    ({0: [1, 0], 1: [42, 0], 2: [137, 1, 0]}, dict(jitter=False)),
    ({0: [0, 0], 1: [3], 2: [1, 0]},
     dict(jitter=False, stop_codes=(3,), restart_clean=True,
          max_restarts=2)),
], ids=["crashes", "stop_and_clean"])
def test_supervise_fleet_matches_reference(codes, kwargs):
    got = _drive_fleet(port_sup, 3, codes, **kwargs)
    want = _drive_fleet(ref_sup, 3, codes, **kwargs)
    assert got == want
    assert {i: r[0][-1] for i, r in got["runs"].items()} == {
        i: f"serve.replica_name=r{i}" for i in range(3)}


def _parsed(mod, argv, monkeypatch):
    """What ``mod.main(argv)`` hands ``supervise``/``supervise_fleet``."""
    seen = {}

    def record(name):
        def fn(cmd, *args, **kwargs):
            seen.update(fn=name, cmd=cmd, args=args, kwargs=kwargs)
            return 0
        return fn

    monkeypatch.setattr(mod, "supervise", record("supervise"))
    monkeypatch.setattr(mod, "supervise_fleet", record("supervise_fleet"))
    try:
        rc = mod.main(argv)
    except SystemExit as e:
        rc = ("exit", e.code)
    return rc, seen


@pytest.mark.parametrize("argv", [
    ["--", "python", "-m", "x", "train"],
    ["--max-restarts", "5", "--preempt-code", "9", "--backoff-base", "2",
     "--backoff-cap", "30", "--preempt-delay", "0.5", "--no-jitter", "--",
     "cmd", "a"],
    ["--downsize-after", "2", "--mesh-ladder", "4,2", "--downsize-window",
     "60", "--", "cmd"],
    ["--fleet", "3", "--stop-codes", "3", "--restart-clean-exits", "--",
     "cmd", "serve.replica_name=r{i}"],
    ["--downsize-after", "2", "--", "cmd"],
    ["--mesh-ladder", "4,x", "--", "cmd"],
    ["--stop-codes", "a", "--", "cmd"],
    [],
], ids=["defaults", "flags", "downsize", "fleet", "no_ladder",
        "bad_ladder", "bad_stop_codes", "no_command"])
def test_cli_parses_like_the_reference(argv, monkeypatch, capsys):
    assert _parsed(port_sup, argv, monkeypatch) == \
        _parsed(ref_sup, argv, monkeypatch)


def test_supervisor_loads_only_the_standard_library():
    """It must run where the accelerator stack is what crashes: no torch,
    no numpy, nothing of JAX or the reference."""
    code = ("import sys, tpu_resnet_torch.tools.supervise; print(sorted("
            "m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'jaxlib', 'flax', 'tpu_resnet')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    assert out.strip() == "[]", out


def _train_cmd(d, steps, *extra):
    return [sys.executable, "-m", "tpu_resnet_torch", "train", "--device",
            "cpu", "--preset", "smoke", f"train.train_dir={d}",
            f"train.train_steps={steps}", "train.checkpoint_every=10",
            "train.log_every=5", "train.steps_per_call=5",
            "resilience.inject_preempt_burst=2",
            "resilience.inject_preempt_burst_every=10", *extra]


def _supervised(d, sup_args, cmd, timeout):
    """The supervisor over ``cmd``; its children on one intra-op thread
    each (the suite's workers share the host's cores, and spinning OpenMP
    threads over them stall)."""
    from tpu_resnet_torch.hostenv import run_subprocess
    rc, out = run_subprocess(
        [sys.executable, "-m", "tpu_resnet_torch.tools.supervise",
         "--preempt-delay", "0", *sup_args, "--", *cmd], timeout=timeout,
        extra_env={"OMP_NUM_THREADS": "1"})
    with open(os.path.join(d, "fault_burst_state.json")) as f:
        burst = json.load(f)
    steps = sorted(int(n) for n in os.listdir(d) if n.isdigit())
    return rc, out, burst, steps


def test_supervised_trainer_rides_a_preemption_burst(tmp_path):
    """Two injected SIGTERMs, each 10 steps after its child's first chunk
    boundary: the children exit 42, 42, then 0 at step 30, and the
    supervisor exits 0."""
    d = str(tmp_path)
    rc, out, burst, steps = _supervised(d, [], _train_cmd(d, 30), 150)
    assert rc == 0, out[-2000:]
    assert burst == {"fired": 2, "of": 2}
    assert steps == [10, 20, 30]
    assert out.count("preempted (exit 42)") == 2, out[-2000:]
    assert "command exited 0 after 2 restart(s)" in out


@pytest.mark.slow  # three launches, two of them two gloo ranks (~27 s)
def test_supervisor_downsizes_two_gloo_ranks_to_one(tmp_path):
    """``--downsize-after 2 --mesh-ladder 1``: the burst preempts two
    2-rank runs, the third child gets ``mesh.data=1`` appended and the
    elastic resume finishes the run on one rank."""
    from tpu_resnet_torch.resilience import elastic
    d = str(tmp_path)
    rc, out, burst, steps = _supervised(
        d, ["--downsize-after", "2", "--mesh-ladder", "1"],
        _train_cmd(d, 30, "model.name=mlp", "mesh.data=2",
                   "model.sync_bn=false"), 240)
    assert rc == 0, out[-2000:]
    assert burst == {"fired": 2, "of": 2} and steps == [10, 20, 30]
    assert "with mesh.data=1" in out
    assert elastic.read_topology(d)["mesh_shape"] == {"data": 1,
                                                      "model": 1}
