"""The reference's fault drills (``tests/test_resilience_drills.py``) on the
port's ``train()``, each run on the reference's ``train()`` too, on the same
plan, with the outcomes compared: SIGTERM → a clean save and an exact
resume, then a corrupt newest checkpoint → the restore falls back; a NaN
batch → rollback past the bad window (losses against the reference's,
from its initial weights); a data stall → the watchdog's stack dump,
unhealthy mark and recovery; SIGTERM during a stall; the
``TPU_RESNET_FAULT_*`` channel; a synthetic OOM in flight → the emergency
save and ``oom_report.json``. (A NaN with no checkpoint, and the emergency
save after a crash in a metrics write, are held against the reference in
``tests/test_torch_train.py``.) The smoke preset (ResNet-8, synthetic data, float32,
B=8) on the streaming path, where both inject their data faults; one CPU
device each. Every stall is at most 2 s."""

import glob
import json
import os
import signal
import threading
import time
import types

import jax
import pytest
import torch

from tpu_resnet import resilience as ref_resilience
from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.obs import memory as ref_memory
from tpu_resnet.obs.spans import load_spans
from tpu_resnet.parallel import create_mesh
from tpu_resnet.resilience import faultinject as ref_faultinject
from tpu_resnet.train import latest_step_in as ref_latest_step_in
from tpu_resnet.train import train as ref_train
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.obs import memory
from tpu_resnet_torch.resilience import faultinject
from tpu_resnet_torch.resilience.shutdown import Preempted
from tpu_resnet_torch.train import checkpoint
from tpu_resnet_torch.train.loop import train

import test_torch_chunked_train as tct
import test_torch_train as tt

SIDES = ("ref", "port")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's runs here: they are small, and
    the suite's workers share the host's cores (a thread pool per worker
    oversubscribes them many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# The once-a-run ledgers are off in the drills (the reference's memory and
# comms ledgers are XLA compiles of their own), but for the OOM drill's.
LEDGERS_OFF = ("train.mfu_accounting=false", "train.memory_ledger=false",
               "train.comms_ledger=false")


def _run(side, train_dir, *extra, steps=12):
    """``train()`` of ``side`` on the drill's config and ``extra``."""
    overrides = tt._fault_overrides(train_dir, f"train.train_steps={steps}",
                                    *LEDGERS_OFF, *extra)
    if side == "ref":
        cfg = ref_load_config("smoke", "", overrides)
        return ref_train(cfg, mesh=create_mesh(cfg.mesh,
                                               devices=jax.devices()[:1]))
    return train(load_config("smoke", "", overrides), device="cpu")


def _step(side, state):
    return int(jax.device_get(state.step)) if side == "ref" else state.step


def _latest(side, train_dir):
    return (ref_latest_step_in(str(train_dir)) if side == "ref"
            else checkpoint.latest_step_in(str(train_dir)))


def _spans(train_dir, kind=None):
    spans = load_spans(os.path.join(str(train_dir), "events.jsonl"))
    return [s for s in spans if kind is None or s["span"] == kind]


def _runs(train_dir):
    return [(s["start_step"], s["stop_step"])
            for s in _spans(train_dir, "run")]


PREEMPTED = {"ref": ref_resilience.Preempted, "port": Preempted}


@pytest.mark.parametrize("side", SIDES)
def test_sigterm_drill_then_corrupt_checkpoint_drill(tmp_path, side):
    """SIGTERM at step 6: ``Preempted``, a clean save at 6, and a resume to
    12 with no step lost or replayed. Then the resume's injector corrupts
    the newest checkpoint (``resilience.inject_corrupt_ckpt``): the
    restore falls back to the step before and the run goes on to 16."""
    with pytest.raises(PREEMPTED[side]) as exc:
        _run(side, tmp_path, "resilience.inject_sigterm_at_step=6")
    assert exc.value.step == 6
    assert _latest(side, tmp_path) == 6       # the resume loses no step
    assert _step(side, _run(side, tmp_path)) == 12
    assert _runs(tmp_path) == [(0, 6), (6, 12)]
    (stop,) = _spans(tmp_path, "preempt_stop")
    assert stop["step"] == 6 and stop["signum"] == signal.SIGTERM

    state = _run(side, tmp_path, "resilience.inject_corrupt_ckpt=true",
                 steps=16)
    assert _step(side, state) == 16
    assert [s["step"] for s in _spans(
        tmp_path, "checkpoint_restore_failed")] == [12]
    restore = _spans(tmp_path, "checkpoint_restore")[-1]
    assert restore["step"] == 8 and restore["fallback_from_step"] == 12
    assert _runs(tmp_path) == [(0, 6), (6, 12), (8, 16)]
    assert _latest(side, tmp_path) == 16


def test_nan_drill_matches_the_reference(tmp_path, monkeypatch):
    """The injector-driven twin of
    ``test_torch_train.py::test_nan_rollback_matches_the_reference``: both
    poison the step-5 batch with their own injector
    (``resilience.inject_nan_at_step``), from the reference's initial
    weights; both write one ``nan_rollback`` span, 6 → 4, retry 1, and log
    the same losses (float32, other summation orders: the tolerance of
    ``tt._close_losses``)."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    _run("ref", ref_dir, "resilience.inject_nan_at_step=5")
    cfg = load_config("smoke", "", tt._fault_overrides(
        port_dir, *LEDGERS_OFF, "resilience.inject_nan_at_step=5"))
    tct._from_reference_init(cfg, monkeypatch)
    assert train(cfg, device="cpu").step == 12
    key = ("from_step", "to_step", "retry")
    (want,) = _spans(ref_dir, "nan_rollback")
    (got,) = _spans(port_dir, "nan_rollback")
    assert [got[k] for k in key] == [want[k] for k in key] == [6, 4, 1]
    assert got["loss"] == want["loss"] == "nan"
    tt._close_losses(tt._losses(port_dir), tt._reference_losses(ref_dir))


# The stall lands after the first dispatch and its ledgers (the producer
# runs at most ~7 batches ahead), so the loop is blocked once the queue
# drains: 1.5 s against a 0.5 s watchdog.
STALL = ("resilience.watchdog_stall_sec=0.5",
         "resilience.inject_stall_at_step=10",
         "resilience.inject_stall_seconds=1.5")


@pytest.mark.parametrize("side", SIDES)
def test_stall_drill_watchdog_fires_and_stream_recovers(tmp_path, side):
    assert _step(side, _run(side, tmp_path, *STALL, steps=16)) == 16
    stalls = [s for s in _spans(tmp_path, "watchdog_stall")
              if s["step"] >= 4]
    assert stalls, "the watchdog never fired during the injected stall"
    with open(stalls[0]["stack_dump"]) as f:
        assert "MainThread" in f.read()
    recovered = [s for s in _spans(tmp_path, "watchdog_recovered")
                 if s["start"] >= stalls[0]["start"]]
    assert recovered and recovered[0]["outage_sec"] > 0.5


class _SigtermDuringSleep:
    """``time`` for a fault injector's module: its stall's sleep sends this
    process SIGTERM after ``after`` s, while the loop waits on the stalled
    stream."""

    def __init__(self, after):
        self.after = after

    def sleep(self, seconds):
        threading.Timer(self.after, os.kill,
                        args=(os.getpid(), signal.SIGTERM)).start()
        time.sleep(seconds)

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.mark.parametrize("side", SIDES)
def test_sigterm_during_data_stall_still_saves(tmp_path, side,
                                               monkeypatch):
    """SIGTERM while the loop is blocked on a stalled source: the external
    stop ends the wait, the final save lands at the stop step, well before
    the stall is over."""
    mod = ref_faultinject if side == "ref" else faultinject
    monkeypatch.setattr(mod, "time", _SigtermDuringSleep(0.5))
    t0 = time.monotonic()
    with pytest.raises(PREEMPTED[side]) as exc:
        _run(side, tmp_path, "resilience.inject_stall_at_step=10",
             "resilience.inject_stall_seconds=2.0", steps=16)
    assert time.monotonic() - t0 < 60
    assert 4 <= exc.value.step <= 10
    assert _latest(side, tmp_path) == exc.value.step
    (stop,) = _spans(tmp_path, "preempt_stop")
    assert stop["step"] == exc.value.step


@pytest.mark.parametrize("side", SIDES)
def test_preempt_env_injection_and_stack_artifacts_clean(tmp_path, side,
                                                         monkeypatch):
    """``TPU_RESNET_FAULT_SIGTERM_STEP`` drives the same drill as the
    config field; a clean preemption leaves no stall dumps."""
    monkeypatch.setenv("TPU_RESNET_FAULT_SIGTERM_STEP", "4")
    with pytest.raises(PREEMPTED[side]) as exc:
        _run(side, tmp_path)
    assert exc.value.step == 4
    assert _latest(side, tmp_path) == 4
    assert not glob.glob(os.path.join(str(tmp_path), "stall_stacks_*.txt"))


def test_oom_drill_emergency_save_and_report(tmp_path):
    """``resilience.inject_oom_at_step=6`` with no periodic checkpoint:
    both raise the synthetic RESOURCE_EXHAUSTED at the step-6 boundary,
    save the unsaved progress once (the emergency save: checkpoint 6, an
    ``emergency_save`` span), and write ``oom_report.json`` and an ``oom``
    span; the port's report passes the reference's validator and its own,
    and names the memory ledger's program key."""
    reports = {}
    for side in SIDES:
        d = tmp_path / side
        with pytest.raises(Exception, match="RESOURCE_EXHAUSTED"):
            _run(side, d, "train.memory_ledger=true",
                 "train.checkpoint_every=100",
                 "resilience.inject_oom_at_step=6")
        assert _latest(side, d) == 6
        assert [s["step"] for s in _spans(d, "emergency_save")] == [6]
        with open(d / "oom_report.json") as f:
            reports[side] = report = json.load(f)
        assert ref_memory.validate_oom_report(report) == []
        assert memory.validate_oom_report(report) == []
        (oom,) = _spans(d, "oom")
        assert oom["step"] == report["step"] == 6
        assert report["program_key"] == oom["program_key"] == \
            "train|synthetic_rn8_f32|mesh1x1|b8"
    assert reports["port"]["live_arrays"]["total_arrays"] > 0
    assert set(reports["port"]) == set(reports["ref"])


def test_fault_plan_reads_config_and_env_as_the_reference():
    """The same plan from the same config fields and environment."""
    env = {"TPU_RESNET_FAULT_NAN_STEP": "3",
           "TPU_RESNET_FAULT_CORRUPT_CKPT": "yes",
           "TPU_RESNET_FAULT_STALL_SEC": "1.5"}
    for fields in ({}, {"inject_sigterm_at_step": 7, "inject_oom_at_step": 2,
                        "inject_preempt_burst": 2}):
        port_r = types.SimpleNamespace(**{
            **vars(load_config("smoke").resilience), **fields})
        ref_r = types.SimpleNamespace(**{
            **vars(ref_load_config("smoke").resilience), **fields})
        for e in ({}, env):
            got = faultinject.FaultPlan.from_config(port_r, env=e)
            want = ref_faultinject.FaultPlan.from_config(ref_r, env=e)
            assert {k: getattr(want, k) for k in vars(got)} == vars(got)
            assert got.active == want.active
