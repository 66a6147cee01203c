"""The port's training path against the reference on the CPU: the ResNet in
training mode, the train step over three steps from one converted state,
the schedules and the L2 term; then the port's loop itself (resume repeats
the uninterrupted stream bit for bit, metrics, pruning, eval, serving a
trained checkpoint, SIGTERM), the guards of this slice, and the NaN guard
and emergency save against the reference's ``train()``."""

import json
import logging
import math
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet import resilience as ref_resilience
from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.models import build_model as ref_build_model
from tpu_resnet.models.resnet import cifar_resnet_v2 as ref_cifar
from tpu_resnet.obs.spans import load_spans
from tpu_resnet.parallel import create_mesh
from tpu_resnet.train import latest_step_in as ref_latest_step_in
from tpu_resnet.train import train as ref_train
from tpu_resnet.train import metrics_io as ref_metrics_io
from tpu_resnet.train import schedule as ref_sched
from tpu_resnet.train.state import TrainState as RefState
from tpu_resnet.train.state import build_optimizer as ref_build_optimizer
from tpu_resnet.train.step import l2_weight_penalty as ref_l2
from tpu_resnet.data import augment as ref_aug
from tpu_resnet.data import cifar as ref_cifar_data
from tpu_resnet.data import pipeline as ref_pipeline
from tpu_resnet.train.step import make_eval_step as ref_make_eval_step
from tpu_resnet.train.step import make_train_step as ref_make_train_step
from tpu_resnet_torch import convert
from tpu_resnet_torch import data as data_lib
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.evaluation.evaluator import evaluate
from tpu_resnet_torch.main import main as port_main
from tpu_resnet_torch.models import (build_model, cifar_resnet_v2,
                                     imagenet_resnet_v2)
from tpu_resnet_torch.resilience import sentinel as port_sentinel
from tpu_resnet_torch.resilience.shutdown import Preempted
from tpu_resnet_torch.serve.backend import CheckpointBackend
from tpu_resnet_torch.train import checkpoint
from tpu_resnet_torch.train import loop
from tpu_resnet_torch.train import metrics_io
from tpu_resnet_torch.train import schedule as sched
from tpu_resnet_torch.train.loop import build_state, train
from tpu_resnet_torch.train.state import create_state
from tpu_resnet_torch.train.step import (check_step_config,
                                         l2_weight_penalty, make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGENET_FIXTURES = os.path.join(REPO, "tests", "fixtures", "imagenet")


def _randomize(variables, seed):
    """BN parameters and statistics off their init values."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a, np.float32)
        if "'scale'" in name or "'var'" in name:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if "'bn'" in name or ("final_dense" in name and "'bias'" in name):
            return rng.normal(0, 0.2, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _reference_variables(size, seed=1):
    model = ref_cifar(size, 10, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                           train=False)
    return _randomize(jax.device_get(variables), seed)


def _port_model(variables, size, **kw):
    model = cifar_resnet_v2(size, 10, dtype=torch.float32, **kw)
    model.load_state_dict(convert.flax_to_torch(variables), strict=True)
    return model


def _batch(seed, b=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, b).astype(np.int32))


def _close(got, want, what, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=what)


@pytest.mark.parametrize("epilogue", ["off", "on"])
def test_train_mode_forward_matches_reference(epilogue):
    variables = _reference_variables(14)
    x, _ = _batch(0)
    ref = ref_cifar(14, 10, dtype=jnp.float32, fused_epilogue=epilogue)
    want, updates = ref.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    port = _port_model(variables, 14, fused_epilogue=epilogue)
    got = port(torch.from_numpy(x), train=True)
    assert got.dtype == torch.float32 and got.requires_grad
    # float32 end to end; batch moments and convs summed in another order.
    _close(got.detach().numpy(), want, "logits", atol=1e-5, rtol=1e-5)
    stats = convert.flax_to_torch({"batch_stats": jax.device_get(
        updates["batch_stats"])})
    buffers = dict(port.named_buffers())
    assert set(stats) == set(buffers)
    for name, value in stats.items():
        _close(buffers[name].numpy(), value.numpy(), name, atol=1e-5,
               rtol=1e-5)


def _optim_cfg(epilogue, label_smoothing):
    cfg = load_config("cifar10", "", [
        f"model.fused_epilogue={epilogue}", "optim.use_pallas_xent=on",
        f"optim.label_smoothing={label_smoothing}", "model.resnet_size=8",
        "optim.boundaries=[2]", "optim.values=[0.1,0.05]"])
    return cfg


@pytest.mark.parametrize("epilogue, label_smoothing", [
    ("off", 0.0), ("on", 0.0), ("on", 0.1)])
def test_train_step_matches_reference(epilogue, label_smoothing):
    """Three steps of each from one state (BN moved off its init, a random
    momentum trace); the schedule's boundary falls inside them."""
    size = 8
    cfg = _optim_cfg(epilogue, label_smoothing)
    variables = _reference_variables(size)
    rng = np.random.default_rng(7)
    trace = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.01).astype(np.float32),
        jax.device_get(variables["params"]))

    ref_model = ref_cifar(size, 10, dtype=jnp.float32,
                          fused_epilogue=epilogue)
    schedule = ref_sched.build_schedule(cfg.optim, cfg.train)
    tx = ref_build_optimizer(cfg.optim, schedule)
    state = RefState.create(variables["params"], variables["batch_stats"], tx)
    state = state.replace(opt_state=(state.opt_state[0]._replace(
        trace=jax.tree_util.tree_map(jnp.asarray, trace)),
        *state.opt_state[1:]))
    ref_step = jax.jit(ref_make_train_step(ref_model, cfg.optim, schedule,
                                           10))

    port = _port_model(variables, size, fused_epilogue=epilogue)
    port_state = create_state(port, cfg.optim)
    port_state.load_momentum_buffers(convert.flax_opt_state_to_torch(trace))
    port_step = make_train_step(cfg.optim, sched.build_schedule(
        cfg.optim, cfg.train), 10)

    for i in range(3):
        x, y = _batch(10 + i)
        state, want = ref_step(state, jnp.asarray(x), jnp.asarray(y))
        got = port_step(port_state, torch.from_numpy(x), torch.from_numpy(y))
        for key in ("loss", "precision", "learning_rate", "grad_norm"):
            _close(float(got[key]), float(want[key]), f"step {i} {key}")
    assert port_state.step == int(state.step) == 3
    want = convert.flax_to_torch(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    got = port_state.model.state_dict()
    assert set(got) == set(want)
    for name in want:
        _close(got[name].numpy(), want[name].numpy(), name)
    want_m = convert.flax_opt_state_to_torch(jax.device_get(
        state.opt_state[0].trace))
    got_m = port_state.momentum_buffers()
    assert set(got_m) == set(want_m)
    for name in want_m:
        _close(got_m[name].numpy(), want_m[name].numpy(), f"momentum {name}")


@pytest.mark.parametrize("include_bn", [True, False])
def test_l2_penalty_matches_reference(include_bn):
    variables = _reference_variables(8)
    want = ref_l2(variables["params"], include_bn)
    with torch.no_grad():
        got = l2_weight_penalty(_port_model(variables, 8), include_bn)
    _close(got.item(), float(want), "penalty", atol=0, rtol=1e-6)


SCHEDULES = [
    ("cifar_piecewise", (), ()), ("cifar_piecewise", (3, 7), (0.5, 0.2, 0.1)),
    ("imagenet_warmup", (), ()), ("imagenet_warmup", (10, 20, 30), ()),
    ("constant", (), ()), ("cosine", (), ())]


@pytest.mark.parametrize("name, boundaries, values", SCHEDULES)
def test_schedules_match_reference(name, boundaries, values):
    cfg = load_config("cifar10", "", [f"optim.schedule={name}"])
    cfg.optim.boundaries, cfg.optim.values = boundaries, values
    cfg.optim.warmup_steps = 8
    cfg.train.train_steps = 40
    ref = ref_sched.build_schedule(cfg.optim, cfg.train)
    port = sched.build_schedule(cfg.optim, cfg.train)
    edge = {"cifar_piecewise": boundaries[0] if boundaries else 40_000,
            "imagenet_warmup": 8, "constant": 5, "cosine": 8}[name]
    for step in (0, 1, edge - 1, edge, edge + 1, 25, 40, 90_000):
        _close(port(step), float(ref(jnp.int32(step))), f"{name} @ {step}",
               atol=0, rtol=1e-6)


# ---------------------------------------------------------------- the loop
def _loop_cfg(train_dir, *extra):
    return load_config("smoke", "", [
        "optim.use_pallas_xent=on", "model.fused_epilogue=on",
        "data.synthetic_learnable=true", "data.synthetic_train_examples=64",
        "data.synthetic_eval_examples=40", "train.eval_batch_size=16",
        "train.global_batch_size=8", "train.log_every=1",
        "train.checkpoint_every=3", "train.keep_checkpoints=2",
        "train.train_steps=12", f"train.train_dir={train_dir}", *extra])


def _losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)]


@pytest.mark.parametrize("model", [
    [], ["model.fused_blocks=true", "model.resnet_size=14"]],
    ids=["unfused", "fused"])
def test_resume_repeats_the_uninterrupted_run(tmp_path, model):
    """Stopped at 6 and resumed to 12, the losses equal a 12-step run's
    bit for bit (data order, augmentation and optimizer state resume),
    with and without the fused blocks (ResNet-14: one per stage)."""
    whole, split = tmp_path / "whole", tmp_path / "split"
    train(_loop_cfg(whole, *model), device="cpu")
    train(_loop_cfg(split, *model, "train.train_steps=6"), device="cpu")
    state = train(_loop_cfg(split, *model), device="cpu")
    assert state.step == 12
    assert _losses(split) == _losses(whole)
    assert [s for s, _ in _losses(whole)] == list(range(1, 13))


def test_metrics_checkpoints_eval_and_serve(tmp_path):
    cfg = _loop_cfg(tmp_path)
    train(cfg, device="cpu")
    with open(tmp_path / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    assert {"step", "wall", "loss", "precision", "learning_rate",
            "grad_norm"} <= set(rec)
    assert checkpoint.all_steps_in(str(tmp_path)) == [9, 12]
    saved = checkpoint.restore(str(tmp_path), 12)
    assert saved["step"] == 12 and saved["opt_state"]
    assert set(saved["opt_state"]) == set(saved["params"])

    cfg.train.eval_once = True
    precision = evaluate(cfg, device="cpu")
    with open(tmp_path / "eval" / "best_precision.json") as f:
        best = json.load(f)
    assert best == {"best_precision": precision, "step": 12}
    assert 0.0 <= precision <= 1.0

    backend = CheckpointBackend(cfg, torch.device("cpu"))
    assert backend.model_step == 12
    logits = backend.infer(np.zeros((2, 32, 32, 3), np.uint8))
    assert logits.shape == (2, 10) and np.isfinite(logits).all()


@pytest.mark.parametrize("epilogue", ["off", "on"])
def test_eval_pass_matches_reference(tmp_path, epilogue):
    """``eval --once`` on a checkpoint of converted reference weights reads
    the reference eval step's precision and loss over the same split."""
    cfg = _loop_cfg(tmp_path, f"model.fused_epilogue={epilogue}",
                    "model.compute_dtype=float32", "model.resnet_size=8")
    variables = _reference_variables(8, seed=4)
    checkpoint.save(str(tmp_path), 5, _port_model(variables, 8,
                                                  fused_epilogue=epilogue))
    cfg.train.eval_once = True
    got = evaluate(cfg, device="cpu")
    with open(tmp_path / "eval" / "metrics.jsonl") as f:
        got_loss = json.loads(f.readline())["eval_loss"]

    ref_step = jax.jit(ref_make_eval_step(
        ref_cifar(8, 10, dtype=jnp.float32, fused_epilogue=epilogue), 10,
        ref_aug.cifar_eval_preprocess))

    state = RefState(step=jnp.int32(5), params=variables["params"],
                     batch_stats=variables["batch_stats"], opt_state=())
    images, labels = ref_cifar_data.load_split(cfg.data, train=False)
    correct = loss = count = 0
    for im, lab in ref_pipeline.eval_batches(images, labels, 16):
        c, ls, n = ref_step(state, jnp.asarray(im), jnp.asarray(lab))
        correct, loss = correct + int(c), loss + float(ls)
        count += int(n)
    assert count == 40
    assert got == correct / count
    _close(got_loss, loss / count, "eval loss", atol=1e-5, rtol=1e-5)


def test_sigterm_stops_with_a_final_checkpoint(tmp_path):
    cmd = [sys.executable, "-m", "tpu_resnet_torch", "train", "--device",
           "cpu", "--preset", "smoke", "optim.use_pallas_xent=off",
           "train.train_steps=100000", "train.log_every=1",
           "train.checkpoint_every=100000", f"train.train_dir={tmp_path}"]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120
        metrics = tmp_path / "metrics.jsonl"
        while not (metrics.exists() and metrics.read_text().count("\n") >= 2):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 42
    finally:
        proc.kill()
    steps = checkpoint.all_steps_in(str(tmp_path))
    assert len(steps) == 1 and steps[0] >= 2


def test_preempted_in_process(tmp_path, monkeypatch):
    """A stop request between steps saves the step it stopped at."""
    from tpu_resnet_torch.resilience import shutdown
    monkeypatch.setattr(shutdown.ShutdownCoordinator, "requested",
                        property(lambda self: os.path.exists(
                            tmp_path / "3")))
    with pytest.raises(Preempted) as e:
        train(_loop_cfg(tmp_path, "train.checkpoint_every=3"), device="cpu")
    assert e.value.step == 3
    assert checkpoint.latest_step_in(str(tmp_path)) == 3


@pytest.mark.parametrize("overrides, exc, match", [
    (["optim.use_pallas_xent=auto", "model.fused_epilogue=auto"], None,
     None),
    (["optim.use_pallas_xent=maybe"], ValueError, "auto|on|off"),
    ("fused ImageNet bottleneck", None, None),
    (["mesh.model=2"], NotImplementedError, "one device"),
    (["data.device_resident=on", "data.dataset=imagenet",
      "model.resnet_size=18", "data.image_size=32"], ValueError,
     "unsupported for dataset 'imagenet'"),
    (["data.dataset=imagenet", "model.resnet_size=18", "data.image_size=32"],
     FileNotFoundError, "no ImageNet shards match"),
])
def test_train_guards(tmp_path, overrides, exc, match):
    """What the port does not train raises, and what it trains trains
    (``exc`` None): the ``auto`` policies, and ImageNet ResNet-50 through
    the fused bottlenecks on the fixture shards (the string case: one step
    at 32x32 from small resize sides). ``data.device_resident=on`` refuses
    ImageNet with the reference's ValueError, and a data dir without shards
    raises the reference's FileNotFoundError."""
    if isinstance(overrides, str):
        model = imagenet_resnet_v2(50, 10, fused_blocks=True)
        assert model(torch.zeros(2, 32, 32, 3), train=True).shape == (2, 10)
        state = train(load_config("imagenet", "", [
            "model.fused_blocks=true", "model.fused_epilogue=on",
            "optim.use_pallas_xent=on", "data.image_size=32",
            f"data.data_dir={IMAGENET_FIXTURES}", "data.resize_min=36",
            "data.resize_max=44", "data.num_workers=1", "data.ring_slots=1",
            "train.global_batch_size=4", "train.train_steps=1",
            f"train.train_dir={tmp_path}"]), device="cpu")
        assert state.step == 1
        assert math.isfinite(_losses(tmp_path)[0][1])
        return
    cfg = _loop_cfg(tmp_path, *overrides,
                    f"data.data_dir={tmp_path / 'no_shards'}")
    if exc is None:
        state = train(cfg, device="cpu")
        assert state.step == 12
        return
    with pytest.raises(exc, match=match):
        train(cfg, device="cpu")


def test_imagenet_train_then_eval_once_on_the_fixtures(tmp_path, caplog):
    """``train`` then ``eval --once`` on ``--preset imagenet`` end to end on
    the CPU (ResNet-18, 32x32 crops from small resize sides) over the
    fixture shards: the loop logs the decode engine's stats with each step,
    and eval counts the validation shard's 8 records exactly once."""
    common = ["--device", "cpu", "--preset", "imagenet",
              "model.resnet_size=18", "model.compute_dtype=float32",
              "data.image_size=32", f"data.data_dir={IMAGENET_FIXTURES}",
              "data.resize_min=36", "data.resize_max=44",
              "data.eval_resize=40", "data.num_workers=2",
              "train.global_batch_size=4", "train.eval_batch_size=3",
              f"train.train_dir={tmp_path}"]
    assert port_main(["train", *common, "train.train_steps=2",
                      "train.log_every=1"]) == 0
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(math.isfinite(r["loss"]) for r in recs)
    assert recs[-1]["data_stream_seq"] == 2.0
    with caplog.at_level(logging.INFO, logger="tpu_resnet_torch"):
        assert port_main(["eval", "--once", *common]) == 0
    done = [r.args for r in caplog.records
            if r.msg.startswith("eval @ step")]
    assert len(done) == 1 and done[0][0] == 2 and done[0][-1] == 8
    with open(tmp_path / "eval" / "metrics.jsonl") as f:
        rec = json.loads(f.readlines()[-1])
    assert rec["step"] == 2 and math.isfinite(rec["eval_loss"])


def test_check_step_config_passes_the_slice():
    check_step_config(load_config("cifar10", "", [
        "model.fused_epilogue=on", "optim.use_pallas_xent=on"]))


def test_train_and_eval_need_cuda_unless_asked_for_cpu(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["train"], ["eval", "--once"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_main([*cmd, "--preset", "smoke",
                       "optim.use_pallas_xent=on",
                       f"train.train_dir={tmp_path}"])


# ------------------------------------------------------ remat, torn files
@pytest.mark.parametrize("overrides", [
    [], ["model.fused_blocks=true", "model.resnet_size=14"],
    ["model.fused_epilogue=on"]], ids=["unfused", "fused", "epilogue"])
def test_remat_step_equals_the_plain_step(overrides):
    """``model.remat``: one CPU step recomputing each block in the backward
    pass gives the loss, gradients and running statistics of the step
    without it, bit for bit; the recompute does not move the running
    statistics a second time."""
    results = []
    for remat in (False, True):
        cfg = load_config("smoke", "", [
            "model.compute_dtype=float32", "train.global_batch_size=8",
            *overrides, f"model.remat={str(remat).lower()}"])
        state = build_state(cfg, torch.device("cpu"))
        assert all(layer.remat == remat for name, layer in
                   state.model.named_children()
                   if name.startswith("block_layer"))
        step = make_train_step(cfg.optim, lambda s: 0.1,
                               cfg.data.num_classes)
        x, y = (torch.from_numpy(a) for a in _batch(3))
        m = step(state, x, y)
        grads = {n: p.grad.clone() for n, p in
                 state.model.named_parameters()}
        results.append((float(m["loss"]), grads,
                        {n: b.clone() for n, b in
                         state.model.named_buffers()}))
    (loss0, g0, b0), (loss1, g1, b1) = results
    assert loss0 == loss1
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for n in b0:
        assert torch.equal(b0[n], b1[n]), n
    init = build_state(load_config("smoke", "", overrides),
                       torch.device("cpu")).model
    moved = [n for n, b in init.named_buffers()
             if not torch.equal(b, b1[n])]
    assert moved   # the statistics did move, once


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def test_resume_falls_back_past_a_torn_newest_checkpoint(tmp_path):
    """The newest ``state.pt`` cut in half: the trainer resumes from the
    newest restorable step, discards the torn one, and reaches the
    uninterrupted run's losses."""
    train(_loop_cfg(tmp_path / "whole"), device="cpu")
    cfg = _loop_cfg(tmp_path / "torn", "train.train_steps=9")
    train(cfg, device="cpu")
    assert checkpoint.all_steps_in(str(tmp_path / "torn")) == [6, 9]
    _truncate(tmp_path / "torn" / "9" / checkpoint.STATE_FILE)
    state = create_state(cifar_resnet_v2(8, 10), cfg.optim)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "torn"))
    assert mgr.restore(state).step == 6
    assert checkpoint.all_steps_in(str(tmp_path / "torn")) == [6, 9]
    train(_loop_cfg(tmp_path / "torn"), device="cpu")
    assert _losses(tmp_path / "torn")[-3:] == _losses(tmp_path / "whole")[-3:]


def test_restore_raises_when_no_checkpoint_loads(tmp_path):
    cfg = _loop_cfg(tmp_path, "train.train_steps=3")
    train(cfg, device="cpu")
    _truncate(tmp_path / "3" / checkpoint.STATE_FILE)
    state = create_state(cifar_resnet_v2(8, 10), cfg.optim)
    with pytest.raises(RuntimeError, match="no restorable checkpoint"):
        checkpoint.CheckpointManager(str(tmp_path)).restore(state)


def test_eval_retries_then_skips_a_torn_checkpoint(tmp_path, monkeypatch):
    """``eval --once`` on a torn newest step retries
    ``resilience.eval_restore_retries`` times with backoff, then skips it
    and logs; a whole step evaluates."""
    cfg = _loop_cfg(tmp_path, "train.train_steps=3",
                    "resilience.eval_restore_retries=2",
                    "resilience.eval_restore_backoff_sec=0")
    train(cfg, device="cpu")
    path = tmp_path / "3" / checkpoint.STATE_FILE
    whole = path.read_bytes()
    _truncate(path)
    loads = []
    real = checkpoint.restore
    monkeypatch.setattr(checkpoint, "restore",
                        lambda *a: loads.append(a) or real(*a))
    cfg.train.eval_once = True
    assert evaluate(cfg, device="cpu") is None
    assert len(loads) == 2
    assert not (tmp_path / "eval" / "best_precision.json").exists()
    path.write_bytes(whole)
    assert evaluate(cfg, device="cpu") is not None


# ------------------------------------------- NaN guard and emergency save
NAN_STEP = 5   # the batch consumed at this step is all NaN


def _fault_overrides(train_dir, *extra):
    """The smoke preset (ResNet-8, synthetic data, float32) on the
    streaming path, where the reference's fault injector poisons its
    batches; plain versions in both."""
    return ["optim.use_pallas_xent=off", "model.fused_epilogue=off",
            "data.device_resident=off", "data.transfer_stage=1",
            "data.synthetic_train_examples=64", "train.global_batch_size=8",
            "train.train_steps=12", "train.log_every=2",
            "train.summary_every=2", "train.checkpoint_every=4",
            "train.image_summary_every=0",
            "resilience.watchdog_stall_sec=0",
            f"train.train_dir={train_dir}", *extra]


def _reference_run(train_dir, *extra):
    """The reference's ``train()`` on one CPU device, the step-NAN_STEP
    batch poisoned by its own fault injector; returns its config."""
    cfg = ref_load_config("smoke", "", _fault_overrides(train_dir, *extra))
    cfg.resilience.inject_nan_at_step = NAN_STEP
    ref_train(cfg, mesh=create_mesh(cfg.mesh, devices=jax.devices()[:1]))
    return cfg


def _port_run(train_dir, monkeypatch, *extra):
    """The port's ``train()`` on the CPU from the reference's initial
    weights (``init`` at the split of ``PRNGKey(train.seed)`` its loop
    uses), the step-NAN_STEP batch of its batch source poisoned once."""
    cfg = load_config("smoke", "", _fault_overrides(train_dir, *extra))
    size = cfg.data.resolved_image_size
    variables = jax.device_get(ref_build_model(cfg).init(
        jax.random.split(jax.random.PRNGKey(cfg.train.seed))[0],
        jnp.zeros((1, size, size, 3), jnp.float32), train=False))

    def start(cfg, device):
        model = build_model(cfg)
        model.load_state_dict(convert.flax_to_torch(variables), strict=True)
        return create_state(model.to(device), cfg.optim)

    real, fired = data_lib.train_batches, []

    def batches(data_cfg, local_batch, seed=0, start_step=0):
        for i, (images, labels) in enumerate(real(
                data_cfg, local_batch, seed=seed, start_step=start_step)):
            if start_step + i == NAN_STEP and not fired:
                fired.append(NAN_STEP)
                images = np.full_like(np.asarray(images, np.float32),
                                      np.nan)
            yield images, labels

    monkeypatch.setattr(loop, "build_state", start)
    monkeypatch.setattr(data_lib, "train_batches", batches)
    return train(cfg, device="cpu")


def _reference_losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)
                if "loss" in r]


def _spans(train_dir, name):
    return [s for s in load_spans(os.path.join(train_dir, "events.jsonl"))
            if s["span"] == name]


def _port_logs(caplog, prefix):
    """The args of the port's log records that start with ``prefix``."""
    return [r.args for r in caplog.records
            if r.name == "tpu_resnet_torch" and r.msg.startswith(prefix)]


def _close_losses(got, want):
    assert [s for s, _ in got] == [s for s, _ in want]
    assert all(math.isfinite(v) for _, v in got)
    # float32 on both sides, summed in other orders, over 12 steps.
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-4, atol=1e-5)


def test_nan_rollback_matches_the_reference(tmp_path, monkeypatch, caplog):
    """The NaN reaches the loss at step 6, the first log boundary after the
    poisoned batch: both roll back to checkpoint 4, restart the stream at
    6 and log the same losses from there to 12."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    _reference_run(ref_dir)
    (rb,) = _spans(ref_dir, "nan_rollback")
    assert (rb["from_step"], rb["to_step"], rb["retry"]) == (6, 4, 1)
    with caplog.at_level(logging.WARNING, logger="tpu_resnet_torch"):
        state = _port_run(port_dir, monkeypatch)
    assert state.step == 12
    assert _port_logs(caplog, "nan rollback") == [(6, 4, 1)]
    _close_losses(_losses(port_dir), _reference_losses(ref_dir))
    assert [s for s, _ in _losses(port_dir)] == [2, 4, 6, 8, 10, 12]


def test_divergence_without_checkpoint_raises(tmp_path, monkeypatch):
    """No checkpoint before the NaN: both raise DivergenceError at once and
    save nothing (the emergency save skips a divergence)."""
    extra = ("train.checkpoint_every=100",)
    with pytest.raises(ref_resilience.DivergenceError, match="no checkpoint"):
        _reference_run(tmp_path / "ref", *extra)
    with pytest.raises(port_sentinel.DivergenceError,
                       match="no checkpoint") as e:
        _port_run(tmp_path / "port", monkeypatch, *extra)
    assert "at step 6 " in str(e.value)
    assert ref_latest_step_in(str(tmp_path / "ref")) is None
    assert checkpoint.all_steps_in(str(tmp_path / "port")) == []


def test_nonfinite_state_is_not_checkpointed(tmp_path, monkeypatch, caplog):
    """checkpoint_every=2, log_every=4: step 6 is a checkpoint boundary
    between loss checks holding NaN state; neither saves it, and the log
    boundary at 8 rolls back to 4."""
    extra = ("train.checkpoint_every=2", "train.log_every=4",
             "train.summary_every=4")
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    _reference_run(ref_dir, *extra)
    assert [s["step"] for s in _spans(
        ref_dir, "checkpoint_save_skipped_nonfinite")] == [6]
    (rb,) = _spans(ref_dir, "nan_rollback")
    with caplog.at_level(logging.WARNING, logger="tpu_resnet_torch"):
        state = _port_run(port_dir, monkeypatch, *extra)
    assert state.step == 12
    assert _port_logs(caplog, "skipping checkpoint save") == [(6,)]
    assert _port_logs(caplog, "nan rollback") == [
        (rb["from_step"], rb["to_step"], rb["retry"])] == [(8, 4, 1)]
    _close_losses(_losses(port_dir), _reference_losses(ref_dir))


def test_emergency_save_on_in_flight_exception(tmp_path, monkeypatch):
    """After the rollback, a metrics write that raises at step 10 (the
    checkpoint at 8 written): both save step 10 once and let the error
    through."""
    def crashing(writer_cls):
        real = writer_cls.write

        def write(self, step, m):
            if step >= 10:
                raise RuntimeError("disk full")
            return real(self, step, m)
        return write

    monkeypatch.setattr(ref_metrics_io.MetricsWriter, "write",
                        crashing(ref_metrics_io.MetricsWriter))
    monkeypatch.setattr(metrics_io.MetricsWriter, "write",
                        crashing(metrics_io.MetricsWriter))
    with pytest.raises(RuntimeError, match="disk full"):
        _reference_run(tmp_path / "ref")
    assert [s["step"] for s in _spans(tmp_path / "ref",
                                      "emergency_save")] == [10]
    with pytest.raises(RuntimeError, match="disk full"):
        _port_run(tmp_path / "port", monkeypatch)
    assert checkpoint.all_steps_in(str(tmp_path / "port")) == [4, 8, 10]
    assert ref_latest_step_in(str(tmp_path / "ref")) == 10
    saved = checkpoint.restore(str(tmp_path / "port"), 10)
    assert saved["step"] == 10
    assert all(bool(torch.isfinite(t).all())
               for t in saved["params"].values())


@pytest.mark.parametrize("enabled", [True, False])
def test_nan_sentinel_policy_matches_the_reference(enabled):
    """The port's copy of the sentinel: the same decisions, the same
    messages, the same retry budget."""
    def outcomes(mod):
        s = mod.NaNSentinel(max_retries=2, enabled=enabled)
        seen = []
        for step, loss in ((10, 1.5), (10, float("nan")),
                           (20, float("inf")), (25, -2.0),
                           (30, float("nan"))):
            try:
                seen.append(s.check(step, loss))
            except mod.DivergenceError as e:
                seen.append(str(e))
        return seen, s.rollbacks, str(s.no_checkpoint(5, float("nan")))

    got, want = outcomes(port_sentinel), outcomes(ref_resilience)
    assert got == want
    assert got[0] == ([False, True, True, False, got[0][4]] if enabled
                      else [False] * 5)
    if enabled:
        assert "nan_max_retries=2" in got[0][4]
