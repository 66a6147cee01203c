"""The port's data-parallel training against the reference on the CPU:
gloo ranks spawned once per rank count (a ``file://`` rendezvous under
``tmp_path``; ``tests/torch_dp_worker.py`` is their side) run the port's
rank step and ``train()``, and the same inputs go through the reference's
``shard_step`` over ``jax.devices()[:N]`` (as ``test_per_replica_bn.py``
runs it) and its ``train()`` on an N-device mesh.

The preset is ``smoke`` (ResNet-8, float32), global batch 16 at N = 2 and
4, from converted reference weights. Tolerances: float32 on both sides,
the moments and gradients summed in other orders and across ranks in
another order — 1e-5 absolute and 1e-4 relative on losses, metrics,
parameters and statistics (the one-device step tests' own). The momentum
buffers (after two steps, 0.9·g1 + g2) are held normwise per tensor,
‖got − want‖ ≤ 1e-2·‖want‖ (``chip_smoke.py``'s cap on gradients): a ReLU
whose input rounds across 0 in one package and not the other flips a
gradient element, and on these inputs the one-device port and reference
steps already differ by 3.3e-3 normwise. zero1 against replicated in the
port: 1e-6, as the reference's ``test_zero1_replicated_step_parity_on_
fakepod``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dp_worker
from test_torch_train import _randomize
from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.models import build_model as ref_build_model
from tpu_resnet.parallel import (batch_sharding, create_mesh,
                                 make_partitioner, replicated)
from tpu_resnet.train import train as ref_train
from tpu_resnet.train.metrics_io import MetricsWriter
from tpu_resnet.train.schedule import build_schedule
from tpu_resnet.train.state import TrainState as RefState
from tpu_resnet.train.state import build_optimizer
from tpu_resnet.train.step import make_train_step as ref_make_train_step
from tpu_resnet.train.step import shard_step
from tpu_resnet_torch import convert
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.models import build_model
from tpu_resnet_torch.train import checkpoint, loop
from tpu_resnet_torch.train.loop import train
from tpu_resnet_torch.train.state import create_state

STEPS = 2
BATCH = 16
TRAIN_STEPS = 4
TOL = dict(atol=1e-5, rtol=1e-4)
MOMENTUM_RTOL = 1e-2


def _close(got, want, what, atol=TOL["atol"], rtol=TOL["rtol"]):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=what)


def _variables(overrides):
    cfg = ref_load_config("smoke", "", overrides)
    variables = ref_build_model(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    return _randomize(jax.device_get(variables), 3)


def _batches(seed, n_steps=STEPS, b=BATCH):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, b).astype(np.int32))
            for _ in range(n_steps)]


def _identical(n):
    """Every rank's shard the same two examples."""
    (x, y), = _batches(11, 1, 2)
    return [(np.tile(x, (n, 1, 1, 1)), np.tile(y, n))] * STEPS


def _torch_batches(batches):
    return [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches]


def _train_overrides(train_dir, resident="off"):
    return [f"data.device_resident={resident}",
            "data.synthetic_train_examples=64", "train.log_every=1",
            "train.summary_every=1", "train.checkpoint_every=2", f"train.train_steps={TRAIN_STEPS}",
            "train.steps_per_call=1", "resilience.watchdog_stall_sec=0",
            "train.mfu_accounting=false", "train.memory_ledger=false",
            f"train.train_dir={train_dir}"]


def _train_init():
    cfg = ref_load_config("smoke")
    return jax.device_get(ref_build_model(cfg).init(
        jax.random.split(jax.random.PRNGKey(cfg.train.seed))[0],
        jnp.zeros((1, 32, 32, 3), jnp.float32), train=False))


def _spawn(tmp, n, plan):
    """Run the ranks on ``plan``; each rank's results."""
    plan_path = os.path.join(tmp, "plan.pt")
    torch.save(plan, plan_path)
    mp.start_processes(torch_dp_worker.main,
                       args=(n, os.path.join(tmp, "rendezvous"), plan_path,
                             tmp),
                       nprocs=n, join=True, start_method="spawn")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


def _plan(n, tmp):
    plan = {"init": convert.flax_to_torch(_variables([])),
            "batches": _torch_batches(_batches(5)),
            "identical": _torch_batches(_identical(n))}
    if n == 2:
        plan["init14"] = convert.flax_to_torch(
            _variables(torch_dp_worker.FUSED))
        plan["fused_batches"] = _torch_batches(_batches(7))
        plan["train_init"] = convert.flax_to_torch(_train_init())
        plan["train_overrides"] = []
        plan["train_runs"] = {
            "train": _train_overrides(os.path.join(tmp, "run")),
            "train_zero1": [*_train_overrides(os.path.join(tmp, "split"),
                                              resident="on"),
                            "mesh.partition=zero1",
                            f"train.train_steps={TRAIN_STEPS // 2}"]}
    return plan


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp2"))
    return tmp, _spawn(tmp, 2, _plan(2, tmp))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp4"))
    return tmp, _spawn(tmp, 4, _plan(4, tmp))


def _ranks(request, n):
    return request.getfixturevalue(f"ranks{n}")[1]


# ------------------------------------------------------ the reference side
def _ref_steps(overrides, n, batches, partition="replicated"):
    cfg = ref_load_config("smoke", "", [*overrides, f"mesh.data={n}",
                                        f"mesh.partition={partition}"])
    variables = _variables([o for o in overrides if o.startswith("model.")
                            and "sync_bn" not in o])
    mesh = create_mesh(cfg.mesh, devices=jax.devices()[:n])
    per_replica = not cfg.model.sync_bn
    part = make_partitioner(cfg.mesh, mesh)
    sched = build_schedule(cfg.optim, cfg.train)
    state = RefState.create(variables["params"], variables["batch_stats"],
                            build_optimizer(cfg.optim, sched))
    state = (part.shard_state(state) if part.is_sharded
             else jax.device_put(state, replicated(mesh)))
    step = shard_step(
        ref_make_train_step(ref_build_model(cfg), cfg.optim, sched, 10,
                            augment_fn=None, base_rng=jax.random.PRNGKey(1),
                            mesh=mesh,
                            grad_axis="data" if per_replica else None,
                            partitioner=part),
        mesh, per_replica_bn=per_replica,
        state_sharding=(part.state_shardings(state) if part.is_sharded
                        else None))
    bs, metrics = batch_sharding(mesh), []
    for x, y in batches:
        state, m = step(state, jax.device_put(x, bs), jax.device_put(y, bs))
        metrics.append({k: float(v) for k, v in m.items()})
        if part.is_sharded:  # the step leaves the BN statistics' layout open
            state = jax.device_put(state, part.state_shardings(state))
    got = jax.device_get({"params": state.params,
                          "batch_stats": state.batch_stats})
    return (metrics, convert.flax_to_torch(got),
            convert.flax_opt_state_to_torch(jax.device_get(
                state.opt_state[0].trace)))


def _check_case(ranks, case, want, atol=TOL["atol"], rtol=TOL["rtol"],
                norm_rtol=MOMENTUM_RTOL):
    """Every rank holds the same state, and it is the reference's."""
    metrics, state, momentum = want
    first = ranks[0][case]
    for r, other in enumerate(ranks[1:], 1):
        for name, t in first["state"].items():
            assert torch.equal(other[case]["state"][name], t), (case, r, name)
    for i, (got, ref) in enumerate(zip(first["metrics"], metrics)):
        for key in ("loss", "precision", "learning_rate", "grad_norm"):
            _close(got[key], ref[key], f"{case} step {i} {key}", atol, rtol)
    assert set(first["state"]) == set(state)
    for name, t in state.items():
        _close(first["state"][name], t, f"{case} {name}", atol, rtol)
    assert set(first["momentum"]) == set(momentum)
    for name, t in momentum.items():
        err = torch.linalg.norm(first["momentum"][name] - t)
        assert err <= max(rtol, norm_rtol) * torch.linalg.norm(t), \
            (case, name, float(err / torch.linalg.norm(t)))


@pytest.mark.parametrize("n", [2, 4])
def test_per_replica_bn_steps_match_reference(request, n):
    _check_case(_ranks(request, n), "per_replica",
                _ref_steps(["model.sync_bn=false"], n, _batches(5)))


@pytest.mark.parametrize("n", [2, 4])
def test_synced_bn_steps_match_reference(request, n):
    _check_case(_ranks(request, n), "synced",
                _ref_steps([], n, _batches(5)))


@pytest.mark.parametrize("n", [2, 4])
def test_zero1_steps_match_reference_and_replicated(request, n):
    ranks = _ranks(request, n)
    _check_case(ranks, "zero1", _ref_steps([], n, _batches(5), "zero1"))
    rep = ranks[0]["synced"]
    _check_case(ranks, "zero1", (rep["metrics"], rep["state"],
                                 rep["momentum"]), atol=1e-6, rtol=1e-6,
                norm_rtol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_identical_shards_give_global_bn(request, n):
    """Every rank holding the same examples, the per-replica moments are
    the global ones: the port's per-replica step is the reference's
    synced (global-batch) step."""
    _check_case(_ranks(request, n), "identical",
                _ref_steps([], n, _identical(n)))


def test_fused_per_replica_step_matches_reference(request):
    """The fused ResNet-14 (one fused block a stage, the epilogue and
    cross-entropy kernels on) per replica: the port's plain versions
    against the reference's fused path in interpret mode."""
    _check_case(_ranks(request, 2), "fused",
                _ref_steps(torch_dp_worker.FUSED, 2, _batches(7)))


def _metrics(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_two_ranks_matches_reference(request, tmp_path):
    """``train()`` at 2 ranks (synced BN, the streamed input: the
    reference's resident path compiles for tens of seconds on the CPU)
    against the reference's on a 2-device mesh, from the same initial
    weights: the losses step for step, and only rank 0 wrote the run's
    files."""
    tmp, ranks = request.getfixturevalue("ranks2")
    run = os.path.join(tmp, "run")
    cfg = ref_load_config("smoke", "", [*_train_overrides(tmp_path / "ref"),
                                        "train.comms_ledger=false"])
    ref_train(cfg, mesh=create_mesh(cfg.mesh, devices=jax.devices()[:2]),
              metrics=MetricsWriter(str(tmp_path / "ref"), tensorboard=False))
    got, want = _metrics(run), _metrics(tmp_path / "ref")
    assert [r["step"] for r in got] == list(range(1, TRAIN_STEPS + 1))
    _close([r["loss"] for r in got], [r["loss"] for r in want], "losses")
    for name, t in ranks[0]["train"].items():
        assert torch.equal(ranks[1]["train"][name], t), name
    assert sorted(os.listdir(run)) == sorted(
        ["2", "4", "events.jsonl", "manifest.json", "metrics.jsonl",
         "run_id.json", "topology.json"])
    with open(os.path.join(run, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["mesh"]["shape"] == {"data": 2}
    assert manifest["devices"]["count"] == 2
    with open(os.path.join(run, "topology.json")) as f:
        topology = json.load(f)
    assert topology["mesh_shape"] == {"data": 2, "model": 1}
    assert topology["devices"] == 2 and topology["global_batch"] == BATCH


def test_checkpoint_moves_across_ranks_and_partition(request, tmp_path,
                                                     monkeypatch):
    """Resident input: saved at 2 ranks under zero1 at step 2 (each rank
    its rows of every batch) and resumed on 1 rank replicated to step 4,
    the state of an uninterrupted 1-rank run (synced BN: the global
    moments do not depend on the split)."""
    tmp, _ = request.getfixturevalue("ranks2")
    split = os.path.join(tmp, "split")
    saved = checkpoint.restore(split, TRAIN_STEPS // 2)
    assert set(saved["opt_state"]) == set(saved["params"])
    for name, t in saved["opt_state"].items():
        assert t.shape == saved["params"][name].shape, name
    resumed = train(load_config("smoke", "", _train_overrides(
        split, resident="on")), device="cpu")
    assert resumed.step == TRAIN_STEPS
    init = convert.flax_to_torch(_train_init())

    def start(cfg, device):
        model = build_model(cfg)
        model.load_state_dict(init, strict=True)
        return create_state(model.to(device), cfg.optim)

    monkeypatch.setattr(loop, "build_state", start)
    whole = train(load_config("smoke", "", _train_overrides(
        tmp_path / "whole", resident="on")), device="cpu")
    want = whole.model.state_dict()
    for name, t in resumed.model.state_dict().items():
        _close(t, want[name], name)
    for name, t in whole.momentum_buffers().items():
        err = torch.linalg.norm(resumed.momentum_buffers()[name] - t)
        assert err <= 1e-5 * torch.linalg.norm(t) + 1e-7, name
