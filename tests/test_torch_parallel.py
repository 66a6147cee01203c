"""The port's data-parallel pure functions against the reference's, with
no process spawned: the layout's fitting and batch checks, the zero1
per-leaf rule leaf for leaf (applied in the reference's layout), the
process group's environment resolution (``init_process_group``
monkeypatched: no group opened), the topology record and its resolution,
the step-config gates on every combination, and each input stream's rows
for a rank."""

import itertools
import json
import os

import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.distributed as dist

from tpu_resnet import parallel as ref_parallel
from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.models import build_model as ref_build_model
from tpu_resnet.parallel.partition import StatePartitioner as RefPartitioner
from tpu_resnet.resilience import elastic as ref_elastic
from tpu_resnet.train.step import check_step_config as ref_check_step_config
from tpu_resnet_torch import parallel
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.convert import reference_layout
from tpu_resnet_torch.models import build_model
from tpu_resnet_torch.parallel import multihost
from tpu_resnet_torch.parallel.mesh import Mesh
from tpu_resnet_torch.resilience import elastic
from tpu_resnet_torch.train.step import check_step_config


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (ValueError, NotImplementedError) as e:
        return (type(e).__name__, str(e))


def _ref_mesh(n):
    return ref_parallel.create_mesh(ref_load_config("smoke").mesh,
                                    devices=jax.devices()[:n])


# ------------------------------------------------------------- the layout
FIT_CASES = [(d, m, n) for d in (-1, 0, 1, 2, 4, 8) for m in (1, 2, 4)
             for n in (1, 2, 3, 4, 7, 8)]


def test_fit_mesh_matches_reference():
    for data, model, n in FIT_CASES:
        cfg = load_config("smoke", "", [f"mesh.data={data}",
                                        f"mesh.model={model}"])
        ref_cfg = ref_load_config("smoke", "", [f"mesh.data={data}",
                                                f"mesh.model={model}"])
        assert _outcome(parallel.fit_mesh, cfg.mesh, n) == _outcome(
            ref_parallel.fit_mesh, ref_cfg.mesh, n), (data, model, n)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_batch_checks_match_reference(n):
    mesh, ref_mesh = Mesh(data=n), _ref_mesh(n)
    for batch in (1, 2, 3, 6, 8, 12, 16, 128):
        assert _outcome(parallel.check_divisible, batch, mesh) == _outcome(
            ref_parallel.check_divisible, batch, ref_mesh), batch
        assert _outcome(parallel.local_batch_size, batch, mesh) == _outcome(
            ref_parallel.local_batch_size, batch, ref_mesh), batch


def test_rank_rows_split_each_process_in_device_order():
    """Ranks are numbered node by node: rank r of 2 nodes x 2 cards takes
    rows [r·b, (r+1)·b) of the global batch, rows [l·b, (l+1)·b) of its
    node's local batch."""
    for rank in range(4):
        mesh = Mesh(data=4, rank=rank, local_rank=rank % 2,
                    process_index=rank // 2, process_count=2)
        assert mesh.rank_rows(16) == (4 * rank, 4 * rank + 4)
        assert mesh.local_rows(16) == (4 * (rank % 2), 4 * (rank % 2) + 4)
        assert parallel.local_batch_size(16, mesh) == 8
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        parallel.local_batch_size(7, Mesh(data=1, process_count=2))


def test_create_mesh_matches_reference():
    for data, model, n in FIT_CASES:
        cfg = load_config("smoke", "", [f"mesh.data={data}",
                                        f"mesh.model={model}"])
        got = _outcome(lambda: parallel.create_mesh(cfg.mesh, n).shape)
        ref_cfg = ref_load_config("smoke", "", [f"mesh.data={data}",
                                                f"mesh.model={model}"])
        want = _outcome(lambda: dict(ref_parallel.create_mesh(
            ref_cfg.mesh, devices=jax.devices()[:n]).shape))
        assert got == want, (data, model, n)


# -------------------------------------------------------- the zero1 rule
def _ref_slot_specs(cfg, n):
    """The reference partitioner's spec of every momentum leaf, by its
    reference path, or the error it raises."""
    model = ref_build_model(cfg)
    params = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        train=False))["params"]
    opt = jax.eval_shape(optax.sgd(0.1, momentum=0.9).init, params)
    part = RefPartitioner(_ref_mesh(n), "zero1")
    specs = part._opt_specs(opt)
    return {"/".join(k.key for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_leaves_with_path(
                specs[0].trace,
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}


@pytest.mark.parametrize("size, n", [(8, 2), (8, 4), (8, 8), (8, 3),
                                     (50, 2), (50, 4), (50, 8), (50, 7)])
def test_zero1_leaf_rule_matches_reference(size, n):
    """Leaf for leaf: the port shards (along the port axis that is the
    reference's axis), replicates or refuses exactly the reference's
    leaves."""
    overrides = [f"model.resnet_size={size}"]
    ref_cfg = ref_load_config("cifar10", "", overrides)
    model = build_model(load_config("cifar10", "", overrides))
    part = parallel.StatePartitioner(Mesh(data=n), "zero1")
    want = _outcome(_ref_slot_specs, ref_cfg, n)
    got = _outcome(part.slot_axes, model)
    if want[0] != "ok":
        assert got[0] == want[0] == "ValueError"
        head = want[1].split(":")[0]
        assert got[1].split(":")[0] == head
        assert "leaf/leaves over the" in got[1]
        return
    assert got[0] == "ok", got
    specs, axes = want[1], got[1]
    assert len(axes) == len(specs)
    for name, p in model.named_parameters():
        path, ref_shape, port_axes = reference_layout(name, p.shape)
        spec = specs[path]
        assert part.slot_spec(ref_shape) == spec, name
        assert axes[name] == (port_axes[len(spec) - 1] if spec else None)
        if axes[name] is not None:
            assert p.shape[axes[name]] % n == 0


def test_zero1_is_the_identity_on_one_rank():
    from tpu_resnet_torch.parallel import zero
    part = parallel.StatePartitioner(Mesh(data=1), "zero1")
    assert not part.is_sharded
    assert zero.make_update_fn(part, None) is zero.plain_update
    two = parallel.StatePartitioner(Mesh(data=2), "replicated")
    assert zero.make_update_fn(two, None) is zero.replicated_update
    with pytest.raises(ValueError, match="mesh.partition must be one of"):
        parallel.check_partition_mode("zero2")


# ---------------------------------------------------- the process group
def _clear_env(monkeypatch):
    for var in ("TPU_COORDINATOR_ADDRESS", "TPU_NUM_PROCESSES",
                "TPU_PROCESS_ID", "TPU_PROCS_PER_NODE", "TPU_LOCAL_RANK",
                "TPU_CHIPS_PER_NODE"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture
def calls(monkeypatch):
    """Record init_process_group and set_device; open no group."""
    _clear_env(monkeypatch)
    out = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: out.append(kw))
    monkeypatch.setattr(dist, "new_group", lambda **kw: None)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "mocked")
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: out.append({"card": d}))
    yield out
    multihost.shutdown()


def test_initialize_single_process_is_noop(calls):
    assert multihost.initialize() is None
    assert calls == []
    assert multihost.layout() == Mesh()
    assert multihost.is_primary()


def test_initialize_env_resolution_order(calls, monkeypatch):
    """Explicit arguments beat the launcher's variables; the world is the
    processes times each one's ranks."""
    monkeypatch.setenv("TPU_COORDINATOR_ADDRESS", "10.0.0.1:8476")
    monkeypatch.setenv("TPU_NUM_PROCESSES", "4")
    monkeypatch.setenv("TPU_PROCESS_ID", "3")
    mesh = multihost.initialize(device_type="cpu")
    assert calls[-1]["init_method"] == "tcp://10.0.0.1:8476"
    assert (calls[-1]["world_size"], calls[-1]["rank"]) == (4, 3)
    assert calls[-1]["backend"] == "gloo"
    assert (mesh.process_index, mesh.process_count) == (3, 4)
    multihost.initialize("127.0.0.1:9", 2, 1, local_rank=1, local_world=2,
                         device_type="cpu")
    assert calls[-1]["init_method"] == "tcp://127.0.0.1:9"
    assert (calls[-1]["world_size"], calls[-1]["rank"]) == (4, 3)
    multihost.initialize("file:///tmp/x", 1, 0, device_type="cpu")
    assert calls[-1]["init_method"] == "file:///tmp/x"


def test_initialize_multi_proc_per_node_card_slices(calls, monkeypatch):
    """TPU_PROCS_PER_NODE > 1: each process's ranks take their cards from
    its slice of the node; an over-subscribed node raises the
    reference's ValueError."""
    monkeypatch.setenv("TPU_COORDINATOR_ADDRESS", "127.0.0.1:9")
    monkeypatch.setenv("TPU_NUM_PROCESSES", "4")
    monkeypatch.setenv("TPU_PROCESS_ID", "1")
    monkeypatch.setenv("TPU_PROCS_PER_NODE", "2")
    monkeypatch.setenv("TPU_LOCAL_RANK", "1")
    monkeypatch.setenv("TPU_CHIPS_PER_NODE", "4")
    for local in (0, 1):
        multihost.initialize(local_rank=local, local_world=2)
        card, group = calls[-2:]
        assert card == {"card": 2 + local}
        assert group["backend"] == "nccl" and group["rank"] == 2 + local
    monkeypatch.setenv("TPU_PROCS_PER_NODE", "8")
    with pytest.raises(ValueError, match="TPU_PROCS_PER_NODE"):
        multihost.initialize()


def test_is_primary_is_global_rank_zero(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 0)
    assert multihost.is_primary() is True
    monkeypatch.setattr(dist, "get_rank", lambda *a: 2)
    assert multihost.is_primary() is False


# ----------------------------------------------------- the topology record
def test_topology_record_schema_and_round_trip(tmp_path):
    got = elastic.topology_record(Mesh(data=8), "zero1", 16, "cpu")
    want = ref_elastic.topology_record(_ref_mesh(8), "zero1", 16)
    assert got == want
    assert elastic.describe(got) == ref_elastic.describe(want)
    path = elastic.write_topology(str(tmp_path / "a"), Mesh(data=8),
                                  "zero1", 16, "cpu")
    assert json.load(open(path)) == want
    assert ref_elastic.read_topology(str(tmp_path / "a")) == want
    ref_elastic.write_topology(str(tmp_path / "b"), _ref_mesh(4),
                               "replicated", 16)
    assert elastic.read_topology(str(tmp_path / "b")) == \
        elastic.topology_record(Mesh(data=4), "replicated", 16, "cpu")
    assert elastic.read_topology(str(tmp_path / "missing")) is None


def _cfgs(n, train_dir, *extra):
    over = [f"mesh.data={n}", f"train.train_dir={train_dir}", *extra]
    return load_config("smoke", "", over), ref_load_config("smoke", "", over)


def test_resolve_matches_reference(tmp_path):
    """Reshape detection, downsizing and the changed-batch mark: the
    same decisions and span attributes as the reference's."""
    ref_elastic.write_topology(str(tmp_path), _ref_mesh(8), "replicated", 16)
    for n, devices, extra in ((4, 4, ["mesh.partition=zero1"]),
                              (8, 4, []), (8, 8, []),
                              (8, 8, ["train.global_batch_size=32"])):
        cfg, ref_cfg = _cfgs(n, tmp_path, *extra)
        got = elastic.resolve(cfg, devices, device_kind="cpu")
        want = ref_elastic.resolve(ref_cfg, devices=jax.devices()[:devices])
        assert got.mesh.shape == dict(want.mesh.shape)
        assert (got.changed, got.downsized, got.stream_compatible) == (
            want.changed, want.downsized, want.stream_compatible)
        assert got.attrs() == want.attrs()
        assert got.current == want.current


def test_resolve_global_batch_error_matches_reference(tmp_path):
    ref_elastic.write_topology(str(tmp_path), _ref_mesh(8), "replicated", 16)
    cfg, ref_cfg = _cfgs(3, tmp_path)
    got = _outcome(elastic.resolve, cfg, 3)
    want = _outcome(ref_elastic.resolve, ref_cfg, jax.devices()[:3])
    assert got == want and got[0] == "ValueError"
    assert "checkpoint topology" in got[1] and "'data': 8" in got[1]


# ------------------------------------------------------ the step's gates
GATES = list(itertools.product((False, True), ("off", "on", "auto"),
                               (True, False), ("replicated", "zero1"),
                               (1, 2, 4)))


@pytest.mark.parametrize("fused, epilogue, sync_bn, partition, n", GATES)
def test_step_config_gates_match_reference(fused, epilogue, sync_bn,
                                           partition, n):
    over = [f"model.fused_blocks={str(fused).lower()}",
            f"model.fused_epilogue={epilogue}",
            f"model.sync_bn={str(sync_bn).lower()}",
            f"mesh.partition={partition}", "model.resnet_size=14"]
    got = _outcome(check_step_config, load_config("cifar10", "", over), n)
    want = _outcome(ref_check_step_config,
                    ref_load_config("cifar10", "", over), n)
    assert got == want


# ------------------------------------------------- each rank's input rows
def test_each_stream_keeps_a_ranks_rows():
    """The resident split, the streamed batcher and the ImageNet engine:
    rank r of 2 gets rows [r·b, (r+1)·b) of the batch the whole stream
    gives, with the same order and, for the engine, the same crop draws
    (it decodes only its rows)."""
    from tpu_resnet_torch.data import pipeline
    from tpu_resnet_torch.data.cifar import synthetic_data
    from tpu_resnet_torch.data.device_data import DeviceDataset
    from tpu_resnet_torch.data.imagenet import ImageNetIterator

    images, labels = synthetic_data(40, 8, 10)
    whole = DeviceDataset(images, labels, 8, "cpu", seed=3)
    b = iter(pipeline.ShardedBatcher(images, labels, 8, seed=3,
                                     start_step=2))
    batches = [next(b) for _ in range(6)]
    for rank in range(2):
        lo, hi = Mesh(data=2, rank=rank).rank_rows(8)
        part = DeviceDataset(images, labels, 8, "cpu", seed=3,
                             rows=(lo, hi))
        s = iter(pipeline.ShardedBatcher(images, labels, 8, seed=3,
                                         start_step=2, rows=(lo, hi)))
        for step in range(2, 8):  # across an epoch boundary
            got, want = part.batch_at(step), whole.batch_at(step)
            assert torch.equal(got[0], want[0][lo:hi])
            assert torch.equal(got[1], want[1][lo:hi])
            im, lab = next(s)
            assert (im == batches[step - 2][0][lo:hi]).all()
            assert (lab == batches[step - 2][1][lo:hi]).all()

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures", "imagenet")
    it = ImageNetIterator(fixtures, 4, image_size=32, resize_min=36,
                          resize_max=44, seed=5)
    eng = it.engine(device="cpu", workers=1)
    try:
        want = next(eng)
    finally:
        eng.close()
    eng = it.engine(device="cpu", workers=1, rows=(2, 4))
    try:
        got = next(eng)
    finally:
        eng.close()
    assert torch.equal(got[0], want[0][2:4])
    assert torch.equal(got[1], want[1][2:4])
