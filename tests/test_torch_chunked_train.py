"""The port's multi-step dispatch on the CPU, against the reference: the
chunk boundaries (``_chunk_len``), chunked against one-step training
(bit for bit), the chunked and staged ``train()`` against the reference's,
the staged superbatches and the double-buffered transfer against the
reference's, a NaN rollback under chunking, and a restore that keeps every
tensor where it is (a captured CUDA graph reads and writes those tensors).
On the CPU the runner runs its chunks as eager steps; the graph replays
are held on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import itertools
import json
import logging
import os
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.data import pipeline as ref_pipeline
from tpu_resnet.models import build_model as ref_build_model
from tpu_resnet.parallel import create_mesh, staged_batch_sharding
from tpu_resnet.train import loop as ref_loop
from tpu_resnet.train import train as ref_train
from tpu_resnet_torch import convert
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.data import device_data, pipeline
from tpu_resnet_torch.data.cifar import load_split
from tpu_resnet_torch.models import build_model
from tpu_resnet_torch.train import checkpoint, loop
from tpu_resnet_torch.train.loop import build_state, train
from tpu_resnet_torch.train.state import create_state

import test_torch_train as tt


# ------------------------------------------------------- (a) _chunk_len
def _train_cfg(k, log, summary, image, ckpt):
    return types.SimpleNamespace(steps_per_call=k, log_every=log,
                                 summary_every=summary,
                                 image_summary_every=image,
                                 checkpoint_every=ckpt)


CHUNK_GRID = [
    # steps_per_call, log, summary, image summary, checkpoint, epoch
    (10, 20, 100, 1000, 1000, 0), (10, 1, 100, 1000, 1000, 390),
    (10, 100, 100, 0, 50, 390), (4, 2, 2, 0, 4, 0), (4, 3, 5, 7, 11, 13),
    (1, 20, 100, 1000, 1000, 0), (0, 20, 100, 1000, 1000, 0),
    (16, 0, 0, 0, 0, 0), (16, 5, 0, 0, 0, 6), (8, 6, 9, 0, 0, 4),
    (32, 25, 100, 1000, 30, 97), (10, 7, 0, 0, 3, 0),
]


@pytest.mark.parametrize("extra", [(), (17,), (5, 64, 200)],
                         ids=["none", "one", "three"])
@pytest.mark.parametrize("total", [1, 37, 250])
@pytest.mark.parametrize("k, log, summary, image, ckpt, epoch", CHUNK_GRID)
def test_chunk_len_equals_the_reference(k, log, summary, image, ckpt, epoch,
                                        total, extra):
    """At every step of a run to ``total``, the port's chunk length is the
    reference's, and walking the chunks reaches ``total`` exactly."""
    cfg = _train_cfg(k, log, summary, image, ckpt)
    for step in range(total):
        got = loop._chunk_len(step, total, cfg, epoch, extra)
        assert got == ref_loop._chunk_len(step, total, cfg, epoch, extra)
        assert 1 <= got <= max(1, k)
    step, walked = 0, []
    while step < total:
        step += loop._chunk_len(step, total, cfg, epoch, extra)
        walked.append(step)
    assert walked[-1] == total
    for interval in (log, ckpt, epoch):
        if interval > 0:   # every boundary is a chunk's end
            assert set(range(interval, total, interval)) <= set(walked)


# ------------------------------------- (b) chunked == unchunked, bit for bit
def _run_cfg(train_dir, *extra):
    return tt._loop_cfg(train_dir, "train.log_every=2",
                        "train.checkpoint_every=5", *extra)


INPUTS = {
    "resident": [],
    "streamed_stage1": ["data.device_resident=off", "data.transfer_stage=1"],
    "streamed_stage4_db": ["data.device_resident=off",
                           "data.transfer_stage=4",
                           "data.h2d_double_buffer=true"],
    "streamed_stage4": ["data.device_resident=off", "data.transfer_stage=4",
                        "data.h2d_double_buffer=false"],
}


@pytest.mark.parametrize("inputs", sorted(INPUTS))
def test_chunked_train_equals_one_step_train(tmp_path, inputs):
    """steps_per_call=4 and =1 log the same losses at the same steps and
    end in the same parameters, statistics and momentum buffers, bit for
    bit; both checkpoint at the same steps."""
    runs = {}
    for k in (1, 4):
        d = tmp_path / f"k{k}"
        state = train(_run_cfg(d, *INPUTS[inputs],
                               f"train.steps_per_call={k}"), device="cpu")
        runs[k] = (state, tt._losses(d), checkpoint.all_steps_in(str(d)))
    (s1, l1, c1), (s4, l4, c4) = runs[1], runs[4]
    assert s1.step == s4.step == 12
    assert l1 == l4 and [s for s, _ in l1] == [2, 4, 6, 8, 10, 12]
    assert c1 == c4 == [10, 12]
    for (name, a), b in zip(s1.model.state_dict().items(),
                            s4.model.state_dict().values()):
        assert torch.equal(a, b), name
    m1, m4 = s1.momentum_buffers(), s4.momentum_buffers()
    assert set(m1) == set(m4) and m1
    assert all(torch.equal(m1[n], m4[n]) for n in m1)


def test_chunks_are_clipped_to_every_boundary(tmp_path, monkeypatch):
    """The runner sees the chunks _chunk_len gives: on the resident split
    (4 steps an epoch here) none crosses an epoch, a log or a checkpoint
    boundary."""
    seen = []
    real = device_data.ChunkRunner.run

    def run(self, state, step, c):
        seen.append((step, c))
        return real(self, state, step, c)

    monkeypatch.setattr(device_data.ChunkRunner, "run", run)
    cfg = _run_cfg(tmp_path, "data.synthetic_train_examples=32",
                   "train.log_every=3", "train.steps_per_call=8")
    train(cfg, device="cpu")
    ends = list(itertools.accumulate(c for _, c in seen))
    assert [s for s, _ in seen] == [0] + ends[:-1] and ends[-1] == 12
    assert {3, 4, 5, 6, 8, 9, 10, 12} <= set(ends)
    want, step = [], 0
    while step < 12:
        want.append((step, ref_loop._chunk_len(step, 12, cfg.train, 4)))
        step += want[-1][1]
    assert seen == want


def test_runner_refuses_bad_chunks():
    """A chunk longer than steps_per_call or across an epoch raises; on
    CUDA a step that is not a TrainStep is refused when the runner is
    built, naming steps_per_call=1."""
    cfg = load_config("smoke", "", ["train.global_batch_size=8",
                                    "data.synthetic_train_examples=32"])
    cpu = torch.device("cpu")
    ds = device_data.DeviceDataset(*load_split(cfg.data, train=True), 8,
                                   cpu)
    state = build_state(cfg, cpu)
    runner = device_data.ChunkRunner(loop.make_loop_step(cfg, cpu), cpu, 4,
                                     ds)
    with pytest.raises(ValueError, match="steps_per_call=4"):
        runner.run(state, 0, 5)
    with pytest.raises(ValueError, match="state at 0"):
        runner.run(state, 1, 1)
    state.step = 2
    with pytest.raises(ValueError, match="crosses the epoch boundary"):
        runner.run(state, 2, 3)
    with pytest.raises(ValueError, match="train.steps_per_call=1"):
        device_data.ChunkRunner(lambda s, x, y: {}, "cuda", 4)


# ------------------------------ (c) against the reference's chunked train()
def _staged_overrides(train_dir, *extra):
    return ["optim.use_pallas_xent=off", "model.fused_epilogue=off",
            "data.device_resident=off", "data.transfer_stage=4",
            "train.steps_per_call=4", "data.synthetic_train_examples=64",
            "train.global_batch_size=8", "train.train_steps=12",
            "train.log_every=3", "train.summary_every=3",
            "train.checkpoint_every=6", "train.image_summary_every=0",
            "resilience.watchdog_stall_sec=0", f"train.train_dir={train_dir}",
            *extra]


def _from_reference_init(cfg, monkeypatch):
    """Make the port's loop start from the reference's initial weights."""
    size = cfg.data.resolved_image_size
    variables = jax.device_get(ref_build_model(cfg).init(
        jax.random.split(jax.random.PRNGKey(cfg.train.seed))[0],
        jnp.zeros((1, size, size, 3), jnp.float32), train=False))

    def start(cfg, device):
        model = build_model(cfg)
        model.load_state_dict(convert.flax_to_torch(variables), strict=True)
        return create_state(model.to(device), cfg.optim)

    monkeypatch.setattr(loop, "build_state", start)


@pytest.mark.parametrize("double_buffer", ["true", "false"])
def test_staged_chunked_train_matches_the_reference(tmp_path, monkeypatch,
                                                    double_buffer):
    """steps_per_call=4, transfer_stage=4 on the streaming path, from the
    reference's initial weights: the same logged steps and checkpoints,
    losses within the train tests' tolerance."""
    extra = (f"data.h2d_double_buffer={double_buffer}",)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    cfg = ref_load_config("smoke", "", _staged_overrides(ref_dir, *extra))
    ref_train(cfg, mesh=create_mesh(cfg.mesh, devices=jax.devices()[:1]))
    port_cfg = load_config("smoke", "", _staged_overrides(port_dir, *extra))
    _from_reference_init(port_cfg, monkeypatch)
    state = train(port_cfg, device="cpu")
    assert state.step == 12
    got, want = tt._losses(port_dir), tt._reference_losses(ref_dir)
    assert [s for s, _ in got] == [3, 6, 9, 12]
    tt._close_losses(got, want)
    assert checkpoint.all_steps_in(str(port_dir)) == sorted(
        ocp.utils.checkpoint_steps(str(ref_dir))) == [6, 12]


# ------------------------------------ (d) staged superbatches on the CPU
def _batches(n_batches=11, b=16, hw=8):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 255, (b, hw, hw, 3)).astype(np.uint8),
             rng.integers(0, 10, b).astype(np.int32))
            for _ in range(n_batches)]


def _reference_stages(batches, stage):
    mesh = create_mesh(ref_load_config("smoke").mesh,
                       devices=jax.devices()[:1])
    return [(np.asarray(gi), np.asarray(gl), k) for gi, gl, k in
            ref_pipeline.staged_superbatch_prefetch(
                iter(batches), staged_batch_sharding(mesh), stage=stage)]


@pytest.mark.parametrize("n_batches, stage", [(11, 4), (8, 4), (3, 4),
                                               (5, 1)])
@pytest.mark.parametrize("form", ["generator", "double_buffered"])
def test_staged_superbatches_equal_the_reference(n_batches, stage, form):
    """Both forms yield the reference's superbatches, a partial last stage
    with its true k included, as CPU tensors."""
    batches = _batches(n_batches)
    want = _reference_stages(batches, stage)
    if form == "generator":
        got = list(pipeline.staged_superbatch_prefetch(iter(batches), "cpu",
                                                       stage=stage))
    else:
        db = pipeline.DoubleBufferedH2D(iter(batches), "cpu", stage=stage)
        got = [(gi.clone(), gl.clone(), k) for gi, gl, k in db]
        db.close()
    assert [k for *_, k in got] == [k for *_, k in want]
    for (gi, gl, _), (wi, wl, _) in zip(got, want):
        assert gi.dtype == torch.uint8 and gl.dtype == torch.int32
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gl.numpy(), wl)


def test_staged_superbatch_promotes_a_float_batch():
    """A float batch in a stage (the NaN-poisoned one of the fault tests)
    promotes the superbatch as the reference's np.stack does."""
    batches = _batches(4)
    batches[2] = (np.full(batches[2][0].shape, np.nan, np.float32),
                  batches[2][1])
    for it in (pipeline.staged_superbatch_prefetch(iter(batches), "cpu"),
               pipeline.DoubleBufferedH2D(iter(batches), "cpu")):
        (gi, gl, k), = [(a.clone(), b.clone(), k) for a, b, k in it]
        assert k == 4 and gi.dtype == torch.float32
        assert torch.isnan(gi[2]).all() and not torch.isnan(gi[1]).any()
        np.testing.assert_array_equal(gi[0].numpy(), batches[0][0])


def test_device_stages_group_without_copying():
    """The engine's stages: batches taken as their rows are read, the same
    objects, and a stream that ends inside a stage raises StopIteration at
    the row it lacks."""
    batches = [tuple(torch.from_numpy(a) for a in b) for b in _batches(7)]
    pulled = []

    def source():
        for b in batches:
            pulled.append(b)
            yield b

    stages = pipeline.device_stages(source(), 3)
    flat = []
    for _ in range(2):
        ims, lbs, k = next(stages)
        assert k == 3
        for i in range(3):
            flat.append((ims[i], lbs[i]))
            assert len(pulled) == len(flat)
    ims, lbs, k = next(stages)
    flat.append((ims[0], lbs[0]))
    assert all(a is x and b is y for (a, b), (x, y) in zip(flat, batches))
    with pytest.raises(StopIteration):
        ims[1]
    with pytest.raises(StopIteration):
        next(stages)


def test_double_buffered_h2d_two_slot_bound():
    """With a ready slot unconsumed, at most one further transfer lands:
    the producer never runs ahead of the two-slot buffer."""
    db = pipeline.DoubleBufferedH2D(iter(_batches(12)), "cpu", stage=2,
                                    depth=2)
    try:
        deadline = time.time() + 5
        landed = 0
        while landed < 2 and time.time() < deadline:
            landed += len(db.drain_transfers())
            time.sleep(0.02)
        time.sleep(0.3)
        assert landed == 2 and len(db.drain_transfers()) == 0
        next(db)                   # slot 0 taken: slot 1's put goes in
        next(db)                   # slot 0 handed back: one more lands
        deadline = time.time() + 5
        while not db.drain_transfers() and time.time() < deadline:
            time.sleep(0.02)
        time.sleep(0.3)
        assert len(db.drain_transfers()) == 0
    finally:
        db.close()


def test_double_buffered_h2d_stats_and_events():
    batches = _batches(8)
    db = pipeline.DoubleBufferedH2D(iter(batches), "cpu", stage=4)
    consumed = list(db)
    stats = db.stats()
    events = db.drain_transfers()
    db.close()
    assert len(consumed) == 2 and len(events) == 2
    expect = sum(im.nbytes + lb.nbytes for im, lb in batches)
    assert sum(e[2] for e in events) == expect
    assert all(e[1] >= e[0] for e in events)
    assert [e[3] for e in events] == [4, 4]
    assert stats["h2d_bytes_per_sec"] > 0
    assert 0.0 <= stats["h2d_overlap_frac"] <= 1.0
    assert db.stats()["h2d_bytes_per_sec"] == 0.0


def test_double_buffered_h2d_propagates_errors_in_order():
    batches = _batches(3)

    def stream():
        yield batches[0]
        yield batches[1]
        raise RuntimeError("shard went away")

    db = pipeline.DoubleBufferedH2D(stream(), "cpu", stage=2)
    try:
        gi, gl, k = next(db)  # the complete first stage arrives
        assert k == 2
        np.testing.assert_array_equal(gi[1].numpy(), batches[1][0])
        with pytest.raises(RuntimeError, match="shard went away"):
            next(db)
    finally:
        db.close()


def test_double_buffered_h2d_external_stop_unblocks(monkeypatch):
    monkeypatch.setattr(pipeline, "GET_POLL_SEC", 0.05)
    stall, stop = threading.Event(), threading.Event()

    def stream():
        stall.wait(30)
        yield from ()

    db = pipeline.DoubleBufferedH2D(stream(), "cpu", stage=2,
                                    external_stop=stop)
    try:
        stop.set()
        with pytest.raises(StopIteration):
            next(db)
    finally:
        stall.set()
        db.close()


# ------------------------------------- (e) a NaN rollback under chunking
def test_nan_rollback_under_chunking_matches_the_reference(tmp_path,
                                                           monkeypatch,
                                                           caplog):
    """steps_per_call=4 and transfer_stage=4 on the fault tests' run: the
    NaN reaches the loss at step 6, both roll back to checkpoint 4, restart
    the stream at 6, and log the same losses from there to 12."""
    extra = ("train.steps_per_call=4", "data.transfer_stage=4")
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    tt._reference_run(ref_dir, *extra)
    (rb,) = tt._spans(ref_dir, "nan_rollback")
    assert (rb["from_step"], rb["to_step"], rb["retry"]) == (6, 4, 1)
    with caplog.at_level(logging.WARNING, logger="tpu_resnet_torch"):
        state = tt._port_run(port_dir, monkeypatch, *extra)
    assert state.step == 12
    assert tt._port_logs(caplog, "nan rollback") == [(6, 4, 1)]
    tt._close_losses(tt._losses(port_dir), tt._reference_losses(ref_dir))
    assert [s for s, _ in tt._losses(port_dir)] == [2, 4, 6, 8, 10, 12]


# ------------------------------------------- restore keeps the tensors
def _pointers(state):
    return ({n: p.data_ptr() for n, p in state.model.named_parameters()},
            {n: b.data_ptr() for n, b in state.model.named_buffers()},
            {n: b.data_ptr() for n, b in state.momentum_buffers().items()})


@pytest.mark.parametrize("saved_momentum", [True, False])
def test_restore_writes_into_the_state_tensors(tmp_path, saved_momentum):
    """A restore (resume or NaN rollback) copies into the parameters, the
    BN statistics and the momentum buffers that exist: every data_ptr is
    the same after it, and the values are the checkpoint's. A checkpoint
    without momentum buffers zeroes them in place."""
    cfg = tt._loop_cfg(tmp_path, "train.train_steps=3",
                       "train.checkpoint_every=3")
    trained = train(cfg, device="cpu")
    if not saved_momentum:
        checkpoint.save(str(tmp_path), 3, trained.model, {})
    state = build_state(cfg, torch.device("cpu"))
    step_fn = loop.make_loop_step(cfg, torch.device("cpu"))
    images = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8)
    labels = torch.randint(0, 10, (8,), dtype=torch.int32)
    step_fn(state, images, labels)
    before = _pointers(state)
    assert before[2]
    checkpoint.CheckpointManager(str(tmp_path)).restore(state)
    assert state.step == 3
    assert _pointers(state) == before
    saved = checkpoint.restore(str(tmp_path), 3)
    for n, p in state.model.named_parameters():
        assert torch.equal(p, saved["params"][n]), n
    for n, b in state.model.named_buffers():
        assert torch.equal(b, saved["batch_stats"][n]), n
    for n, b in state.momentum_buffers().items():
        want = saved["opt_state"].get(n, torch.zeros_like(b))
        assert torch.equal(b, want), n


def test_restore_into_a_fresh_state_makes_the_momentum_buffers(tmp_path):
    """Before any step there are no buffers: the restore makes them (the
    resume path, before any capture), with the checkpoint's values."""
    cfg = tt._loop_cfg(tmp_path, "train.train_steps=3",
                       "train.checkpoint_every=3")
    train(cfg, device="cpu")
    state = build_state(cfg, torch.device("cpu"))
    assert not state.momentum_buffers()
    checkpoint.CheckpointManager(str(tmp_path)).restore(state)
    saved = checkpoint.restore(str(tmp_path), 3)
    got = state.momentum_buffers()
    assert set(got) == set(saved["opt_state"]) and got
    assert all(torch.equal(got[n], saved["opt_state"][n]) for n in got)


def test_metrics_name_the_staged_transfer(tmp_path):
    """With the double buffer on, metrics.jsonl carries its h2d stats."""
    train(_run_cfg(tmp_path, *INPUTS["streamed_stage4_db"],
                   "train.steps_per_call=4"), device="cpu")
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert all({"h2d_bytes_per_sec", "h2d_overlap_frac"} <= set(r)
               for r in recs)
    assert all(0.0 <= r["h2d_overlap_frac"] <= 1.0 for r in recs)
