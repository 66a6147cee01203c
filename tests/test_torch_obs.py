"""The port's observability (``tpu_resnet_torch/obs``) against the
reference's on the CPU: the ``/metrics`` text byte for byte the reference
registry's for the same updates, and read by the reference's parsers; the
server's endpoints through the reference's ``scrape``; ``events.jsonl``
read by the reference's ``load_spans``; a tiny run of both (train, resume,
eval once) writing the same sequence of span kinds, manifests with the
reference's keys and ledgers under the reference's program key; the OOM
report through the reference's validator; the FLOP count against the
reference's XLA count, convolution by convolution; the peak table, the
program keys of every preset, the breakdown and the watchdog; and a
``train()`` scraped while it runs, its server and watchdog gone after it,
also after a failed setup."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tpu_resnet import obs as ref_obs
from tpu_resnet.config import PRESETS as REF_PRESETS
from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.evaluation import evaluate as ref_evaluate
from tpu_resnet.obs import memory as ref_memory
from tpu_resnet.obs import mfu as ref_mfu
from tpu_resnet.obs import server as ref_server
from tpu_resnet.obs.spans import load_spans
from tpu_resnet.parallel import create_mesh
from tpu_resnet.resilience.watchdog import HangWatchdog as RefWatchdog
from tpu_resnet.train import train as ref_train
from tpu_resnet_torch import obs
from tpu_resnet_torch.config import PRESETS, load_config
from tpu_resnet_torch.evaluation.evaluator import evaluate
from tpu_resnet_torch.obs import memory, mfu, server
from tpu_resnet_torch.resilience import corrupt_checkpoint
from tpu_resnet_torch.resilience.watchdog import HangWatchdog
from tpu_resnet_torch.train.loop import train

import test_torch_train as tt

THREADS = ("tpu-resnet-torch-telemetry", "tpu-resnet-torch-watchdog")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's runs here: they are small, and
    the suite's workers share the host's cores (a thread pool per worker
    oversubscribes them many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _updates(reg):
    """One sequence of registry updates: gauges, histogram observations
    (weighted too), a heartbeat."""
    reg.update({"loss": 2.25, "precision": 0.125, "learning_rate": 0.1,
                "steps_per_sec": 7.5, "images_per_sec": 960.0,
                "mfu": 0.0251, "model_flops_per_sec": 2.41e13,
                "hbm_bytes_in_use": 6.33e9, "grad_norm": 1.5})
    for v, n in ((3.2, 1), (12.0, 4), (129.0, 10), (7000.0, 1)):
        reg.observe("train_step_ms", v, n=n)
    reg.set("checkpoint_lag_steps", 20)
    reg.heartbeat(40)


def test_metrics_text_equals_the_reference_rendering(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    got = server.TelemetryRegistry(histograms=server.CORE_HISTOGRAMS)
    want = ref_server.TelemetryRegistry(histograms=ref_server.CORE_HISTOGRAMS)
    assert got.render() == want.render()       # the pre-declared series
    _updates(got)
    _updates(want)
    text = got.render()
    assert text == want.render()
    assert ref_server.parse_prometheus(text) == \
        server.parse_prometheus(text)
    hist = ref_server.parse_histograms(text)["tpu_resnet_train_step_ms"]
    assert hist["count"] == 16
    for q in (0.5, 0.95, 0.99):
        assert got.hist_percentile("train_step_ms", q) == \
            ref_server.histogram_quantile(hist, q)
    assert server.merge_histograms([hist, hist])["count"] == 32


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_server_endpoints_through_the_reference_scrape(tmp_path):
    assert server.TelemetryServer.maybe_start(-1, None) is None
    reg = server.TelemetryRegistry(histograms=server.CORE_HISTOGRAMS)
    srv = server.TelemetryServer.maybe_start(0, reg, train_dir=str(tmp_path))
    try:
        assert ref_server.read_telemetry_port(str(tmp_path)) == srv.port
        assert server.read_telemetry_port(str(tmp_path)) == srv.port
        _updates(reg)
        got = ref_server.scrape(f"127.0.0.1:{srv.port}")
        assert got["health_status"] == 200 and got["health"]["ok"]
        assert got["metrics"]["tpu_resnet_step"] == 40.0
        assert got["metrics"]["tpu_resnet_mfu"] == 0.0251
        assert got["histograms"]["tpu_resnet_train_step_ms"]["count"] == 16
        reg.mark_unhealthy("no step progress for 3.0s")
        status, body = _get(srv.port, "/healthz")
        assert status == 503
        assert json.loads(body)["unhealthy_reason"] == \
            "no step progress for 3.0s"
        reg.clear_unhealthy()
        assert _get(srv.port, "/healthz")[0] == 200
        assert _get(srv.port, "/nope")[0] == 404
    finally:
        srv.close()
    srv.close()  # idempotent


def test_spans_are_read_by_the_reference(tmp_path):
    tracer = obs.SpanTracer(str(tmp_path), run_id="abc123")
    tracer.record("compile", 10.0, 12.5, seconds=2.5, step=0)
    tracer.event("preempt_stop", step=6, signum=15)
    with pytest.raises(ValueError):
        with tracer.span("eval_pass", step=6) as attrs:
            attrs["precision"] = 0.5
            raise ValueError("torn")
    tracer.close()
    tracer.close()
    tracer.event("after_close")
    path = os.path.join(str(tmp_path), "events.jsonl")
    with open(path, "a") as f:
        f.write('{"span": "torn')                 # a torn last line
    spans = load_spans(path)
    assert spans == obs.spans.load_spans(path)
    assert [s["span"] for s in spans] == ["compile", "preempt_stop",
                                          "eval_pass"]
    assert spans[0] == {"span": "compile", "start": 10.0, "end": 12.5,
                        "duration_sec": 2.5, "pid": os.getpid(),
                        "run_id": "abc123", "seconds": 2.5, "step": 0}
    assert spans[2]["precision"] == 0.5
    assert spans[2]["error"] == "ValueError: torn"


# ----------------------------------------------- a tiny run of both
def _run_overrides(train_dir, steps):
    # The resume skips the memory ledger (one XLA compile of the
    # reference's fewer).
    return tt._fault_overrides(train_dir, f"train.train_steps={steps}",
                               "train.checkpoint_every=2",
                               "train.comms_ledger=false",
                               f"train.memory_ledger={steps == 4}",
                               "data.synthetic_eval_examples=24",
                               "train.eval_batch_size=8")


def _both_runs(tmp_path):
    """Each side: 4 steps, a resume to 6, one eval of the newest
    checkpoint."""
    for side in ("ref", "port"):
        d = tmp_path / side
        for steps in (4, 6):
            o = _run_overrides(d, steps)
            if side == "ref":
                cfg = ref_load_config("smoke", "", o)
                mesh = create_mesh(cfg.mesh, devices=jax.devices()[:1])
                ref_train(cfg, mesh=mesh)
            else:
                cfg = load_config("smoke", "", o)
                train(cfg, device="cpu")
        cfg.train.eval_once = True
        if side == "ref":
            ref_evaluate(cfg, mesh=mesh)
        else:
            evaluate(cfg, device="cpu")


def _kinds(path):
    return [s["span"] for s in load_spans(path)]


def test_run_artifacts_match_the_reference(tmp_path):
    """The same sequence of span kinds (timings left out) in the train
    dir and the eval dir, one run_id across them; manifests with the
    reference's keys; ``flops.json`` and ``memory.json`` under the
    reference's key, read by the reference's loaders."""
    _both_runs(tmp_path)
    ref, port = tmp_path / "ref", tmp_path / "port"
    kinds = _kinds(port / "events.jsonl")
    assert kinds == _kinds(ref / "events.jsonl")
    assert kinds == ["compile", "mfu_account", "memory_account",
                     "checkpoint_save", "checkpoint_save", "run",
                     "checkpoint_restore", "compile", "mfu_account",
                     "checkpoint_save", "run"]
    assert _kinds(port / "eval" / "events.jsonl") == \
        _kinds(ref / "eval" / "events.jsonl") == ["eval_pass"]
    rid = obs.read_run_id(str(port))
    assert {s["run_id"] for s in load_spans(str(port / "events.jsonl"))
            + load_spans(str(port / "eval" / "events.jsonl"))} == {rid}
    (ev,) = load_spans(str(port / "eval" / "events.jsonl"))
    assert ev["step"] == 6 and ev["examples"] == 24

    want = json.load(open(ref / "manifest.json"))
    got = json.load(open(port / "manifest.json"))
    assert set(got) == set(want)
    for key in ("mesh", "devices", "processes"):
        assert set(got[key]) == set(want[key])
    assert got["run_id"] == rid
    assert got["mesh"]["shape"] == {"data": 1}
    assert got["devices"] == {"count": 1, "kinds": ["cpu"],
                              "platform": "cpu"}
    assert got["processes"] == {"count": 1, "index": 0}
    assert {"python", "torch", "cuda", "tpu_resnet_torch"} == \
        set(got["versions"])
    assert got["config"] == json.loads(json.dumps(load_config(
        "smoke", "", _run_overrides(port, 6)).to_dict(), default=list))

    key = "train|synthetic_rn8_f32|mesh1x1|b8"
    assert ref_mfu.FlopsRegistry.load(str(ref)).get(key)
    entry = ref_mfu.FlopsRegistry.load(str(port)).get(key)
    assert entry["flops_source"] == "flop_counter"
    assert entry["flops_per_step"] == mfu.count_train_flops(
        load_config("smoke", "", _run_overrides(port, 6)))["total"]
    assert ref_memory.MemoryLedger.load(str(ref)).keys() == [key]
    entry = ref_memory.MemoryLedger.load(str(port)).get(key)
    assert entry["budget_source"] == "none"        # measured on CUDA only
    assert entry["params_bytes"] == entry["opt_state_bytes"] > 0


def test_oom_report_passes_the_reference_validator(tmp_path):
    ledger = memory.MemoryLedger()
    ledger.register("train|x|mesh1x1|b8", {"peak_bytes": 10})
    ring = memory.MemorySampleRing(2)
    for step in (10, 20, 30):
        ring.add(step, {"hbm_bytes_in_use": float(step)})
    assert [s["step"] for s in ring.snapshot()] == [20, 30]
    keep = torch.zeros(64, 3)
    for err in (torch.cuda.OutOfMemoryError(
                    "CUDA out of memory. Tried to allocate 2.00 GiB"),
                RuntimeError("RESOURCE_EXHAUSTED: injected OOM drill")):
        assert memory.is_oom_error(err)
        path = memory.write_oom_report(
            str(tmp_path), err, step=30, program_key="train|x|mesh1x1|b8",
            ledger=ledger, samples=ring.snapshot(), run_id="r")
        report = json.load(open(path))
        assert ref_memory.validate_oom_report(report) == []
        assert memory.validate_oom_report(report) == []
        assert report["error"]["type"] == type(err).__name__
        assert report["error"]["message"].startswith("RESOURCE_EXHAUSTED")
        assert any(b["shape"] == [64, 3] and b["dtype"] == "torch.float32"
                   for b in report["live_arrays"]["buckets"])
        assert report["devices"] == [{"id": -1, "device_kind": "cpu",
                                      "stats": None}]
    del keep
    for err in (RuntimeError("RESOURCE_EXHAUSTED: x"), ValueError("x"),
                RuntimeError("other"), None):
        assert memory.is_oom_error(err) == ref_memory.is_oom_error(err)
    assert memory.validate_oom_report({"format": 1}) == \
        ref_memory.validate_oom_report({"format": 1})


# ------------------------------------------------------------------- MFU
def _reference_flops(cfg):
    """The reference's count, called as ``tests/test_mfu.py`` calls it."""
    from tpu_resnet import parallel
    from tpu_resnet.models import build_model
    from tpu_resnet.train import build_schedule, init_state
    from tpu_resnet.train.step import make_train_step

    mesh = parallel.create_mesh(cfg.mesh, devices=jax.devices()[:1])
    model = build_model(cfg)
    sched = build_schedule(cfg.optim, cfg.train)
    rng = jax.random.PRNGKey(0)
    state = init_state(model, cfg.optim, sched, rng,
                       jnp.zeros((1, 32, 32, 3)))
    state = jax.device_put(state, parallel.replicated(mesh))
    step = make_train_step(model, cfg.optim, sched, cfg.data.num_classes,
                           None, base_rng=rng, mesh=mesh)
    return ref_mfu.account_train_step(cfg, mesh, state, step)


def _conv_calls(cfg):
    """The plain model's convolutions in one forward on the meta device:
    (x shape, w shape, stride, padding), as ``aten.convolution`` gets
    them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from tpu_resnet_torch.models import build_model

    calls = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket == torch.ops.aten.convolution:
                x, w = args[0], args[1]
                calls.append((tuple(x.shape), tuple(w.shape),
                              tuple(args[3]), tuple(args[4])))
            return func(*args, **(kwargs or {}))

    with torch.device("meta"):
        model = build_model(mfu.plain_twin(cfg))
        images = torch.empty(cfg.train.global_batch_size, 32, 32, 3)
    with Record():
        model(images, train=True)
    return calls


def _xla_flops(fn, *args):
    cost = jax.jit(fn).lower(*args).cost_analysis()
    return (cost[0] if isinstance(cost, list) else cost)["flops"]


def test_flop_count_against_the_reference():
    """The smoke preset (ResNet-8, synthetic, unfused) at B=16. XLA's
    count of the reference's step is 1.147e9; ``FlopCounterMode`` with its
    own convolution formula counts 1.211e9 (+5.6%): it counts every tap,
    those over the zero padding too, which XLA's cost analysis leaves out
    (a 3x3 convolution of a 32x32 plane has (94/96)² of its taps on the
    input). The port counts taps as XLA does, and each convolution's
    forward, input gradient and weight gradient then equal XLA's count of
    the same convolution lowered alone, exactly, as the dense layer's
    products do. What the reference's total has beyond the port's is what
    XLA counts and the counter does not: the elementwise work (batch norm,
    ReLU, the loss, the L2 term, the update), 2.1% of the step here; the
    test allows it 0 to 3%."""
    cfg = load_config("smoke", "", ["train.global_batch_size=16"])
    ref_cfg = ref_load_config("smoke", "", ["train.global_batch_size=16"])
    want = _reference_flops(ref_cfg)
    assert want["flops_source"] == "xla_cost_analysis"
    got = mfu.count_train_flops(cfg)
    every_tap = mfu.count_train_flops(cfg, taps="all")
    assert every_tap["total"] > want["flops_per_step"] > got["total"]

    xla_conv = 0.0
    calls = _conv_calls(cfg)
    assert len(calls) == 10     # the stem, three blocks of two and a projection
    for i, (xs, ws, stride, pad) in enumerate(calls):
        x = jnp.zeros((xs[0], xs[2], xs[3], xs[1]))     # NCHW -> NHWC
        w = jnp.zeros((ws[2], ws[3], ws[1], ws[0]))     # OIHW -> HWIO

        def conv(x, w, stride=stride, pad=pad):
            return lax.conv_general_dilated(
                x, w, stride, [(p, p) for p in pad],
                dimension_numbers=("NHWC", "HWIO", "NHWC"))

        y = jax.eval_shape(conv, x, w)
        g = jnp.zeros(y.shape)
        fwd = _xla_flops(conv, x, w)
        dx = _xla_flops(lambda x, w, g: jax.vjp(conv, x, w)[1](g)[0],
                        x, w, g)
        dw = _xla_flops(lambda x, w, g: jax.vjp(conv, x, w)[1](g)[1],
                        x, w, g)
        # The images take no gradient: the stem's input gradient is not
        # computed, by either.
        xla_conv += fwd + (dx if i else 0) + dw
    by_op = got["by_op"]
    port_conv = by_op["aten.convolution"] + by_op["aten.convolution_backward"]
    assert port_conv == xla_conv
    dense = 2 * 16 * 64 * 10
    assert by_op["aten.addmm"] == dense and by_op["aten.mm"] == 2 * dense
    assert got["total"] == port_conv + 3 * dense
    gap = (want["flops_per_step"] - got["total"]) / want["flops_per_step"]
    assert 0 < gap < 0.03


def test_fused_configs_record_their_plain_twins_count(tmp_path):
    for preset, extra in (("imagenet", ["model.resnet_size=50"]),
                          ("cifar10", ["model.resnet_size=14"])):
        plain = load_config(preset, "", [*extra,
                                          "train.global_batch_size=2"])
        fused = load_config(preset, "", [
            *extra, "train.global_batch_size=2", "model.fused_blocks=true",
            "model.fused_epilogue=on", "optim.use_pallas_xent=on"])
        got = mfu.account_train_step(fused, "cpu", train_dir=str(tmp_path))
        want = mfu.account_train_step(plain, "cpu")
        assert got["flops_per_step"] == want["flops_per_step"] > 0
        key = mfu.train_program_key(fused)
        assert "_fused_ep|" in key
        assert mfu.FlopsRegistry.load(str(tmp_path)).flops(key) == \
            got["flops_per_step"]


def test_peak_table(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("TPU_RESNET_PEAK_FLOPS", raising=False)
    for kind, peak in (("NVIDIA H100 80GB HBM3", 989.4e12),
                       ("NVIDIA H100 SXM5 80GB", 989.4e12),
                       ("NVIDIA H100 NVL", 835e12),
                       ("NVIDIA H100 PCIe", 756e12)):
        assert mfu.peak_flops_per_chip(kind) == peak
        assert mfu.mfu(peak / 4, kind, 1) == 0.25
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB", "TPU v5 lite", ""):
        assert mfu.peak_flops_per_chip(kind) is None
        assert mfu.mfu(1e12, kind, 1) is None
    monkeypatch.setenv("BENCH_PEAK_FLOPS", "5e12")
    assert mfu.peak_flops_per_chip("cpu") == 5e12
    monkeypatch.setenv("TPU_RESNET_PEAK_FLOPS", "junk")
    assert mfu.peak_flops_per_chip("cpu") == 5e12
    assert mfu.analytic_resnet50_flops(128) == \
        ref_mfu.analytic_resnet50_flops(128)


VARIANTS = ([], ["model.fused_blocks=true"], ["model.remat=true"],
            ["model.fused_epilogue=on"], ["model.compute_dtype=float32"],
            ["model.stem_space_to_depth=false"], ["mesh.partition=zero1"],
            ["train.global_batch_size=16"])


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_program_keys_match_the_reference(preset):
    assert sorted(PRESETS) == sorted(REF_PRESETS)
    for extra in VARIANTS:
        got = mfu.train_program_key(load_config(preset, "", extra))
        want = ref_mfu.train_program_key(ref_load_config(preset, "", extra),
                                         {"data": 1, "model": 1})
        assert got == want


def test_breakdown_splits_waits_out_of_dispatch():
    b = obs.StepBreakdown()

    def slow():
        time.sleep(0.05)
        yield 1

    with b.dispatch():
        with b.data_wait():          # nested waits count once
            assert list(b.waited(slow())) == [1]
    got = b.sample_device(lambda: "synced", steps=4)
    assert got == "synced"
    out = b.interval()
    assert out["data_wait_sec"] >= 0.05
    assert out["dispatch_sec"] < out["data_wait_sec"]
    ref = ref_obs.StepBreakdown()
    ref.sample_device(jnp.zeros(()), steps=4)
    assert set(out) == set(ref.interval())
    assert b.first_dispatch_done(lambda: None) >= 0
    assert "compile_seconds" in b.interval()


def test_watchdog_stall_and_recovery_as_the_reference(tmp_path):
    """A 0.3 s deadline: both mark /healthz unhealthy, dump the stacks,
    record the stall and the recovery, and count the stall."""
    outcomes = {}
    for side, cls, reg_cls in (
            ("ref", RefWatchdog, ref_server.TelemetryRegistry),
            ("port", HangWatchdog, server.TelemetryRegistry)):
        d = tmp_path / side
        reg = reg_cls()
        spans = obs.SpanTracer(str(d))
        wd = cls(0.3, str(d), telemetry=reg, spans=spans, poll_sec=0.05)
        wd.start()
        try:
            wd.progress(1)
            deadline = time.monotonic() + 5
            while wd.stalls < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            unhealthy = not reg.health()["ok"]
            wd.progress(2)
            time.sleep(0.2)
            healthy = reg.health()["ok"]
        finally:
            wd.close()
            spans.close()
        outcomes[side] = (wd.stalls, unhealthy, healthy,
                          [s["span"] for s in load_spans(
                              str(d / "events.jsonl"))],
                          os.path.basename(wd.dumps[0]),
                          reg.render().count("fault_watchdog_stalls 1.0"))
    assert outcomes["port"] == outcomes["ref"] == (
        1, True, True, ["watchdog_stall", "watchdog_recovered"],
        "stall_stacks_1.txt", 1)
    assert HangWatchdog.maybe_start(0, str(tmp_path)) is None


def test_memory_gauges_on_the_cpu(tmp_path):
    assert memory.sample_device_memory("cpu") == {}
    assert memory.device_limit_bytes("cpu") is None
    reg = server.TelemetryRegistry()
    got = server.parse_prometheus(reg.render())
    assert all(got[f"tpu_resnet_{k}"] == 0.0 for k in (
        "hbm_bytes_in_use", "hbm_bytes_peak", "hbm_bytes_limit",
        "hbm_utilization", "mfu", "model_flops_per_sec"))


def _obs_threads():
    return sorted(t.name for t in threading.enumerate()
                  if t.name in THREADS)


def test_train_is_scraped_while_it_runs_and_leaves_nothing(tmp_path):
    """``train.telemetry_port=0``: a thread scrapes the running loop
    (through the reference's ``scrape``); the gauges the loop sets are
    there, mfu stays 0 on the CPU (no peak), ``hbm_*`` stay 0. After the
    run the server and the watchdog are gone, and so they are after a
    setup that fails (a corrupt only checkpoint: no restore)."""
    assert _obs_threads() == []
    cfg = load_config("smoke", "", tt._fault_overrides(
        tmp_path, "train.train_steps=16", "train.telemetry_port=0",
        "train.checkpoint_every=100"))
    scrapes, done = [], threading.Event()

    def scraper():
        while not done.is_set():
            port = ref_server.read_telemetry_port(str(tmp_path))
            if port:
                try:
                    scrapes.append(ref_server.scrape(f"127.0.0.1:{port}",
                                                     timeout=2))
                except OSError:
                    pass
            time.sleep(0.05)

    t = threading.Thread(target=scraper)
    t.start()
    try:
        train(cfg, device="cpu")
    finally:
        done.set()
        t.join()
    assert _obs_threads() == []
    assert scrapes, "no scrape reached the running loop"
    last = max(scrapes, key=lambda s: s["metrics"]["tpu_resnet_step"])
    m = last["metrics"]
    assert m["tpu_resnet_step"] >= 2 and m["tpu_resnet_loss"] > 0
    assert last["health_status"] == 200
    assert m["tpu_resnet_mfu"] == 0.0 and m["tpu_resnet_hbm_bytes_peak"] == 0
    if m["tpu_resnet_step"] >= 4:       # a logged rate: FLOP/s and ms
        assert m["tpu_resnet_model_flops_per_sec"] > 0
        assert last["histograms"]["tpu_resnet_train_step_ms"]["count"] > 0
    with open(tmp_path / "metrics.jsonl") as f:
        rec = [json.loads(line) for line in f][-1]
    assert rec["step"] == 16
    assert {"model_flops_per_sec", "data_wait_frac", "dispatch_sec",
            "device_sync_sec", "compile_seconds",
            "train_step_ms_p99"} <= set(rec)
    assert np.isfinite(rec["model_flops_per_sec"])

    assert corrupt_checkpoint(str(tmp_path)) == 16
    for step in range(1, 16):
        assert not (tmp_path / str(step)).exists()
    with pytest.raises(RuntimeError, match="no restorable checkpoint"):
        train(cfg, device="cpu")
    assert _obs_threads() == []


def test_watchdog_ends_a_rank_past_the_collective_timeout(tmp_path,
                                                          monkeypatch):
    """``abort_sec`` (a data-parallel rank's collective timeout): no
    progress for that long dumps the stacks to ``abort_stacks.txt`` and
    ends the process with ``ABORT_EXIT_CODE``, also where stall reports
    are off; progress within it never ends it."""
    from tpu_resnet_torch.resilience import watchdog as wd_mod

    codes = []
    monkeypatch.setattr(wd_mod.os, "_exit", codes.append)
    assert HangWatchdog.maybe_start(0, str(tmp_path / "off")) is None
    wd = HangWatchdog(0, str(tmp_path / "rank1"), poll_sec=0.02,
                      abort_sec=0.3)
    wd.start()
    try:
        for step in range(8):  # progress every 0.05 s: no abort
            wd.progress(step)
            time.sleep(0.05)
        assert codes == []
        deadline = time.monotonic() + 5
        while not codes and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        wd.close()
    assert codes == [wd_mod.ABORT_EXIT_CODE]
    with open(tmp_path / "rank1" / "abort_stacks.txt") as f:
        assert "collectives' timeout 0.3s" in f.read()
    started = HangWatchdog.maybe_start(0, str(tmp_path), abort_sec=60)
    assert started is not None and started.stall_sec == 0
    started.close()
