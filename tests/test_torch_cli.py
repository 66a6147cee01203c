"""The port's run tools (``python -m tpu_resnet_torch info|inspect|plot|
trace-export``) and ``train.profile_steps`` against the reference's on the
CPU: ``info``'s lines equal the reference's ``print_model_info``'s (the
config, the counts, the per-parameter rows through ``convert.py``'s
names) and its FLOP count lies within a stated band of XLA's estimate;
``inspect`` reads a checkpoint saved from converted reference weights;
``plot --csv`` and ``trace-export`` write the reference's bytes for the
same run dir; a profiled window clips the chunks, changes no loss and
lands its capture inside its ``profiler_trace`` span."""

import contextlib
import functools
import gzip
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.models import build_model as ref_build_model
from tpu_resnet.obs import trace as ref_trace
from tpu_resnet.tools import analysis as ref_analysis
from tpu_resnet.tools import plot_metrics as ref_plot
from tpu_resnet.tools import profiling as ref_profiling
from tpu_resnet_torch import convert
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.data import device_data
from tpu_resnet_torch.evaluation.evaluator import evaluate
from tpu_resnet_torch.main import main as port_main
from tpu_resnet_torch.models import build_model
from tpu_resnet_torch.obs import trace
from tpu_resnet_torch.tools import analysis, inspect_ckpt, plot_metrics
from tpu_resnet_torch.tools.profiling import StepTracer, parse_window
from tpu_resnet_torch.train import checkpoint
from tpu_resnet_torch.train.loop import train


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue().splitlines()


# ------------------------------------------------------------------ info
def _in_order(ordered, shapes):
    """``shapes`` (keys sorted by jax's flatten) in ``ordered``'s key
    order."""
    if not hasattr(ordered, "items"):
        return shapes
    return {k: _in_order(v, shapes[k]) for k, v in ordered.items()}


class _AbstractInit:
    """A flax model whose ``init`` returns shapes only (``jax.eval_shape``)
    in module-definition order (the traced init's own dict order; the
    pytree flatten that ``eval_shape`` ends with sorts the keys): the
    reference's ``print_model_info`` counts and lists shapes, and an
    eager init of CIFAR ResNet-50 takes most of a minute here."""

    def __init__(self, model):
        self._model = model

    def init(self, *args, **kw):
        traced = []

        def init(*a):
            traced.append(self._model.init(*a, **kw))
            return traced[-1]

        shapes = jax.eval_shape(init, *args)
        return _in_order(traced[0], shapes)

    def __getattr__(self, name):
        return getattr(self._model, name)


@pytest.fixture(scope="module")
def ref_info():
    """The reference's ``info --layers`` lines for CIFAR-10 ResNet-50."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_analysis, "build_model",
               lambda cfg: _AbstractInit(ref_build_model(cfg)))
    try:
        yield _lines(ref_analysis.print_model_info,
                     ref_load_config("cifar10"), layers=True)
    finally:
        mp.undo()


def test_info_imagenet_resnet50_count(capsys):
    assert port_main(["info", "--preset", "imagenet"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "trainable params: 25,549,352" in out
    assert "batch-norm moving stats: 45,440" in out
    assert json.loads("\n".join(out[:out.index(
        "model: resnet size=50 width=1 dataset=imagenet")]))["data"][
            "dataset"] == "imagenet"


def _split(lines):
    """(config JSON, the lines after it up to the FLOPs line, FLOPs)."""
    model = next(i for i, ln in enumerate(lines) if ln.startswith("model:"))
    flops = next(ln for ln in lines if ln.startswith("forward FLOPs"))
    return (json.loads("\n".join(lines[:model])),
            lines[model:lines.index(flops)],
            int(flops.rsplit(":", 1)[1].replace(",", "")))


def test_info_lines_match_the_reference(ref_info):
    got = _lines(analysis.print_model_info, load_config("cifar10"))
    got_cfg, got_body, _ = _split(got)
    want_cfg, want_body, _ = _split(ref_info)
    assert got_cfg == want_cfg
    # The model line and the two counts; the reference's rows follow.
    assert got_body == want_body[:3]
    assert got_body[1:] == ["trainable params: 758,618",
                            "batch-norm moving stats: 3,616"]


def test_info_layer_rows_are_the_reference_rows_converted(ref_info):
    """Row for row in the same order, the reference's flax path and shape
    mapped through ``convert.py`` to the port's name and shape."""
    _, want_body, _ = _split(ref_info)
    got = analysis.layer_params(
        build_model(load_config("cifar10")).to("meta"))
    rows = [ln.split() for ln in want_body[3:-1]]
    want = []
    for row in rows:
        path, count = row[0], int(row[-1].replace(",", ""))
        shape = tuple(int(d) for d in re.findall(r"\d+", " ".join(
            row[1:-1])))
        name, arr = convert._map_leaf("params", tuple(path.split("/")),
                                      np.zeros(shape, np.float32))
        want.append((name, arr.shape, count))
    assert got == want
    assert want_body[-1].split()[-1] == "758,618"
    lines = _lines(analysis.print_model_info, load_config("cifar10"),
                   layers=True)
    assert len(_split(lines)[1]) == len(want_body)


def test_info_flops_against_the_xla_estimate(ref_info):
    """The port counts convolutions over the taps that fall on the input,
    and the dense layer (``obs/mfu.py``); XLA's estimate also counts the
    elementwise work (batch norm, ReLU, the residual adds, the pooling),
    which is about 5% of CIFAR ResNet-50's forward. So the port's count
    lies below XLA's, by no more than that elementwise share: within
    0.93-1.00 of it (0.951 at this config)."""
    got = _split(_lines(analysis.print_model_info,
                        load_config("cifar10")))[2]
    want = _split(ref_info)[2]
    assert got == 203_188_864
    assert 0.93 <= got / want <= 1.00, (got, want, got / want)


# --------------------------------------------------------------- inspect
def test_inspect_lists_and_peeks_converted_weights(tmp_path, capsys):
    """A checkpoint saved from the reference's initial ResNet-8 weights,
    converted: its ``params/`` and ``batch_stats/`` rows are the converted
    names and shapes, ``--peek`` gives the source array's mean and std."""
    cfg = ref_load_config("smoke")
    init = functools.partial(ref_build_model(cfg).init, train=False)
    variables = jax.jit(init)(jax.random.PRNGKey(3),
                              jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree.map(np.asarray, variables)
    state = convert.flax_to_torch(variables)
    model = build_model(load_config("smoke"))
    model.load_state_dict(state)
    moms = {n: torch.full_like(p, 0.5) for n, p in model.named_parameters()}
    checkpoint.save(str(tmp_path), 7, model, moms)
    step, rows = inspect_ckpt.list_arrays(str(tmp_path))
    assert step == 7
    buffers = {n for n, _ in model.named_buffers()}
    want = sorted(
        [(f"{'batch_stats' if n in buffers else 'params'}/{n}",
          tuple(t.shape), "float32") for n, t in state.items()]
        + [(f"opt_state/{n}", tuple(t.shape), "float32")
           for n, t in moms.items()] + [("step", (), "int")])
    assert sorted(rows) == want

    src = variables["params"]["initial_conv"]["conv"]["kernel"]
    assert port_main(["inspect", "--dir", str(tmp_path), "--peek",
                      "params/initial_conv.weight"]) == 0
    out = capsys.readouterr().out
    assert "checkpoint step 7" in out and "total elements" in out
    mean, std = (float(v) for v in re.search(
        r"mean=(\S+) std=(\S+)", out).groups())
    assert abs(mean - float(src.mean())) <= 1e-6
    assert abs(std - float(src.std())) <= 1e-6
    with pytest.raises(KeyError, match="initial_conv.weight"):
        inspect_ckpt.main(str(tmp_path), peek="params/initial_conv")
    with pytest.raises(FileNotFoundError):
        inspect_ckpt.list_arrays(str(tmp_path / "none"))


# ------------------------------------------------ a tiny run for plot/trace
def _run_cfg(train_dir, *extra):
    return load_config("smoke", "", [
        "train.train_steps=6", "train.global_batch_size=8",
        "train.log_every=2", "train.checkpoint_every=3",
        "data.synthetic_train_examples=64",
        "data.synthetic_eval_examples=16", "train.eval_batch_size=8",
        f"train.train_dir={train_dir}", *extra])


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tiny CPU train (6 steps) and one eval pass of the port, and
    hand-written serve and route events with traced requests (the port
    writes none yet; the exporter reads them when present)."""
    d = tmp_path_factory.mktemp("run")
    cfg = _run_cfg(d)
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # set up before the autouse fixture runs
    try:
        train(cfg, device="cpu")
        cfg.train.eval_once = True
        evaluate(cfg, device="cpu")
    finally:
        torch.set_num_threads(n)
    t0 = json.loads((d / "events.jsonl").read_text().splitlines()[0])[
        "start"]
    serve = [{"span": "serve_warmup", "start": t0 + 1, "end": t0 + 2,
              "pid": 501, "run_id": "r"},
             {"span": "serve_request", "start": t0 + 2.0, "end": t0 + 2.3,
              "pid": 501, "trace_id": "t1", "duration_sec": 0.3,
              "queue_wait_ms": 50, "infer_ms": 120},
             {"span": "hot_reload", "start": t0 + 3, "end": t0 + 3,
              "pid": 502}]
    route = [{"span": "route_request", "start": t0 + 1.9, "end": t0 + 2.4,
              "pid": 600, "trace_id": "t1", "duration_sec": 0.5},
             {"span": "replica_down", "start": t0 + 4, "end": t0 + 4,
              "pid": 600}]
    for name, recs in (("serve_events.jsonl", serve),
                       ("route_events.jsonl", route)):
        (d / name).write_text("".join(json.dumps(r) + "\n" for r in recs))
    return d


def test_plot_csv_is_the_reference_bytes(run_dir, tmp_path):
    want = tmp_path / "ref.csv"
    ref_plot.write_csv(ref_plot.load_series(str(run_dir / "metrics.jsonl")),
                       ref_plot.load_series(str(run_dir / "eval" /
                                                "metrics.jsonl")),
                       str(want))
    got, png = tmp_path / "port.csv", tmp_path / "curves.png"
    assert port_main(["plot", "--dir", str(run_dir), "--out", str(png),
                      "--csv", str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
    assert b"eval," in got.read_bytes()
    assert png.stat().st_size > 0
    assert plot_metrics.load_series(str(run_dir / "metrics.jsonl")) == \
        ref_plot.load_series(str(run_dir / "metrics.jsonl"))


def test_trace_export_is_the_reference_bytes(run_dir, tmp_path):
    """Both exporters write the same bytes for the same dir (spans,
    metrics counters, eval, serve and router lanes, request lanes); a
    second export is the same bytes; both validators pass."""
    ref_path, ref = ref_trace.export_trace(str(run_dir),
                                           str(tmp_path / "ref.json"))
    port_path = tmp_path / "port.json"
    assert port_main(["trace-export", "--dir", str(run_dir), "--out",
                      str(port_path)]) == 0
    first = port_path.read_bytes()
    assert first == open(ref_path, "rb").read()
    trace.export_trace(str(run_dir), str(port_path))
    assert port_path.read_bytes() == first
    got = json.loads(first)
    assert trace.validate_trace(got) == [] == ref_trace.validate_trace(got)
    names = {e["name"] for e in got["traceEvents"]}
    assert {"run", "compile", "eval_pass", "serve_request",
            "route_request", "queue_wait", "infer"} <= names
    assert got["metadata"]["request_lanes"]["traces"] == 1


# -------------------------------------------------- train.profile_steps
@pytest.mark.parametrize("spec", ["", "2:7", "0:1", "5:6", "3:3", "a:b",
                                  "4", "-1:2", "7:2"])
def test_parse_window_as_the_reference(spec):
    try:
        want = ref_profiling.parse_window(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            parse_window(spec)
        return
    assert parse_window(spec) == want
    assert StepTracer("/nonexistent", spec).boundaries() == (want or ())


def _chunked_run(train_dir, monkeypatch, *extra):
    """A resident CPU train of 12 steps in chunks of <= 4: its chunk
    lengths and (step, loss) stream."""
    chunks = []
    run = device_data.ChunkRunner.run

    def record(self, state, step, k):
        chunks.append(k)
        return run(self, state, step, k)

    monkeypatch.setattr(device_data.ChunkRunner, "run", record)
    try:
        losses = _losses_of(train_dir, *extra)
    finally:
        monkeypatch.setattr(device_data.ChunkRunner, "run", run)
    return chunks, losses


def _losses_of(train_dir, *extra):
    cfg = _run_cfg(train_dir, "train.train_steps=12",
                   "train.steps_per_call=4", "train.log_every=4",
                   "train.checkpoint_every=12", *extra)
    assert device_data.should_use(cfg.data)
    train(cfg, device="cpu")
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)]


def test_profile_window_clips_chunks_and_keeps_losses(tmp_path,
                                                      monkeypatch):
    """A window 2:7 across chunks of 4: the chunks end at 2 and 7 too, the
    losses and the checkpoint are a plain run's, a ``profiler_trace`` span
    is recorded and ``--device-trace`` merges the capture (the CPU's
    operators, the CPU being the device) inside it."""
    plain_chunks, plain = _chunked_run(tmp_path / "plain", monkeypatch)
    chunks, losses = _chunked_run(tmp_path / "prof", monkeypatch,
                                  "train.profile_steps=2:7")
    assert plain_chunks == [4, 4, 4]
    assert chunks == [2, 2, 3, 1, 4]
    assert losses == plain
    a = checkpoint.restore(str(tmp_path / "plain"), 12)
    b = checkpoint.restore(str(tmp_path / "prof"), 12)
    for part in ("params", "batch_stats", "opt_state"):
        for n, t in a[part].items():
            assert torch.equal(t, b[part][n]), n

    spans = [json.loads(ln) for ln in
             (tmp_path / "prof" / "events.jsonl").read_text().splitlines()]
    (span,) = [s for s in spans if s["span"] == "profiler_trace"]
    assert (span["start_step"], span["stop_step"]) == (2, 7)
    assert os.path.isfile(os.path.join(span["dir"], StepTracer.FILE))
    assert port_main(["trace-export", "--dir", str(tmp_path / "prof"),
                      "--device-trace"]) == 0
    got = json.loads((tmp_path / "prof" / "trace.json").read_text())
    meta = got["metadata"]["device_trace"]
    assert meta["anchored_by"] == "profiler_trace_span"
    assert meta["device"] == "cpu" and meta["events"] > 0
    (ev,) = [e for e in got["traceEvents"] if e["name"] == "profiler_trace"]
    dev = [e for e in got["traceEvents"] if e.get("cat") == "device"]
    assert len(dev) == meta["events"]
    assert all(ev["ts"] <= e["ts"] and e["ts"] + e["dur"] <=
               ev["ts"] + ev["dur"] for e in dev)
    assert "aten::convolution" in {e["name"] for e in dev}
    assert trace.validate_trace(got) == []


def test_train_logs_profile_steps_as_honoured(tmp_path, caplog):
    with caplog.at_level("INFO", logger="tpu_resnet_torch"):
        train(_run_cfg(tmp_path, "train.train_steps=2"), device="cpu")
    ignored = next(r.getMessage() for r in caplog.records
                   if "this slice ignores" in r.getMessage())
    assert "train.profile_steps" not in ignored
    assert "train.profiler_port" in ignored


# ----------------------------------------- --device-trace, by hand-written
# torch.profiler exports: a CUDA capture's kernels, copies and memsets on
# two streams, its host events (runtime calls, operators, Python
# functions), flow events and metadata.
def _cuda_capture(session_ts):
    evs = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": "python"}},
           {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
            "pid": "Spans", "tid": "PyTorch Profiler", "ts": session_ts,
            "dur": 5000.0},
           {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 77,
            "tid": 77, "ts": session_ts + 10, "dur": 40},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "pid": 77, "tid": 77, "ts": session_ts + 12, "dur": 3},
           {"ph": "X", "cat": "python_function", "name": "train.py(1): f",
            "pid": 77, "tid": 77, "ts": session_ts + 1, "dur": 90},
           {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 77,
            "tid": 77, "ts": session_ts + 12}]
    for i in range(6):
        evs.append({"ph": "X", "cat": "kernel", "name": "block_fwd_kernel",
                    "pid": 0, "tid": 7 if i % 2 else 13,
                    "ts": session_ts + 100 + 300 * i, "dur": 250,
                    "args": {"stream": 7 if i % 2 else 13}})
    evs.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
                "pid": 0, "tid": 7, "ts": session_ts + 4000, "dur": 20})
    evs.append({"ph": "X", "cat": "gpu_memset", "name": "Memset",
                "pid": 0, "tid": 13, "ts": session_ts + 4100, "dur": 5})
    return {"schemaVersion": 1, "traceEvents": evs,
            "baseTimeNanoseconds": 1790000000000000000}


def _capture_dir(run, name, payload, gz):
    d = run / "profile" / name
    d.mkdir(parents=True)
    path = d / ("trace.json.gz" if gz else "trace.json")
    data = json.dumps(payload).encode()
    path.write_bytes(gzip.compress(data) if gz else data)
    return path


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzipped"])
def test_device_trace_lanes_and_anchor(tmp_path, gz):
    """The newest capture, plain or gzipped: one lane a CUDA stream, the
    device events kept, host and Python events dropped and counted, every
    event re-anchored inside the ``profiler_trace`` span."""
    run = tmp_path / "run"
    run.mkdir()
    t0 = 1_800_000_000.0
    (run / "events.jsonl").write_text(json.dumps(
        {"span": "profiler_trace", "start": t0, "end": t0 + 0.01,
         "pid": 77, "start_step": 2, "stop_step": 4}) + "\n")
    _capture_dir(run, "20260101T000000.000001",
                 {"traceEvents": [{"ph": "X", "cat": "kernel", "name": "old",
                                   "pid": 0, "tid": 1, "ts": 5, "dur": 1}]},
                 False)
    _capture_dir(run, "20260101T000000.000002", _cuda_capture(9e12), gz)
    got = trace.build_trace(str(run), device_trace=True)
    meta = got["metadata"]["device_trace"]
    assert meta["files"] == [os.path.join(
        "profile", "20260101T000000.000002",
        "trace.json.gz" if gz else "trace.json")]
    assert meta["device"] == "cuda" and meta["lanes"] == 2
    assert meta["events"] == 8
    assert meta["python_tracer_events_dropped"] == 1
    assert meta["host_events_dropped"] == 2   # the runtime call, the op
    dev = [e for e in got["traceEvents"] if e.get("cat") == "device"]
    assert {e["name"] for e in dev} == {"block_fwd_kernel", "Memcpy HtoD",
                                        "Memset"}
    assert {e["tid"] for e in dev} == {7, 13}
    assert min(e["ts"] for e in dev) == 100.0   # session start = span start
    assert all(e["ts"] + e["dur"] <= 10_000 for e in dev)
    lanes = {e["args"]["name"] for e in got["traceEvents"]
             if e["ph"] == "M" and e["pid"] >= 9_000_000}
    assert lanes == {"device-trace: cuda:0", "stream 7", "stream 13"}
    assert trace.validate_trace(got) == []


def test_device_trace_without_span_and_cap(tmp_path, monkeypatch):
    """No ``profiler_trace`` span: the file's mtime end-anchors the
    capture; over the cap, the earliest events stay and the drop is
    counted; no capture at all raises."""
    run = tmp_path / "run"
    run.mkdir()
    (run / "metrics.jsonl").write_text(json.dumps(
        {"step": 1, "wall": 1_800_000_000.0, "loss": 1.0}) + "\n")
    with pytest.raises(FileNotFoundError, match="no profiler capture"):
        trace.build_trace(str(run), device_trace=True)
    path = _capture_dir(run, "a", _cuda_capture(50.0), False)
    os.utime(path, (1_800_000_010.0, 1_800_000_010.0))
    monkeypatch.setattr(trace, "_DEVICE_TRACE_EVENT_CAP", 3)
    got = trace.build_trace(str(run), device_trace=True)
    meta = got["metadata"]["device_trace"]
    assert meta["anchored_by"] == "file_mtime" and meta["events"] == 3
    dev = sorted(e["ts"] for e in got["traceEvents"]
                 if e.get("cat") == "device")
    # The session's last event (the memset) ends 4105 us after its start,
    # which lands 10 s after the metrics' wall.
    assert dev[0] == pytest.approx(10e6 - 4105 + 100, abs=0.2)
    assert meta["events_dropped"] >= 5
