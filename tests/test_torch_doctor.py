"""The port's ``doctor`` on the CPU (``tpu_resnet_torch/tools/doctor.py``):
on a machine without a card ``backend`` and ``kernels`` fail with their
reasons and the command exits 1 (nothing falls back to the CPU); a probe
that hangs is a timeout within its limit; the dataset layout check is the
reference's; the telemetry check passes against the port's own server;
the flags of the reference's conductor-backed probes are refused; the
data bench and the fault drill, asked for the CPU, pass here; and the
synthetic JPEGs the data bench decodes are JPEGs PIL reads, the port's
plain decoder giving PIL's pixels."""

import io
import json
import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

from tpu_resnet.data import engine as ref_engine
from tpu_resnet.tools.datasets import validate_layout as ref_validate
from tpu_resnet_torch import obs
from tpu_resnet_torch.data import jpeg, jpeg_encode
from tpu_resnet_torch.main import main as port_main
from tpu_resnet_torch.tools import doctor
from tpu_resnet_torch.tools.datasets import validate_layout

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "imagenet")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _doctor(capsys, *args):
    rc = port_main(["doctor", *args])
    out = capsys.readouterr().out.splitlines()
    summary = json.loads(out[-1][len("DOCTOR_JSON: "):])
    assert out[-1].startswith("DOCTOR_JSON: ")
    return rc, out, summary


def test_doctor_fails_without_a_card(capsys):
    """No CUDA here: ``backend`` and ``kernels`` FAIL with their reasons,
    each line in the reference's format, and the exit code is 1."""
    rc, out, summary = _doctor(capsys, "--probe-timeout", "120")
    assert rc == 1 and summary["ok"] is False
    assert summary["versions"]["ok"] is True
    assert summary["versions"]["torch"] == torch.__version__
    assert summary["backend"] == {
        "ok": False, "devices": 0,
        "error": "torch.cuda.is_available() is false: no CUDA device"}
    kernels = summary["kernels"]
    assert kernels["ok"] is False and kernels["nvcc"] is None
    assert "nvcc not found" in kernels["error"]
    assert kernels["built"].startswith("not attempted")
    assert kernels["noop"].startswith("not attempted")
    assert [ln.split()[1:3] for ln in out[:-1]] == [
        ["versions", "ok"], ["backend", "FAIL"], ["kernels", "FAIL"]]


def test_hung_probe_is_a_timeout(monkeypatch):
    monkeypatch.setattr(doctor, "_PROBE", "import time; time.sleep(60)")
    t0 = time.monotonic()
    out = doctor._check_backend(2)
    assert time.monotonic() - t0 < 10
    assert out["ok"] is False and "hung for 2s" in out["error"]


def test_probe_without_its_line_is_reported(monkeypatch):
    monkeypatch.setattr(doctor, "_PROBE", "raise SystemExit('no driver')")
    out = doctor._check_backend(60)
    assert out["ok"] is False and out["rc"] == 1
    assert out["tail"] == ["no driver"]


@pytest.mark.parametrize("dataset,where", [
    ("imagenet", FIXTURES), ("imagenet", "empty"), ("cifar10", "empty"),
    ("cifar10", "cifar"), ("cifar100", "cifar")])
def test_dataset_layout_as_the_reference(dataset, where, tmp_path):
    """The layout check passes and fails where the reference's does."""
    if where == "cifar":
        d = tmp_path / "cifar-10-batches-bin"
        d.mkdir()
        for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
                "test_batch.bin"]:
            (d / name).write_bytes(b"")
    data_dir = str(tmp_path) if where in ("empty", "cifar") else where
    try:
        ref_validate(dataset, data_dir)
        want = None
    except (FileNotFoundError, ValueError) as e:
        want = type(e)
    if want is None:
        validate_layout(dataset, data_dir)
    else:
        with pytest.raises(want):
            validate_layout(dataset, data_dir)
    got = doctor._check_dataset(dataset, data_dir)
    assert got["ok"] is (want is None)


def test_dataset_check_in_the_summary(capsys):
    rc, out, summary = _doctor(capsys, "--dataset", "imagenet",
                               "--data-dir", FIXTURES)
    assert summary["dataset"] == {"ok": True, "dataset": "imagenet",
                                  "data_dir": FIXTURES}
    assert rc == 1  # backend and kernels still fail here
    with pytest.raises(SystemExit):
        port_main(["doctor", "--dataset", "imagenet"])


def test_telemetry_check_against_the_port_server(tmp_path):
    assert doctor._check_telemetry(str(tmp_path))["ok"] is False
    reg = obs.TelemetryRegistry(stale_after_sec=60)
    reg.heartbeat(7)
    server = obs.TelemetryServer.maybe_start(0, reg, train_dir=str(tmp_path))
    try:
        got = doctor._check_telemetry(str(tmp_path))
    finally:
        server.close()
    assert got["ok"] is True and got["step"] == 7
    assert got["port"] == obs.read_telemetry_port(str(tmp_path))
    assert got["series"] > 10
    stale = doctor._check_telemetry(str(tmp_path), timeout=1.0)
    assert stale["ok"] is False and "error" in stale


# The reference's doctor flags whose probes run on its scenario conductor
# (not ported): argparse refuses each.
UNPORTED = ("--list-probes", "--check", "--serve-probe", "--coldstart-probe",
            "--autoscale-probe", "--trace-probe", "--perfwatch",
            "--sweep-probe", "--mem-probe", "--partition-probe",
            "--reshape-drill", "--mesh-devices=8")


@pytest.mark.parametrize("flag, name", [("--fleet-probe", "fleet_probe"),
                                        ("--fleetmon-probe",
                                         "fleetmon_probe")])
def test_fleet_drills_join_the_summary(flag, name, monkeypatch, capsys):
    """The two serving-fleet drills run on the card (their children are
    the card's); here each flag is shown to run its drill and put its
    result, under the reference's key, in the summary and its line."""
    ran = []
    for drill in ("_check_fleet_probe", "_check_fleetmon_probe"):
        monkeypatch.setattr(doctor, drill, lambda drill=drill: ran.append(
            drill) or {"ok": False, "phase": "readiness"})
    rc, out, summary = _doctor(capsys, flag)
    assert ran == [f"_check_{name}"]
    assert summary[name] == {"ok": False, "phase": "readiness"}
    assert rc == 1 and summary["ok"] is False
    assert out[-2].split()[1:3] == [name, "FAIL"]


@pytest.mark.parametrize("flag", UNPORTED)
def test_unported_doctor_flags_are_refused(flag, capsys):
    with pytest.raises(SystemExit) as e:
        port_main(["doctor", flag])
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_data_bench_on_the_cpu_has_the_reference_keys():
    """Asked for the CPU, the bench runs the engine's plain decode path;
    its keys are the reference's probe's (``mode`` and ``device`` added),
    every worker count moved images."""
    got = doctor._check_data_bench(seconds=0.3, device="cpu", local_batch=2,
                                   n_records=4, warmup_batches=1,
                                   photo_size=(96, 64))
    assert got["ok"] is True, got
    assert got["mode"] == "thread" and got["device"] == "cpu"
    assert got["jpeg_kind"] == "synthetic_photo_96x64"
    assert set(got["engine_images_per_sec_by_procs"]) == {
        "1", str(min(8, os.cpu_count() or 1))}
    keys = {"cpu_count", "local_batch", "jpeg_kind",
            "single_process_images_per_sec",
            "engine_images_per_sec_by_procs", "best_images_per_sec",
            "scaling_vs_single_process", "implied_max_steps_per_sec_b128"}
    assert keys <= set(got)
    assert got["implied_max_steps_per_sec_b128"] == round(
        got["best_images_per_sec"] / 128, 2)


def test_data_bench_on_a_missing_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = doctor._check_data_bench(seconds=0.1)
    assert got["ok"] is False and "CUDA is not available" in got["error"]


def test_fault_drill_on_the_cpu(monkeypatch):
    """The drill's two subprocesses on the CPU: exit 42 with a checkpoint
    at step 20, then a resume to 40 whose run spans read (0, 20),
    (20, 40). One intra-op thread each: the suite's workers share the
    host's cores, and spinning OpenMP threads over them stall."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    got = doctor._check_fault_drill(device="cpu")
    assert got == {"ok": True, "preempt_rc": 42, "ckpt_at_stop": 20,
                   "run_spans": [(0, 20), (20, 40)]}, got


@pytest.mark.parametrize("size,quality", [((640, 480), 90), ((53, 37), 75),
                                          ((16, 16), 100), ((33, 8), 10)])
def test_synthetic_jpeg_decodes_as_pil_encodes(size, quality):
    """The encoder's JPEG: PIL reads it as 4:2:0 at its size, the port's
    plain decoder gives PIL's pixels bit for bit, and it is about as close
    to the image, and as large, as PIL's own encoding at that quality."""
    rng = np.random.default_rng(1)
    img = jpeg_encode.synthetic_photo(size, rng=rng)
    data = jpeg_encode.encode(img, quality)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert pil.shape == (size[1], size[0], 3)
    assert jpeg.sampling(data) == "4:2:0"
    assert np.array_equal(jpeg.decode(data), pil)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    ref = np.asarray(Image.open(buf).convert("RGB"))
    err = np.abs(pil.astype(int) - img).mean()
    ref_err = np.abs(ref.astype(int) - img).mean()
    assert err <= 1.05 * ref_err + 0.5, (err, ref_err)
    assert 0.8 <= len(data) / len(buf.getvalue()) <= 1.25


def test_synthetic_photo_is_the_reference_image(monkeypatch):
    """The same seeded pixels the reference's ``synthetic_photo_jpeg``
    hands PIL's encoder."""
    handed = []
    fromarray = Image.fromarray
    monkeypatch.setattr(Image, "fromarray",
                        lambda arr: handed.append(arr) or fromarray(arr))
    ref_engine.synthetic_photo_jpeg(rng=np.random.default_rng(0))
    got = jpeg_encode.synthetic_photo(rng=np.random.default_rng(0))
    assert got.shape == (480, 640, 3)
    assert np.array_equal(got, handed[0])
