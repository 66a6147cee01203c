"""Environment triage for the port: ``python -m tpu_resnet_torch doctor``
(port of ``tpu_resnet/tools/doctor.py``'s checks that need no scenario
conductor).

One line a check, ``[doctor] <name> ok|FAIL {detail}``, then one
``DOCTOR_JSON:`` line with the summary; the command exits 0 when every
check passed, else 1. Nothing falls back to the CPU: a machine without a
CUDA card fails ``backend`` and ``kernels``.

Checks:
  versions    python, torch and its CUDA, numpy, matplotlib; a torch or
              numpy import that fails fails the check (matplotlib, which
              only ``plot`` needs, is reported)
  backend     ``torch.cuda`` probed in a subprocess under
              ``--probe-timeout`` (a driver that hangs costs seconds, not
              a hung doctor): the device's name, count and compute
              capability, and its power limit where ``nvidia-smi``
              answers. No CUDA device fails it.
  kernels     in place of the reference's ``native`` and ``cpu_mesh``:
              ``nvcc --version``, every kernel library built
              (``ops/_build.py`` ``build_all``), one empty ``tr_noop``
              launch synchronized on the card. Each step that could not
              run says why.
  dataset     with ``--data-dir``: the layout the loaders need
              (``tools/datasets.py`` ``validate_layout``)
  telemetry   with ``--train-dir``: the run's telemetry server
              (``obs/server.py``, port from ``<train_dir>/telemetry.json``):
              ``/metrics`` parses with the ``tpu_resnet_step`` gauge and
              ``/healthz`` reports a fresh heartbeat
  data_bench  with ``--data-bench``: the ImageNet decode engine's
              images/s at 1 and N worker threads on synthetic JPEGs,
              about 4 s each, and the train steps/s that could feed at
              batch 128 (``data/engine.py`` ``decode_scaling_probe``)
  fault_drill with ``--fault-drill``: the SIGTERM-and-resume drill on a
              small CIFAR ResNet (ResNet-8 on synthetic data, 40 steps) in
              two subprocesses on the card: the first is stopped at step
              20 and must exit with ``resilience.preempt_exit_code`` and a
              checkpoint at step 20; the second must resume there and
              finish, the run spans reading (0, 20), (20, 40)

The reference's probes that run on its scenario conductor (serve, cold
start, fleet, fleetmon, autoscale, trace, perfwatch, sweep, memory,
partition and reshape drills, ``--check``, ``--list-probes``) are not
ported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

# The backend probe: one line, ``PROBE available | count | name |
# capability``.
_PROBE = ("import torch\n"
          "n = torch.cuda.device_count() if torch.cuda.is_available() "
          "else 0\n"
          "name = torch.cuda.get_device_name(0) if n else ''\n"
          "cap = '.'.join(map(str, torch.cuda.get_device_capability(0))) "
          "if n else ''\n"
          "print('PROBE', n > 0, '|', n, '|', name, '|', cap, flush=True)\n")

# The repository root: subprocesses import the package from there.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _check_versions() -> dict:
    """The core imports (torch, numpy; one that fails fails the check) and
    matplotlib, which only ``plot`` needs: reported, never failing."""
    import importlib

    out = {"python": sys.version.split()[0], "ok": True}
    for mod in ("torch", "numpy", "matplotlib"):
        try:
            m = importlib.import_module(mod)
            out[mod] = getattr(m, "__version__", "?")
            if mod == "torch":
                out["torch_cuda"] = m.version.cuda
        except Exception as e:  # pragma: no cover - env-specific
            out[mod] = f"import failed: {type(e).__name__}"
            if mod != "matplotlib":
                out["ok"] = False  # a broken core dependency fails it
    return out


def _power_limit(timeout: float = 30.0):
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    None where it does not answer."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=timeout)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = proc.stdout.strip().splitlines()
    return lines[0] if proc.returncode == 0 and lines else None


def _check_backend(timeout: int) -> dict:
    """Probe ``torch.cuda`` in a subprocess, so that a driver that hangs
    is reported as a timeout instead of hanging the doctor."""
    try:
        proc = subprocess.run([sys.executable, "-c", _PROBE],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"ok": False,
                "error": f"CUDA probe hung for {timeout}s: the driver or "
                         f"the device is wedged"}
    for line in reversed(proc.stdout.strip().splitlines()):
        if line.startswith("PROBE "):
            avail, n, name, cap = (
                p.strip() for p in line[len("PROBE "):].split("|"))
            if avail != "True":
                return {"ok": False, "devices": 0,
                        "error": "torch.cuda.is_available() is false: no "
                                 "CUDA device"}
            return {"ok": True, "platform": "gpu", "device_kind": name,
                    "devices": int(n), "capability": cap,
                    "nvidia_smi": _power_limit()}
    return {"ok": False, "rc": proc.returncode,
            "tail": proc.stdout.strip().splitlines()[-3:]}


def _check_kernels() -> dict:
    """nvcc, every kernel library built, one empty launch on the card."""
    from tpu_resnet_torch.ops import _build

    try:
        nvcc = _build._nvcc()
    except RuntimeError as e:
        return {"ok": False, "nvcc": None, "error": str(e),
                "built": "not attempted: no nvcc",
                "noop": "not attempted: no kernels"}
    out = {"nvcc": nvcc}
    try:
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60)
        out["nvcc_version"] = (ver.stdout.strip().splitlines() or ["?"])[-1]
        t0 = time.monotonic()
        out["built"] = sorted(_build.build_all())
        out["build_seconds"] = round(time.monotonic() - t0, 1)
    except Exception as e:  # noqa: BLE001 - reported, never raised
        return {**out, "ok": False, "error": f"{type(e).__name__}: {e}"[:2000],
                "noop": "not attempted: the build failed"}
    import torch

    if not torch.cuda.is_available():
        return {**out, "ok": False, "noop": "not attempted: no CUDA device"}
    try:
        lib = _build.library("epilogue")
        _build.check(lib.tr_noop(torch.cuda.current_device(),
                                 torch.cuda.current_stream().cuda_stream),
                     "tr_noop")
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001
        return {**out, "ok": False, "noop": f"{type(e).__name__}: {e}"}
    return {**out, "ok": True, "noop": "launched"}


def _check_dataset(dataset: str, data_dir: str) -> dict:
    from tpu_resnet_torch.tools.datasets import validate_layout

    try:
        validate_layout(dataset, data_dir)
        return {"ok": True, "dataset": dataset, "data_dir": data_dir}
    except Exception as e:  # noqa: BLE001
        return {"ok": False, "dataset": dataset,
                "error": f"{type(e).__name__}: {e}"}


def _check_telemetry(train_dir: str, timeout: float = 5.0) -> dict:
    """Scrape the run's telemetry server: ``telemetry.json`` names a port,
    ``/metrics`` parses with the ``tpu_resnet_step`` gauge and ``/healthz``
    reports a fresh heartbeat."""
    from tpu_resnet_torch.obs.server import read_telemetry_port, scrape

    port = read_telemetry_port(train_dir)
    if port is None:
        return {"ok": False,
                "error": f"no telemetry.json under {train_dir}: is the "
                         "trainer running with train.telemetry_port >= 0?"}
    try:
        report = scrape(f"http://127.0.0.1:{port}", timeout=timeout)
    except (OSError, ValueError) as e:
        return {"ok": False, "port": port,
                "error": f"{type(e).__name__}: {e}"}
    health, metrics = report["health"], report["metrics"]
    return {"ok": bool(health.get("ok")) and "tpu_resnet_step" in metrics,
            "port": port, "step": health.get("step"),
            "heartbeat_age_sec": health.get("heartbeat_age_sec"),
            "series": len(metrics)}


def _check_data_bench(seconds: float = 4.0, device=None, **probe) -> dict:
    """The decode engine's rate by worker count; healthy when every count
    moved images. ``device``: the card unless the caller names another."""
    from tpu_resnet_torch.data.engine import decode_scaling_probe

    try:
        out = decode_scaling_probe(worker_counts=(1, 0), seconds=seconds,
                                   device=device or "cuda", **probe)
    except Exception as e:  # noqa: BLE001
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}
    rates = out.get("engine_images_per_sec_by_procs", {})
    return {"ok": bool(rates) and all(v > 0 for v in rates.values()),
            **out}


def _run_spans(train_dir: str) -> list:
    from tpu_resnet_torch.obs.spans import load_spans

    return [(s.get("start_step"), s.get("stop_step"))
            for s in load_spans(os.path.join(train_dir, "events.jsonl"))
            if s.get("span") == "run"]


def _check_fault_drill(timeout: int = 240, device=None) -> dict:
    """SIGTERM at step 20 and a resume to 40, each a ``train`` subprocess
    (``device``: the card unless the caller names another)."""
    from tpu_resnet_torch.config import load_config

    preempt_rc = load_config("smoke").resilience.preempt_exit_code
    with tempfile.TemporaryDirectory(prefix="tpures_drill_") as d:
        train_dir = os.path.join(d, "train")
        cmd = [sys.executable, "-m", "tpu_resnet_torch", "train",
               "--preset", "smoke", *(["--device", device] if device else
                                      []),
               f"train.train_dir={train_dir}", "train.train_steps=40",
               "train.checkpoint_every=10", "train.log_every=10",
               "train.steps_per_call=5", "model.resnet_size=8",
               "data.synthetic_train_examples=1024",
               "train.mfu_accounting=false", "train.memory_ledger=false",
               "data.device_resident=off", "data.transfer_stage=1"]
        rcs = {}
        for label, extra, want in (
                ("preempt", ["resilience.inject_sigterm_at_step=20"],
                 preempt_rc),
                ("resume", [], 0)):
            try:
                proc = subprocess.run(
                    cmd + extra, cwd=_ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True, timeout=timeout)
            except subprocess.TimeoutExpired:
                return {"ok": False, "phase": label,
                        "error": f"{label} run hung for {timeout}s"}
            rcs[label] = proc.returncode
            if proc.returncode != want:
                return {"ok": False, "phase": label, "rc": proc.returncode,
                        "want_rc": want,
                        "tail": proc.stdout.strip().splitlines()[-5:]}
            if label == "preempt" and not os.path.isfile(
                    os.path.join(train_dir, "20", "state.pt")):
                return {"ok": False, "phase": "preempt",
                        "error": "no checkpoint at the stop step 20"}
        spans = _run_spans(train_dir)
        if spans != [(0, 20), (20, 40)]:
            return {"ok": False, "phase": "resume", "run_spans": spans,
                    "error": "the run spans are not (0, 20), (20, 40)"}
    return {"ok": True, "preempt_rc": rcs["preempt"], "ckpt_at_stop": 20,
            "run_spans": spans}


def run_doctor(dataset: str = "", data_dir: str = "", train_dir: str = "",
               probe_timeout: int = 60, fault_drill: bool = False,
               data_bench: bool = False, data_bench_secs: float = 4.0,
               stream=None) -> dict:
    """Run the checks; print one line each to ``stream`` (default stdout)
    and the summary as the last, ``DOCTOR_JSON: {...}``; return it."""
    stream = stream or sys.stdout

    def emit(name, result):
        status = "ok" if result.get("ok", True) else "FAIL"
        detail = {k: v for k, v in result.items() if k != "ok"}
        print(f"[doctor] {name:10s} {status}  {detail}", file=stream,
              flush=True)

    summary = {"versions": _check_versions()}
    emit("versions", summary["versions"])
    summary["backend"] = _check_backend(probe_timeout)
    emit("backend", summary["backend"])
    summary["kernels"] = _check_kernels()
    emit("kernels", summary["kernels"])
    if data_dir:
        summary["dataset"] = _check_dataset(dataset or "cifar10", data_dir)
        emit("dataset", summary["dataset"])
    if train_dir:
        summary["telemetry"] = _check_telemetry(train_dir)
        emit("telemetry", summary["telemetry"])
    if data_bench:
        summary["data_bench"] = _check_data_bench(seconds=data_bench_secs)
        emit("data_bench", summary["data_bench"])
    if fault_drill:
        summary["fault_drill"] = _check_fault_drill()
        emit("fault_drill", summary["fault_drill"])
    summary["ok"] = all(v.get("ok", True) for v in summary.values()
                        if isinstance(v, dict))
    print("DOCTOR_JSON: " + json.dumps(summary), file=stream, flush=True)
    return summary
