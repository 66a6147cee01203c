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
  fleet_probe with ``--fleet-probe``: the serving-fleet drill — two
              replicas of the smoke ResNet-8 served through the fused
              block and epilogue kernels behind ``route``, one SIGKILLed
              under the port's loadgen (every request 200, the circuit
              opens), a hot-reload on the survivor, a rolling drain
              through the router (exit 0), the router's exit 0, and the
              merged trace's router and replica lanes under one run id
  fleetmon_probe with ``--fleetmon-probe``: the fleet-observability drill
              — r0 slowed by an injected 150 ms a batch, r1 clean,
              ``route`` and ``fleetmon`` (SLO 50 ms): every request 200,
              the merged fleet p99 above r1's own, the burn alert fired,
              the slowest routed requests attributed to r0

The drills' children (``hostenv.py``) run on the card; the reference's
perfwatch ingest of their results is not ported. The reference's probes
that run on its scenario conductor (serve, cold start, autoscale, trace,
perfwatch, sweep, memory, partition and reshape drills, ``--check``,
``--list-probes``) are not ported.
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


class _Children:
    """The drills' child processes, each started from the repository root
    under ``hostenv.child_env`` with its output in
    ``<dir>/<name>_child.log``; :meth:`close` kills and reaps every one
    still running (a SIGKILLed replica's zombie included)."""

    def __init__(self, directory: str):
        self.directory = directory
        self.procs, self.logs = {}, {}

    def spawn(self, name: str, cmd, extra_env=None):
        from tpu_resnet_torch.hostenv import REPO_ROOT, child_env

        path = os.path.join(self.directory, f"{name}_child.log")
        fh = open(path, "w")
        self.logs[name] = (path, fh)
        self.procs[name] = subprocess.Popen(
            cmd, env=child_env(extra_env), cwd=REPO_ROOT, stdout=fh,
            stderr=subprocess.STDOUT, text=True)
        return self.procs[name]

    def tail(self, name: str) -> list:
        path, fh = self.logs[name]
        fh.flush()
        try:
            with open(path) as f:
                return f.read().strip().splitlines()[-5:]
        except OSError:
            return []

    def fail(self, phase: str, **extra) -> dict:
        extra.setdefault("tails", {n: self.tail(n) for n in self.procs})
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        return {"ok": False, "phase": phase, **extra}

    def dead(self):
        """{name: exit code} of the children that have exited."""
        return {n: p.poll() for n, p in self.procs.items()
                if p.poll() is not None}

    def close(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        for _, fh in self.logs.values():
            fh.close()


def _get_json(url: str, timeout: float = 2.0) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _fleet_commands(d: str, device=None) -> dict:
    """The drills' commands: ``train(steps)`` the smoke ResNet-8 into
    ``d`` (plain ops, checkpoints every 3 steps), ``serve(name)`` a
    replica of it through the fused block and epilogue kernels, the
    router and fleetmon on ``d``. ``device`` (``--device``) goes to the
    train and serve children only: the router and fleetmon touch no
    device."""
    py = [sys.executable, "-m", "tpu_resnet_torch"]
    dev = ["--device", device] if device else []

    def train(steps: int) -> list:
        return py + ["train", "--preset", "smoke", *dev,
                     f"train.train_dir={d}", f"train.train_steps={steps}",
                     "train.checkpoint_every=3", "train.log_every=3",
                     f"train.summary_every={steps}",
                     "train.image_summary_every=0", "train.steps_per_call=3",
                     "data.device_resident=off", "data.transfer_stage=1",
                     "optim.use_pallas_xent=off",
                     "train.mfu_accounting=false",
                     "train.memory_ledger=false"]

    def serve(name: str) -> list:
        return py + ["serve", "--preset", "smoke", *dev,
                     f"train.train_dir={d}", f"serve.replica_name={name}",
                     "serve.host=127.0.0.1", "serve.port=0",
                     "serve.max_batch=4", "serve.max_wait_ms=5",
                     "serve.reload_interval_secs=0.5",
                     "model.fused_blocks=true", "model.fused_epilogue=on"]

    def route(*extra) -> list:
        return py + ["route", "--preset", "smoke", f"train.train_dir={d}",
                     f"route.discover_dir={d}", "route.host=127.0.0.1",
                     "route.port=0", "route.probe_interval_secs=0.3",
                     "route.probe_timeout_secs=2", "route.open_secs=2",
                     *extra]

    def fleetmon(*extra) -> list:
        return py + ["fleetmon", "--preset", "smoke", f"train.train_dir={d}",
                     f"fleet.discover_dir={d}", "fleet.host=127.0.0.1",
                     "fleet.port=0", *extra]

    return {"train": train, "serve": serve, "route": route,
            "fleetmon": fleetmon}


def _start_replicas(kids: "_Children", cmds: dict, d: str, timeout: float,
                    envs: dict):
    """Start r0, wait until it is ready (its ``serve-r0.json`` is written
    after every bucket ran), then r1 the same way: two replicas that start
    together would both read the card's free memory before either
    allocates. Returns None, or the failure result."""
    from tpu_resnet_torch.serve.discovery import read_port

    for name in ("r0", "r1"):
        kids.spawn(name, cmds["serve"](name), extra_env=envs.get(name))
        deadline = time.time() + timeout
        while time.time() < deadline:
            if kids.dead():
                return kids.fail("startup", rcs=kids.dead())
            port = read_port(d, f"serve-{name}.json")
            if port is not None:
                try:
                    if _get_json(f"http://127.0.0.1:{port}/healthz")["ok"]:
                        break
                except (OSError, ValueError, KeyError):
                    pass
            time.sleep(0.3)
        else:
            return kids.fail("readiness", replica=name,
                             error=f"{name} not ready in {timeout}s")
    return None


def _loadgen(base: str, d: str, out_json: str, timeout: float,
             *extra) -> tuple:
    """The port's load generator through ``base``; returns (rc, output,
    result dict or None)."""
    from tpu_resnet_torch.hostenv import run_subprocess

    rc, out = run_subprocess(
        [sys.executable, "-m", "tpu_resnet_torch.tools.loadgen",
         "--url", base, "--deadline-ms", "30000", "--out", out_json,
         *extra], timeout=timeout)
    try:
        with open(out_json) as f:
            return rc, out, json.load(f)
    except (OSError, ValueError):
        return rc, out, None


def _check_fleet_probe(timeout: int = 420, device=None) -> dict:
    """Serving-fleet resilience drill (``serve/router.py``), the
    reference's phases and pass conditions with the port's children on
    the card (``device``: the card unless the caller names another):

    1. train the smoke ResNet-8 (plain ops, 6 steps), start TWO serve
       replicas of it through the fused block and epilogue kernels
       (``serve.replica_name=r0``/``r1``, ephemeral ports, one train
       dir; r1 after r0 is ready) and the router (``route.discover_dir``)
       — wait until the router reports both healthy;
    2. run 8 closed-loop clients of the port's loadgen against the
       ROUTER (``--scenario replica_kill``: r0 SIGKILLed at half time):
       every request must answer 200, and the router must exclude r0
       (``route_replicas_healthy`` drops to 1);
    3. train on to step 12 so the survivor hot-reloads, then drain r1
       through the router's admin endpoint — the replica must exit 0;
    4. SIGTERM the router (exit 0), then ``trace-export`` the train dir:
       ``route_drain``, ``serve_reload``, ``serve_drain`` and
       ``replica_down`` on router and replica lanes under one run id.

    The reference's perfwatch ingest of the loadgen result is not
    ported (``perfwatch_ingested: "not ported"``)."""
    import signal
    import threading
    import urllib.error
    import urllib.request

    from tpu_resnet_torch.hostenv import run_subprocess
    from tpu_resnet_torch.obs.server import parse_prometheus
    from tpu_resnet_torch.obs.trace import export_trace
    from tpu_resnet_torch.serve.router import (discover_replicas,
                                               read_route_port)

    ns = "tpu_resnet_"
    if device in (None, "cuda"):
        from tpu_resnet_torch.ops import _build
        _build.build_all()  # once, before any replica starts
    with tempfile.TemporaryDirectory(prefix="tpures_fleet_") as d:
        cmds = _fleet_commands(d, device)
        rc, out = run_subprocess(cmds["train"](6), timeout)
        if rc != 0:
            return {"ok": False, "phase": "train", "rc": rc,
                    "tail": out.strip().splitlines()[-5:]}
        kids = _Children(d)
        try:
            failed = _start_replicas(kids, cmds, d, timeout / 2, {})
            if failed:
                return failed
            kids.spawn("router", cmds["route"]("route.fail_threshold=1"))
            base, healthy = None, 0
            deadline = time.time() + timeout / 2
            while time.time() < deadline:
                if kids.dead():
                    return kids.fail("startup", rcs=kids.dead())
                port = read_route_port(d)
                if port is not None:
                    base = f"http://127.0.0.1:{port}"
                    try:
                        h = _get_json(base + "/healthz")
                        healthy = int(h.get("replicas_healthy", 0))
                        if h.get("ok") and healthy >= 2:
                            break
                    except (OSError, ValueError):
                        pass
                time.sleep(0.3)
            if healthy < 2:
                return kids.fail("readiness", replicas_healthy=healthy)

            # The headline drill: r0's own /healthz going
            # connection-refused marks its death, the router's
            # route_replicas_healthy dropping to 1 its exclusion.
            r0_url = next(r["url"] for r in discover_replicas(d)
                          if r["name"] == "r0")
            watch = {"dead_at": None, "excluded_at": None}

            def watcher():
                stop_at = time.monotonic() + 60
                while time.monotonic() < stop_at:
                    if watch["dead_at"] is None:
                        try:
                            with urllib.request.urlopen(
                                    r0_url + "/healthz", timeout=1) as r:
                                r.read()
                        except urllib.error.HTTPError as e:
                            e.read()
                        except OSError:
                            watch["dead_at"] = time.monotonic()
                    else:
                        try:
                            with urllib.request.urlopen(
                                    base + "/metrics", timeout=2) as r:
                                m = parse_prometheus(r.read().decode())
                            if m.get(ns + "route_replicas_healthy") == 1.0:
                                watch["excluded_at"] = time.monotonic()
                                return
                        except (OSError, ValueError):
                            pass
                    time.sleep(0.1)

            w = threading.Thread(target=watcher, daemon=True)
            w.start()
            lg_rc, lg_out, lg_result = _loadgen(
                base, d, os.path.join(d, "loadgen_replica_kill.json"),
                timeout, "--clients", "8", "--duration", "8",
                "--scenario", "replica_kill", "--fleet-dir", d)
            w.join(timeout=70)
            if lg_result is None:
                return kids.fail("chaos_traffic", rc=lg_rc,
                                 lg_tail=lg_out.strip().splitlines()[-5:])
            hard = (lg_result["failed"] + lg_result["timeouts"]
                    + lg_result["connect_failures"])
            if lg_rc != 0 or hard or not lg_result["requests_ok"]:
                return kids.fail("chaos_traffic", rc=lg_rc, result={
                    k: lg_result.get(k) for k in
                    ("requests_ok", "failed", "timeouts",
                     "connect_failures", "chaos")})
            if not (lg_result.get("chaos") or {}).get("killed"):
                return kids.fail("chaos_traffic",
                                 error="loadgen never delivered the SIGKILL",
                                 chaos=lg_result.get("chaos"))
            if watch["excluded_at"] is None:
                return kids.fail("circuit", error="router never excluded "
                                 "the killed replica", watch=watch)
            excluded_in = round(watch["excluded_at"] - watch["dead_at"], 2)
            metrics = {}
            try:
                with urllib.request.urlopen(base + "/metrics",
                                            timeout=5) as r:
                    metrics = parse_prometheus(r.read().decode())
            except (OSError, ValueError):
                pass

            # Hot-reload on the survivor, then the rolling drain.
            rc, out = run_subprocess(cmds["train"](12), timeout)
            if rc != 0:
                return kids.fail("reload_train", rc=rc,
                                 tail_train=out.strip().splitlines()[-5:])
            reload_deadline = time.time() + 30
            reloaded = False
            while time.time() < reload_deadline:
                try:
                    if _get_json(base + "/info").get("model_step") == 12:
                        reloaded = True
                        break
                except (OSError, ValueError):
                    pass
                time.sleep(0.5)
            if not reloaded:
                return kids.fail("hot_reload",
                                 error="survivor never served step 12")
            req = urllib.request.Request(
                base + "/admin/drain?replica=r1", data=b"{}",
                method="POST")
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    drain = json.loads(r.read())
            except urllib.error.HTTPError as e:
                drain = json.loads(e.read())  # 409: the drain's report
            try:
                r1_rc = kids.procs["r1"].wait(timeout=60)
            except subprocess.TimeoutExpired:
                return kids.fail("drain", error="r1 still running after "
                                 "the router drain", drain=drain)
            if not drain.get("ok") or r1_rc != 0:
                return kids.fail("drain", drain=drain, r1_rc=r1_rc)

            # The router's exit code, then the merged timeline.
            kids.procs["router"].send_signal(signal.SIGTERM)
            try:
                router_rc = kids.procs["router"].wait(timeout=30)
            except subprocess.TimeoutExpired:
                return kids.fail("router_exit",
                                 error="router ignored SIGTERM for 30s")
            if router_rc != 0:
                return kids.fail("router_exit", rc=router_rc)
            try:
                _, trace = export_trace(d)
            except (OSError, ValueError) as e:
                return kids.fail("trace", error=f"{type(e).__name__}: {e}")
            names = {e["name"] for e in trace["traceEvents"]}
            need = {"route_drain", "serve_reload", "serve_drain",
                    "replica_down"}
            if not need <= names:
                return kids.fail("trace", missing=sorted(need - names))
            run_ids = trace["metadata"]["source_run_ids"]
            correlated = (len(run_ids.get("serve", [])) == 1
                          and run_ids.get("route") == run_ids["serve"])
            result = {"ok": bool(correlated),
                      "requests_ok": lg_result["requests_ok"],
                      "client_failures": 0,
                      "killed": lg_result["chaos"]["killed"],
                      "excluded_in_sec": excluded_in,
                      "p50_ms": lg_result["latency_ms"]["p50"],
                      "p99_ms": lg_result["latency_ms"]["p99"],
                      "throughput_rps": lg_result["throughput_rps"],
                      "retries": int(metrics.get(
                          ns + "route_retries_total", 0)),
                      "perfwatch_ingested": "not ported",
                      "survivor_model_step": 12,
                      "drain": {k: drain.get(k) for k in
                                ("ok", "replica", "replica_gone")},
                      "r1_rc": r1_rc, "router_rc": router_rc,
                      "trace_run_ids": run_ids}
            if not correlated:
                result["phase"] = "trace_run_ids"
            return result
        finally:
            kids.close()


def _check_fleetmon_probe(timeout: int = 420, device=None) -> dict:
    """Fleet-observability drill (``obs/fleet.py``), the reference's
    phases and pass conditions with the port's children on the card
    (``device``: the card unless the caller names another):

    1. train the smoke ResNet-8, start replica r0 with an injected 150 ms
       inference fault (``TPU_RESNET_FAULT_SERVE_SLOW_MS``), a clean r1,
       the router, and ``fleetmon`` with a 50 ms SLO — wait for the
       router's readiness and fleetmon's first scrape round;
    2. drive traced traffic of the port's loadgen through the router:
       every request must answer 200, and ``RESULT_JSON`` must name the
       slowest client-minted trace ids;
    3. the fleet-merged p99 must exceed the healthy replica's own p99,
       and the burn-rate alert must fire (``fleet_alerts_total`` >= 1, a
       ``fleet_burn_alert`` event);
    4. fleetmon and the router exit 0 on SIGTERM; ``trace-export``:
       request lanes rendered, the slowest routed requests attribute to
       r0, a slow ``serve_request``'s inference segment dominates it.

    The reference's perfwatch step is not ported
    (``perfwatch_ingested: "not ported"``)."""
    import signal
    import urllib.request

    from tpu_resnet_torch.hostenv import run_subprocess
    from tpu_resnet_torch.obs.fleet import read_fleet_port
    from tpu_resnet_torch.obs.server import (histogram_quantile,
                                             parse_histograms,
                                             parse_prometheus)
    from tpu_resnet_torch.obs.trace import export_trace
    from tpu_resnet_torch.serve.router import (discover_replicas,
                                               read_route_port)

    ns = "tpu_resnet_"
    if device in (None, "cuda"):
        from tpu_resnet_torch.ops import _build
        _build.build_all()  # once, before any replica starts

    def get_metrics(url, t=5):
        with urllib.request.urlopen(url + "/metrics", timeout=t) as r:
            text = r.read().decode()
        return parse_prometheus(text), parse_histograms(text)

    with tempfile.TemporaryDirectory(prefix="tpures_fleetmon_") as d:
        cmds = _fleet_commands(d, device)
        rc, out = run_subprocess(cmds["train"](6), timeout)
        if rc != 0:
            return {"ok": False, "phase": "train", "rc": rc,
                    "tail": out.strip().splitlines()[-5:]}
        kids = _Children(d)
        try:
            # r0 carries the injected 150 ms-a-batch inference fault: the
            # one bad machine the plane must attribute.
            failed = _start_replicas(
                kids, cmds, d, timeout / 2,
                {"r0": {"TPU_RESNET_FAULT_SERVE_SLOW_MS": "150"}})
            if failed:
                return failed
            kids.spawn("router", cmds["route"]("route.fail_threshold=2"))
            kids.spawn("fleetmon", cmds["fleetmon"](
                "fleet.scrape_interval_secs=0.5", "fleet.slo_ms=50"))
            base = fm_base = None
            healthy, fm_ok = 0, False
            deadline = time.time() + timeout / 2
            while time.time() < deadline:
                if kids.dead():
                    return kids.fail("startup", rcs=kids.dead())
                if base is None and read_route_port(d) is not None:
                    base = f"http://127.0.0.1:{read_route_port(d)}"
                if fm_base is None and read_fleet_port(d) is not None:
                    fm_base = f"http://127.0.0.1:{read_fleet_port(d)}"
                try:
                    if base is not None and healthy < 2:
                        h = _get_json(base + "/healthz")
                        healthy = int(h.get("replicas_healthy", 0))
                    if fm_base is not None and not fm_ok:
                        fm_ok = bool(_get_json(fm_base
                                               + "/healthz").get("ok"))
                except (OSError, ValueError):
                    pass
                if healthy >= 2 and fm_ok:
                    break
                time.sleep(0.3)
            if healthy < 2 or not fm_ok:
                return kids.fail("readiness", replicas_healthy=healthy,
                                 fleetmon_ok=fm_ok)

            # Traced traffic through the router: the slow replica makes
            # the fleet SLOW, never broken.
            lg_rc, lg_out, lg_result = _loadgen(
                base, d, os.path.join(d, "loadgen_fleetmon.json"), timeout,
                "--clients", "6", "--duration", "10")
            if lg_result is None:
                return kids.fail("traffic", rc=lg_rc,
                                 lg_tail=lg_out.strip().splitlines()[-5:])
            hard = (lg_result["failed"] + lg_result["timeouts"]
                    + lg_result["connect_failures"])
            if lg_rc != 0 or hard or not lg_result["requests_ok"]:
                return kids.fail("traffic", rc=lg_rc, result={
                    k: lg_result.get(k) for k in
                    ("requests_ok", "failed", "timeouts",
                     "connect_failures")})
            slowest = lg_result.get("slowest_traces") or []
            if not slowest or not all(
                    s.get("trace_id", "").startswith("lg") for s in slowest):
                return kids.fail("traffic", error="RESULT_JSON carries no "
                                 "client-minted slowest trace ids",
                                 slowest=slowest)

            # Fleet percentiles and the burn alert, over a few rounds.
            fm = {}
            alert_deadline = time.time() + 30
            while time.time() < alert_deadline:
                try:
                    fm, _ = get_metrics(fm_base)
                except (OSError, ValueError):
                    fm = {}
                if fm.get(ns + "fleet_alerts_total", 0) >= 1 and \
                        fm.get(ns + "fleet_requests_total", 0) > 0:
                    break
                time.sleep(0.5)
            r1_url = next(r["url"] for r in discover_replicas(d)
                          if r["name"] == "r1")
            r0_url = next(r["url"] for r in discover_replicas(d)
                          if r["name"] == "r0")
            _, r1_hists = get_metrics(r1_url)
            _, r0_hists = get_metrics(r0_url)
            r1_p99 = histogram_quantile(
                r1_hists.get(ns + "serve_latency_ms", {}), 0.99)
            r0_p99 = histogram_quantile(
                r0_hists.get(ns + "serve_latency_ms", {}), 0.99)
            fleet_p99 = fm.get(ns + "fleet_serve_p99_ms", 0.0)
            burn_fast = fm.get(ns + "fleet_burn_rate_fast", 0.0)
            if fm.get(ns + "fleet_alerts_total", 0) < 1:
                return kids.fail("burn_alert", metrics={
                    k: v for k, v in sorted(fm.items())
                    if k.startswith(ns + "fleet_")})
            if not fleet_p99 > r1_p99 > 0:
                return kids.fail("fleet_percentiles", fleet_p99_ms=fleet_p99,
                                 r1_p99_ms=r1_p99)

            # Exit codes before the timeline, so every writer has closed.
            for name in ("fleetmon", "router"):
                kids.procs[name].send_signal(signal.SIGTERM)
            rcs = {}
            for name in ("fleetmon", "router"):
                try:
                    rcs[name] = kids.procs[name].wait(timeout=30)
                except subprocess.TimeoutExpired:
                    return kids.fail("exit", error=f"{name} ignored SIGTERM")
            if any(rcs.values()):
                return kids.fail("exit", rcs=rcs)

            # Attribution on the merged timeline.
            try:
                _, trace = export_trace(d)
            except (OSError, ValueError) as e:
                return kids.fail("trace", error=f"{type(e).__name__}: {e}")
            events = trace["traceEvents"]
            names = {e["name"] for e in events}
            need = {"route_request", "serve_request", "fleet_start",
                    "fleet_burn_alert"}
            if not need <= names:
                return kids.fail("trace", missing=sorted(need - names))
            lanes = trace["metadata"].get("request_lanes") or {}
            if not lanes.get("rendered"):
                return kids.fail("trace", error="no request lanes rendered",
                                 request_lanes=lanes)
            routed = [e["args"] for e in events
                      if e["name"] == "route_request"
                      and e.get("args", {}).get("replica")]
            served = [e["args"] for e in events
                      if e["name"] == "serve_request"
                      and e.get("args", {}).get("replica")]
            if not routed:
                return kids.fail("attribution",
                                 error="no replica-attributed route spans")
            tail_spans = sorted(routed, key=lambda a:
                                a.get("latency_ms", 0.0))[-5:]
            slow_share = sum(1 for a in tail_spans
                             if a["replica"] == "r0") / len(tail_spans)
            if slow_share < 0.6:
                return kids.fail("attribution", error="tail traces do not "
                                 "attribute to the slowed replica",
                                 tail=tail_spans)
            r0_served = [a for a in served if a["replica"] == "r0"
                         and a.get("infer_ms") and a.get("latency_ms")]
            infer_dominates = bool(r0_served) and max(
                a["infer_ms"] / a["latency_ms"] for a in r0_served) > 0.5
            if r0_served and not infer_dominates:
                return kids.fail("attribution", error="r0 inference segment "
                                 "does not dominate its request time",
                                 r0_served=r0_served[:5])
            return {"ok": True,
                    "requests_ok": lg_result["requests_ok"],
                    "client_failures": 0,
                    "slowest_traces": slowest,
                    "client_p50_ms": lg_result["latency_ms"]["p50"],
                    "client_p99_ms": lg_result["latency_ms"]["p99"],
                    "fleet_p99_ms": fleet_p99,
                    "r0_p99_ms": round(r0_p99, 2),
                    "r1_p99_ms": round(r1_p99, 2),
                    "burn_rate_fast": burn_fast,
                    "alerts_total": int(
                        fm.get(ns + "fleet_alerts_total", 0)),
                    "tail_slow_replica_share": slow_share,
                    "infer_segment_dominates": infer_dominates,
                    "request_lanes": lanes,
                    "perfwatch_ingested": "not ported",
                    "rcs": rcs}
        finally:
            kids.close()


def run_doctor(dataset: str = "", data_dir: str = "", train_dir: str = "",
               probe_timeout: int = 60, fault_drill: bool = False,
               data_bench: bool = False, data_bench_secs: float = 4.0,
               fleet_probe: bool = False, fleetmon_probe: bool = False,
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
    if fleet_probe:
        summary["fleet_probe"] = _check_fleet_probe()
        emit("fleet_probe", summary["fleet_probe"])
    if fleetmon_probe:
        summary["fleetmon_probe"] = _check_fleetmon_probe()
        emit("fleetmon_probe", summary["fleetmon_probe"])
    summary["ok"] = all(v.get("ok", True) for v in summary.values()
                        if isinstance(v, dict))
    print("DOCTOR_JSON: " + json.dumps(summary), file=stream, flush=True)
    return summary
