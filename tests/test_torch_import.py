"""The port stands alone: importing it loads no JAX stack and no PIL, no
file of it imports the reference package (nor, in the package, PIL: the
card has none), its config copy means what the reference's means, its
entry points refuse to run on a machine without CUDA unless asked for the
CPU, and its kernel build links each library with its own flags."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from tpu_resnet import config as ref_config
from tpu_resnet_torch import config as port_config
from tpu_resnet_torch.device import resolve_device
from tpu_resnet_torch.main import main as port_main
from tpu_resnet_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, files in os.walk(os.path.join(REPO, "tpu_resnet_torch"))
    for f in files if f.endswith(".py")) + [
        "chip_smoke.py", *(os.path.join("tools", f"{name}.py") for name in (
            "profile_torch_forward", "profile_torch_grad",
            "profile_torch_train", "time_torch_block",
            "time_torch_bottleneck", "time_torch_epilogue",
            "time_torch_folded_bwd", "time_torch_imagenet_input",
            "make_torch_imagenet_fixtures"))]
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax", "tpu_resnet")
# The package also imports no PIL (the tests and the fixture tool may).
PACKAGE_FORBIDDEN = FORBIDDEN_ROOTS + ("PIL",)


def test_import_loads_no_jax_stack():
    """The package, the serve surface (export, int8 arm, predict) and the
    serving fleet's modules among it, loads no JAX stack and no PIL."""
    code = ("import sys, tpu_resnet_torch, tpu_resnet_torch.main, "
            "tpu_resnet_torch.serve.server, tpu_resnet_torch.convert, "
            "tpu_resnet_torch.ops.fused_bottleneck, "
            "tpu_resnet_torch.train.loop, "
            "tpu_resnet_torch.evaluation.evaluator, "
            "tpu_resnet_torch.data.imagenet, tpu_resnet_torch.data.engine, "
            "tpu_resnet_torch.data.jpeg, tpu_resnet_torch.ops.jpeg_decode, "
            "tpu_resnet_torch.export, tpu_resnet_torch.ops.quant, "
            "tpu_resnet_torch.serve.calibrate, tpu_resnet_torch.tools.predict, "
            "tpu_resnet_torch.models.mlp, "
            "tpu_resnet_torch.resilience.exitcodes, "
            "tpu_resnet_torch.serve.router, tpu_resnet_torch.obs.fleet, "
            "tpu_resnet_torch.tools.obs_scrape, "
            "tpu_resnet_torch.tools.loadgen, tpu_resnet_torch.hostenv; "
            "print(sorted(m for m in sys.modules "
            f"if m.split('.')[0] in {PACKAGE_FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]", out


def test_run_tools_load_no_jax_stack():
    """The run tools (``info``, ``inspect``, ``plot``, ``trace-export``,
    ``doctor``) and the profiler window load no JAX stack and no PIL; the
    file-only tools load no matplotlib until they draw."""
    code = ("import sys, tpu_resnet_torch.obs.trace, "
            "tpu_resnet_torch.tools.analysis, "
            "tpu_resnet_torch.tools.inspect_ckpt, "
            "tpu_resnet_torch.tools.plot_metrics, "
            "tpu_resnet_torch.tools.doctor, "
            "tpu_resnet_torch.tools.datasets, "
            "tpu_resnet_torch.tools.profiling, "
            "tpu_resnet_torch.data.jpeg_encode; "
            "print(sorted(m for m in sys.modules "
            f"if m.split('.')[0] in {PACKAGE_FORBIDDEN + ('matplotlib',)!r}"
            "))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]", out


def test_fleet_host_modules_load_no_torch():
    """The router, fleetmon, the scraper, the load generator, the autopilot
    and the supervisor are host code in front of the replicas: importing
    them loads no torch (a router holding a CUDA context would take card
    memory from the replicas), nothing of JAX and nothing of the
    reference."""
    code = ("import sys, tpu_resnet_torch.serve.router, "
            "tpu_resnet_torch.obs.fleet, tpu_resnet_torch.tools.obs_scrape, "
            "tpu_resnet_torch.tools.loadgen, tpu_resnet_torch.hostenv, "
            "tpu_resnet_torch.autopilot, tpu_resnet_torch.autopilot.signals, "
            "tpu_resnet_torch.autopilot.policy, "
            "tpu_resnet_torch.autopilot.actuator, "
            "tpu_resnet_torch.autopilot.controller, "
            "tpu_resnet_torch.autopilot.cli, "
            "tpu_resnet_torch.tools.supervise; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{('torch',) + FORBIDDEN_ROOTS!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]", out


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_no_reference(rel):
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read(), filename=rel)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    forbidden = (PACKAGE_FORBIDDEN if rel.startswith("tpu_resnet_torch")
                 else FORBIDDEN_ROOTS)
    assert not roots & set(forbidden), (rel, roots)


@pytest.mark.parametrize("preset", sorted(ref_config.PRESETS))
def test_config_copy_matches_reference(preset):
    assert port_config.load_config(preset).to_dict() == \
        ref_config.load_config(preset).to_dict()


def test_config_overrides_match_reference():
    overrides = ["model.fused_blocks=true", "model.fused_epilogue=on",
                 "serve.max_batch=8", "train.train_dir=/tmp/x"]
    assert port_config.load_config("cifar10", "", overrides).to_dict() == \
        ref_config.load_config("cifar10", "", overrides).to_dict()


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["serve", "--preset", "cifar10",
                   f"train.train_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["export", "--preset", "cifar10",
                   f"train.train_dir={tmp_path}", "--out",
                   str(tmp_path / "export")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["predict", "--preset", "cifar10", "--export-dir",
                   str(tmp_path / "export"), "--out", str(tmp_path / "p")])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_build_links_each_library_with_its_own_flags(tmp_path):
    """nvJPEG's shim links libnvjpeg from the toolkit beside nvcc, with
    that directory as its run path; every other library links nothing
    more; a library's file name (the hash of what it is built from)
    changes with its link flags."""
    home = tmp_path / "cuda"
    (home / "lib64").mkdir(parents=True)
    flags = _build.link_flags("jpeg_decode", str(home))
    lib = str(home / "lib64")
    assert flags == [f"-L{lib}", "-Xlinker", f"-rpath={lib}", "-lnvjpeg"]
    assert set(_build.LINKED_LIBS) <= set(_build.SIGNATURES)
    for name in _build.SIGNATURES:
        if name != "jpeg_decode":
            assert _build.link_flags(name, str(home)) == []
    plain = _build._target("epilogue", [])
    assert plain[1] != _build._target("epilogue", flags)[1]
    assert os.path.basename(plain[0]) == "epilogue.cu"
    assert set(_build.SIGNATURES["jpeg_decode"]) == {
        "tr_jpeg_create", "tr_jpeg_destroy", "tr_jpeg_info_batch",
        "tr_jpeg_decode_batch", "tr_resize_crop"}
