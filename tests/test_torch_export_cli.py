"""The ``export`` → ``serve serve.backend=export`` → ``predict`` CLI on the
CPU, each a process of its own with ``--device cpu``: the served logits are
the live model's, the predictions and the PNG grid are written."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.models import build_model, init_weights
from tpu_resnet_torch.serve.infer import make_serve_infer
from tpu_resnet_torch.train import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = ["model.compute_dtype=float32"]
FUSED = ["model.fused_blocks=true", "model.fused_epilogue=on"]


def _images(n, size=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


def _live(cfg, model, images):
    return make_serve_infer(cfg, torch.device("cpu"))(model.eval(),
                                                      images).numpy()


def _cli(*args):
    return [sys.executable, "-m", "tpu_resnet_torch", *args]


def test_cli_export_serve_predict(tmp_path):
    """``export`` → ``serve serve.backend=export`` → ``predict``, each a
    CLI process with ``--device cpu``."""
    run = str(tmp_path / "run")
    out = str(tmp_path / "export")
    overrides = F32 + FUSED + ["model.resnet_size=14", "data.dataset="
                               "synthetic", "serve.host=127.0.0.1",
                               "serve.port=0", "serve.max_batch=4",
                               f"train.train_dir={run}"]
    cfg = load_config("cifar10", "", overrides)
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    ckpt.save(run, 6, model)
    subprocess.run(_cli("export", "--device", "cpu", "--preset", "cifar10",
                        *overrides, "--out", out), cwd=REPO, check=True,
                   timeout=240, capture_output=True)
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f)["step"] == 6

    proc = subprocess.Popen(
        _cli("serve", "--device", "cpu", "--preset", "cifar10", *overrides,
             "serve.backend=export", f"serve.export_dir={out}"),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        record = os.path.join(run, "serve.json")
        deadline = time.monotonic() + 120
        while not os.path.exists(record) and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert os.path.exists(record), proc.stdout.read().decode()
        with open(record) as f:
            port = json.load(f)["port"]
        images = _images(3, seed=5)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict?logits=1",
            data=images.tobytes(),
            headers={"Content-Type": "application/octet-stream",
                     "X-Shape": "3,32,32,3"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert body["count"] == 3 and body["model_step"] == 6
        want = _live(cfg, model, images)
        np.testing.assert_allclose(body["logits"], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/info",
                                    timeout=30) as r:
            info = json.loads(r.read())
        assert info["backend"] == "ExportBackend" and info["device"] == "cpu"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        proc.stdout.close()

    pred = str(tmp_path / "predict")
    subprocess.run(_cli("predict", "--device", "cpu", "--preset", "cifar10",
                        *overrides, "--export-dir", out, "--out", pred,
                        "--num-examples", "24"), cwd=REPO, check=True,
                   timeout=240, capture_output=True)
    with open(os.path.join(pred, "predictions.json")) as f:
        results = json.load(f)
    assert results["num_examples"] == 24
    assert 0.0 <= results["precision"] <= 1.0
    with open(os.path.join(pred, "mispredictions.png"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
