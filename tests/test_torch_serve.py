"""The port's serve path on the CPU: eval preprocessing against the
reference, the checkpoint format, the HTTP predict server against the
reference's ``make_serve_infer`` on the same converted weights, readiness,
hot-reload, and the CLI's SIGTERM drain."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.data import augment as ref_aug
from tpu_resnet.models import build_model as ref_build_model
from tpu_resnet.serve.infer import make_serve_infer as ref_make_serve_infer
from tpu_resnet.serve.server import parse_predict_body as ref_parse
from tpu_resnet_torch import convert
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.data import augment as aug
from tpu_resnet_torch.models import build_model, init_weights
from tpu_resnet_torch.serve.backend import CheckpointBackend
from tpu_resnet_torch.serve.server import PredictServer, parse_predict_body
from tpu_resnet_torch.train import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = ["model.resnet_size=8", "model.compute_dtype=float32",
             "model.fused_blocks=true", "model.fused_epilogue=on",
             "serve.host=127.0.0.1", "serve.port=0", "serve.max_batch=4",
             "serve.reload_interval_secs=0"]


def _images(n, seed=0, size=32):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(port, body, ctype="application/octet-stream", shape=None):
    headers = {"Content-Type": ctype}
    if shape:
        headers["X-Shape"] = shape
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict?logits=1", data=body,
        headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ------------------------------------------------------------ preprocessing
@pytest.mark.parametrize("dataset", ["cifar10", "imagenet"])
def test_eval_preprocess_matches_reference(dataset):
    images = _images(4, seed=1)
    images[0] = 7   # a constant image: std 0, hits the 1/sqrt(n) floor
    _, ref_pre = ref_aug.get_augment_fns(dataset)
    want = np.asarray(ref_pre(jnp.asarray(images)))
    got = aug.get_eval_preprocess(dataset)(torch.from_numpy(images)).numpy()
    # float32 mean/std reductions in another order.
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ checkpoints
def test_checkpoint_round_trip(tmp_path):
    cfg = load_config("cifar10", "", OVERRIDES)
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    assert ckpt.latest_step_in(str(tmp_path)) is None
    ckpt.save(str(tmp_path), 3, model)
    ckpt.save(str(tmp_path), 10, model)
    os.makedirs(tmp_path / "12")          # no state.pt: not a checkpoint
    assert ckpt.latest_step_in(str(tmp_path)) == 10
    state = ckpt.restore(str(tmp_path), 10)
    assert state["step"] == 10
    assert set(state["params"]) == {n for n, _ in model.named_parameters()}
    assert set(state["batch_stats"]) == {n for n, _ in model.named_buffers()}
    fresh = ckpt.load_state(build_model(cfg), state)
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), n
    assert not [f for f in os.listdir(tmp_path / "10") if "tmp" in f]

    poller = ckpt.CheckpointPoller(str(tmp_path))
    assert poller.poll() == 10
    poller.mark_seen(10)
    assert poller.poll() is None
    ckpt.save(str(tmp_path), 12, model)
    assert poller.poll() == 12


# ------------------------------------------------------------ wire format
@pytest.mark.parametrize("body, ctype, shape", [
    (_images(2).tobytes(), "application/octet-stream", "2,32,32,3"),
    (_images(2).tobytes(), "application/octet-stream", "32,32,3"),
    (_images(1).tobytes(), "application/octet-stream", None),
    (json.dumps({"instances": _images(1)[0].tolist()}).encode(),
     "application/json", None),
    (b"abc", "application/octet-stream", "1,32,32,3"),
    (_images(1).tobytes(), "application/octet-stream", "1,16,16,3"),
    (b"{not json", "application/json", None),
    (json.dumps({"x": 1}).encode(), "application/json", None),
    (b"", "text/plain", None),
])
def test_parse_predict_body_matches_reference(body, ctype, shape):
    try:
        want = ref_parse(body, ctype, shape, (32, 32, 3))
    except ValueError:
        with pytest.raises(ValueError):
            parse_predict_body(body, ctype, shape, (32, 32, 3))
        return
    np.testing.assert_array_equal(
        parse_predict_body(body, ctype, shape, (32, 32, 3)), want)


# ------------------------------------------------------------ the server
@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """rn8 checkpoint from randomized reference variables, and the
    reference's own inference function over the same variables."""
    train_dir = str(tmp_path_factory.mktemp("serve"))
    cfg = load_config("cifar10", "", OVERRIDES +
                      [f"train.train_dir={train_dir}"])
    ref_cfg = ref_load_config("cifar10", "", OVERRIDES +
                              [f"train.train_dir={train_dir}"])
    ref_model = ref_build_model(ref_cfg)
    variables = jax.device_get(ref_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    rng = np.random.default_rng(5)
    variables["params"]["final_dense"]["bias"] = rng.normal(
        0, 1.0, 10).astype(np.float32)
    model = build_model(cfg)
    model.load_state_dict(convert.flax_to_torch(variables))
    ckpt.save(train_dir, 7, model)
    ref_infer = ref_make_serve_infer(ref_cfg)

    def reference(images):
        return np.asarray(ref_infer(variables, jnp.asarray(images)))

    return cfg, reference


def test_server_answers_like_reference(served):
    cfg, reference = served
    srv = PredictServer(cfg, device="cpu")
    try:
        assert srv.health()["ok"] is False
        srv.start()
        assert srv.buckets == (1, 2, 4)
        assert _get(srv.port, "/healthz")[0] == 200

        imgs = _images(3, seed=2)
        code, out = _post(srv.port, imgs.tobytes(), shape="3,32,32,3")
        assert code == 200 and out["count"] == 3 and out["model_step"] == 7
        want = reference(imgs)
        assert out["predictions"] == want.argmax(-1).tolist()
        np.testing.assert_allclose(out["logits"], want, atol=1e-4, rtol=1e-4)

        imgs = _images(2, seed=3)
        code, out = _post(srv.port, json.dumps(
            {"instances": imgs.tolist()}).encode(), ctype="application/json")
        assert code == 200
        want = reference(imgs)
        assert out["predictions"] == want.argmax(-1).tolist()
        np.testing.assert_allclose(out["logits"], want, atol=1e-4, rtol=1e-4)

        imgs = _images(6, seed=4)   # split across batches of at most 4
        code, out = _post(srv.port, imgs.tobytes(), shape="6,32,32,3")
        assert code == 200
        assert out["predictions"] == reference(imgs).argmax(-1).tolist()

        assert _post(srv.port, b"abc", shape="1,32,32,3")[0] == 400
        code, info = _get(srv.port, "/info")
        assert code == 200 and info["buckets"] == [1, 2, 4]
        assert info["device"] == "cpu" and info["model_step"] == 7
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                    timeout=30) as r:
            assert r.status == 200 and b"serve_requests_total" in r.read()

        assert srv.drain(10.0) is True
        code, health = _get(srv.port, "/healthz")
        assert code == 503 and health["reason"] == "draining"
        assert _post(srv.port, _images(1).tobytes(),
                     shape="1,32,32,3")[0] == 503
    finally:
        srv.close()


def test_backend_hot_reload(tmp_path):
    cfg = load_config("cifar10", "", OVERRIDES +
                      [f"train.train_dir={tmp_path}"])
    ckpt.save(str(tmp_path), 1, init_weights(
        build_model(cfg), torch.Generator().manual_seed(0)))
    backend = CheckpointBackend(cfg, torch.device("cpu"))
    imgs = _images(2, seed=6)
    before = backend.infer(imgs)
    assert before.shape == (2, 10) and before.dtype == np.float32
    assert backend.maybe_reload() is False
    ckpt.save(str(tmp_path), 2, init_weights(
        build_model(cfg), torch.Generator().manual_seed(1)))
    assert backend.maybe_reload() is True
    assert backend.model_step == 2 and backend.reloads == 1
    assert not np.allclose(backend.infer(imgs), before)
    backend.close()
    ckpt.save(str(tmp_path), 3, init_weights(
        build_model(cfg), torch.Generator().manual_seed(2)))
    assert backend.maybe_reload() is False and backend.model_step == 2


def test_close_without_start_does_not_hang(served):
    cfg, _ = served
    srv = PredictServer(cfg, backend=_GatedBackend())
    closer = threading.Thread(target=srv.close)
    closer.start()
    closer.join(10)
    assert not closer.is_alive()


def test_backend_needs_a_checkpoint(tmp_path):
    cfg = load_config("cifar10", "", OVERRIDES +
                      [f"train.train_dir={tmp_path}"])
    with pytest.raises(FileNotFoundError):
        CheckpointBackend(cfg, torch.device("cpu"))


class _GatedBackend:
    """Warmup blocks until released: readiness can be probed over HTTP."""

    num_classes, image_size, model_step, reloads = 10, 32, 0, 0

    def __init__(self):
        self.release = threading.Event()

    def constrain_buckets(self, buckets):
        return tuple(buckets)

    def warmup(self, buckets):
        assert self.release.wait(30)

    def infer(self, images):
        return np.zeros((images.shape[0], 10), np.float32)

    def maybe_reload(self):
        return False

    def close(self):
        pass


def test_healthz_503_until_warm(served):
    cfg, _ = served
    backend = _GatedBackend()
    srv = PredictServer(cfg, backend=backend)
    starter = threading.Thread(target=srv.start)
    starter.start()
    try:
        code, health = _get(srv.port, "/healthz")
        assert code == 503 and health["reason"].startswith("loading")
        backend.release.set()
        starter.join(30)
        assert not starter.is_alive()
        assert _get(srv.port, "/healthz")[0] == 200
    finally:
        backend.release.set()
        starter.join(30)
        srv.drain(5.0)
        srv.close()


def test_cli_serves_and_drains_on_sigterm(served, tmp_path):
    cfg, _ = served
    train_dir = cfg.train.train_dir
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_resnet_torch", "serve", "--preset",
         "cifar10", "--device", "cpu", *OVERRIDES,
         f"train.train_dir={train_dir}", "serve.replica_name=cli"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        record = os.path.join(train_dir, "serve-cli.json")
        deadline = time.monotonic() + 90
        while not os.path.exists(record) and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert os.path.exists(record), proc.stdout.read().decode()
        with open(record) as f:
            port = json.load(f)["port"]
        code, out = _post(port, _images(1).tobytes(), shape="1,32,32,3")
        assert code == 200 and out["model_step"] == 7
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        proc.stdout.close()
