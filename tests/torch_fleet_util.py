"""Helpers of the port's fleet tests (``test_torch_router.py``,
``test_torch_fleet.py``): stub-backed port replicas, a port router on a
discovery directory, and HTTP calls."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.serve.router import Router
from tpu_resnet_torch.serve.server import PredictServer, write_discovery

SHAPE = (8, 8, 3)


def img(px, n=1):
    imgs = np.zeros((n,) + SHAPE, np.uint8)
    imgs[:, 0, 0, 0] = px
    return imgs


class FakeBackend:
    """A stub backend: logits one-hot at the first pixel's value."""

    def __init__(self, delay=0.0):
        self.image_size, self.num_classes = 8, 7
        self.model_step, self.reloads = 7, 0
        self.delay = delay
        self.batches = 0

    def constrain_buckets(self, buckets):
        return tuple(buckets)

    def warmup(self, buckets):
        pass

    def infer(self, images):
        self.batches += 1
        if self.delay:
            time.sleep(self.delay)
        n = images.shape[0]
        logits = np.zeros((n, self.num_classes), np.float32)
        logits[np.arange(n), images[:, 0, 0, 0] % self.num_classes] = 1.0
        return logits

    def maybe_reload(self):
        return False

    def close(self):
        pass


def mk_replica(train_dir, name, delay=0.0, backend=None):
    cfg = load_config("", "", [
        "serve.port=0", "serve.host=127.0.0.1", "serve.max_batch=8",
        "serve.max_wait_ms=5", "serve.reload_interval_secs=0",
        f"serve.replica_name={name}", f"train.train_dir={train_dir}"])
    srv = PredictServer(cfg, backend=backend or FakeBackend(delay)).start()
    write_discovery(train_dir, srv.port, name=name)
    return srv


def stop_all(*servers, hung=False, router=None):
    """Close the servers (and ``router``) together: each HTTP server's
    shutdown waits out its poll interval."""
    def one(srv):
        if hung:
            srv.batcher._stop.set()
        else:
            srv.batcher.drain(2.0)
        srv.close()

    threads = [threading.Thread(target=one, args=(s,)) for s in servers]
    if router is not None:
        threads.append(threading.Thread(target=router.close))
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def mk_router(train_dir, **route_overrides):
    cfg = load_config("", "", [
        "route.host=127.0.0.1", f"route.discover_dir={train_dir}",
        "route.probe_interval_secs=0.15", "route.probe_timeout_secs=2",
        "route.fail_threshold=1", "route.open_secs=0.5"])
    for k, v in route_overrides.items():
        setattr(cfg.route, k, v)
    return Router(cfg)


def http_post(port, body, shape="1,8,8,3", headers=None, query=""):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict{query}", data=body,
        headers={"Content-Type": "application/octet-stream",
                 "X-Shape": shape, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=15) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def http_get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def wait_for(cond, seconds=5.0):
    deadline = time.monotonic() + seconds
    while not cond():
        assert time.monotonic() < deadline, "condition not met in time"
        time.sleep(0.05)
