"""The serving fleet as a whole on the CPU: weights made by the JAX
reference's model and converted (``tpu_resnet_torch/convert.py``), two
port replicas serving them (CIFAR ResNet-8, 32², float32, fused blocks:
the plain versions run here) behind the port's router with ``fleetmon``'s
aggregator beside. Answers through the router are held against the
reference's ``make_serve_infer`` on the same weights; the reference's and
the port's aggregators scrape the same live replicas once the traffic has
stopped; the port's loadgen drives the fleet; ``trace-export`` lays the
router and replica lanes under one run id."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.models import build_model as ref_build_model
from tpu_resnet.obs import fleet as ref_fleet
from tpu_resnet.serve.infer import make_serve_infer as ref_make_serve_infer
from tpu_resnet_torch import convert
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.models import build_model
from tpu_resnet_torch.obs import fleet
from tpu_resnet_torch.obs.manifest import ensure_run_id
from tpu_resnet_torch.obs.spans import SpanTracer
from tpu_resnet_torch.obs.trace import SERVE_EVENTS_FILE, export_trace
from tpu_resnet_torch.serve.router import Router, write_route_discovery
from tpu_resnet_torch.serve.server import PredictServer, write_discovery
from tpu_resnet_torch.tools import loadgen
from tpu_resnet_torch.train import checkpoint as ckpt
from torch_fleet_util import http_post, stop_all, wait_for

OVERRIDES = ["model.resnet_size=8", "model.compute_dtype=float32",
             "model.fused_blocks=true", "model.fused_epilogue=on",
             "serve.host=127.0.0.1", "serve.port=0", "serve.max_batch=4",
             "serve.reload_interval_secs=0"]
ROUTE = ["route.host=127.0.0.1", "route.probe_interval_secs=0.15",
         "route.fail_threshold=1", "route.open_secs=0.5"]


def _images(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 32, 32, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def served_fleet(tmp_path_factory):
    """A checkpoint of randomized reference variables; the reference's
    inference over them; two port replicas of it behind a port router."""
    d = str(tmp_path_factory.mktemp("fleet"))
    run_id = ensure_run_id(d)
    # The reference's unfused model: the same variables as its fused one,
    # and XLA's convolutions in place of the kernels' interpret mode.
    ref_cfg = ref_load_config("cifar10", "", OVERRIDES[:2])
    ref_model = ref_build_model(ref_cfg)
    variables = jax.device_get(jax.jit(lambda key: ref_model.init(
        key, jnp.zeros((1, 32, 32, 3)), train=False))(
            jax.random.PRNGKey(0)))
    variables["params"]["final_dense"]["bias"] = np.random.default_rng(
        5).normal(0, 1.0, 10).astype(np.float32)
    cfg = load_config("cifar10", "", OVERRIDES + [f"train.train_dir={d}"])
    model = build_model(cfg)
    model.load_state_dict(convert.flax_to_torch(variables))
    ckpt.save(d, 3, model)
    ref_infer = ref_make_serve_infer(ref_cfg)
    spans = SpanTracer(d, filename=SERVE_EVENTS_FILE, run_id=run_id)
    servers = []
    for name in ("r0", "r1"):
        servers.append(PredictServer(
            load_config("cifar10", "", OVERRIDES + [
                f"train.train_dir={d}", f"serve.replica_name={name}"]),
            device="cpu", spans=spans).start())
        write_discovery(d, servers[-1].port, run_id=run_id, name=name)
    router = Router(load_config("", "", ROUTE + [
        f"route.discover_dir={d}"])).start()
    write_route_discovery(d, router.port, run_id=run_id)
    wait_for(lambda: sum(1 for r in router.replicas()
                         if r.healthy and r.image_shape) == 2, 10)
    yield {"dir": d, "run_id": run_id, "router": router,
           "servers": servers,
           "reference": lambda im: np.asarray(ref_infer(
               variables, jnp.asarray(im)))}
    stop_all(*servers, router=router)
    spans.close()


def test_answers_through_the_router_are_the_reference(served_fleet):
    """Requests of 1, 3, 4 and 6 images through the router: the logits
    within 1e-4 of the reference's ``make_serve_infer`` on the same
    weights, its argmax, and both replicas answering."""
    router = served_fleet["router"]
    answered = set()
    for i, n in enumerate((1, 3, 4, 6, 1, 3, 4, 6)):
        im = _images(n, seed=i)
        code, out, headers = http_post(router.port, im.tobytes(),
                                       shape=f"{n},32,32,3",
                                       query="?logits=1")
        assert code == 200 and out["count"] == n and out["model_step"] == 3
        want = served_fleet["reference"](im)
        np.testing.assert_allclose(out["logits"], want, atol=1e-4,
                                   rtol=1e-4)
        assert out["predictions"] == want.argmax(-1).tolist()
        answered.add(headers["X-Replica"])
    assert answered == {"r0", "r1"}


def test_loadgen_drives_the_fleet(served_fleet):
    router = served_fleet["router"]
    result = loadgen.run_load(f"http://127.0.0.1:{router.port}", clients=3,
                              duration=1.0, images_per_request=2)
    assert result["requests_ok"] > 0 and result["run_id"] == \
        served_fleet["run_id"]
    assert result["failed"] + result["timeouts"] + \
        result["connect_failures"] + result["rejected_429"] == 0
    assert result["router"]["replicas_healthy"] == 2
    assert result["images_per_sec"] == pytest.approx(
        2 * result["throughput_rps"], rel=1e-2)


def test_aggregators_agree_on_the_live_replicas(served_fleet):
    """After the traffic, the reference's and the port's aggregators scrape
    the same two replicas and the router: equal rounds, the pooled count
    the replicas' requests."""
    d = served_fleet["dir"]

    def cfg(load):
        # A scrape timeout no busy CPU reaches: both rounds see every
        # endpoint up.
        return load("", "", [f"fleet.discover_dir={d}", "fleet.port=-1",
                             "fleet.slo_ms=50",
                             "fleet.scrape_timeout_secs=30"])

    aggs = [fleet.FleetAggregator(cfg(load_config), clock=lambda: 7.0),
            ref_fleet.FleetAggregator(cfg(ref_load_config),
                                      clock=lambda: 7.0)]
    try:
        got, want = (a.scrape_once() for a in aggs)
        assert aggs[0].snapshot() == aggs[1].snapshot()
    finally:
        for a in aggs:
            a.close()
    assert got == want
    served = sum(s.batcher.stats()["requests"]
                 for s in served_fleet["servers"])
    assert got["endpoints"] == 3 and got["up"] == 3
    assert got["fleet"]["count"] == served > 0
    assert set(got["per"]) == {"r0", "r1", "router"}


def test_trace_export_lays_router_and_replica_lanes(served_fleet):
    """The router's ``route_request`` spans and the replicas' serve events
    in one Chrome trace, every source under the minted run id."""
    router = served_fleet["router"]
    for i in range(70):             # past the tail sampler's base period
        http_post(router.port, _images(1, seed=100 + i).tobytes(),
                  shape="1,32,32,3", headers={"X-Trace-Id": f"t{i}"})
    _, trace = export_trace(served_fleet["dir"])
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"route_request", "route_start", "serve_ready",
            "serve_warmup"} <= names
    ids = trace["metadata"]["source_run_ids"]
    assert ids["route"] == ids["serve"] == [served_fleet["run_id"]]
    assert os.path.exists(os.path.join(served_fleet["dir"],
                                       "trace.json"))
