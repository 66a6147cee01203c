"""The ranks of ``test_torch_data_parallel.py``: spawned processes that
join a gloo group (a ``file://`` rendezvous) and run the port's
data-parallel steps and ``train()`` on inputs the test made, each rank
saving what it computed. Imports torch and the port only."""

import os

import torch

from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.models import build_model
from tpu_resnet_torch.parallel import multihost, zero
from tpu_resnet_torch.train import loop
from tpu_resnet_torch.train import schedule as sched
from tpu_resnet_torch.train.state import create_state
from tpu_resnet_torch.train.step import make_train_step

# The step cases: (config overrides, partition).
CASES = {
    "per_replica": (["model.sync_bn=false"], "replicated"),
    "synced": ([], "replicated"),
    "zero1": ([], "zero1"),
    "identical": (["model.sync_bn=false"], "replicated"),
}
FUSED = ["model.resnet_size=14", "model.fused_blocks=true",
         "model.fused_epilogue=on", "optim.use_pallas_xent=on",
         "model.sync_bn=false"]


def step_cfg(overrides, n):
    return load_config("smoke", "", [*overrides, f"mesh.data={n}"])


def run_steps(cfg, init, batches, mesh, partition):
    """The port's rank step over ``batches`` (global, preprocessed
    floats) from ``init``: metrics per step, state and whole momentum."""
    cfg.mesh.partition = partition
    model = build_model(cfg)
    model.load_state_dict(init, strict=True)
    state = create_state(model, cfg.optim)
    update = zero.attach(state, cfg.mesh, mesh)
    step = make_train_step(
        cfg.optim, sched.build_schedule(cfg.optim, cfg.train),
        cfg.data.num_classes, device="cpu", mesh=mesh,
        per_replica_bn=loop.per_replica_bn(cfg, mesh), update=update)
    metrics = []
    for images, labels in batches:
        lo, hi = mesh.rank_rows(images.shape[0])
        m = step(state, images[lo:hi], labels[lo:hi])
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "state": {k: v.clone() for k, v in
                      state.model.state_dict().items()},
            "momentum": {k: v.clone() for k, v in
                         state.momentum_buffers().items()}}


def run_train(plan, overrides):
    """``train()`` on this rank from the plan's initial weights."""
    init = plan["train_init"]

    def start(cfg, device):
        model = build_model(cfg)
        model.load_state_dict(init, strict=True)
        return create_state(model.to(device), cfg.optim)

    loop.build_state = start
    cfg = load_config("smoke", "", [*plan["train_overrides"], *overrides])
    state = loop.train(cfg, device="cpu")
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def main(rank, n, init_file, plan_path, out_dir):
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * n)))
    plan = torch.load(plan_path, weights_only=False)
    mesh = multihost.initialize(f"file://{init_file}", 1, 0,
                                local_rank=rank, local_world=n,
                                device_type="cpu", timeout_sec=120)
    out = {}
    try:
        for name, (overrides, partition) in CASES.items():
            out[name] = run_steps(step_cfg(overrides, n), plan["init"],
                                  plan["identical" if name == "identical"
                                       else "batches"], mesh, partition)
        if "fused_batches" in plan:
            out["fused"] = run_steps(step_cfg(FUSED, n), plan["init14"],
                                     plan["fused_batches"], mesh,
                                     "replicated")
        for name, overrides in plan.get("train_runs", {}).items():
            out[name] = run_train(plan, overrides)
    finally:
        multihost.shutdown()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
