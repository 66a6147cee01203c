"""Train and eval steps (port of ``tpu_resnet/train/step.py``): on one
device, or on each rank of a data-parallel run (:class:`TrainStep`).

Step semantics, as the reference's:
- loss = mean softmax cross-entropy + weight_decay · Σ sum(w²)/2 over the
  parameters (BN scale/bias and the dense bias included unless
  ``optim.weight_decay_on_bn=false``), in float32;
- BN running statistics update inside the forward (``train=True``);
- the learning rate is ``schedule(step)`` read before the step moves, as
  a float32 tensor on the device (:class:`TrainStep`);
- metrics: loss, precision (argmax == label), learning_rate and grad_norm,
  the global L2 norm of the full gradient, penalty included.

Loss dispatch (reference :147–162): ``optim.use_pallas_xent=on`` with no
label smoothing runs the CUDA cross-entropy kernels for CUDA tensors
(``ops/softmax_xent.py``); ``off``, label smoothing or a CPU tensor runs
the plain chain :func:`softmax_xent`. ``auto`` with no label smoothing on
CUDA takes the decision of the timed A/B at (B, classes)
(``sx.ensure_xent_probe``, run when the step is built); on the CPU, or
with label smoothing, it takes the plain chain, as the reference's
``auto`` does off the TPU.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_resnet_torch.models.resnet import synced_batch_norm
from tpu_resnet_torch.ops import softmax_xent as sx
from tpu_resnet_torch.parallel import zero
from tpu_resnet_torch.parallel.mesh import Mesh
from tpu_resnet_torch.parallel.partition import check_partition_mode
from tpu_resnet_torch.train.state import TrainState

XENT_MODES = {"true": "on", "1": "on", "yes": "on",
              "false": "off", "0": "off", "no": "off"}


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 num_classes: int, label_smoothing: float = 0.0
                 ) -> torch.Tensor:
    """Mean softmax cross-entropy on integer labels: one-hot (smoothed),
    then ``-Σ onehot · log_softmax`` per example."""
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    if label_smoothing:
        onehot = (onehot * (1 - label_smoothing)
                  + label_smoothing / num_classes)
    return -(onehot * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def l2_weight_penalty(model: nn.Module, include_bn: bool) -> torch.Tensor:
    """Σ sum(w²)/2 over the parameters in float32; ``include_bn=False``
    drops the 1-D ones (BN scale/bias, the dense bias)."""
    terms = [torch.square(p.float()).sum() / 2 for p in model.parameters()
             if include_bn or p.dim() > 1]
    return torch.stack(terms).sum()


def xent_mode(optim_cfg) -> str:
    mode = str(optim_cfg.use_pallas_xent).lower()
    mode = XENT_MODES.get(mode, mode)
    if mode not in ("on", "off", "auto"):
        raise ValueError(f"optim.use_pallas_xent must be auto|on|off, got "
                         f"{optim_cfg.use_pallas_xent!r}")
    return mode


def check_step_config(cfg, data_axis: int = 1) -> None:
    """The reference's step-config gate (``check_step_config``), word for
    word, over a ``data_axis``-rank data axis, plus what the port does not
    train: a ``model`` axis above 1. ``model.fused_blocks=true`` trains the
    CIFAR models through the live-BN fused block kernels and the ImageNet
    ResNets through the live-BN fused bottleneck kernels; across ranks the
    fused kernels need per-replica BN, as the reference's do. A dataset's
    missing input pipeline is refused where the batches are read
    (``data.train_batches``), not here."""
    per_replica_bn = (not cfg.model.sync_bn) and data_axis > 1
    partition = check_partition_mode(
        getattr(cfg.mesh, "partition", "replicated"))
    if cfg.mesh.model != 1:
        raise NotImplementedError(
            f"mesh.model={cfg.mesh.model}: each rank of the port holds the "
            f"whole model on one device; a model axis is a later slice "
            f"(ROADMAP Queue 1)")
    if partition == "zero1" and per_replica_bn:
        raise ValueError(
            "mesh.partition=zero1 on a multi-chip data axis requires "
            "model.sync_bn=true: per-replica BN runs the step inside "
            "shard_map, where the zero1 sharding annotations "
            "(with_sharding_constraint over the mesh) cannot be applied "
            "— the auto-sharded jit path is the supported dispatch for "
            "cross-replica optimizer sharding (docs/PARALLELISM.md)")
    if cfg.model.fused_blocks and data_axis > 1 and not per_replica_bn:
        raise ValueError(
            "model.fused_blocks on a multi-chip data axis requires "
            "model.sync_bn=false (per-replica BN via shard_map — the "
            "reference's BN semantics); global-batch sync-BN is not "
            "implemented for the fused kernels")
    if (getattr(cfg.model, "fused_epilogue", "off") != "off"
            and data_axis > 1 and not per_replica_bn):
        raise ValueError(
            "model.fused_epilogue on a multi-chip data axis requires "
            "model.sync_bn=false (per-replica BN via shard_map): the "
            "epilogue pallas_call cannot be auto-partitioned by the "
            "sharded jit — same dispatch rule as fused_blocks")
    xent_mode(cfg.optim)


class TrainStep:
    """``train_step(state, images, labels) -> metrics``, the eager step,
    which updates ``state`` in place; and its two halves, which a captured
    step replays (``data/device_data.py`` ``ChunkRunner``):

    - ``host_inputs(step, b)``: on the host, the step's learning rate
      ``schedule(step)`` and its augmentation draws (numpy arrays) for
      this rank's ``b`` images;
    - ``core(state, images, labels, lr, *draws)``: on the device, with
      ``lr`` a 0-dim float32 tensor and the draws as tensors: augmentation,
      forward, loss, backward, the collectives, the global gradient norm
      and the update (``update``, ``parallel/zero.py``). It reads nothing
      on the host and leaves ``state.step`` to its caller.

    Across the ranks of ``mesh`` (the reference's step rules): with
    ``per_replica_bn`` the BN moments are each rank's batch's and the
    draws ``fold_in(step key, rank)``'s, and the loss, precision,
    gradients and running statistics are averaged over the ranks;
    otherwise (synced BN) the moments are the global batch's
    (``models.resnet.synced_batch_norm``), the draws the global batch's,
    this rank taking its rows, and the loss, precision and gradients are
    averaged.

    The eager step runs ``core`` on ``lr`` and the draws copied to the
    images' device, so both compute the same thing. Metrics are 0-dim
    tensors on the device (no host sync): loss, precision, learning_rate,
    grad_norm."""

    def __init__(self, loss_fn: Callable, schedule: Callable[[int], float],
                 augment=None, mesh: Optional[Mesh] = None,
                 per_replica_bn: bool = False, update: Callable = None):
        self.loss_fn = loss_fn
        self.schedule = schedule
        self.augment = augment
        self.mesh = mesh or Mesh()
        self.per_replica_bn = per_replica_bn
        self.update = update or zero.plain_update

    def host_inputs(self, step: int, b: int) -> Tuple[float, tuple]:
        draws = ()
        if self.augment is not None:
            draws = self.augment.draws(step, b, rank=self.mesh.rank,
                                       world=self.mesh.data,
                                       per_replica=self.per_replica_bn)
        return self.schedule(step), draws

    def core(self, state: TrainState, images: torch.Tensor,
             labels: torch.Tensor, lr: torch.Tensor,
             *draws: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.augment is not None:
            images = self.augment.apply(images, *draws)
        state.optimizer.zero_grad(set_to_none=True)
        synced = 1 if self.per_replica_bn else self.mesh.data
        with synced_batch_norm(synced):
            loss, logits = self.loss_fn(state.model, images, labels)
            loss.backward()
        with torch.no_grad():
            precision = (logits.argmax(-1) == labels).float().mean()
        stats = list(state.model.buffers()) if self.per_replica_bn else []
        grad_norm, means = self.update(state, lr,
                                       [loss.detach(), precision, *stats])
        with torch.no_grad():
            for buf, avg in zip(stats, means[2:]):
                buf.copy_(avg)
        return {"loss": means[0], "precision": means[1],
                "learning_rate": lr, "grad_norm": grad_norm}

    def __call__(self, state: TrainState, images: torch.Tensor,
                 labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        lr, draws = self.host_inputs(state.step, images.shape[0])
        dev = images.device
        m = self.core(state, images, labels,
                      torch.tensor(lr, dtype=torch.float32, device=dev),
                      *(torch.from_numpy(d).to(dev) for d in draws))
        state.step += 1
        return m


def make_train_step(optim_cfg, schedule: Callable[[int], float],
                    num_classes: int, augment=None,
                    device=None, xent_probe_batch: Optional[int] = None,
                    mesh: Optional[Mesh] = None,
                    per_replica_bn: bool = False,
                    update: Optional[Callable] = None) -> TrainStep:
    """The :class:`TrainStep`. ``images`` are raw uint8 with ``augment``
    (a ``data.augment.StepAugment``) applied on their device, or
    pre-processed floats (``augment=None``). Under
    ``use_pallas_xent=auto`` on a CUDA ``device`` the cross-entropy A/B
    runs here, at (``xent_probe_batch``, ``num_classes``). ``mesh``,
    ``per_replica_bn`` and ``update`` (``parallel.zero.attach``)
    make it a step across ranks."""
    mode = xent_mode(optim_cfg)
    use_kernel = mode in ("on", "auto") and optim_cfg.label_smoothing == 0.0
    if use_kernel and mode == "auto":
        use_kernel = (device is not None
                      and torch.device(device).type == "cuda"
                      and sx.ensure_xent_probe(xent_probe_batch, num_classes,
                                               device=device).use_pallas)

    def loss_fn(model: nn.Module, images, labels):
        logits = model(images, train=True)
        x = logits.float()
        if use_kernel and x.device.type == "cuda":
            xent = sx.softmax_xent_mean(x, labels)
        else:
            xent = softmax_xent(x, labels, num_classes,
                                optim_cfg.label_smoothing)
        penalty = optim_cfg.weight_decay * l2_weight_penalty(
            model, optim_cfg.weight_decay_on_bn)
        return xent + penalty, logits

    return TrainStep(loss_fn, schedule, augment, mesh=mesh,
                     per_replica_bn=per_replica_bn, update=update)


def make_eval_step(num_classes: int,
                   preprocess_fn: Optional[Callable] = None):
    """``eval_step(model, images, labels) -> (correct, loss_sum, valid)``
    as 0-dim device tensors; labels < 0 are padding."""

    @torch.inference_mode()
    def eval_step(model: nn.Module, images: torch.Tensor,
                  labels: torch.Tensor):
        if preprocess_fn is not None:
            images = preprocess_fn(images)
        logits = model(images, train=False).float()
        valid = labels >= 0
        safe = torch.clamp_min(labels.long(), 0)
        onehot = F.one_hot(safe, num_classes).to(logits.dtype)
        per_ex = -(onehot * F.log_softmax(logits, dim=-1)).sum(-1)
        correct = (logits.argmax(-1) == safe) & valid
        return (correct.sum(), (per_ex * valid.float()).sum(), valid.sum())

    return eval_step
