"""The train state: step, model (parameters and BN running statistics) and
optimizer (port of ``tpu_resnet/train/state.py``).

The update is optax's ``sgd`` with the reference's settings: ``momentum``
is ``sgd(lr, momentum=0.9)`` (``v ← g + m·v``, ``p ← p + (−lr)·v``),
``sgd`` has no momentum. :func:`sgd_update` writes it out as
``torch._foreach_*`` calls on a learning rate held in a 0-dim float32
tensor on the parameters' device, so that no host read happens in it and a
CUDA graph can replay it: ``torch.optim.SGD`` passes a tensor learning
rate as ``alpha=-lr``, which reads it on the host. The optimizer object
stays as the holder of the momentum buffers (``optimizer.state[p]
["momentum_buffer"]``, created at the first momentum step as
``torch.optim.SGD`` creates them) and of the momentum factor. Weight decay
is not the optimizer's: the reference adds the L2 term to the loss
(``train/step.py``), which interacts with momentum differently.

Under ``mesh.partition=zero1`` on more than one rank the state's ``zero``
(a ``parallel.zero.Zero1Update``) owns the momentum buffers: each rank
holds its shards, :meth:`TrainState.momentum_buffers` gathers the whole
ones (a collective: every rank calls it) and
:meth:`TrainState.load_momentum_buffers` keeps this rank's shards.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn as nn


@dataclasses.dataclass
class TrainState:
    step: int                        # the reference's global_step
    model: nn.Module                 # parameters + BN running statistics
    optimizer: torch.optim.Optimizer
    zero: Optional[object] = None    # zero1's owner of the buffers

    def momentum_buffers(self, local: bool = False
                         ) -> Dict[str, torch.Tensor]:
        """{parameter name: momentum buffer} for the parameters that have
        one (none before the first momentum step, none for plain sgd).
        Under zero1 the whole buffers, gathered from every rank, or with
        ``local`` this rank's shards."""
        if self.zero is not None and not local:
            return self.zero.full_slots(self)
        out = {}
        for name, p in self.model.named_parameters():
            buf = self.optimizer.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                out[name] = buf
        return out

    def load_momentum_buffers(self, buffers: Dict[str, torch.Tensor]
                              ) -> None:
        """Set the momentum buffers to ``buffers``, by parameter name (an
        unknown name raises). A buffer that exists is written in place, so
        that a captured step that reads and writes it stays valid; one
        that does not is created; an existing one that ``buffers`` lacks
        (a checkpoint saved before the first momentum step) is zeroed in
        place, and the next step then computes ``g + m·0 = g``, as it
        would from no buffer. Under zero1 each rank keeps its shards of
        the whole ``buffers``."""
        params = dict(self.model.named_parameters())
        unknown = set(buffers) - set(params)
        if unknown:
            raise KeyError(f"momentum buffers for unknown parameters: "
                           f"{sorted(unknown)[:5]}")
        if self.zero is not None:
            self.zero.load_slots(self, buffers)
            return
        with torch.no_grad():
            for name, p in params.items():
                state = self.optimizer.state[p]
                old = state.get("momentum_buffer")
                if name in buffers:
                    if old is None:
                        state["momentum_buffer"] = buffers[name].to(
                            device=p.device, dtype=p.dtype).clone()
                    else:
                        old.copy_(buffers[name])
                elif old is not None:
                    old.zero_()


def sgd_update(state: TrainState, lr: torch.Tensor) -> None:
    """One optax ``sgd``/``momentum`` update of every parameter that has a
    gradient, ``lr`` a 0-dim float32 tensor on their device; reads nothing
    on the host. A parameter without a momentum buffer gets ``clone(g)``
    (``torch.optim.SGD``'s first step; optax's ``g + m·0``); once every
    buffer exists, the update is ``v ← m·v + g``, ``p ← p + (−lr)·v``."""
    params = [p for p in state.model.parameters() if p.grad is not None]
    sgd_apply(params, [p.grad for p in params],
              [state.optimizer.state[p] for p in params],
              state.optimizer.param_groups[0]["momentum"], lr)


def sgd_apply(params: List[torch.Tensor], grads: List[torch.Tensor],
              slots: List[dict], momentum: float, lr: torch.Tensor) -> None:
    """:func:`sgd_update`'s arithmetic on tensors: each of ``params``
    (written in place; a view, such as a zero1 shard, is fine) takes its
    ``grads`` entry, and ``slots`` holds each one's ``momentum_buffer``,
    shaped as its parameter tensor."""
    with torch.no_grad():
        if momentum == 0:
            updates = grads
        else:
            updates = [s.get("momentum_buffer") for s in slots]
            have = [i for i, buf in enumerate(updates) if buf is not None]
            if have:
                bufs = [updates[i] for i in have]
                torch._foreach_mul_(bufs, momentum)
                torch._foreach_add_(bufs, [grads[i] for i in have])
            for i, buf in enumerate(updates):
                if buf is None:
                    updates[i] = slots[i]["momentum_buffer"] = torch.clone(
                        grads[i]).detach()
        torch._foreach_add_(params, torch._foreach_mul(updates, -lr))


def build_optimizer(optim_cfg, model: nn.Module) -> torch.optim.Optimizer:
    """The holder of the momentum buffers and factor over ``model``'s
    parameters (:func:`sgd_update` runs the update)."""
    if optim_cfg.optimizer == "sgd":
        momentum = 0.0
    elif optim_cfg.optimizer == "momentum":
        momentum = optim_cfg.momentum
    else:
        raise ValueError(f"unknown optimizer {optim_cfg.optimizer!r}")
    return torch.optim.SGD(model.parameters(), lr=0.0, momentum=momentum,
                           dampening=0.0, nesterov=False, weight_decay=0.0)


def create_state(model: nn.Module, optim_cfg) -> TrainState:
    return TrainState(step=0, model=model,
                      optimizer=build_optimizer(optim_cfg, model))


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
