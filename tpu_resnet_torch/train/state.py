"""The train state: step, model (parameters and BN running statistics) and
optimizer (port of ``tpu_resnet/train/state.py``).

The optimizer matches optax's ``sgd`` with the reference's settings:
``momentum`` is ``sgd(lr, momentum=0.9)`` (``v ← g + m·v``, ``p ← p −
lr·v``), ``sgd`` has no momentum. ``torch.optim.SGD`` with dampening 0,
no Nesterov and no weight decay computes exactly that; the train step sets
the learning rate from the schedule before every update. Weight decay is
not the optimizer's: the reference adds the L2 term to the loss
(``train/step.py``), which interacts with momentum differently.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn as nn


@dataclasses.dataclass
class TrainState:
    step: int                        # the reference's global_step
    model: nn.Module                 # parameters + BN running statistics
    optimizer: torch.optim.Optimizer

    def momentum_buffers(self) -> Dict[str, torch.Tensor]:
        """{parameter name: momentum buffer} for the parameters that have
        one (none before the first momentum step, none for plain sgd)."""
        out = {}
        for name, p in self.model.named_parameters():
            buf = self.optimizer.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                out[name] = buf
        return out

    def load_momentum_buffers(self, buffers: Dict[str, torch.Tensor]) -> None:
        """Set momentum buffers by parameter name (an unknown name raises)."""
        params = dict(self.model.named_parameters())
        unknown = set(buffers) - set(params)
        if unknown:
            raise KeyError(f"momentum buffers for unknown parameters: "
                           f"{sorted(unknown)[:5]}")
        for name, buf in buffers.items():
            p = params[name]
            self.optimizer.state[p]["momentum_buffer"] = buf.to(
                device=p.device, dtype=p.dtype).clone()


def build_optimizer(optim_cfg, model: nn.Module) -> torch.optim.Optimizer:
    """SGD over ``model``'s parameters; the learning rate is set per step."""
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
