"""One-hidden-layer softmax MLP (port of ``tpu_resnet/models/mlp.py``),
the debug model the int8 serve arm's accuracy gate is held on.

Flatten the NHWC image → ``hidden`` (``hidden_units``, truncated normal
std 1/image_size) → ReLU → ``softmax_linear`` (``num_classes``, truncated
normal std 1/sqrt(hidden_units)) → float32 logits. As in the reference, the
input is rounded to the compute dtype and the dense layers compute in
float32 (their parameters' dtype); ``train`` is accepted and ignored (no
BN, no dropout).
"""

from __future__ import annotations

import math

import torch
from torch import nn


class MLP(nn.Module):
    def __init__(self, hidden_units: int = 100, num_classes: int = 10,
                 image_size: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_size = image_size
        self.dtype = dtype
        self.hidden = nn.Linear(image_size * image_size * 3, hidden_units)
        self.softmax_linear = nn.Linear(hidden_units, num_classes)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        del train
        x = x.to(self.dtype).float().reshape(x.shape[0], -1)
        return self.softmax_linear(torch.relu(self.hidden(x))).float()

    def init_weights(self, generator: torch.Generator) -> "MLP":
        """flax's ``truncated_normal(std)``: a unit normal truncated to
        [-2, 2], times std; zero biases."""
        with torch.no_grad():
            for layer, std in ((self.hidden, 1.0 / self.image_size),
                               (self.softmax_linear,
                                1.0 / math.sqrt(self.hidden.out_features))):
                nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                nn.init.zeros_(layer.bias)
        return self
