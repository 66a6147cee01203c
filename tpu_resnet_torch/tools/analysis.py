"""Model analysis (port of ``tpu_resnet/tools/analysis.py``): the
parameter count and the forward FLOPs of the configured model, as the
reference's tfprof dump prints them.

    python -m tpu_resnet_torch info --preset imagenet [--layers]

The model is built on the ``meta`` device: no memory, no device, no
kernel. The FLOPs are the port's own count (``obs/mfu.py``: convolutions
over the taps that fall on the input, and the dense layer), not XLA's cost
analysis, which also counts the elementwise work; the reference's ``bytes
accessed`` line is an XLA figure with no counterpart here.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from tpu_resnet_torch.models import build_model
from tpu_resnet_torch.obs.mfu import count_train_flops


def layer_params(model: torch.nn.Module) -> List[Tuple[str, tuple, int]]:
    """(name, shape, count) per parameter in module-definition order, under
    the model's ``state_dict`` names (the reference's ``layer_params``)."""
    return [(name, tuple(p.shape), int(p.numel()))
            for name, p in model.named_parameters()]


def print_model_info(cfg, layers: bool = False) -> None:
    """Print the resolved config, the model line, the trainable parameters
    and the BN moving statistics, the per-parameter table with
    ``layers``, and the forward FLOPs of one example."""
    with torch.device("meta"):
        model = build_model(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    n_stats = sum(b.numel() for b in model.buffers())
    print(cfg.to_json())
    print(f"model: {cfg.model.name} size={cfg.model.resnet_size} "
          f"width={cfg.model.width_multiplier} dataset={cfg.data.dataset}")
    print(f"trainable params: {n_params:,}")
    print(f"batch-norm moving stats: {n_stats:,}")
    if layers:
        rows = layer_params(model)
        width = max(len(r[0]) for r in rows)
        for name, shape, count in rows:
            print(f"  {name:<{width}}  {str(shape):>20}  {count:>12,}")
        print(f"  {'total':<{width}}  {'':>20}  {n_params:>12,}")
    try:
        flops = count_train_flops(cfg, batch=1)["forward"]
        print(f"forward FLOPs/example (port count, convolutions and dense "
              f"only): {int(flops):,}")
    except Exception as e:  # noqa: BLE001 - the count is best-effort
        print(f"FLOP count unavailable: {type(e).__name__}: {e}")
