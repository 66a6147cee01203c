"""The serve hot path: eval preprocessing, then the model, on the device."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tpu_resnet_torch.data.augment import get_eval_preprocess


def make_serve_infer(cfg, device: torch.device) -> Callable:
    """``infer(model, images_uint8[B,H,W,3]) -> float32 logits [B,classes]``
    (a tensor on ``device``). The images may be a numpy array or a tensor;
    they are copied to ``device``, standardized there and run through the
    model under ``torch.inference_mode()``. The model is an argument, so a
    hot-reload swaps weights by passing another model."""
    if cfg.serve.quantize != "off":
        raise NotImplementedError(
            f"serve.quantize={cfg.serve.quantize}: the int8 arm is a later "
            f"slice of the port")
    preprocess = get_eval_preprocess(cfg.data.dataset)

    def infer(model: torch.nn.Module, images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        with torch.inference_mode():
            x = preprocess(images.to(device, non_blocking=True))
            return model(x, train=False)

    return infer
