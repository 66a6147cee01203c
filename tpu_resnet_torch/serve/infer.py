"""The serve hot path: eval preprocessing, then the model, on the device.

The model is the configured float32 model, or for ``serve.quantize=int8``
the reference's quantized arm (``tpu_resnet/serve/infer.py``):
``ops.quant.QuantizedModel``, which fake-quantizes the standardized input
with the calibrated scale, dequantizes the int8 weights it holds on the
device inside the call and runs the model on them; the fused kernels get
float32 weights. Both are called as ``model(x, train=False)``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tpu_resnet_torch.data.augment import get_eval_preprocess
from tpu_resnet_torch.models import build_model
from tpu_resnet_torch.ops import quant


def make_serve_infer(cfg, device: torch.device) -> Callable:
    """``infer(model, images_uint8[B,H,W,3]) -> float32 logits [B,classes]``
    (a tensor on ``device``). The images may be a numpy array or a tensor;
    they are copied to ``device``, standardized there and run through the
    model under ``torch.inference_mode()``. The model is an argument, so a
    hot-reload swaps weights by passing another model."""
    quant.check_quantize_config(cfg)
    preprocess = get_eval_preprocess(cfg.data.dataset)

    def infer(model: torch.nn.Module, images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        with torch.inference_mode():
            x = preprocess(images.to(device, non_blocking=True))
            return model(x, train=False)

    return infer


def serve_model(cfg, model: torch.nn.Module, device: torch.device,
                act_max: Optional[float] = None) -> torch.nn.Module:
    """The model a serve arm runs, in eval mode on ``device``: ``model``
    (the configured model with its weights loaded), or for
    ``serve.quantize=int8`` the :class:`~tpu_resnet_torch.ops.quant.
    QuantizedModel` of its state, quantized on the device, with the input
    scale of the calibrated ``act_max``."""
    model = model.to(device).eval()
    if cfg.serve.quantize != "int8":
        return model
    if act_max is None:
        raise ValueError("serve.quantize=int8 needs the calibrated act_max")
    qvars = quant.quantize_variables(model.state_dict(), act_max=act_max)
    return quant.QuantizedModel(qvars, build_model(cfg)).to(device).eval()


class ServeProgram(torch.nn.Module):
    """uint8 images [B,H,W,3] → float32 logits: eval preprocessing baked in
    before ``model`` (float32 or quantized), the program ``export``
    freezes."""

    def __init__(self, model: torch.nn.Module, dataset: str):
        super().__init__()
        self.model = model
        self.preprocess = get_eval_preprocess(dataset)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(self.preprocess(images), train=False)
