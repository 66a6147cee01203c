"""Post-training int8 quantization math (port of
``tpu_resnet/ops/quant.py``): symmetric per-output-channel weight
quantization and one per-tensor activation scale, in plain PyTorch.

The int8 serve arm (``serve.quantize=int8``) holds each conv and dense
weight as int8 codes and one float32 scale per output channel, about 0.25x
the bytes of the float32 weights, and dequantizes them inside the call: the
fused kernels receive float32 weights, as the reference's Pallas kernels
do. The network input is fake-quantized (quantize, then dequantize, in
float32) with one scale calibrated over eval batches
(``serve/calibrate.py``).

**Layout.** The reference's output channel is the LAST axis (HWIO conv
kernels, ``[in, out]`` dense kernels); the port's is axis 0 (OIHW conv
weights, ``nn.Linear``'s ``[out, in]``). So :func:`quantize_leaf` reduces
over every axis but 0, and its codes and scales are the reference's bit
for bit once ``convert.py`` has mapped the layouts: the division, the
round (half to even in both) and the clip are the same float32 operations.

The quantized tree of a state dict (:func:`quantize_variables`):
``{"params": {name: int8 codes for each weight of two or more axes, the
tensor itself otherwise (BN affines, biases, running statistics)},
"qscales": {name: float32 [C_out]}, "qact": {"input": float32 scalar}}``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

# Allowed values of serve.quantize.
QUANT_MODES = ("off", "int8")

# int8 symmetric range: +-127 (-128 unused, so -q is always a code).
QMAX = 127.0

# Keys the quantized tree adds beside the state.
QSCALES_KEY = "qscales"
QACT_KEY = "qact"


def check_quantize_config(cfg, data_axis: int = 1) -> None:
    """The reference's guards of ``serve.quantize``, with its messages: an
    unknown mode, and int8 with per-replica BN over a data axis of more
    than one replica (each replica would fold another BN affine, so one
    calibration cannot hold across them)."""
    mode = getattr(getattr(cfg, "serve", None), "quantize", "off")
    if mode not in QUANT_MODES:
        raise ValueError(
            "serve.quantize must be one of %s, got %r"
            % ("|".join(QUANT_MODES), mode))
    if mode == "int8" and data_axis > 1 and not cfg.model.sync_bn:
        raise ValueError(
            "serve.quantize=int8 requires model.sync_bn=true when "
            "data_axis > 1: per-replica batch statistics give each "
            "replica a different folded BN affine, so one calibration "
            "cannot hold across the fleet")


def is_weight(name: str, t: torch.Tensor) -> bool:
    """Quantized: conv and dense weights (``*.weight`` of two or more
    axes); BN affines, biases and running statistics stay float32."""
    return name.endswith("weight") and t.dim() >= 2


def _channel_view(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    return scale.reshape((-1,) + (1,) * (ndim - 1))


def quantize_leaf(w: torch.Tensor):
    """``(q int8 of w's shape, scale float32 [C_out])`` of one weight, its
    output channel on axis 0; an all-zero channel gets scale 1.0, so its
    dequantization is exact."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    scale = torch.where(amax > 0, amax / QMAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / _channel_view(scale, w.dim())),
                    -QMAX, QMAX).to(torch.int8)
    return q, scale


def dequant_leaf(q: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` over the output channel (axis 0)."""
    return (q.float() * _channel_view(scale, q.dim())).to(dtype)


def act_scale_from_max(amax) -> torch.Tensor:
    """The per-tensor activation scale (float32 scalar) of a calibrated
    max-abs value."""
    amax = torch.as_tensor(amax, dtype=torch.float32)
    return torch.where(amax > 0, amax / QMAX, torch.ones_like(amax))


def fake_quant(x: torch.Tensor, scale) -> torch.Tensor:
    """Quantize, then dequantize, ``x`` with a per-tensor scale in float32;
    the result in x's dtype."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX)
    return (q * scale).to(x.dtype)


def quantize_variables(state: Mapping[str, torch.Tensor],
                       act_max=1.0) -> dict:
    """The quantized tree (module docstring) of a state dict; ``act_max``
    is the calibrated input max-abs."""
    params, qscales = {}, {}
    for name, t in state.items():
        if is_weight(name, t):
            params[name], qscales[name] = quantize_leaf(t)
        else:
            params[name] = t
    return {"params": params, QSCALES_KEY: qscales,
            QACT_KEY: {"input": act_scale_from_max(act_max)}}


def dequantize_variables(qvars: Mapping, dtype: torch.dtype = torch.float32
                         ) -> Dict[str, torch.Tensor]:
    """The float32 state dict of a quantized tree."""
    qscales = qvars[QSCALES_KEY]
    return {name: (t if name not in qscales
                   else dequant_leaf(t, qscales[name], dtype))
            for name, t in qvars["params"].items()}


def tree_argument_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict: the ``serve_weight_bytes``
    gauge and the export manifest's ``weight_bytes``."""
    if isinstance(tree, Mapping):
        return sum(tree_argument_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _buffer_key(name: str) -> str:
    return name.replace(".", "__")


class QuantizedModel(torch.nn.Module):
    """The int8 arm's model: called as the float32 model is (``model(x,
    train=False)`` on the preprocessed input), it fake-quantizes x with
    the calibrated scale, dequantizes the int8 weights it holds and runs
    ``skeleton`` (the configured model; its own tensors are never read)
    on that state through ``torch.func.functional_call``. The codes, the
    scales and the float32 rest are its buffers, so that ``.to(device)``
    moves them and an exported program holds them as int8 and float32
    tensors, the dequantization as graph operations."""

    def __init__(self, qvars: Mapping, skeleton: torch.nn.Module):
        super().__init__()
        self._names = list(qvars["params"])
        self._quantized = set(qvars[QSCALES_KEY])
        for name in self._names:
            self.register_buffer(_buffer_key(name), qvars["params"][name])
            if name in self._quantized:
                self.register_buffer("qscale__" + _buffer_key(name),
                                     qvars[QSCALES_KEY][name])
        self.register_buffer("qact_input", qvars[QACT_KEY]["input"])
        # Not a submodule: its tensors are not this module's.
        object.__setattr__(self, "skeleton", skeleton.to("meta").eval())

    def qvars(self) -> dict:
        """The quantized tree this model holds (on its device)."""
        params, qscales = {}, {}
        for name in self._names:
            params[name] = getattr(self, _buffer_key(name))
            if name in self._quantized:
                qscales[name] = getattr(self, "qscale__" + _buffer_key(name))
        return {"params": params, QSCALES_KEY: qscales,
                QACT_KEY: {"input": self.qact_input}}

    def forward(self, x: torch.Tensor, *, train: bool = False
                ) -> torch.Tensor:
        if train:
            raise ValueError("the int8 arm serves; it does not train")
        x = fake_quant(x, self.qact_input)
        state = dequantize_variables(self.qvars())
        return torch.func.functional_call(self.skeleton, state, (x,),
                                          {"train": False})
