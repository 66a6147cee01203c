"""MFU accounting: the train step's model FLOPs, counted once a run, and
the live ``model_flops_per_sec`` / ``mfu`` at each log boundary (port of
``tpu_resnet/obs/mfu.py``).

``PEAK_FLOPS_BY_KIND``  dense BF16 tensor-core FLOP/s without sparsity
                        per NVIDIA card (NVIDIA's H100 datasheet), by
                        device-name substring, the most specific first.
``count_train_flops``   one forward and backward of the configured model's
                        plain twin (``fused_blocks=false``,
                        ``fused_epilogue=off``, ``use_pallas_xent=off``) at
                        the global batch, on the ``meta`` device under
                        ``torch.utils.flop_counter.FlopCounterMode``: no
                        memory, no kernel. The CUDA kernels are ``ctypes``
                        calls the counter cannot see into; model FLOPs do
                        not depend on the kernel route, so a fused
                        configuration records its plain twin's count.
``FlopsRegistry``       one entry a program key (the reference's spelling,
                        ``train|cifar10_rn50_bf16|mesh1x1|b128``), saved
                        to ``<train_dir>/flops.json``.
``mfu``                 achieved model FLOP/s over the card's peak.

Convention. Two FLOPs a multiply-add, as XLA's cost analysis. A
convolution counts, as XLA does, only the taps that fall on the input:
taps over the zero padding are not multiplied, so a 3x3 convolution of a
32x32 plane counts (94/96)² of its taps, an 8x8 one (22/24)². Its input
and weight gradients count the forward's taps each, as XLA counts their
convolutions. Unlike XLA, nothing elementwise is counted (batch norm,
ReLU, the loss, the update), which leaves the count a few percent under
the reference's at CIFAR sizes.
"""

from __future__ import annotations

import copy
import json
import logging
import math
import os
from typing import Dict, Optional

log = logging.getLogger("tpu_resnet_torch")

REGISTRY_FILE = "flops.json"

# Dense BF16 tensor-core FLOP/s per card, without sparsity (NVIDIA H100
# datasheet), by lower-case device-name substring; the most specific first.
PEAK_FLOPS_BY_KIND = (
    ("h100 nvl", 835e12),
    ("h100 pcie", 756e12),
    ("h100 80gb hbm3", 989.4e12),   # SXM5, as torch.cuda names it
    ("h100 sxm", 989.4e12),
)


def peak_flops_per_chip(device_kind: str,
                        env_var: str = "TPU_RESNET_PEAK_FLOPS"
                        ) -> Optional[float]:
    """Peak dense FLOP/s of one card of ``device_kind``; None when the kind
    is unknown (the CPU, another card). ``env_var`` (and
    ``BENCH_PEAK_FLOPS``) override the table."""
    for var in (env_var, "BENCH_PEAK_FLOPS"):
        env = os.environ.get(var)
        if env:
            try:
                return float(env)
            except ValueError:
                log.warning("ignoring non-numeric %s=%r", var, env)
    kind = (device_kind or "").lower()
    for sub, peak in PEAK_FLOPS_BY_KIND:
        if sub in kind:
            return peak
    return None


def analytic_resnet50_flops(batch: int, image: int = 224) -> float:
    """The reference's analytic fallback: ResNet-50 forward ≈ 4.09e9 per
    224² image (multiply-adds, so about half the counted FLOPs), training
    3× the forward, scaled by pixel area. Not used by the loop."""
    return 3 * 4.09e9 * batch * (image / 224.0) ** 2


def mfu(model_flops_per_sec: Optional[float], device_kind: str,
        n_chips: int) -> Optional[float]:
    """Model FLOP/s over the aggregate peak of ``n_chips`` cards of
    ``device_kind``; None when either is unknown."""
    peak = peak_flops_per_chip(device_kind)
    if not peak or not model_flops_per_sec or n_chips < 1:
        return None
    return model_flops_per_sec / (peak * n_chips)


def train_program_key(cfg, mesh_shape: Optional[Dict[str, int]] = None,
                      kind: str = "train") -> str:
    """The reference's key for ``cfg``'s train step on one card."""
    from tpu_resnet_torch.programs import spell

    return spell(cfg, mesh_shape or {"data": 1, "model": 1}, kind=kind)


# ------------------------------------------------------------- counting
def _valid_taps(n_in: int, n_out: int, k: int, stride: int, pad: int,
                dilation: int) -> int:
    """(output, tap) pairs of one spatial dimension whose input index
    ``o*stride - pad + t*dilation`` lies inside ``[0, n_in)``."""
    total = 0
    for t in range(k):
        shift = t * dilation - pad
        lo = max(0, math.ceil(-shift / stride))
        hi = min(n_out - 1, math.floor((n_in - 1 - shift) / stride))
        total += max(0, hi - lo + 1)
    return total


def _conv_taps_flops(x_shape, w_shape, out_shape, stride, padding,
                     dilation, groups: int = 1) -> int:
    """2 · N · C_out · C_in/groups · Π valid (output, tap) pairs."""
    n, c_out, c_in = x_shape[0], w_shape[0], w_shape[1]
    pairs = 1
    for d in range(len(w_shape) - 2):
        pairs *= _valid_taps(x_shape[2 + d], out_shape[2 + d],
                             w_shape[2 + d], stride[d], padding[d],
                             dilation[d])
    return 2 * n * c_out * c_in * pairs


def _conv_flop(x_shape, w_shape, _bias, stride, padding, dilation,
               transposed, _output_padding=None, groups=1, *args,
               out_shape=None, **kwargs) -> int:
    if transposed:
        from torch.utils.flop_counter import conv_flop_count
        return conv_flop_count(x_shape, w_shape, out_shape, transposed=True)
    return _conv_taps_flops(x_shape, w_shape, out_shape, stride, padding,
                            dilation, groups)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, stride,
                        padding, dilation, transposed, _output_padding,
                        groups, output_mask, out_shape=None,
                        **kwargs) -> int:
    if transposed:
        from torch.utils.flop_counter import conv_backward_flop
        return conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias,
                                  stride, padding, dilation, transposed,
                                  _output_padding, groups, output_mask,
                                  out_shape)
    one = _conv_taps_flops(x_shape, w_shape, grad_out_shape, stride,
                           padding, dilation, groups)
    return one * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def plain_twin(cfg):
    """``cfg`` with the kernel routes off: the model whose FLOPs every
    route of ``cfg`` computes."""
    twin = copy.deepcopy(cfg)
    twin.model.fused_blocks = False
    twin.model.fused_epilogue = "off"
    twin.optim.use_pallas_xent = "off"
    return twin


def count_train_flops(cfg, batch: Optional[int] = None,
                      taps: str = "valid") -> Dict[str, float]:
    """FLOPs of one train step of ``cfg``'s plain twin at ``batch`` (the
    global batch by default): the forward and the backward (input
    gradients, but none for the images, and weight gradients), on the
    ``meta`` device. ``taps="all"`` counts convolutions as
    ``FlopCounterMode`` does by default (every tap, padding included).
    Returns ``{"total", "forward", "by_op": {op: flops}}``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from tpu_resnet_torch.models import build_model

    if taps not in ("valid", "all"):
        raise ValueError(f"taps must be valid|all, got {taps!r}")
    twin = plain_twin(cfg)
    b = int(batch or cfg.train.global_batch_size)
    size = twin.data.resolved_image_size
    aten = torch.ops.aten
    mapping = ({aten.convolution: _conv_flop,
                aten._convolution: _conv_flop,
                aten.convolution_backward: _conv_backward_flop}
               if taps == "valid" else {})
    with torch.device("meta"):
        model = build_model(twin)
        images = torch.empty(b, size, size, 3)
    with FlopCounterMode(display=False, custom_mapping=mapping) as count:
        logits = model(images, train=True)
        forward = count.get_total_flops()
        logits.float().sum().backward()
    by_op = {str(op): int(n) for op, n in
             count.get_flop_counts().get("Global", {}).items()}
    return {"total": float(count.get_total_flops()),
            "forward": float(forward), "by_op": by_op}


class FlopsRegistry:
    """Per-program FLOPs entries, persisted as ``<train_dir>/flops.json``
    (the reference's format)."""

    def __init__(self):
        self._entries: Dict[str, dict] = {}

    def register(self, key: str, flops_per_step: Optional[float],
                 source: str = "flop_counter", **extra) -> dict:
        entry = {"flops_per_step": flops_per_step,
                 "flops_source": source if flops_per_step else "none"}
        entry.update(extra)
        self._entries[key] = entry
        return entry

    def get(self, key: str) -> Optional[dict]:
        return self._entries.get(key)

    def flops(self, key: str) -> Optional[float]:
        entry = self._entries.get(key) or {}
        return entry.get("flops_per_step")

    def to_dict(self) -> dict:
        return {"format": 1, "entries": dict(self._entries)}

    def save(self, train_dir: str) -> Optional[str]:
        """Atomic ``<train_dir>/flops.json``."""
        try:
            os.makedirs(train_dir, exist_ok=True)
            path = os.path.join(train_dir, REGISTRY_FILE)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self.to_dict(), f, indent=1)
            os.replace(tmp, path)
            return path
        except OSError as e:
            log.warning("could not write %s: %s", REGISTRY_FILE, e)
            return None

    @classmethod
    def load(cls, train_dir: str) -> "FlopsRegistry":
        reg = cls()
        try:
            with open(os.path.join(train_dir, REGISTRY_FILE)) as f:
                payload = json.load(f)
            reg._entries.update(payload.get("entries", {}))
        except (OSError, ValueError):
            pass
        return reg


def device_kind(device) -> str:
    """``torch.cuda.get_device_name`` of a CUDA device, else ``"cpu"``."""
    import torch

    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def account_train_step(cfg, device,
                       registry: Optional[FlopsRegistry] = None,
                       train_dir: Optional[str] = None) -> dict:
    """Count and register the train step's FLOPs for ``cfg`` on
    ``device`` (once a run, after the first dispatch); returns the entry
    and saves the registry in ``train_dir``."""
    registry = registry or FlopsRegistry()
    counted = count_train_flops(cfg)
    kind = device_kind(device)
    entry = registry.register(
        train_program_key(cfg), counted["total"], source="flop_counter",
        global_batch=cfg.train.global_batch_size,
        forward_flops=counted["forward"], conv_taps="valid",
        counted_model="plain twin (fused_blocks=false, fused_epilogue=off, "
                      "use_pallas_xent=off) on the meta device",
        device_kind=kind, n_devices=1,
        peak_flops_per_chip=peak_flops_per_chip(kind))
    if train_dir:
        registry.save(train_dir)
    return entry
