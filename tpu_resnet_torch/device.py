"""Where the port runs, and with which float32 precision.

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``). Without CUDA and without that
request they raise: nothing quietly moves to the CPU.

Precision: float32 means float32. ``torch.backends.cudnn.allow_tf32``
(PyTorch's default is True, so float32 convolutions would run in TF32) and
``torch.backends.cuda.matmul.allow_tf32`` are both set to False, so a
float32 model and the kernels' float32 oracle compute in full float32. The
serving default computes in bfloat16, which these flags do not touch.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(requested: Optional[str] = None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` → that CUDA device, with TF32 off
    (raises when CUDA is unavailable); ``"cpu"`` → the CPU."""
    device = torch.device(requested or "cuda")
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"device must be cuda or cpu, got {requested!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' (or "
                           "--device cpu) to run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device
