"""Kernels of the port: CUDA sources in ``csrc/``, wrappers here. Importing
the package registers the serve forward's trace-time custom ops
(``_library``), which loading an exported program needs."""

from tpu_resnet_torch.ops import _library  # noqa: F401
