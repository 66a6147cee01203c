"""tpu_resnet_torch — the PyTorch/CUDA port of ``tpu_resnet`` for one
NVIDIA H100.

A package of its own beside the JAX reference: it imports torch, numpy and
the standard library, never JAX and nothing of ``tpu_resnet``. This slice
serves the CIFAR ResNet (``python -m tpu_resnet_torch serve``), with the
fused basic block and the BN+ReLU epilogue as hand-written CUDA kernels
(``csrc/``). Module names follow the reference's.
"""

__version__ = "0.1.0"
