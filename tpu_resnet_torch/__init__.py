"""tpu_resnet_torch — the PyTorch/CUDA port of ``tpu_resnet`` for NVIDIA
H100 cards.

A package of its own beside the JAX reference: it imports torch, numpy and
the standard library, never JAX and nothing of ``tpu_resnet``. Module
names follow the reference's. ``python -m tpu_resnet_torch``:

- ``train``, ``eval``: the CIFAR and ImageNet ResNets, one card or N ranks
  (``mesh.data``), through the fused basic block, the fused bottleneck,
  the BN+ReLU epilogue and the cross-entropy pair as hand-written CUDA
  kernels (``csrc/``), from TFRecord shards of JPEGs decoded on the card;
- ``serve``, ``export``, ``predict``: the predict server (checkpoint or
  frozen ``torch.export`` artifact, float32 or int8) running the kernels;
- ``route``, ``fleetmon``, ``autopilot``: the serving fleet in front of
  the replicas — the router (failover, SLO shedding, hedging, rolling
  drain), the fleet monitor (merged percentiles, burn-rate alerts) and
  the autopilot (replicas spawned and drained with the traffic), host
  processes that import no torch; ``tools/loadgen.py`` drives them and
  ``tools/supervise.py`` restarts preempted trainers and crashed
  replicas;
- ``info``, ``inspect``, ``plot``, ``trace-export``, ``doctor``: the run
  tools.

Everything on a device runs on CUDA unless the caller asks for the CPU
(``--device cpu``), where the kernels' plain PyTorch versions run.
"""

__version__ = "0.1.0"
