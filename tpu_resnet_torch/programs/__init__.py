"""Program keys (``registry.spell``), the reference's spelling."""

from tpu_resnet_torch.programs.registry import spell

__all__ = ["spell"]
