from tpu_resnet_torch.export.serialize import (
    InferenceBundle,
    export_from_checkpoint,
    load_inference,
    make_inference_program,
    save_inference,
)

__all__ = [
    "InferenceBundle",
    "export_from_checkpoint",
    "load_inference",
    "make_inference_program",
    "save_inference",
]
