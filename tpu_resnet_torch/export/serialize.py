"""Frozen inference artifacts (port of ``tpu_resnet/export/serialize.py``).

The reference freezes a checkpoint into a serialized StableHLO program
(``jax.export``) beside a JSON manifest. The port freezes the same function,
eval preprocessing then the model, with ``torch.export`` into one file that
loads without the model's code:

    bundle = load_inference(out_dir)          # on CUDA unless device="cpu"
    logits = bundle(images_uint8)             # numpy float32 [B, classes]

An export directory holds ``manifest.json`` (the reference's keys, with
``"format": "torch.export"``) and ``inference.pt2``
(``torch.export.save``). ``batch_size=0`` exports a dynamic batch dimension,
``Dim("b", min=1, max=MAX_DYNAMIC_BATCH)``, traced on an example of 2 (an
example of 1 would specialize it); a fixed size pins it.

The kernels are inside the artifact: while ``torch.export`` traces, the
wrappers of ``sbr``, ``block_fwd`` and ``bottleneck_fwd`` call their custom
ops (``ops/_library.py``), so each call is one node of the program, and a
loaded program on the card launches the CUDA kernels, counted as an eager
forward's are. The artifact keeps the device it was traced on; loading it
for another device moves it there (``move_to_device_pass``) or raises.

A quantized bundle (``serve.quantize=int8``) freezes the int8 arm
(``ops.quant.QuantizedModel``): the int8 codes and the float32 scales are
tensors of the program, the dequantization graph operations, so the file
holds about 0.25x the float32 bytes; the manifest records the calibration
digest, and ``weight_bytes`` is ``quant.tree_argument_bytes`` of the tree
the program holds, as the reference's is of its argument tree.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from tpu_resnet_torch.ops import quant as quant_lib
from tpu_resnet_torch.serve.infer import ServeProgram, serve_model

MANIFEST = "manifest.json"
ARTIFACT = "inference.pt2"
FORMAT = "torch.export"
# The largest batch a dynamic-batch artifact takes.
MAX_DYNAMIC_BATCH = 1024


def _canonical(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _device_of(tensors) -> Optional[torch.device]:
    for t in tensors:
        if isinstance(t, torch.Tensor):
            return t.device
    return None


def make_inference_program(cfg, model: torch.nn.Module) -> ServeProgram:
    """uint8 [B,H,W,3] → logits: eval preprocessing baked in before
    ``model`` (the configured model with its weights, or its int8 arm)."""
    return ServeProgram(model, cfg.data.dataset).eval()


def save_inference(cfg, model: torch.nn.Module, out_dir: str,
                   batch_size: int = 0, step: Optional[int] = None,
                   calibration: Optional[dict] = None) -> str:
    """Freeze ``model`` (the configured model with its weights, on the
    device to trace on) into ``out_dir``. ``step``, where known, goes into
    the manifest (the ``serve_model_step`` gauge of a frozen bundle).
    ``cfg.serve.quantize="int8"`` freezes the int8 arm, with the input
    scale of ``calibration`` (a ``serve/calibrate.py`` record; collected on
    the spot when None)."""
    os.makedirs(out_dir, exist_ok=True)
    quantize = cfg.serve.quantize
    quant_lib.check_quantize_config(cfg)
    device = _device_of(model.state_dict().values()) or torch.device("cpu")
    calibration_digest = ""
    act_max = None
    if quantize == "int8":
        if calibration is None:
            from tpu_resnet_torch.serve import calibrate

            calibration = calibrate.collect_ranges(cfg, device=device)
        calibration_digest = calibration["digest"]
        act_max = float(calibration["act_max"]["input"])
    served = serve_model(cfg, model, device, act_max=act_max)
    weights = served.qvars() if quantize == "int8" else served.state_dict()
    size = cfg.data.resolved_image_size
    example = torch.zeros((batch_size or 2, size, size, 3), dtype=torch.uint8,
                          device=device)
    dynamic = None if batch_size else {"images": {0: torch.export.Dim(
        "b", min=1, max=MAX_DYNAMIC_BATCH)}}
    with torch.no_grad():
        exported = torch.export.export(make_inference_program(cfg, served),
                                       (example,), dynamic_shapes=dynamic,
                                       strict=False)
    torch.export.save(exported, os.path.join(out_dir, ARTIFACT))
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump({
            "format": FORMAT,
            "model": cfg.model.name,
            "resnet_size": cfg.model.resnet_size,
            "dataset": cfg.data.dataset,
            "num_classes": cfg.data.num_classes,
            "image_size": size,
            "batch_size": batch_size or "dynamic",
            "input": "uint8 NHWC, raw pixels (preprocessing baked in)",
            "output": "float32 logits",
            "step": step if step is not None else -1,
            "quantize": quantize,
            "calibration_digest": calibration_digest,
            # The int8 tree lives in the artifact itself.
            "weights": ARTIFACT if quantize == "int8" else "",
            "weight_bytes": quant_lib.tree_argument_bytes(weights),
        }, f, indent=2)
    return out_dir


class InferenceBundle:
    """A loaded frozen program on ``device``: ``bundle(images)`` → numpy
    float32 logits, ``bundle.logits(images)`` → the tensor on the device,
    ``bundle.predict(images)`` → top-1 indices."""

    def __init__(self, exported, manifest: dict, device: torch.device):
        self.exported = exported
        self.manifest = manifest
        self.device = device
        self._module = exported.module()

    def logits(self, images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images, np.uint8))
        with torch.inference_mode():
            return self._module(images.to(self.device, non_blocking=True))

    def __call__(self, images) -> np.ndarray:
        return self.logits(images).float().cpu().numpy()

    def predict(self, images) -> np.ndarray:
        return np.argmax(self(images), axis=-1)


def load_inference(out_dir: str, device=None) -> InferenceBundle:
    """Load an export directory onto ``device`` (the artifact's own device
    when None). Importing ``tpu_resnet_torch.ops`` first registers the
    kernels' custom ops, which the program calls."""
    import tpu_resnet_torch.ops  # noqa: F401

    with open(os.path.join(out_dir, MANIFEST)) as f:
        manifest = json.load(f)
    exported = torch.export.load(os.path.join(out_dir, ARTIFACT))
    own = _device_of([*exported.state_dict.values(),
                      *exported.constants.values()])
    device = _canonical(device if device is not None else own or "cpu")
    if own is not None and own != device:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, device)
    return InferenceBundle(exported, manifest, device)


def export_from_checkpoint(cfg, out_dir: str, step: Optional[int] = None,
                           batch_size: int = 0, device=None) -> str:
    """Checkpoint of ``cfg.train.train_dir`` (the newest, or ``step``) →
    frozen artifact, traced on ``device`` (CUDA unless ``"cpu"``). The
    int8 arm calibrates beside the checkpoints (load or collect), so a
    quantized export and a quantized live replica of one train dir carry
    the same digest."""
    from tpu_resnet_torch.device import resolve_device
    from tpu_resnet_torch.models import build_model
    from tpu_resnet_torch.train import checkpoint as ckpt

    device = resolve_device(device)
    train_dir = cfg.train.train_dir
    if step is None:
        step = ckpt.latest_step_in(train_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {train_dir}")
    model = ckpt.load_state(build_model(cfg), ckpt.restore(train_dir, step))
    calibration = None
    if cfg.serve.quantize == "int8":
        from tpu_resnet_torch.serve import calibrate

        calibration = calibrate.ensure_calibration(cfg, train_dir,
                                                   device=device)
    return save_inference(cfg, model.to(device), out_dir,
                          batch_size=batch_size, step=int(step),
                          calibration=calibration)
