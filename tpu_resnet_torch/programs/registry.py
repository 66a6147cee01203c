"""The reference's program-key spelling (copy of ``spell`` from
``tpu_resnet/programs/registry.py``): the key under which ``flops.json``
and ``memory.json`` file a run's train step, e.g.
``train|cifar10_rn50_bf16|mesh1x1|b128``. The port has no program cache;
the key names the configuration so that both packages' ledgers line up.
"""

from __future__ import annotations

from typing import Dict, Optional


def spell(cfg, mesh_shape: Dict[str, int], kind: str = "train",
          batch: Optional[int] = None) -> str:
    """``kind|<dataset>_<model>_<dtype><variant>|mesh<data>x<model>|b<B>``;
    the variant carries every config dimension that changes the program
    (``_fused``, ``_remat``, ``_ep`` for ``fused_epilogue=on``, ``_nos2d``,
    ``_pr``, the partition when not replicated, ``_q8`` for int8 serving),
    as the reference spells it. ``batch`` overrides
    ``train.global_batch_size``."""
    m = cfg.model
    name = m.name if m.name != "resnet" else f"rn{m.resnet_size}"
    if m.name == "resnet" and m.width_multiplier != 1:
        name = f"wrn{m.resnet_size}_{m.width_multiplier}"
    dataset = cfg.data.dataset
    if dataset == "synthetic" and getattr(cfg.data, "synthetic_classes",
                                          10) != 10:
        dataset = f"synthetic{cfg.data.synthetic_classes}"
    dtype = {"bfloat16": "bf16", "float32": "f32"}.get(
        m.compute_dtype, m.compute_dtype)
    data_axis = mesh_shape.get("data", 1)
    partition = getattr(getattr(cfg, "mesh", None), "partition",
                        "replicated")
    per_replica = (not m.sync_bn) and data_axis > 1
    quantized = (kind == "serve" and getattr(
        getattr(cfg, "serve", None), "quantize", "off") == "int8")
    variant = (("_fused" if m.fused_blocks else "")
               + ("_remat" if m.remat else "")
               + ("_ep" if getattr(m, "fused_epilogue", "off") == "on"
                  else "")
               + ("_nos2d" if dataset.startswith("imagenet")
                  and not getattr(m, "stem_space_to_depth", True) else "")
               + ("_pr" if per_replica else "")
               + (f"_{partition}" if partition != "replicated" else "")
               + ("_q8" if quantized else ""))
    b = batch if batch is not None else cfg.train.global_batch_size
    return (f"{kind}|{dataset}_{name}_{dtype}{variant}"
            f"|mesh{data_axis}x{mesh_shape.get('model', 1)}|b{b}")
