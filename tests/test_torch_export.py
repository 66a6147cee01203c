"""Frozen ``torch.export`` artifacts on the CPU: save and load against the
live port (unfused and fused CIFAR ResNets, the fused ImageNet ResNet-50 at
32²), the custom-op nodes the fused programs hold (the kernels' places on
the card), one dynamic-batch artifact at B = 1, 3, 16 against the live port
and the reference's ``jax.export`` bundle of the same converted weights,
the manifest's keys, the int8 bundle's bytes against the reference's, and
the export backend (the CLI: ``test_torch_export_cli.py``)."""

import json
import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.export import load_inference as ref_load_inference
from tpu_resnet.export import save_inference as ref_save_inference
from tpu_resnet.models import build_model as ref_build_model
from tpu_resnet.serve import calibrate as ref_calibrate
from tpu_resnet_torch import convert
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.export import load_inference, save_inference
from tpu_resnet_torch.models import build_model, init_weights
from tpu_resnet_torch.ops import _library
from tpu_resnet_torch.serve.backend import ExportBackend
from tpu_resnet_torch.serve.infer import make_serve_infer, serve_model

CPU = torch.device("cpu")
F32 = ["model.compute_dtype=float32"]
FUSED = ["model.fused_blocks=true", "model.fused_epilogue=on"]


def _images(n, size=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


def _op_nodes(bundle) -> Counter:
    """Calls of the kernels' custom ops in a loaded program's graph."""
    return Counter(
        str(node.target).split(".")[1]
        for node in bundle.exported.graph.nodes
        if node.op == "call_function"
        and str(node.target).startswith(f"{_library.NAMESPACE}."))


def _live(cfg, model, images, act_max=None):
    served = serve_model(cfg, model, CPU, act_max=act_max)
    return make_serve_infer(cfg, CPU)(served, images).numpy()


@pytest.mark.parametrize("preset, overrides, ops", [
    ("cifar10", ["model.resnet_size=8"], {}),
    ("cifar10", ["model.resnet_size=8", *FUSED], {"sbr": 7}),
    ("cifar10", ["model.resnet_size=14", *FUSED],
     {"sbr": 7, "block_fwd": 3}),
    ("imagenet", ["data.image_size=32", *FUSED],
     {"sbr": 19, "bottleneck_fwd": 10}),
], ids=["resnet8", "resnet8_fused", "resnet14_fused", "imagenet50_fused"])
def test_artifact_serves_the_live_logits(tmp_path, preset, overrides, ops):
    cfg = load_config(preset, "", F32 + overrides)
    model = init_weights(build_model(cfg),
                         torch.Generator().manual_seed(0)).eval()
    save_inference(cfg, model, str(tmp_path), step=3)
    bundle = load_inference(str(tmp_path))
    assert bundle.device == CPU and bundle.manifest["step"] == 3
    assert dict(_op_nodes(bundle)) == ops
    images = _images(2, cfg.data.resolved_image_size)
    want = _live(cfg, model, images)
    got = bundle(images)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(bundle.predict(images), want.argmax(-1))


@pytest.fixture(scope="module")
def reference_resnet8():
    """Converted reference weights of a fused-epilogue ResNet-8 (float32).
    The reference's config runs its plain epilogue, the same function: its
    Pallas epilogue's tiling cannot be traced over a symbolic batch."""
    overrides = F32 + ["model.resnet_size=8", "model.fused_epilogue=on"]
    ref_cfg = ref_load_config("cifar10", "", F32 + ["model.resnet_size=8"])
    variables = jax.tree.map(np.asarray, jax.device_get(
        ref_build_model(ref_cfg).init(jax.random.PRNGKey(1),
                                      jnp.zeros((1, 32, 32, 3)),
                                      train=False)))
    variables["params"]["final_dense"]["bias"] = np.random.default_rng(
        2).normal(0, 1.0, 10).astype(np.float32)
    cfg = load_config("cifar10", "", overrides)
    model = build_model(cfg)
    model.load_state_dict(convert.flax_to_torch(variables))
    return cfg, ref_cfg, variables, model.eval()


def test_dynamic_artifact_serves_the_reference_bundle(tmp_path,
                                                      reference_resnet8):
    cfg, ref_cfg, variables, model = reference_resnet8
    save_inference(cfg, model, str(tmp_path / "port"))
    ref_save_inference(ref_cfg, variables["params"],
                       variables["batch_stats"], str(tmp_path / "ref"))
    bundle = load_inference(str(tmp_path / "port"))
    ref_bundle = ref_load_inference(str(tmp_path / "ref"))
    assert set(bundle.manifest) == set(ref_bundle.manifest)
    assert bundle.manifest["format"] == "torch.export"
    same = ("model", "resnet_size", "dataset", "num_classes", "image_size",
            "batch_size", "input", "output", "step", "quantize",
            "calibration_digest", "weights", "weight_bytes")
    assert {k: bundle.manifest[k] for k in same} == \
        {k: ref_bundle.manifest[k] for k in same}
    for n in (1, 3, 16):
        images = _images(n, seed=n)
        got = bundle(images)
        want = _live(cfg, model, images)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), n
        np.testing.assert_allclose(got, ref_bundle(images), atol=1e-4,
                                   rtol=1e-4)


def test_fixed_batch_artifact_pins_the_buckets(tmp_path, reference_resnet8):
    cfg, _, _, model = reference_resnet8
    save_inference(cfg, model, str(tmp_path), batch_size=4)
    backend = ExportBackend(str(tmp_path), CPU)
    assert backend.fixed_batch == 4 and backend.model_step == -1
    assert backend.constrain_buckets((1, 2, 4, 8)) == (4,)
    images = _images(4, seed=9)
    np.testing.assert_allclose(backend.infer(images),
                               _live(cfg, model, images), rtol=0, atol=1e-6)
    assert backend.warmup_bucket(4)["bucket"] == 4
    with pytest.raises(Exception):
        backend.infer(_images(3))


def test_quantized_bundle_bytes_are_the_reference(tmp_path,
                                                  reference_resnet8):
    cfg, ref_cfg, variables, model = reference_resnet8
    q_cfg = load_config("cifar10", "", F32 + [
        "model.resnet_size=8", "model.fused_epilogue=on",
        "serve.quantize=int8"])
    ref_q_cfg = ref_load_config("cifar10", "", F32 + [
        "model.resnet_size=8", "serve.quantize=int8"])
    calibration = {"format": ref_calibrate.FORMAT, "dataset": "cifar10",
                   "image_size": 32, "batches": 1, "batch": 64,
                   "act_max": {"input": 2.5}}
    calibration["digest"] = ref_calibrate.calibration_digest(calibration)
    save_inference(cfg, model, str(tmp_path / "f32"))
    save_inference(q_cfg, model, str(tmp_path / "q8"),
                   calibration=calibration)
    ref_save_inference(ref_q_cfg, variables["params"],
                       variables["batch_stats"], str(tmp_path / "ref_q8"),
                       calibration=calibration)
    f32 = load_inference(str(tmp_path / "f32")).manifest
    q8 = load_inference(str(tmp_path / "q8"))
    with open(tmp_path / "ref_q8" / "manifest.json") as f:
        ref_q8 = json.load(f)
    man = q8.manifest
    assert man["quantize"] == "int8"
    assert man["calibration_digest"] == calibration["digest"]
    assert os.path.exists(tmp_path / "q8" / man["weights"])
    assert man["weight_bytes"] == ref_q8["weight_bytes"]
    assert man["weight_bytes"] <= 0.30 * f32["weight_bytes"]
    # The int8 codes are tensors of the program.
    assert any(t.dtype == torch.int8
               for t in q8.exported.state_dict.values()) or any(
        t.dtype == torch.int8 for t in q8.exported.constants.values()
        if isinstance(t, torch.Tensor))
    images = _images(8, seed=4)
    want = _live(q_cfg, model, images, act_max=2.5)
    assert np.abs(q8(images) - want).max() <= 1e-6 * np.abs(want).max()
    backend = ExportBackend(str(tmp_path / "q8"), CPU)
    assert backend.quantize == "int8"
    assert backend.calibration_digest == calibration["digest"]
    assert backend.weight_argument_bytes() == ref_q8["weight_bytes"]
