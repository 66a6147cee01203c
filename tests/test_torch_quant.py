"""The port's int8 arm against the reference's on the CPU: the codes,
scales and activation math bit for bit after the layout mapping, the
quantized trees of a converted ResNet-8 and of the MLP, the config guards'
messages, the calibration record and its digest, the int8 logits against
the reference's int8 ``make_serve_infer``, the reference's argmax gate on
the MLP, and the trees' bytes."""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.data.augment import get_augment_fns
from tpu_resnet.data.cifar import synthetic_data
from tpu_resnet.models import build_model as ref_build_model
from tpu_resnet.ops import quant as ref_quant
from tpu_resnet.serve import calibrate as ref_calibrate
from tpu_resnet.serve.infer import make_serve_infer as ref_make_serve_infer
from tpu_resnet_torch import convert
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.data.augment import get_eval_preprocess
from tpu_resnet_torch.models import build_model
from tpu_resnet_torch.ops import quant
from tpu_resnet_torch.serve import calibrate
from tpu_resnet_torch.serve.infer import make_serve_infer, serve_model

RESNET8 = ["model.resnet_size=8", "model.compute_dtype=float32",
           "model.fused_epilogue=on"]


def _cfgs(preset, overrides):
    return (load_config(preset, "", overrides),
            ref_load_config(preset, "", overrides))


def _reference_variables(ref_cfg, seed=0):
    model = ref_build_model(ref_cfg)
    size = ref_cfg.data.resolved_image_size
    variables = jax.tree.map(np.asarray, jax.device_get(model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
        train=False)))
    return {"batch_stats": {}, **variables}   # the MLP has no statistics


def _port_model(cfg, variables):
    model = build_model(cfg)
    model.load_state_dict(convert.flax_to_torch(variables))
    return model.eval()


def _keystr_name(keystr: str) -> str:
    """The port's parameter name of a reference kernel's ``keystr`` path."""
    path = tuple(re.findall(r"\['([^']+)'\]", keystr))
    rank = 4 if path[-2] == "conv" else 2
    return convert._map_leaf("params", path, np.zeros((1,) * rank))[0]


# ------------------------------------------------------------------ math
@pytest.mark.parametrize("ref_shape, axes", [
    ((3, 3, 8, 16), (3, 2, 0, 1)),     # HWIO conv → OIHW
    ((1, 1, 16, 32), (3, 2, 0, 1)),
    ((64, 10), (1, 0)),                # [in, out] dense → [out, in]
    ((3072, 100), (1, 0)),
])
def test_quantize_leaf_is_the_reference_bit_for_bit(ref_shape, axes):
    rng = np.random.default_rng(sum(ref_shape))
    w = (rng.standard_normal(ref_shape)
         * rng.uniform(0.01, 3.0, ref_shape[-1])).astype(np.float32)
    w[..., 1] = 0.0                    # an all-zero channel: scale 1.0
    w[..., 2] = np.float32(0.5) * 127  # codes at the half: round to even
    w[(0,) * (len(ref_shape) - 1) + (2,)] = -127.0 * 2
    ref_q, ref_s = ref_quant.quantize_leaf(jnp.asarray(w))
    q, s = quant.quantize_leaf(torch.from_numpy(w.transpose(axes)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(ref_q).transpose(axes))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    assert float(s[1]) == 1.0
    back = quant.dequant_leaf(q, s).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(ref_quant.dequant_leaf(ref_q, ref_s))
        .transpose(axes))


@pytest.mark.parametrize("amax", [0.0, 1e-30, 0.7, 2.1136, 127.0, 3e5])
def test_act_scale_and_fake_quant_are_the_reference(amax):
    scale = quant.act_scale_from_max(amax)
    ref_scale = ref_quant.act_scale_from_max(amax)
    assert scale.dtype == torch.float32
    assert scale.item() == float(ref_scale)
    x = (np.random.default_rng(1).standard_normal((4, 8, 8, 3))
         * max(amax, 1.0)).astype(np.float32)
    x[0, 0, 0, :] = (np.arange(3) + 0.5) * float(ref_scale)  # halves
    np.testing.assert_array_equal(
        quant.fake_quant(torch.from_numpy(x), scale).numpy(),
        np.asarray(ref_quant.fake_quant(jnp.asarray(x), ref_scale)))


# ----------------------------------------------------------------- trees
@pytest.mark.parametrize("preset, overrides", [
    ("cifar10", RESNET8), ("smoke", ["model.name=mlp"])],
    ids=["resnet8", "mlp"])
def test_quantize_variables_match_the_reference(preset, overrides):
    cfg, ref_cfg = _cfgs(preset, overrides)
    variables = _reference_variables(ref_cfg)
    ref_q = ref_quant.quantize_variables(variables, act_max=2.5)
    state = _port_model(cfg, variables).state_dict()
    qvars = quant.quantize_variables(state, act_max=2.5)

    ref_scales = {_keystr_name(k): np.asarray(v)
                  for k, v in ref_q[ref_quant.QSCALES_KEY].items()}
    assert set(qvars[quant.QSCALES_KEY]) == set(ref_scales)
    for name, s in qvars[quant.QSCALES_KEY].items():
        np.testing.assert_array_equal(s.numpy(), ref_scales[name])
    # The codes, mapped as the converter maps the float32 tree.
    ref_codes = convert.flax_to_torch(
        {"params": jax.tree.map(np.asarray, ref_q["params"])})
    for name, t in qvars["params"].items():
        if name in ref_scales:
            assert t.dtype == torch.int8
            np.testing.assert_array_equal(t.float().numpy(),
                                          ref_codes[name].numpy())
        else:
            assert torch.equal(t, state[name])
    assert qvars[quant.QACT_KEY]["input"].item() == \
        float(ref_q[ref_quant.QACT_KEY]["input"])
    assert quant.tree_argument_bytes(qvars) == \
        ref_quant.tree_argument_bytes(ref_q)
    assert quant.tree_argument_bytes(state) == \
        ref_quant.tree_argument_bytes(variables)
    assert quant.tree_argument_bytes(qvars) <= \
        0.30 * quant.tree_argument_bytes(state)
    back = quant.dequantize_variables(qvars)
    ref_back = convert.flax_to_torch(jax.tree.map(
        np.asarray, ref_quant.dequantize_variables(ref_q)))
    for name, t in back.items():
        np.testing.assert_array_equal(t.numpy(), ref_back[name].numpy())


def test_check_quantize_config_messages_are_the_reference():
    for mode, data_axis, sync_bn in (("int4", 1, False), ("int8", 2, False)):
        cfg, ref_cfg = _cfgs("cifar10", [f"serve.quantize={mode}",
                                         f"model.sync_bn={sync_bn}"])
        with pytest.raises(ValueError) as ref_err:
            ref_quant.check_quantize_config(ref_cfg, data_axis=data_axis)
        with pytest.raises(ValueError) as err:
            quant.check_quantize_config(cfg, data_axis=data_axis)
        assert str(err.value) == str(ref_err.value)
    cfg, _ = _cfgs("cifar10", ["serve.quantize=int8", "model.sync_bn=true"])
    quant.check_quantize_config(cfg, data_axis=2)


# ----------------------------------------------------------- calibration
def test_calibration_record_and_digest_are_the_reference(tmp_path):
    overrides = ["serve.calibration_batches=2", "serve.calibration_batch=16",
                 "data.dataset=synthetic"]
    cfg, ref_cfg = _cfgs("cifar10", overrides)
    record = calibrate.collect_ranges(cfg)
    ref_record = ref_calibrate.collect_ranges(ref_cfg)
    # The reference's digest of the port's record, character for character.
    assert record["digest"] == ref_calibrate.calibration_digest(record)
    assert set(record) == set(ref_record)
    assert {k: v for k, v in record.items()
            if k not in ("act_max", "digest")} == \
        {k: v for k, v in ref_record.items()
         if k not in ("act_max", "digest")}
    # Standardization reduces in another order: the max within float32.
    np.testing.assert_allclose(record["act_max"]["input"],
                               ref_record["act_max"]["input"], rtol=1e-6)
    path = calibrate.write_calibration(record, str(tmp_path))
    assert calibrate.load_calibration(str(tmp_path)) == record
    assert ref_calibrate.load_calibration(str(tmp_path)) == record
    assert calibrate.ensure_calibration(cfg, str(tmp_path)) == record
    with open(path) as f:
        tampered = json.load(f)
    tampered["act_max"]["input"] *= 2
    with open(path, "w") as f:
        json.dump(tampered, f)
    with pytest.raises(ValueError, match="digest mismatch"):
        calibrate.load_calibration(str(tmp_path))
    assert calibrate.ensure_calibration(cfg, str(tmp_path)) == record


# ---------------------------------------------------------------- logits
def test_int8_logits_match_the_reference_int8_infer():
    """The int8 arm of a converted ResNet-8 against the reference's int8
    ``make_serve_infer``. The standardized input is the reference's
    within float32 rounding, so a fake-quant code can flip where x / scale
    sits at a half: the test counts those flips and bounds the logits by
    what they explain (none on this input, so 1e-4)."""
    overrides = RESNET8 + ["serve.quantize=int8"]
    cfg, ref_cfg = _cfgs("cifar10", overrides)
    variables = _reference_variables(ref_cfg, seed=3)
    images, _ = synthetic_data(16, 32, 10, seed=7)
    act_max = 2.75
    ref_logits = np.asarray(ref_make_serve_infer(ref_cfg)(
        ref_quant.quantize_variables(variables, act_max=act_max),
        jnp.asarray(images)))
    model = serve_model(cfg, _port_model(cfg, variables),
                        torch.device("cpu"), act_max=act_max)
    assert isinstance(model, quant.QuantizedModel)
    logits = make_serve_infer(cfg, torch.device("cpu"))(model, images)

    _, ref_pre = get_augment_fns("cifar10")
    scale = float(ref_quant.act_scale_from_max(act_max))
    ref_codes = np.round(np.asarray(ref_pre(jnp.asarray(images))) / scale)
    codes = np.round(get_eval_preprocess("cifar10")(
        torch.from_numpy(images)).numpy() / scale)
    flips = int((codes != ref_codes).sum())
    assert flips == 0, f"{flips} input codes flipped"
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=1e-4,
                               rtol=1e-4)


def test_mlp_int8_argmax_gate():
    """The reference's accuracy gate, held by the port's MLP on the
    reference's weights: argmax agreement with the float32 twin >= 0.99
    and top-1 within 0.005."""
    f32_cfg, ref_cfg = _cfgs("smoke", ["model.name=mlp"])
    q_cfg, _ = _cfgs("smoke", ["model.name=mlp", "serve.quantize=int8"])
    variables = _reference_variables(ref_cfg)
    images, labels = synthetic_data(64, 32, 10, seed=5)
    act_max = float(get_eval_preprocess("synthetic")(
        torch.from_numpy(images)).abs().max())
    device = torch.device("cpu")
    f32 = make_serve_infer(f32_cfg, device)(
        serve_model(f32_cfg, _port_model(f32_cfg, variables), device),
        images).numpy()
    q = make_serve_infer(q_cfg, device)(
        serve_model(q_cfg, _port_model(q_cfg, variables), device,
                    act_max=act_max), images).numpy()
    f32_top1, q_top1 = f32.argmax(1), q.argmax(1)
    assert float(np.mean(q_top1 == f32_top1)) >= 0.99
    assert abs(float(np.mean(q_top1 == labels))
               - float(np.mean(f32_top1 == labels))) <= 0.005
    np.testing.assert_allclose(f32, np.asarray(ref_make_serve_infer(ref_cfg)(
        variables, jnp.asarray(images))), atol=1e-5, rtol=1e-5)
