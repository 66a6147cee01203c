"""The port's CIFAR ResNet against the reference flax model: same converted
weights, same inputs, eval mode, for every combination of the two fusion
switches; plus the parameter count and the build guards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.models import build_model as ref_build_model
from tpu_resnet.models.resnet import cifar_resnet_v2 as ref_cifar
from tpu_resnet_torch import convert
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.models import (build_model, cifar_resnet_v2,
                                     imagenet_resnet_v2, init_weights)

SIZE = 14   # n=2: block0 (projection) + block1 (fusable) per stage
BATCH = 4


def _randomize(variables, seed):
    """Reference variables with BN parameters and statistics moved off
    their init values, so the BN folds are exercised."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a, np.float32)
        if "'scale'" in name or "'var'" in name:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if "'bn'" in name:   # bias, mean
            return rng.normal(0, 0.2, a.shape).astype(np.float32)
        if "final_dense" in name and "'bias'" in name:
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def reference():
    model = ref_cifar(SIZE, 10, dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(BATCH, 32, 32, 3)).astype(
        np.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           train=False)
    return _randomize(jax.device_get(variables), seed=1), x


def _port(variables, **kw):
    model = cifar_resnet_v2(SIZE, 10, dtype=torch.float32, **kw)
    model.load_state_dict(convert.flax_to_torch(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("fused_blocks", [False, True])
@pytest.mark.parametrize("fused_epilogue", ["off", "on"])
def test_logits_match_reference(reference, fused_blocks, fused_epilogue):
    variables, x = reference
    ref = ref_cifar(SIZE, 10, dtype=jnp.float32, fused_blocks=fused_blocks,
                    fused_epilogue=fused_epilogue)
    want = np.asarray(ref.apply(variables, jnp.asarray(x), train=False))
    port = _port(variables, fused_blocks=fused_blocks,
                 fused_epilogue=fused_epilogue)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (BATCH, 10)
    # float32 end to end; conv sums taken in another order than XLA's.
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_fused_and_plain_blocks_share_names(reference):
    variables, _ = reference
    names = set(convert.flax_to_torch(variables))
    for fused in (False, True):
        assert set(cifar_resnet_v2(SIZE, 10, fused_blocks=fused)
                   .state_dict()) == names


def test_convert_rejects_unknown_leaf(reference):
    variables, _ = reference
    bad = {"params": {**variables["params"],
                      "extra": {"kernel": np.zeros((2, 2), np.float32)}}}
    with pytest.raises(KeyError, match="extra"):
        convert.flax_to_torch(bad)


def test_bf16_logits_close_to_reference(reference):
    variables, x = reference
    ref = ref_cifar(SIZE, 10, dtype=jnp.bfloat16, fused_blocks=True,
                    fused_epilogue="on")
    want = np.asarray(ref.apply(variables, jnp.asarray(x), train=False))
    port = cifar_resnet_v2(SIZE, 10, fused_blocks=True, fused_epilogue="on")
    port.load_state_dict(convert.flax_to_torch(variables))
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x)).numpy()
    # bfloat16 activations: ~3 significant digits per layer, compounded.
    np.testing.assert_allclose(got, want, atol=0.1 * np.abs(want).max())


@pytest.mark.parametrize("overrides", [
    [], ["model.fused_blocks=true", "model.fused_epilogue=on"]])
def test_rn50_param_count_matches_reference(overrides):
    cfg = load_config("cifar10", "", overrides)
    ref = ref_build_model(cfg)
    shapes = jax.eval_shape(
        lambda: ref.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 32, 32, 3)), train=False))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree.leaves(shapes["params"]))
    got = sum(p.numel() for p in build_model(cfg).parameters())
    assert got == want


def test_init_weights_distributions():
    model = init_weights(cifar_resnet_v2(50, 10),
                         torch.Generator().manual_seed(0))
    w = model.block_layer3.block1.conv1.weight     # 64 → 64, 3x3
    fan_in = 9 * 64
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.05
    assert w.abs().max().item() <= 2 / 0.87962566103423978 / np.sqrt(fan_in)
    d = model.final_dense.weight
    assert d.abs().max().item() <= np.sqrt(6 / (64 + 10))
    assert model.final_dense.bias.abs().sum() == 0
    bn = model.block_layer1.block0.preact
    assert bool((bn.weight == 1).all() and (bn.running_var == 1).all())
    again = init_weights(cifar_resnet_v2(50, 10),
                         torch.Generator().manual_seed(0))
    assert torch.equal(again.block_layer3.block1.conv1.weight, w)


@pytest.mark.parametrize("overrides, exc", [
    (["model.width_multiplier=2", "model.fused_blocks=true",
      "model.resnet_size=16"], ValueError),
    (["model.fused_epilogue=auto", "data.dataset=imagenet",
      "model.resnet_size=34", "model.fused_blocks=true"], None),
    (["model.fused_epilogue=sometimes"], ValueError),
    (["data.dataset=imagenet", "model.resnet_size=18",
      "model.fused_blocks=true"], None),
    (["model.name=mlp"], NotImplementedError),
])
def test_build_model_guards(overrides, exc):
    """The build guards; ImageNet ResNet-18/34 with fused_blocks=true (None)
    build, fused where the reference fuses at 224²: stages 1-3's blocks 1..
    fused, the 7²×512 stage's blocks all ``BuildingBlock``, and the
    parameter names those of the unfused model (checkpoints and the
    converter unchanged)."""
    cfg = load_config("cifar10", "", overrides)
    if exc is not None:
        with pytest.raises(exc):
            build_model(cfg)
        return
    from tpu_resnet_torch.models.resnet import (BuildingBlock,
                                                FusedBuildingBlock)
    model = build_model(cfg)
    for i in (1, 2, 3, 4):
        blocks = list(getattr(model, f"block_layer{i}").children())
        assert len(blocks) > 1 and isinstance(blocks[0], BuildingBlock)
        want = BuildingBlock if i == 4 else FusedBuildingBlock
        assert all(type(b) is want for b in blocks[1:]), (i, blocks)
    cfg.model.fused_blocks = False
    unfused = build_model(cfg)
    assert list(model.state_dict()) == list(unfused.state_dict())


@pytest.mark.parametrize("overrides", [
    [], ["model.fused_blocks=true", "model.fused_epilogue=on"],
    ["model.resnet_size=34"]])
def test_build_model_imagenet_preset(overrides):
    model = build_model(load_config("imagenet", "", overrides))
    assert model.stem == "imagenet" and model.final_dense.out_features == 1000


def test_constructor_and_train_guards():
    with pytest.raises(ValueError, match="width_multiplier"):
        cifar_resnet_v2(16, 10, width_multiplier=2, fused_blocks=True)
    with pytest.raises(ValueError, match="6n\\+2"):
        cifar_resnet_v2(15, 10)
    model = cifar_resnet_v2(8, 10, dtype=torch.float32)
    assert model(torch.zeros(2, 32, 32, 3), train=True).shape == (2, 10)
    fused = cifar_resnet_v2(14, 10, fused_blocks=True)
    assert fused(torch.zeros(2, 32, 32, 3), train=True).shape == (2, 10)
    bottleneck = imagenet_resnet_v2(50, 10, fused_blocks=True)
    assert bottleneck(torch.zeros(2, 32, 32, 3), train=True).shape == (2, 10)
