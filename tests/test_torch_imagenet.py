"""The port's ImageNet ResNet against the reference flax model: the stem
(space-to-depth and plain) and the SAME max-pool alone, ResNet-50 as a whole
with converted weights for every combination of the switches, the parameter
counts of all six sizes, and the ImageNet serve path on the CPU."""

import json
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.config import load_config as ref_load_config
from tpu_resnet.models import build_model as ref_build_model
from tpu_resnet.models import resnet as jax_resnet
from tpu_resnet_torch import convert
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.models import build_model, imagenet_resnet_v2
from tpu_resnet_torch.models.resnet import ImagenetStem, max_pool_same
from tpu_resnet_torch.ops import fused_bottleneck as fbn
from tpu_resnet_torch.serve.server import PredictServer
from tpu_resnet_torch.train import checkpoint as ckpt

SIZE = 64    # 64x64 input: stages at 16, 8, 4 and 2 pixels
BATCH = 2


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


# ------------------------------------------------------------ stem, pool
@pytest.mark.parametrize("size", [112, 6, 7])
def test_max_pool_same_matches_reference(size):
    # Distinct values: a window shifted by one row or column picks another.
    x = np.random.default_rng(size).permutation(
        2 * size * size * 4).reshape(2, size, size, 4).astype(np.float32)
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                  padding="SAME"))
    got = max_pool_same(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size, space_to_depth", [
    (112, True), (112, False), (33, True)])
def test_stem_matches_reference(size, space_to_depth):
    rng = np.random.default_rng(size)
    x = rng.normal(size=(1, size, size, 3)).astype(np.float32)
    ref = (jax_resnet.SpaceToDepthStem(64, jnp.float32) if space_to_depth
           else jax_resnet.ConvFixedPadding(64, 7, 2, jnp.float32))
    params = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(ref.apply(params, jnp.asarray(x)))
    stem = ImagenetStem(3, 64, space_to_depth)
    stem.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(
        np.asarray(params["params"]["conv"]["kernel"]).transpose(3, 2, 0, 1)))})
    with torch.inference_mode():
        got = stem(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, (size + 1) // 2, (size + 1) // 2, 64)
    # float32; 147 products per output summed in another order.
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ ResNet-50
@pytest.fixture(scope="module")
def reference():
    """Randomized ResNet-50 variables, the input, and the reference's XLA
    logits for each stem form."""
    x = np.random.default_rng(0).normal(size=(BATCH, SIZE, SIZE, 3)).astype(
        np.float32)
    model = jax_resnet.imagenet_resnet_v2(50, 1000, dtype=jnp.float32)
    variables = _randomize(jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)), seed=1)
    want = {}
    for s2d in (True, False):
        ref = jax_resnet.imagenet_resnet_v2(50, 1000, dtype=jnp.float32,
                                            stem_space_to_depth=s2d)
        want[s2d] = np.asarray(ref.apply(variables, jnp.asarray(x),
                                         train=False))
    return variables, x, want


@pytest.mark.parametrize("stem_space_to_depth", [True, False])
@pytest.mark.parametrize("fused_blocks", [False, True])
@pytest.mark.parametrize("fused_epilogue", ["off", "on"])
def test_rn50_logits_match_reference(reference, fused_blocks, fused_epilogue,
                                     stem_space_to_depth):
    variables, x, want = reference
    port = imagenet_resnet_v2(50, 1000, dtype=torch.float32,
                              stem_space_to_depth=stem_space_to_depth,
                              fused_blocks=fused_blocks,
                              fused_epilogue=fused_epilogue)
    port.load_state_dict(convert.flax_to_torch(variables), strict=True)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (BATCH, 1000)
    # float32 end to end over 50 layers; sums in another order than XLA's.
    np.testing.assert_allclose(got, want[stem_space_to_depth], atol=1e-4,
                               rtol=1e-4)


def test_rn50_fused_dispatch(monkeypatch):
    """fused_blocks runs the 2 + 3 + 5 stride-1 identity bottlenecks of
    width 64/128/256 through the fused wrapper; block0s and the width-512
    stage stay plain."""
    widths = []

    def spy(x, *rest):
        widths.append(rest[0].shape[1])
        return fbn.bottleneck_fwd_reference(x, *rest)

    monkeypatch.setattr(fbn, "bottleneck_fwd", spy)
    port = imagenet_resnet_v2(50, 10, dtype=torch.float32, fused_blocks=True)
    with torch.inference_mode():
        port.eval()(torch.zeros(1, 32, 32, 3))
    assert widths == [64] * 2 + [128] * 3 + [256] * 5


@pytest.mark.parametrize("size", [18, 34, 50, 101, 152, 200])
def test_imagenet_param_counts_match_reference(size):
    cfg = load_config("imagenet", "", [f"model.resnet_size={size}"])
    ref = ref_build_model(cfg)
    shapes = jax.eval_shape(
        lambda: ref.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                         train=False))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree.leaves(shapes["params"]))
    got = sum(p.numel() for p in build_model(cfg).parameters())
    assert got == want
    if size == 50:
        assert got == 25_549_352


def test_rn50_fused_and_plain_share_names():
    names = {n for n, _ in imagenet_resnet_v2(50, 1000).state_dict().items()}
    assert set(imagenet_resnet_v2(50, 1000, fused_blocks=True)
               .state_dict()) == names


# ------------------------------------------------------------ serving
SERVE_OVERRIDES = [f"data.image_size={SIZE}", "model.compute_dtype=float32",
                   "model.fused_blocks=true", "model.fused_epilogue=on",
                   "serve.host=127.0.0.1", "serve.port=0", "serve.max_batch=2",
                   "serve.reload_interval_secs=0"]


def test_imagenet_server_answers_like_direct_call(tmp_path):
    overrides = SERVE_OVERRIDES + [f"train.train_dir={tmp_path}"]
    cfg = load_config("imagenet", "", overrides)
    ref_cfg = ref_load_config("imagenet", "", overrides)
    assert cfg.to_dict() == ref_cfg.to_dict()
    ref = ref_build_model(ref_cfg)
    variables = _randomize(jax.device_get(ref.init(
        jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 3)), train=False)),
        seed=2)
    model = build_model(cfg)
    model.load_state_dict(convert.flax_to_torch(variables))
    ckpt.save(str(tmp_path), 4, model)
    images = np.random.default_rng(3).integers(
        0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)
    srv = PredictServer(cfg, device="cpu")
    try:
        srv.start()
        assert srv.buckets == (1, 2)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/predict?logits=1",
            data=images.tobytes(),
            headers={"Content-Type": "application/octet-stream",
                     "X-Shape": f"3,{SIZE},{SIZE},3"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["count"] == 3 and out["model_step"] == 4
        x = torch.from_numpy(images).float() / 255.0 - torch.tensor(
            (123.68 / 255.0, 116.78 / 255.0, 103.94 / 255.0))
        with torch.inference_mode():
            direct = model.eval()(x).numpy()
        # The same float32 model and preprocessing: the server ran batches
        # of 2 and 1, the direct call one of 3, and no image's sums depend
        # on the others in its batch.
        np.testing.assert_allclose(out["logits"], direct, atol=1e-5,
                                   rtol=1e-5)
        assert out["predictions"] == direct.argmax(-1).tolist()
        assert srv.drain(10.0) is True
    finally:
        srv.close()
