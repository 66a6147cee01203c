"""The port's device-resident training split and augmentation draws
against the reference's (``tpu_resnet/data/device_data.py``,
``tpu_resnet/data/augment.py``): the same policy, the same per-epoch order
of the same images, and the same crops and flips per step, so that a port
run under the default ``data.device_resident=auto`` trains on the
reference's batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.config import PRESETS, load_config as ref_load_config
from tpu_resnet.data import augment as ref_aug
from tpu_resnet.data import device_data as ref_dd
from tpu_resnet.parallel import create_mesh
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.data import augment as aug
from tpu_resnet_torch.data import device_data as dd
from tpu_resnet_torch.data.cifar import synthetic_data
from tpu_resnet_torch.train import loop


def _mesh():
    return create_mesh(ref_load_config("smoke").mesh,
                       devices=jax.devices()[:1])


def _outcome(fn, data_cfg):
    try:
        return fn(data_cfg)
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("policy", ["off", "auto", "on"])
def test_should_use_matches_reference(preset, policy):
    overrides = [f"data.device_resident={policy}"]
    got = _outcome(dd.should_use, load_config(preset, "", overrides).data)
    want = _outcome(ref_dd.should_use,
                    ref_load_config(preset, "", overrides).data)
    assert got == want


def test_should_use_size_limit():
    cfg = load_config("cifar10")   # 2 * 50000 * 32 * 32 * 3 bytes
    assert dd.should_use(cfg.data)
    cfg.data.resident_max_bytes = 2 * 50000 * 32 * 32 * 3 - 1
    assert not dd.should_use(cfg.data)
    cfg.data.device_resident = "on"
    assert dd.should_use(cfg.data)


def _both(images, labels, batch, seed):
    ref = ref_dd.DeviceDataset(_mesh(), images, labels, batch, seed=seed)
    port = dd.DeviceDataset(images, labels, batch, "cpu", seed=seed)
    return ref, port


@pytest.mark.parametrize("n, batch", [(100, 16), (5, 16)],
                         ids=["split", "tiny_split_tiled"])
def test_two_epochs_match_reference(n, batch):
    images, labels = synthetic_data(n, 8, 10, seed=4)
    ref, port = _both(images, labels, batch, seed=11)
    assert (port.n, port.steps_per_epoch) == (ref.n, ref.steps_per_epoch)
    spe = port.steps_per_epoch
    for epoch in (0, 1):
        ref.ensure_epoch(epoch)
        want_i = np.asarray(jax.device_get(ref.images))
        want_l = np.asarray(jax.device_get(ref.labels))
        for i in range(spe):
            got_i, got_l = port.batch_at(epoch * spe + i)
            np.testing.assert_array_equal(got_i.numpy(), want_i[i])
            np.testing.assert_array_equal(got_l.numpy(), want_l[i])


def test_resume_at_an_epoch_boundary_gets_the_same_batches():
    images, labels = synthetic_data(64, 8, 10, seed=5)
    whole = dd.DeviceDataset(images, labels, 16, "cpu", seed=2)
    run = [whole.batch_at(s) for s in range(8)]
    resumed = dd.DeviceDataset(images, labels, 16, "cpu", seed=2)
    for s in range(4, 8):     # epoch 1 starts at step 4
        for got, want in zip(resumed.batch_at(s), run[s]):
            assert torch.equal(got, want)
    assert not torch.equal(run[0][1], run[4][1])


@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_cifar_train_augment_matches_reference(step):
    """The crops and flips of step ``step`` bit for bit (the reference's
    pipeline before its standardization), and the standardized output
    within 2e-6: the reference's float32 mean and std over 3072 values are
    themselves up to 1.7e-6 from the float64 result on the CPU, the port's
    2.6e-7."""
    images = np.random.default_rng(6).integers(0, 256, (32, 32, 32, 3),
                                               dtype=np.uint8)
    seed = 3
    base = jax.random.split(jax.random.PRNGKey(seed))[1]
    rng = jax.random.fold_in(base, step)
    rng_crop, rng_flip = jax.random.split(rng)
    want_crop = ref_aug._random_flip_batch(rng_flip, ref_aug._random_crop_batch(
        rng_crop, jnp.asarray(images, jnp.float32), pad=2))
    off_h, off_w, flip = (torch.from_numpy(a) for a in aug.cifar_draws(
        aug.step_key(seed, step), 32))
    assert 0 < int(flip.sum()) < 32 and len(set(off_h.tolist())) > 1
    got_crop = aug.crop_flip(torch.from_numpy(images).float(), off_h, off_w,
                             flip)
    np.testing.assert_array_equal(got_crop.numpy(), np.asarray(want_crop))
    want = ref_aug.cifar_train_augment(rng, jnp.asarray(images))
    got = aug.cifar_train_augment(torch.from_numpy(images),
                                  aug.step_key(seed, step))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)


def test_train_feeds_the_reference_batches(tmp_path, monkeypatch):
    """``train()`` on the cifar10 preset's defaults (synthetic data) takes
    the resident path and feeds step s the reference's batch s, across an
    epoch boundary."""
    cfg = load_config("cifar10", "", [
        "data.dataset=synthetic", "data.synthetic_train_examples=48",
        "train.global_batch_size=16", "model.resnet_size=8",
        "train.train_steps=5", "train.checkpoint_every=100",
        f"train.train_dir={tmp_path}"])
    fed = []

    def recording_step(state, images, labels):
        fed.append((images.clone(), labels.clone()))
        state.step += 1
        zero = torch.zeros(())
        return {"loss": zero, "precision": zero, "learning_rate": 0.0,
                "grad_norm": zero}

    monkeypatch.setattr(loop, "build_step",
                        lambda cfg, device, mesh, update: recording_step)
    loop.train(cfg, device="cpu")
    from tpu_resnet.data import load_split
    images, labels = load_split(ref_load_config("cifar10", "", [
        "data.dataset=synthetic", "data.synthetic_train_examples=48"]).data,
        train=True)
    ref = ref_dd.DeviceDataset(_mesh(), images, labels, 16,
                               seed=cfg.train.seed)
    assert len(fed) == 5 and ref.steps_per_epoch == 3
    for step, (got_i, got_l) in enumerate(fed):
        ref.ensure_epoch(step // 3)
        np.testing.assert_array_equal(
            got_i.numpy(), np.asarray(jax.device_get(ref.images))[step % 3])
        np.testing.assert_array_equal(
            got_l.numpy(), np.asarray(jax.device_get(ref.labels))[step % 3])
