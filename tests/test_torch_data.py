"""The port's data layer against the reference's: synthetic data and the
streaming order bit for bit, eval padding, the CIFAR binary reader, and
the training augmentation given the reference's own random draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resnet.data import augment as ref_aug
from tpu_resnet.data import cifar as ref_cifar
from tpu_resnet.data import pipeline as ref_pipeline
from tpu_resnet_torch import data as data_lib
from tpu_resnet_torch.config import load_config
from tpu_resnet_torch.data import augment as aug
from tpu_resnet_torch.data import cifar, pipeline


@pytest.mark.parametrize("kw", [
    dict(learnable=False), dict(learnable=True, task="bands"),
    dict(learnable=True, task="freq100", num_classes=100, label_noise=0.1),
    dict(learnable=True, task="freq100", num_classes=20, seed=3)])
def test_synthetic_data_is_the_references(kw):
    args = dict(num_examples=64, image_size=32, **kw)
    got, want = cifar.synthetic_data(**args), ref_cifar.synthetic_data(**args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("overrides", [
    ["data.dataset=synthetic"],
    ["data.dataset=synthetic", "data.synthetic_learnable=true",
     "data.synthetic_train_examples=96", "data.synthetic_eval_examples=50"]])
def test_load_split_is_the_references(overrides):
    cfg = load_config("cifar10", "", overrides)
    for train in (True, False):
        for g, w in zip(cifar.load_split(cfg.data, train),
                        ref_cifar.load_split(cfg.data, train)):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("start_step", [0, 5, 11])
def test_sharded_batcher_order_is_the_references(start_step):
    """Three epochs of 40 examples in batches of 8 (5 per epoch), from the
    start and from mid-epoch steps."""
    images, labels = ref_cifar.synthetic_data(40, 8, 10)
    got = iter(pipeline.ShardedBatcher(images, labels, 8, seed=3,
                                       start_step=start_step))
    want = iter(ref_pipeline.ShardedBatcher(images, labels, 8, seed=3,
                                            process_index=0, process_count=1,
                                            start_step=start_step))
    for _ in range(15):
        (gi, gl), (wi, wl) = next(got), next(want)
        assert np.array_equal(gi, wi) and np.array_equal(gl, wl)


def test_train_batches_resume_mid_stream():
    cfg = load_config("smoke", "", ["data.synthetic_train_examples=48"])
    whole = data_lib.train_batches(cfg.data, 16, seed=1)
    skipped = [next(whole) for _ in range(4)]
    resumed = data_lib.train_batches(cfg.data, 16, seed=1, start_step=4)
    assert len(skipped) == 4
    for _ in range(5):
        (a, b), (c, d) = next(whole), next(resumed)
        assert np.array_equal(a, c) and np.array_equal(b, d)


def test_eval_batches_pad_with_minus_one():
    images, labels = ref_cifar.synthetic_data(10, 8, 10)
    got = list(pipeline.eval_batches(images, labels, 4))
    want = list(ref_pipeline.eval_batches(images, labels, 4))
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        assert np.array_equal(gi, wi) and np.array_equal(gl, wl)
    assert list(got[-1][1][2:]) == [-1, -1] and not got[-1][0][2:].any()


def test_eval_split_batches_cover_the_split():
    cfg = load_config("smoke", "", ["data.synthetic_eval_examples=30",
                                    "data.synthetic_learnable=true"])
    batches = list(data_lib.eval_split_batches(cfg.data, 8))
    labels = np.concatenate([lab for _, lab in batches])
    assert len(batches) == 4 and (labels >= 0).sum() == 30


@pytest.mark.parametrize("dataset", ["cifar10", "cifar100"])
def test_cifar_binary_reader(tmp_path, dataset):
    rng = np.random.default_rng(0)
    off = 1 if dataset == "cifar100" else 0
    names = (["train.bin"] if dataset == "cifar100"
             else [f"data_batch_{i}.bin" for i in range(1, 6)])
    for name in names:
        rng.integers(0, 256, (3, 1 + off + 3072), dtype=np.uint8).tofile(
            tmp_path / name)
    got = cifar.load_cifar(dataset, str(tmp_path), train=True)
    want = ref_cifar.load_cifar(dataset, str(tmp_path), train=True,
                                use_native=False)
    assert got[0].shape == (3 * len(names), 32, 32, 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        cifar.load_cifar(dataset, str(tmp_path), train=False)


def test_crop_flip_equals_the_reference_given_its_draws():
    """The offsets and flips jax.random draws inside the reference's
    _random_crop_batch/_random_flip_batch for a fixed key, fed to
    crop_flip: the same images."""
    images = np.random.default_rng(1).integers(
        0, 256, (16, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    rng_crop, rng_flip = jax.random.split(key)
    want = ref_aug._random_flip_batch(
        rng_flip, ref_aug._random_crop_batch(rng_crop, jnp.asarray(images),
                                             pad=2))
    rng_h, rng_w = jax.random.split(rng_crop)
    off_h = np.array(jax.random.randint(rng_h, (16,), 0, 5))
    off_w = np.array(jax.random.randint(rng_w, (16,), 0, 5))
    flip = np.array(jax.random.bernoulli(rng_flip, 0.5, (16, 1, 1, 1)))
    assert flip.any() and not flip.all() and len(set(off_h)) > 1
    got = aug.crop_flip(torch.from_numpy(images), torch.from_numpy(off_h),
                        torch.from_numpy(off_w),
                        torch.from_numpy(flip.reshape(16)))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_standardization_matches_the_reference():
    images = np.random.default_rng(2).integers(0, 256, (4, 32, 32, 3))
    images[1] = 7   # a constant image: TF's 1/sqrt(N) floor on the std
    got = aug.per_image_standardization(torch.from_numpy(images))
    want = ref_aug.per_image_standardization(jnp.asarray(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_augmentation_repeats_for_the_same_seed_and_step():
    images = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (8, 32, 32, 3), dtype=np.uint8))
    a = aug.cifar_train_augment(images, aug.step_key(0, 7))
    b = aug.cifar_train_augment(images, aug.step_key(0, 7))
    c = aug.cifar_train_augment(images, aug.step_key(0, 8))
    d = aug.cifar_train_augment(images, aug.step_key(1, 7))
    assert a.dtype == torch.float32 and a.shape == (8, 32, 32, 3)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    means = a.mean(dim=(1, 2, 3))
    assert float(means.abs().max()) < 1e-5


def test_background_iterator_relays_items_errors_and_stop():
    it = pipeline.BackgroundIterator(iter(range(5)), capacity=2)
    assert list(it) == [0, 1, 2, 3, 4]

    def broken():
        yield 1
        raise OSError("disk gone")

    it = pipeline.BackgroundIterator(broken())
    assert next(it) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    import threading
    stop = threading.Event()

    def stalled():
        yield 1
        stop.wait(30)

    it = pipeline.BackgroundIterator(stalled(), external_stop=stop)
    assert next(it) == 1
    stop.set()
    with pytest.raises(StopIteration):
        next(it)
    it.close()
