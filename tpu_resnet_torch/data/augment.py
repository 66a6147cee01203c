"""Preprocessing and augmentation on the images' device (port of
``tpu_resnet/data/augment.py``).

CIFAR training (reference ``cifar_train_augment``): a symmetric 2-pixel
zero pad to 36x36, a per-image random 32x32 crop, a p=0.5 horizontal flip
and per-image standardization. The random draws are the reference's own:
the train step's key is ``fold_in(split(PRNGKey(train.seed))[1], step)``
(:func:`step_key`, as ``tpu_resnet/train/loop.py`` and ``train/step.py``
derive it), and :func:`cifar_draws` splits it into the crop offsets and
flips exactly as the reference does, with ``data/prng.py``'s numpy copy of
``jax.random``. The draws are B numbers made on the host; :func:`crop_flip`
applies them on the images' device.

CIFAR eval: ``tf.image.per_image_standardization``, with the population
standard deviation and TF's ``max(std, 1/sqrt(num_elements))`` floor.

ImageNet training (reference ``imagenet_train_augment``; the host has
already random-resized and cropped to 224x224): uint8 → [0, 1], a p=0.5
horizontal flip drawn from the step key, minus the VGG means. As for
CIFAR, the draw (:func:`imagenet_flips`) and the pure function of the flip
mask (:func:`flip_mean_subtract`) are apart.

:class:`StepAugment` is the train step's view of both: ``draws(step, b)``
on the host, ``apply(images, *draws)`` on the device with no host read, so
that a captured step takes its draws from device slots.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from tpu_resnet_torch.data import prng

# CIFAR training's zero pad on each side of H and W; crops start at
# offsets in [0, 2·CIFAR_PAD].
CIFAR_PAD = 2
# Reference vgg_preprocessing.py:37-39, divided by 255.
VGG_MEANS_01 = (123.68 / 255.0, 116.78 / 255.0, 103.94 / 255.0)


def per_image_standardization(images: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] → float32, each image to zero mean and unit std."""
    images = images.float()
    n = images[0].numel()
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    std = images.std(dim=(1, 2, 3), keepdim=True, unbiased=False)
    return (images - mean) / torch.clamp_min(std, 1.0 / math.sqrt(n))


def step_key(seed: int, step: int) -> np.ndarray:
    """The reference train step's augmentation key:
    ``fold_in(split(PRNGKey(seed))[1], step)``."""
    return prng.fold_in(prng.split(prng.prng_key(seed))[1], step)


def cifar_draws(key: np.ndarray, b: int):
    """The reference's CIFAR draws from ``key`` for a batch of ``b``:
    (off_h, off_w) int32 [b] in [0, 2·CIFAR_PAD] and flip bool [b]."""
    crop_key, flip_key = prng.split(key)
    h_key, w_key = prng.split(crop_key)
    span = 2 * CIFAR_PAD + 1
    return (prng.randint(h_key, (b,), 0, span),
            prng.randint(w_key, (b,), 0, span),
            prng.bernoulli(flip_key, 0.5, (b, 1, 1, 1)).reshape(b))


def imagenet_flips(key: np.ndarray, b: int) -> np.ndarray:
    """The reference's ImageNet flip draw from ``key``: bool [b]."""
    return prng.bernoulli(key, 0.5, (b, 1, 1, 1)).reshape(b)


def crop_flip(images: torch.Tensor, off_h: torch.Tensor, off_w: torch.Tensor,
              flip: torch.Tensor) -> torch.Tensor:
    """Zero-pad H and W by ``CIFAR_PAD`` on each side, crop each image back
    to its size at (off_h[i], off_w[i]), then mirror its columns where
    ``flip[i]``. images [B,H,W,C]; off_h, off_w int [B] in
    [0, 2·CIFAR_PAD]; flip bool [B]."""
    b, h, w, _ = images.shape
    p = CIFAR_PAD
    padded = torch.nn.functional.pad(images, (0, 0, p, p, p, p))
    dev = images.device
    rows = off_h.to(dev).long()[:, None] + torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev).expand(b, w)
    cols = torch.where(flip.to(dev)[:, None], w - 1 - cols, cols)
    cols = off_w.to(dev).long()[:, None] + cols
    bidx = torch.arange(b, device=dev)[:, None, None]
    return padded[bidx, rows[:, :, None], cols[:, None, :]]


def cifar_train_augment(images: torch.Tensor,
                        key: np.ndarray) -> torch.Tensor:
    """uint8 [B,32,32,3] → standardized float32: 2-pixel zero pad, random
    32x32 crop, random horizontal flip, per-image standardization, with
    the reference's draws from ``key`` (:func:`cifar_draws`)."""
    return cifar_apply(images, *(torch.from_numpy(a) for a in
                                 cifar_draws(key, images.shape[0])))


@functools.lru_cache(maxsize=None)
def _vgg_means_cached(device: torch.device) -> torch.Tensor:
    return torch.tensor(VGG_MEANS_01, device=device)


def _vgg_means(device: torch.device) -> torch.Tensor:
    """The VGG means as a float32 [3] tensor on ``device``, made once (a
    captured step may not copy them in); made anew while ``torch.export``
    traces, whose fake tensor must not outlive the trace in the cache."""
    if torch.compiler.is_compiling():
        return torch.tensor(VGG_MEANS_01, device=device)
    return _vgg_means_cached(device)


def flip_mean_subtract(images: torch.Tensor,
                       flip: torch.Tensor) -> torch.Tensor:
    """uint8 [B,H,W,3] → float32 in [0, 1], each image's columns mirrored
    where ``flip[i]`` (bool [B]), minus the VGG means."""
    x = images.float() / 255.0
    x = torch.where(flip.to(images.device)[:, None, None, None], x.flip(2), x)
    return x - _vgg_means(images.device)


def imagenet_train_augment(images: torch.Tensor,
                           key: np.ndarray) -> torch.Tensor:
    """uint8 [B,224,224,3], already resized and cropped → a random
    horizontal flip drawn from ``key`` (:func:`imagenet_flips`), in [0, 1]
    minus the VGG means."""
    return flip_mean_subtract(
        images, torch.from_numpy(imagenet_flips(key, images.shape[0])))


def cifar_apply(images: torch.Tensor, off_h: torch.Tensor,
                off_w: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """:func:`cifar_train_augment` given its draws (device tensors)."""
    return per_image_standardization(
        crop_flip(images.float(), off_h, off_w, flip))


class StepAugment:
    """A dataset's training augmentation for the train step with the
    reference's draws for ``(seed, step)`` (:func:`step_key`):
    ``draws(step, b)``, numpy arrays made on the host, and
    ``apply(images, *draws)``, their device tensors applied on the
    images' device with no host read. ``images`` are uint8 [B,H,W,3]."""

    def __init__(self, dataset: str, seed: int):
        if dataset == "imagenet":
            self._draw = lambda key, b: (imagenet_flips(key, b),)
            self.apply = flip_mean_subtract
        elif dataset in ("cifar10", "cifar100", "synthetic"):
            self._draw = cifar_draws
            self.apply = cifar_apply
        else:
            raise ValueError(f"no training augmentation for dataset "
                             f"{dataset!r}")
        self.seed = seed

    def draws(self, step: int, b: int, rank: int = 0, world: int = 1,
              per_replica: bool = False) -> Tuple[np.ndarray, ...]:
        """The draws of rank ``rank``'s ``b`` images of ``world`` ranks'
        step: with ``per_replica`` (per-replica BN) ``b`` draws from
        ``fold_in(step key, rank)``, as the reference's shard_map step
        takes them, else rows ``[rank·b, (rank+1)·b)`` of the global
        batch's draws."""
        key = step_key(self.seed, step)
        if world == 1:
            return tuple(self._draw(key, b))
        if per_replica:
            return tuple(self._draw(prng.fold_in(key, rank), b))
        return tuple(np.ascontiguousarray(d[rank * b:(rank + 1) * b])
                     for d in self._draw(key, b * world))


def get_train_augment(dataset: str):
    """The training augmentation ``fn(images, key)`` for a dataset."""
    if dataset == "imagenet":
        return imagenet_train_augment
    if dataset in ("cifar10", "cifar100", "synthetic"):
        return cifar_train_augment
    raise ValueError(f"no training augmentation for dataset {dataset!r}")


def cifar_eval_preprocess(images: torch.Tensor) -> torch.Tensor:
    """Eval path: standardization only."""
    return per_image_standardization(images)


def imagenet_eval_preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8 [B,H,W,3], already resized and cropped → [0,1] minus the VGG
    means."""
    return images.float() / 255.0 - _vgg_means(images.device)


def get_eval_preprocess(dataset: str):
    """The eval preprocessing function for a dataset."""
    if dataset == "imagenet":
        return imagenet_eval_preprocess
    if dataset in ("cifar10", "cifar100", "synthetic"):
        return cifar_eval_preprocess
    raise ValueError(f"unknown dataset {dataset!r}")
