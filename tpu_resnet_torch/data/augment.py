"""Preprocessing and augmentation on the images' device (port of
``tpu_resnet/data/augment.py``).

CIFAR training (reference ``cifar_train_augment``): a symmetric 2-pixel
zero pad to 36x36, a per-image random 32x32 crop, a p=0.5 horizontal flip
and per-image standardization. The random draws come from a
``torch.Generator`` on the images' device (:func:`step_generator`, seeded
from ``(seed, step)``), so a resumed run repeats its augmentation; torch's
numbers differ from ``jax.random``'s, so :func:`crop_flip` takes the
offsets and flips as arguments and the tests feed it the reference's.

CIFAR eval: ``tf.image.per_image_standardization``, with the population
standard deviation and TF's ``max(std, 1/sqrt(num_elements))`` floor.

ImageNet training (reference ``imagenet_train_augment``; the host has
already random-resized and cropped to 224x224): uint8 → [0, 1], a p=0.5
horizontal flip, minus the VGG means. As for CIFAR, the draw and the pure
function of the flip mask (:func:`flip_mean_subtract`) are apart.
"""

from __future__ import annotations

import math

import numpy as np
import torch

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


def step_generator(seed: int, step: int,
                   device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)`` alone."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen


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
                        generator: torch.Generator) -> torch.Tensor:
    """uint8 [B,32,32,3] → standardized float32: 2-pixel zero pad, random
    32x32 crop, random horizontal flip, per-image standardization; the
    draws come from ``generator`` (on the images' device)."""
    b = images.shape[0]
    dev = images.device
    span = 2 * CIFAR_PAD + 1
    off_h = torch.randint(0, span, (b,), generator=generator, device=dev)
    off_w = torch.randint(0, span, (b,), generator=generator, device=dev)
    flip = torch.rand(b, generator=generator, device=dev) < 0.5
    return per_image_standardization(
        crop_flip(images.float(), off_h, off_w, flip))


def flip_mean_subtract(images: torch.Tensor,
                       flip: torch.Tensor) -> torch.Tensor:
    """uint8 [B,H,W,3] → float32 in [0, 1], each image's columns mirrored
    where ``flip[i]`` (bool [B]), minus the VGG means."""
    x = images.float() / 255.0
    x = torch.where(flip.to(images.device)[:, None, None, None], x.flip(2), x)
    return x - torch.tensor(VGG_MEANS_01, device=images.device)


def imagenet_train_augment(images: torch.Tensor,
                           generator: torch.Generator) -> torch.Tensor:
    """uint8 [B,224,224,3], already resized and cropped → a random
    horizontal flip drawn from ``generator`` (on the images' device), in
    [0, 1] minus the VGG means."""
    flip = torch.rand(images.shape[0], generator=generator,
                      device=images.device) < 0.5
    return flip_mean_subtract(images, flip)


def get_train_augment(dataset: str):
    """The training augmentation ``fn(images, generator)`` for a dataset."""
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
    means = torch.tensor(VGG_MEANS_01, device=images.device)
    return images.float() / 255.0 - means


def get_eval_preprocess(dataset: str):
    """The eval preprocessing function for a dataset."""
    if dataset == "imagenet":
        return imagenet_eval_preprocess
    if dataset in ("cifar10", "cifar100", "synthetic"):
        return cifar_eval_preprocess
    raise ValueError(f"unknown dataset {dataset!r}")
