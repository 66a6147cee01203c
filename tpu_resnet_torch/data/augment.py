"""Eval-time preprocessing on the device (port of the eval half of
``tpu_resnet/data/augment.py``).

CIFAR: ``tf.image.per_image_standardization``, with the population standard
deviation and TF's ``max(std, 1/sqrt(num_elements))`` floor.
"""

from __future__ import annotations

import math

import torch

# Reference vgg_preprocessing.py:37-39, divided by 255.
VGG_MEANS_01 = (123.68 / 255.0, 116.78 / 255.0, 103.94 / 255.0)


def per_image_standardization(images: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] → float32, each image to zero mean and unit std."""
    images = images.float()
    n = images[0].numel()
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    std = images.std(dim=(1, 2, 3), keepdim=True, unbiased=False)
    return (images - mean) / torch.clamp_min(std, 1.0 / math.sqrt(n))


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
