"""Data layer: in-memory CIFAR/synthetic splits, the streaming batcher and
on-device preprocessing and augmentation."""

from __future__ import annotations


def train_batches(data_cfg, local_batch: int, seed: int = 0,
                  start_step: int = 0):
    """Training batch iterator (host side), yielding (uint8 images [B,H,W,3],
    int32 labels [B]) in the reference's streaming order from
    ``start_step``."""
    if data_cfg.dataset == "imagenet":
        raise NotImplementedError(
            "ImageNet training (data.dataset=imagenet) needs the ImageNet "
            "input pipeline (TFRecord reader, JPEG decode and crop), a later "
            "slice of the port (ROADMAP Queue 1); the train step itself runs "
            "(train.loop.build_state + make_loop_step on uint8 224x224 "
            "batches)")
    from tpu_resnet_torch.data.cifar import load_split
    from tpu_resnet_torch.data.pipeline import ShardedBatcher

    images, labels = load_split(data_cfg, train=True)
    return iter(ShardedBatcher(images, labels, local_batch, seed=seed,
                               start_step=start_step))


def eval_split_batches(data_cfg, batch: int):
    """Eval-split pass in batches of ``batch``; the short last batch is
    zero-padded with labels -1."""
    if data_cfg.dataset == "imagenet":
        raise NotImplementedError(
            "data.dataset=imagenet evaluation needs the TFRecord/JPEG "
            "pipeline, a later slice of the port (ROADMAP Queue 1)")
    from tpu_resnet_torch.data.cifar import load_split
    from tpu_resnet_torch.data.pipeline import eval_batches

    images, labels = load_split(data_cfg, train=False)
    return eval_batches(images, labels, batch)
