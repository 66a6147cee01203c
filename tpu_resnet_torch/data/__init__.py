"""Data layer: in-memory CIFAR/synthetic splits, the streaming batcher, the
ImageNet pipeline (TFRecord shards, decoded and cropped on the device) and
on-device preprocessing and augmentation."""

from __future__ import annotations


def engine_workers(data_cfg) -> int:
    """Decode worker count for the configured engine mode (thread mode's:
    the port has no process mode)."""
    return data_cfg.num_workers


def train_batches(data_cfg, local_batch: int, seed: int = 0,
                  start_step: int = 0, *, device="cuda",
                  external_stop=None, mesh=None):
    """Training batch iterator in the reference's order from
    ``start_step``, yielding (uint8 images [B,H,W,3], int32 labels [B]).
    ``local_batch`` is the process's batch (``parallel.local_batch_size``);
    with a ``mesh`` (a ``parallel.Mesh``) the stream is its process's and
    each batch holds this rank's rows of it (``Mesh.local_rows``): the
    engine decodes only those.

    ImageNet returns a :class:`tpu_resnet_torch.data.engine.HostDataEngine`
    whose batches are already on ``device``: it runs its own workers and
    prefetch, honours ``external_stop`` and owns ``close()``, so the caller
    does not wrap it in another buffering layer. In-memory datasets return a
    plain host iterator the caller backgrounds and copies."""
    pi, pc, rows = 0, 1, None
    if mesh is not None:
        pi, pc = mesh.process_index, mesh.process_count
        rows = mesh.local_rows(local_batch * pc)
    if data_cfg.dataset == "imagenet":
        from tpu_resnet_torch.data.imagenet import ImageNetIterator
        it = ImageNetIterator.from_config(data_cfg, local_batch, seed=seed,
                                          start_step=start_step,
                                          process_index=pi, process_count=pc)
        return it.engine(device=device, mode=data_cfg.engine,
                         workers=engine_workers(data_cfg),
                         ring_slots=data_cfg.ring_slots,
                         external_stop=external_stop, rows=rows)
    from tpu_resnet_torch.data.cifar import load_split
    from tpu_resnet_torch.data.pipeline import ShardedBatcher

    images, labels = load_split(data_cfg, train=True)
    return iter(ShardedBatcher(images, labels, local_batch, seed=seed,
                               start_step=start_step, process_index=pi,
                               process_count=pc, rows=rows))


def eval_split_batches(data_cfg, batch: int, *, device="cuda"):
    """Eval-split pass in batches of ``batch``; the short last batch is
    zero-padded with labels -1. ImageNet batches come decoded on
    ``device``; in-memory splits as host arrays."""
    if data_cfg.dataset == "imagenet":
        if data_cfg.engine == "process":
            raise NotImplementedError(
                "data.engine=process is not ported: the port decodes on the "
                "card (ROADMAP Queue 1); use data.engine=thread")
        from tpu_resnet_torch.data.imagenet import eval_examples
        return eval_examples(data_cfg.data_dir, batch,
                             image_size=data_cfg.resolved_image_size,
                             eval_resize=data_cfg.eval_resize,
                             verify_records=data_cfg.verify_records,
                             device=device)
    from tpu_resnet_torch.data.cifar import load_split
    from tpu_resnet_torch.data.pipeline import eval_batches

    images, labels = load_split(data_cfg, train=False)
    return eval_batches(images, labels, batch)
