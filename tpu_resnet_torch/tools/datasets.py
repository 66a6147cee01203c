"""Dataset layout check (port of ``validate_layout`` in
``tpu_resnet/tools/datasets.py``; ``fetch`` needs a download and is not
ported). The loaders' own file resolution is the check: the CIFAR binary
files (``data/cifar.py`` ``cifar_files``) or the ImageNet TFRecord shards
(``data/imagenet.py`` ``shard_files``), train and validation.
"""

from __future__ import annotations


def validate_layout(dataset: str, data_dir: str) -> None:
    """Raise if ``data_dir`` lacks a file the loaders of ``dataset``
    need."""
    if dataset == "imagenet":
        from tpu_resnet_torch.data.imagenet import shard_files

        for train in (True, False):
            shard_files(data_dir, train)
        return
    from tpu_resnet_torch.data.cifar import cifar_files

    for train in (True, False):
        cifar_files(dataset, data_dir, train)
