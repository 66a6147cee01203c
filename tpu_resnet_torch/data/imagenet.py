"""ImageNet input pipeline: TFRecord shards → decoded, cropped uint8 batches
on the device (port of ``tpu_resnet/data/imagenet.py``).

What is the reference's, exactly (a pure function of seed, step and the
shards):

- shards ``train-*`` / ``validation-*`` under ``data_dir``, sorted
  (:func:`shard_files`); records ``image/encoded`` (JPEG) and
  ``image/class/label`` (1..1000; the pipeline hands ``label - 1`` to the
  model and pads with -1, as the reference does);
- the order (:class:`ImageNetIterator`): shard files striped over
  processes, a per-epoch file shuffle from ``default_rng((seed, epoch))``,
  the reservoir shuffle buffer over (file, record) positions drawn from
  ``default_rng((seed, 1))``, a resume at ``start_step`` that skips
  ``start_step × local_batch`` positions, and per-batch work orders
  (file index, payload offset, payload length);
- the draws (:func:`crop_draws`): training takes the resize side from
  ``rng.integers(resize_min, resize_max + 1)``, then fx, then fy from
  ``rng.random()``; eval takes ``eval_resize`` and the floor-central crop
  (fx = fy = -1); each image's rng is ``default_rng((seed, 0x1DEC0DE,
  seq, j))`` (``data/engine.py``).

What is the port's: the decode stage (``ops/jpeg_decode.py``). On the
card nvJPEG decodes and ``tr_resize_crop`` resizes and crops a batch in
one launch; on the CPU the plain decoder (``data/jpeg.py``, bit for bit
PIL's decode) and the plain resize. The resize is the reference's
antialiased triangle filter over the crop window
(``tpu_resnet/native/loader.cc``), within a level of PIL's ``BILINEAR``
(which rounds to uint8 between its two passes).
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from tpu_resnet_torch.data import tfrecord
from tpu_resnet_torch.device import resolve_device

IMAGE_SIZE = 224
EVAL_RESIZE = 256


def shard_files(data_dir: str, train: bool) -> List[str]:
    pattern = os.path.join(data_dir, "train-*" if train else "validation-*")
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no ImageNet shards match {pattern}")
    return files


def parse_record(serialized: bytes) -> Tuple[bytes, int]:
    """(JPEG bytes, the shard's 1-based label)."""
    ex = tfrecord.parse_example(serialized)
    return ex["image/encoded"][0], int(ex["image/class/label"][0])


def crop_draws(train: bool, rng: np.random.Generator,
               resize_min: int = 256, resize_max: int = 512,
               eval_resize: int = EVAL_RESIZE) -> Tuple[int, float, float]:
    """(resize side, fx, fy) of one image, drawn as the reference's
    ``decode_and_crop`` draws them; eval draws nothing."""
    if train:
        side = int(rng.integers(resize_min, resize_max + 1))
        fx, fy = float(rng.random()), float(rng.random())
        return side, fx, fy
    return eval_resize, -1.0, -1.0


def decode_and_crop(jpeg: bytes, train: bool, rng: np.random.Generator,
                    resize_min: int = 256, resize_max: int = 512,
                    eval_resize: int = EVAL_RESIZE,
                    out_size: int = IMAGE_SIZE) -> np.ndarray:
    """JPEG bytes → uint8 [out_size, out_size, 3] on the host, through the
    plain decoder and the plain resize (the reference's function of the
    same name, one image)."""
    from tpu_resnet_torch.ops.jpeg_decode import decode_crop_batch
    draw = crop_draws(train, rng, resize_min, resize_max, eval_resize)
    return decode_crop_batch([jpeg], [draw], out_size, "cpu")[0].numpy()


class ImageNetIterator:
    """The training (or eval) stream's order: shard files striped per
    process, the per-epoch file shuffle, the reservoir shuffle buffer and
    the resume skip, all over cheap (file, record#) positions, sliced into
    per-batch work orders that the decode engine
    (:class:`tpu_resnet_torch.data.engine.HostDataEngine`) turns into
    batches. Batch ``i`` of the stream is the one consumed at global step
    ``start_step + i``: its contents are a pure function of (seed,
    step)."""

    def __init__(self, data_dir: str, local_batch: int, *, train: bool = True,
                 seed: int = 0, num_workers: int = 4,
                 shuffle_buffer: int = 4096, resize_min: int = 256,
                 resize_max: int = 512, eval_resize: int = EVAL_RESIZE,
                 start_step: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 image_size: int = IMAGE_SIZE, verify_records: bool = False):
        self.files = shard_files(data_dir, train)[process_index::process_count]
        if not self.files:
            raise ValueError("fewer shard files than processes")
        self.local_batch = local_batch
        self.train = train
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.shuffle_buffer = shuffle_buffer
        self.resize_min = resize_min
        self.resize_max = resize_max
        self.eval_resize = eval_resize
        self.image_size = image_size
        self.start_step = start_step
        self.verify_records = verify_records
        self._findex: dict = {}

    @classmethod
    def from_config(cls, data_cfg, local_batch: int, *, seed: int = 0,
                    start_step: int = 0, process_index: int = 0,
                    process_count: int = 1) -> "ImageNetIterator":
        """The training stream that ``data_cfg`` (the config's ``data``
        section) describes."""
        return cls(data_cfg.data_dir, local_batch, train=True, seed=seed,
                   num_workers=data_cfg.num_workers,
                   shuffle_buffer=min(data_cfg.shuffle_buffer, 65536),
                   resize_min=data_cfg.resize_min,
                   resize_max=data_cfg.resize_max, start_step=start_step,
                   process_index=process_index, process_count=process_count,
                   image_size=data_cfg.resolved_image_size,
                   verify_records=data_cfg.verify_records)

    def _file_index(self, path: str):
        """Cached seek-only (offset, length) index of one shard."""
        if path not in self._findex:
            self._findex[path] = tfrecord.record_index(path)
        return self._findex[path]

    def _epoch_files(self, epoch: int) -> List[str]:
        """Per-epoch shard order, a pure function of (seed, epoch)."""
        files = list(self.files)
        np.random.default_rng((self.seed, epoch)).shuffle(files)
        return files

    def _position_stream(self) -> Iterator[Tuple[str, int]]:
        """(file, record#) visit order: infinite (epoch-cycled) for train,
        one pass for eval."""
        epoch = 0
        while True:
            files = (self._epoch_files(epoch) if self.train
                     else list(self.files))
            for f in files:
                for i in range(len(self._file_index(f))):
                    yield f, i
            if not self.train:
                return
            epoch += 1

    def _shuffle_stream(self, items: Iterator, rng: np.random.Generator,
                        buf: List) -> Iterator:
        """Reservoir-style shuffle buffer (the reference's
        ``shuffle(buffer_size=...)``) over positions, never payloads."""
        for item in items:
            buf.append(item)
            if len(buf) >= self.shuffle_buffer:
                idx = int(rng.integers(0, len(buf)))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield buf.pop()
        while buf:
            idx = int(rng.integers(0, len(buf)))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()

    def _shuffled_positions(self) -> Iterator[Tuple[str, int]]:
        """The shuffled positions; with ``start_step > 0`` exactly where an
        uninterrupted run's stream is after ``start_step`` batches."""
        if not self.train:
            yield from self._position_stream()
            return
        rng = np.random.default_rng((self.seed, 1))
        stream = self._shuffle_stream(self._position_stream(), rng, [])
        for _ in range(self.start_step * self.local_batch):
            next(stream)  # infinite train stream: never drains
        yield from stream

    def work_orders(self) -> Iterator[List[Tuple[int, int, int]]]:
        """Per-batch record entries ``(file_idx, offset, length)``; a
        finite eval stream ends with a partial order."""
        fidx = {f: i for i, f in enumerate(self.files)}
        batch: List[Tuple[int, int, int]] = []
        for path, ri in self._shuffled_positions():
            off, length = self._file_index(path)[ri]
            batch.append((fidx[path], off, length))
            if len(batch) == self.local_batch:
                yield batch
                batch = []
        if batch:
            yield batch

    def engine(self, *, device="cuda", mode: str = "thread",
               workers: Optional[int] = None, ring_slots: int = 0,
               external_stop=None, rows=None):
        """The decode engine for this stream; callers own its lifecycle
        (``close()``). ``rows = (lo, hi)`` decodes rows ``lo:hi`` of each
        batch only (a rank's), with the draws the whole batch's rows
        get."""
        from tpu_resnet_torch.data.engine import HostDataEngine

        lo, hi = rows or (0, self.local_batch)
        orders = self.work_orders()
        if (lo, hi) != (0, self.local_batch):
            orders = (order[lo:hi] for order in orders)
        return HostDataEngine(
            orders, files=self.files, row_offset=lo,
            local_batch=hi - lo, image_size=self.image_size,
            seed=self.seed, train=self.train,
            resize_min=self.resize_min, resize_max=self.resize_max,
            eval_resize=self.eval_resize,
            verify_records=self.verify_records, device=device,
            mode=mode, workers=workers or self.num_workers,
            ring_slots=ring_slots, first_seq=self.start_step,
            external_stop=external_stop)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        eng = self.engine()
        try:
            yield from eng
        finally:
            eng.close()


def eval_examples(data_dir: str, batch: int, *,
                  process_index: int = 0, process_count: int = 1,
                  image_size: int = IMAGE_SIZE,
                  eval_resize: int = EVAL_RESIZE,
                  verify_records: bool = False, device="cuda"
                  ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Sequential eval pass in batches of ``batch`` on ``device``: images
    uint8 [batch, S, S, 3] and int32 labels (``label - 1``), the last batch
    zero-padded with labels -1."""
    from tpu_resnet_torch.data.engine import DecodeStage, handoff

    files = shard_files(data_dir, train=False)[process_index::process_count]
    if not files:
        raise ValueError("fewer validation shard files than processes")
    stage = DecodeStage(resolve_device(str(device)), image_size, batch)
    try:
        pending: List[Tuple[bytes, str]] = []
        for f in files:
            offset = 0
            for rec in tfrecord.read_records(f, verify_crc=verify_records):
                pending.append((rec, f"{f} record at offset {offset + 12}"))
                offset += 16 + len(rec)
                if len(pending) == batch:
                    yield handoff(*stage.batch(
                        pending, [(eval_resize, -1.0, -1.0)] * batch))
                    pending = []
        if pending:
            yield handoff(*stage.batch(
                pending, [(eval_resize, -1.0, -1.0)] * len(pending)))
    finally:
        stage.close()
