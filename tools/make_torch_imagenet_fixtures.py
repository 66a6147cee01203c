#!/usr/bin/env python3
"""Write the seeded ImageNet-like JPEG shards of ``tests/fixtures/imagenet/``.

    python3 tools/make_torch_imagenet_fixtures.py [--out DIR] [--seed N]

Photo-like JPEGs (a smooth sine/cosine pattern plus mild noise in each
channel, the recipe of ``tpu_resnet/data/engine.py``
``synthetic_photo_jpeg``, plus a grey texture: noise shared by the three
channels, so that the detail lies in the luma and the chroma stays smooth,
as in photos) at ImageNet's common sizes (500x375, 375x500, 500x333,
333x500, 320x240), quality 92, most in 4:2:0 (PIL's default), some in
4:4:4 and 4:2:2, and grey ones; labels 1..1000, as the shards store them.
The texture's amplitude (``LUMA_NOISE``) sets the compressed size: it is
chosen so that the mean payload is about ImageNet's, whose training
archive
(``ILSVRC2012_img_train.tar``, 147,897,477,120 bytes) holds 1,281,167
JPEGs, about 115 kB an image; nvJPEG's Huffman decode runs on the host
and its cost grows with the bytes. The tool prints the mean. Written
through the port's ``write_records`` as ``train-0000{0..3}-of-00004`` (5
records each) and ``validation-00000-of-00001`` (8 records). The tool
needs PIL; the port does not (it decodes with its own plain decoder on
the CPU and nvJPEG on the card).
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpu_resnet_torch.data import tfrecord  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "fixtures", "imagenet")
SIZES = ((500, 375), (375, 500), (500, 333), (333, 500), (320, 240))
# PIL's subsampling argument: 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0; None: grey.
MODES = (2, 2, 0, 2, 1, 2, None, 2)
TRAIN_SHARDS, PER_SHARD, VALIDATION = 4, 5, 8
# Uniform noise in [0, LUMA_NOISE) added to all three channels alike (the
# mean payload), and in [0, CHROMA_NOISE) to each on its own.
LUMA_NOISE, CHROMA_NOISE, QUALITY = 112, 24, 92


def photo_jpeg(size, mode, rng) -> bytes:
    w, h = size
    fx, fy = rng.uniform(3.0, 10.0, 2)
    xs = np.linspace(0, fx * np.pi, w) + rng.uniform(0, np.pi)
    ys = np.linspace(0, fy * np.pi, h)
    tint = rng.uniform(0.6, 1.0, 3)
    base = (np.sin(xs)[None, :, None] * np.cos(ys)[:, None, None] * 0.5
            + 0.5) * 255 * tint
    arr = (base + rng.integers(0, LUMA_NOISE, (h, w, 1))
           + rng.integers(0, CHROMA_NOISE, (h, w, 3))).clip(0, 255).astype(
        np.uint8)
    img = Image.fromarray(arr)
    buf = io.BytesIO()
    if mode is None:
        img.convert("L").save(buf, "JPEG", quality=QUALITY)
    else:
        img.save(buf, "JPEG", quality=QUALITY, subsampling=mode)
    return buf.getvalue()


def write(out: str, seed: int) -> list:
    rng = np.random.default_rng(seed)
    os.makedirs(out, exist_ok=True)
    names = [f"train-{s:05d}-of-{TRAIN_SHARDS:05d}"
             for s in range(TRAIN_SHARDS)] + ["validation-00000-of-00001"]
    k, sizes = 0, []
    for name in names:
        n = VALIDATION if name.startswith("validation") else PER_SHARD
        records = []
        for _ in range(n):
            jpeg = photo_jpeg(SIZES[k % len(SIZES)], MODES[k % len(MODES)],
                              rng)
            sizes.append(len(jpeg))
            records.append(tfrecord.encode_example({
                "image/encoded": [jpeg],
                "image/class/label": [int(rng.integers(1, 1001))],
                "image/class/text": [b"synthetic"]}))
            k += 1
        tfrecord.write_records(os.path.join(out, name), records)
    return [os.path.join(out, n) for n in names], sizes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    paths, sizes = write(args.out, args.seed)
    total = sum(os.path.getsize(p) for p in paths)
    print(f"wrote {len(paths)} shards, {total} bytes, to {args.out}: "
          f"{len(sizes)} JPEGs, {sum(sizes) / len(sizes):.0f} bytes an "
          f"image on average")
    return 0


if __name__ == "__main__":
    sys.exit(main())
