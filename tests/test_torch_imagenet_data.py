"""The port's ImageNet input pipeline (``tpu_resnet_torch/data/tfrecord.py``,
``imagenet.py``, ``engine.py``, ``jpeg.py`` and the decode stage's plain
half in ``ops/jpeg_decode.py``) against the reference's
(``tpu_resnet/data/tfrecord.py``, ``imagenet.py``, ``engine.py``), on
shards written here with PIL at seeded sizes.

Exact: record framing, CRC and the Example codec both ways; shard
discovery; the work orders (seeds, resume, process striping); each image's
draws, resized size and crop offsets; eval order, padding and labels; the
plain decoder against PIL's decode (libjpeg's own integer arithmetic).
Within a level: the whole crop against the reference's PIL path
(``decode_and_crop(..., use_native=False)``), because PIL's ``BILINEAR``
rounds to uint8 between its two passes and the port's filter (the
reference's ``loader.cc`` window resize) keeps float32.
"""

import io
import itertools
import os
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

from tpu_resnet.data import engine as ref_engine
from tpu_resnet.data import imagenet as ref_imagenet
from tpu_resnet.data import tfrecord as ref_tfrecord
from tpu_resnet_torch.data import engine
from tpu_resnet_torch.data import imagenet
from tpu_resnet_torch.data import jpeg
from tpu_resnet_torch.data import tfrecord
from tpu_resnet_torch.ops import jpeg_decode as jd

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "imagenet")
# The whole crop against the reference's PIL path: at most one level
# anywhere, and on average well under one (measured 0.06-0.23 at 224).
CROP_MAX, CROP_MEAN = 1, 0.35


def photo(size, rng, subsampling=2, grey=False, quality=90, **save):
    w, h = size
    xs = np.linspace(0, 7 * np.pi, w)
    ys = np.linspace(0, 5 * np.pi, h)
    base = (np.sin(xs)[None, :, None] * np.cos(ys)[:, None, None] * 0.5
            + 0.5) * 255
    arr = (base + rng.integers(0, 40, (h, w, 3))).clip(0, 255).astype(
        np.uint8)
    img = Image.fromarray(arr)
    buf = io.BytesIO()
    if grey:
        img.convert("L").save(buf, "JPEG", quality=quality, **save)
    else:
        img.save(buf, "JPEG", quality=quality, subsampling=subsampling,
                 **save)
    return buf.getvalue()


def write_shards(root, seed=0, train_shards=4, per_shard=5, val_shards=2):
    """Seeded shards: sizes 48..96 a side, 4:2:0 mostly, some 4:4:4, 4:2:2
    and grey; labels 1..1000. Returns {name: [(label, jpeg)]}."""
    rng = np.random.default_rng(seed)
    names = ([f"train-{s:05d}-of-{train_shards:05d}"
              for s in range(train_shards)]
             + [f"validation-{s:05d}-of-{val_shards:05d}"
                for s in range(val_shards)])
    out = {}
    for name in names:
        recs, entries = [], []
        for i in range(per_shard):
            size = tuple(int(v) for v in rng.integers(48, 97, 2))
            kind = i % 4
            data = photo(size, rng, subsampling=(2, 0, 1, 2)[kind],
                         grey=kind == 3)
            label = int(rng.integers(1, 1001))
            recs.append(tfrecord.encode_example({
                "image/encoded": [data], "image/class/label": [label],
                "image/class/text": [b"x"]}))
            entries.append((label, data))
        tfrecord.write_records(str(root / name), recs)
        out[name] = entries
    return out


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    return root, write_shards(root)


# ------------------------------------------------------- records and codec
@pytest.mark.parametrize("writer, reader", [
    (tfrecord, ref_tfrecord), (ref_tfrecord, tfrecord)])
def test_records_and_examples_cross_read(tmp_path, writer, reader):
    examples = [{"image/encoded": [b"\xff\xd8" + bytes(range(256)) * 9],
                 "image/class/label": [1000], "neg": [-5, 2**40],
                 "f": [0.25, -1.5], "image/class/text": [b"a", b""]},
                {"image/encoded": [b""], "image/class/label": [1]}]
    path = str(tmp_path / "shard")
    writer.write_records(path, [writer.encode_example(e) for e in examples])
    got = [reader.parse_example(r)
           for r in reader.read_records(path, verify_crc=True)]
    assert got == examples
    assert reader.record_index(path) == writer.record_index(path)
    with open(path, "rb") as f:
        assert f.read() == _written(tmp_path, examples)


def _written(tmp_path, examples):
    path = str(tmp_path / "ref")
    ref_tfrecord.write_records(
        path, [ref_tfrecord.encode_example(e) for e in examples])
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("n", [0, 1, 4, 9, 1023, 1024, 1025, 4096, 30011])
def test_crc32c_fast_matches_the_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert tfrecord.crc32c_fast(data) == ref_tfrecord.crc32c(data)
    assert tfrecord.masked_crc32c_fast(data) == ref_tfrecord.masked_crc32c(
        data)


def test_shard_files_as_the_reference(shards, tmp_path):
    root, _ = shards
    for train in (True, False):
        assert imagenet.shard_files(str(root), train) == \
            ref_imagenet.shard_files(str(root), train)
    for mod in (imagenet, ref_imagenet):
        with pytest.raises(FileNotFoundError, match="no ImageNet shards"):
            mod.shard_files(str(tmp_path), True)


# --------------------------------------------------------- order and draws
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("start_step", [0, 3])
@pytest.mark.parametrize("process", [(0, 1), (0, 2), (1, 2)])
def test_work_orders_match_the_reference(shards, seed, start_step, process):
    root, _ = shards
    kw = dict(train=True, seed=seed, shuffle_buffer=6,
              start_step=start_step, process_index=process[0],
              process_count=process[1])
    port = imagenet.ImageNetIterator(str(root), 3, **kw)
    ref = ref_imagenet.ImageNetIterator(str(root), 3, **kw)
    assert port.files == ref.files
    assert (list(itertools.islice(port.work_orders(), 12))
            == list(itertools.islice(ref.work_orders(), 12)))
    kw.update(train=False, start_step=0)
    assert (list(imagenet.ImageNetIterator(str(root), 4, **kw).work_orders())
            == list(ref_imagenet.ImageNetIterator(str(root), 4,
                                                   **kw).work_orders()))


def test_iterator_from_config_is_the_configured_stream(shards):
    """``ImageNetIterator.from_config`` (what ``train_batches`` and
    ``chip_smoke.py`` build) reads the config's data section: its orders
    from a resume step are the reference's for the same settings, and
    ``read_order`` returns their payloads as the shards hold them."""
    from tpu_resnet_torch.config import load_config
    root, _ = shards
    cfg = load_config("imagenet", "", [
        f"data.data_dir={root}", "data.shuffle_buffer=6",
        "data.image_size=32", "data.resize_min=36", "data.resize_max=48"])
    it = imagenet.ImageNetIterator.from_config(cfg.data, 3, seed=7,
                                               start_step=2)
    assert (it.image_size, it.resize_min, it.resize_max, it.shuffle_buffer,
            it.start_step) == (32, 36, 48, 6, 2)
    ref = ref_imagenet.ImageNetIterator(str(root), 3, seed=7,
                                        shuffle_buffer=6, start_step=2)
    orders = list(itertools.islice(it.work_orders(), 4))
    assert orders == list(itertools.islice(ref.work_orders(), 4))
    cache = {}
    for order in orders:
        records = engine.read_order(order, it.files, True, cache)
        assert records == engine.read_order(order, it.files)
        for (payload, what), (fi, off, length) in zip(records, order):
            with open(it.files[fi], "rb") as f:
                f.seek(off)
                assert payload == f.read(length)
            assert what == f"{it.files[fi]} record at offset {off}"
    assert cache and all(not fh.closed for fh in cache.values())
    for fh in cache.values():
        fh.close()


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("seed", [0, 11])
def test_draws_match_the_reference(shards, monkeypatch, train, seed):
    """Each image's side, resized size and crop offsets are the
    reference's, for seqs and positions in the batch; both consume the
    same draws from the image's rng."""
    root, entries = shards
    jpegs = [d for recs in entries.values() for _, d in recs]
    seen = []
    real_resize = ref_imagenet._resize_keep_aspect
    real_crop = Image.Image.crop

    def spy_resize(img, side):
        out = real_resize(img, side)
        seen.append([img.size, side, out.size])
        return out

    def spy_crop(img, box=None):
        seen[-1].append(tuple(box[:2]))
        return real_crop(img, box)

    monkeypatch.setattr(ref_imagenet, "_resize_keep_aspect", spy_resize)
    monkeypatch.setattr(Image.Image, "crop", spy_crop)
    assert engine._DECODE_STREAM == ref_engine._DECODE_STREAM
    params = dict(train=train, seed=seed, resize_min=40, resize_max=64,
                  eval_resize=44)
    for seq in (0, 1, 5, 123456):
        draws = engine.order_draws(params, seq, 3)
        for j, (side, fx, fy) in enumerate(draws):
            data = jpegs[(seq + j) % len(jpegs)]
            rng = np.random.default_rng((seed, ref_engine._DECODE_STREAM,
                                         seq, j))
            ref_imagenet.decode_and_crop(data, train, rng, 40, 64,
                                         eval_resize=44, out_size=32,
                                         use_native=False)
            size, ref_side, resized, corner = seen[-1]
            rw, rh = jd.resized_size(*size, side)
            assert (side, (rw, rh)) == (ref_side, resized)
            assert jd.crop_offsets(rw, rh, fx, fy, 32) == corner
            mine = np.random.default_rng((seed, engine._DECODE_STREAM,
                                          seq, j))
            imagenet.crop_draws(train, mine, 40, 64, 44)
            assert mine.random() == rng.random()


@pytest.mark.parametrize("size, side", [((3, 2), 3), ((5, 2), 3),
                                        ((375, 500), 256), ((333, 500), 257),
                                        ((7, 3), 5)])
def test_resized_size_rounds_half_up_as_the_reference(size, side):
    img = Image.new("RGB", size)
    assert jd.resized_size(*size, side) == \
        ref_imagenet._resize_keep_aspect(img, side).size


def test_eval_examples_order_padding_and_labels(shards):
    root, entries = shards
    got = list(imagenet.eval_examples(str(root), 4, image_size=32,
                                      eval_resize=40, device="cpu"))
    want = list(ref_imagenet.eval_examples(str(root), 4, image_size=32,
                                           eval_resize=40, use_native=False))
    assert len(got) == len(want) == 3    # 10 records: 4 + 4 + 2 (+2 pad)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == torch.uint8 and gl.dtype == torch.int32
        np.testing.assert_array_equal(gl.numpy(), wl)
        assert _diff(gi.numpy(), wi).max() <= CROP_MAX
    labels = torch.cat([gl for _, gl in got]).tolist()
    val = [l - 1 for n, recs in sorted(entries.items())
           if n.startswith("validation") for l, _ in recs]
    assert labels == val + [-1, -1]
    assert not got[-1][0][2:].any()


# --------------------------------------------------------------- decoding
def _diff(a, b):
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


@pytest.mark.parametrize("kind", ["4:4:4", "4:2:2", "4:2:0", "grey",
                                  "restarts"])
@pytest.mark.parametrize("size", [(500, 375), (333, 500), (37, 29)])
def test_plain_decoder_is_pils_decode(kind, size):
    rng = np.random.default_rng(size[0])
    save = {"restart_marker_blocks": 5} if kind == "restarts" else {}
    data = photo(size, rng, subsampling={"4:4:4": 0, "4:2:2": 1}.get(kind, 2),
                 grey=kind == "grey", **save)
    assert jpeg.sampling(data) == {"restarts": "4:2:0"}.get(kind, kind)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(jpeg.decode(data), want)


def test_fixture_shards_decode_as_pil():
    samplings = set()
    for name in sorted(os.listdir(FIXTURES)):
        for rec in tfrecord.read_records(os.path.join(FIXTURES, name),
                                         verify_crc=True):
            data, label = imagenet.parse_record(rec)
            assert 1 <= label <= 1000
            samplings.add(jpeg.sampling(data))
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            if want.shape[:2] in ((375, 500), (240, 320)):
                np.testing.assert_array_equal(jpeg.decode(data), want)
    assert {"4:4:4", "4:2:0", "grey"} <= samplings


@pytest.mark.parametrize("save, match", [
    ({"progressive": True}, "progressive"), ("cmyk", "CMYK"),
    ("truncated", "corrupt JPEG"), ("png", "not a JPEG")])
def test_plain_decoder_refuses(save, match):
    rng = np.random.default_rng(0)
    buf = io.BytesIO()
    if save == "cmyk":
        Image.new("CMYK", (16, 16), (1, 2, 3, 4)).save(buf, "JPEG")
        data = buf.getvalue()
    elif save == "png":
        Image.new("RGB", (16, 16)).save(buf, "PNG")
        data = buf.getvalue()
    elif save == "truncated":
        data = photo((64, 48), rng)[:300]
    else:
        data = photo((64, 48), rng, **save)
    with pytest.raises(ValueError, match=match):
        jpeg.decode(data)


@pytest.mark.parametrize("train", [True, False])
def test_crop_within_a_level_of_the_reference(shards, train):
    """The plain decoder and the plain resize against the reference's PIL
    path at small resize sizes (``tests/test_imagenet_data.py``'s
    shapes, cut to these images)."""
    root, entries = shards
    diffs = []
    for k, (_, data) in enumerate(r for recs in entries.values()
                                  for r in recs):
        got = imagenet.decode_and_crop(data, train, np.random.default_rng(k),
                                       resize_min=48, resize_max=72,
                                       eval_resize=52, out_size=40)
        want = ref_imagenet.decode_and_crop(
            data, train, np.random.default_rng(k), resize_min=48,
            resize_max=72, eval_resize=52, out_size=40, use_native=False)
        assert got.shape == want.shape == (40, 40, 3)
        diffs.append(_diff(got, want))
    d = np.stack(diffs)
    assert d.max() <= CROP_MAX and d.mean() <= CROP_MEAN, (d.max(), d.mean())


def test_crop_at_imagenet_size_within_a_level_of_the_reference():
    """The fixtures' 500x375 / 320x240 images at 224 from the train and
    eval sides."""
    rec = next(tfrecord.read_records(os.path.join(
        FIXTURES, "validation-00000-of-00001")))
    data, _ = imagenet.parse_record(rec)
    for train, seed in ((True, 1), (True, 2), (False, 0)):
        got = imagenet.decode_and_crop(data, train,
                                       np.random.default_rng(seed))
        want = ref_imagenet.decode_and_crop(
            data, train, np.random.default_rng(seed), use_native=False)
        d = _diff(got, want)
        assert d.max() <= CROP_MAX and d.mean() <= CROP_MEAN


def test_resize_tables_and_plain_resize():
    """The axis tables are loader.cc's (weights normalised, taps inside the
    image), a grey plane reads as R = G = B, and the batch wrapper refuses
    malformed tables."""
    first, count, weights = jd.precompute_axis(500, 256)
    assert first.min() >= 0 and (first + count).max() <= 500
    sums = weights.astype(np.float64).sum(1)
    np.testing.assert_allclose(sums, 1.0, atol=1e-6)
    rgb = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (60, 80, 1), np.uint8))
    tabs = jd.crop_tables(80, 60, 50, 0.3, 0.6, 32)
    grey = jd.resize_crop_reference(rgb, *tabs)
    assert torch.equal(grey[..., 0], grey[..., 1])
    assert torch.equal(grey, jd.resize_crop_reference(rgb.expand(60, 80, 3)
                                                      .contiguous(), *tabs))
    host = [torch.from_numpy(a) for a in (
        np.zeros(1, np.int64), np.array([[80, 60, 1]], np.int32),
        *jd.crop_table_batch([(80, 60)], [(50, 0.3, 0.6)], 32))]
    assert torch.equal(jd.resize_crop(rgb.reshape(-1), *host)[0], grey)
    with pytest.raises(ValueError, match="expected torch.int64"):
        jd.resize_crop(rgb.reshape(-1), host[0].int(), *host[1:])
    with pytest.raises(ValueError, match="smaller than"):
        jd.crop_tables(80, 60, 30, 0.3, 0.6, 32)


# ----------------------------------------------------------------- engine
def _engine_batches(root, workers, start_step, n, verify=False):
    it = imagenet.ImageNetIterator(
        str(root), 3, train=True, seed=5, shuffle_buffer=6, resize_min=36,
        resize_max=48, start_step=start_step, image_size=32,
        verify_records=verify)
    eng = it.engine(device="cpu", workers=workers, ring_slots=2)
    try:
        return [next(eng) for _ in range(n)]
    finally:
        eng.close()


def test_batches_independent_of_workers_and_resume(shards):
    """A batch is a function of (seed, step): one worker or three, from
    the start or resumed at step 2, verified or not; and each image is the
    reference's decode_and_crop with its draws, within a level."""
    root, _ = shards
    one = _engine_batches(root, 1, 0, 4)
    three = _engine_batches(root, 3, 2, 2, verify=True)
    for (ai, al), (bi, bl) in zip(one[2:], three):
        assert torch.equal(ai, bi) and torch.equal(al, bl)
    _check_against_reference(root, one)


def test_engine_under_thread_stress(shards):
    """More workers than cores, switching every 10 µs: the batches are the
    one-worker engine's, in order, and the decode counter (the workers'
    shared state) loses no update."""
    root, _ = shards
    want = _engine_batches(root, 1, 0, 3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        it = imagenet.ImageNetIterator(
            str(root), 3, train=True, seed=5, shuffle_buffer=6,
            resize_min=36, resize_max=48, image_size=32)
        eng = it.engine(device="cpu", workers=2 * (os.cpu_count() or 1) + 1,
                        ring_slots=8)
        try:
            got = [next(eng) for _ in range(3)]
            dispatched = 3 * eng._next_dispatch  # 3 images an order
            deadline = time.monotonic() + 60
            while (eng._decoded_total() < dispatched
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert eng._decoded_total() == dispatched
        finally:
            eng.close()
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in eng._threads)
    for (ai, al), (bi, bl) in zip(want, got):
        assert torch.equal(ai, bi) and torch.equal(al, bl)


def _check_against_reference(root, one):
    orders = ref_imagenet.ImageNetIterator(
        str(root), 3, train=True, seed=5, shuffle_buffer=6).work_orders()
    files = imagenet.shard_files(str(root), True)
    for seq, entries in enumerate(itertools.islice(orders, 4)):
        for j, (fi, off, length) in enumerate(entries):
            with open(files[fi], "rb") as f:
                f.seek(off)
                data, label = ref_imagenet.parse_record(f.read(length))
            want = ref_imagenet.decode_and_crop(
                data, True, np.random.default_rng(
                    (5, ref_engine._DECODE_STREAM, seq, j)), 36, 48,
                out_size=32, use_native=False)
            assert int(one[seq][1][j]) == label - 1
            assert _diff(one[seq][0][j].numpy(), want).max() <= CROP_MAX


def test_verify_records_catches_corruption(tmp_path):
    write_shards(tmp_path, train_shards=1, per_shard=4, val_shards=1)
    shard = next(tmp_path.glob("train-*"))
    raw = bytearray(shard.read_bytes())
    for off, length in tfrecord.record_index(str(shard)):
        raw[off + length // 2] ^= 0xFF  # corrupt each payload
    shard.write_bytes(bytes(raw))
    with pytest.raises(RuntimeError, match="CRC mismatch"):
        _engine_batches(tmp_path, 1, 0, 2, verify=True)
    with pytest.raises(ValueError, match="data CRC mismatch"):
        list(tfrecord.read_records(str(shard), verify_crc=True))
    assert len(list(tfrecord.read_records(str(shard)))) == 4


def test_engine_errors_and_contracts(tmp_path, monkeypatch):
    """A record that does not decode raises at its batch with its file and
    offset; the process engine is not ported; without CUDA the engine
    raises unless asked for the CPU; stats and close keep their
    contracts."""
    rec = tfrecord.encode_example({"image/encoded": [b"\xff\xd8junk"],
                                   "image/class/label": [3]})
    tfrecord.write_records(str(tmp_path / "train-00000-of-00001"), [rec])
    it = imagenet.ImageNetIterator(str(tmp_path), 1, shuffle_buffer=1,
                                   image_size=32, resize_min=36,
                                   resize_max=40)
    eng = it.engine(device="cpu", workers=1)
    with pytest.raises(RuntimeError, match=r"train-00000-of-00001 record "
                       r"at offset 12: .*JPEG"):
        next(eng)
    eng.close()
    eng.close()  # idempotent
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        it.engine(device="cpu", mode="process")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        it.engine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(iter(imagenet.eval_examples(FIXTURES, 1)))
    stats = _stats(tmp_path)
    assert set(stats) == {"data_ring_occupancy", "data_ring_slots",
                          "data_decode_images_per_sec", "data_stream_seq"}
    assert stats["data_stream_seq"] == 1.0


def _stats(tmp_path):
    root = tmp_path / "ok"
    root.mkdir()
    write_shards(root, train_shards=1, per_shard=2, val_shards=1)
    it = imagenet.ImageNetIterator(str(root), 2, shuffle_buffer=2,
                                   image_size=32, resize_min=36,
                                   resize_max=40)
    eng = it.engine(device="cpu", workers=1, ring_slots=1)
    try:
        next(eng)
        return eng.stats()
    finally:
        eng.close()
