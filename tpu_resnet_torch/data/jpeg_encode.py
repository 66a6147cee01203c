"""A baseline JPEG encoder, numpy only, for the synthetic photos of
``doctor --data-bench`` (the reference makes them with PIL, which the port
may not import).

:func:`encode` writes a JFIF file as libjpeg does with its defaults:
YCbCr 4:2:0 (chroma averaged over 2x2 pixels), the standard quantization
tables of ITU-T T.81 Annex K scaled by ``quality`` as libjpeg scales them,
and the standard Huffman tables. The DCT and the Huffman coding are
vectorised, so a 640x480 photo encodes in well under a second. The
decoders read it: PIL, nvJPEG and ``data/jpeg.py``.
"""

from __future__ import annotations

import struct

import numpy as np

from tpu_resnet_torch.data.jpeg import ZIGZAG

# ITU-T T.81 Annex K.1, natural order.
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
_CHROMA_Q = np.full(64, 99, np.int64)
_CHROMA_Q.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                                   [24, 26, 56, 99], [47, 66, 99, 99]]

# ITU-T T.81 Annex K.3: (code counts by length 1..16, symbols), DC then AC,
# luma then chroma.
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
            bytes(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              bytes(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125],
            bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119],
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))

# The orthonormal DCT-II matrix: its 2-D transform is T.81's FDCT.
_DCT = np.array([[np.sqrt((1 if u else 0.5) / 4) *
                  np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` of a base table."""
    q = max(1, min(100, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _codes(table) -> tuple:
    """Canonical Huffman codes of a (counts, symbols) table: (code by
    symbol, length by symbol), 256 entries each."""
    counts, symbols = table
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code[symbols[k]], size[symbols[k]] = c, length
            c += 1
            k += 1
        c <<= 1
    return code, size


def _category(v: np.ndarray) -> tuple:
    """(bit count, extra bits) of each value, as T.81 F.1.2 codes them."""
    a = np.abs(v)
    nbits = np.zeros_like(a)
    while (a >> nbits).any():
        nbits += (a >> nbits) > 0
    extra = np.where(v < 0, v + (1 << nbits) - 1, v)
    return nbits, extra


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] (multiples of 8) -> [H/8, W/8, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _scan(zz: np.ndarray, klass: np.ndarray, comp: np.ndarray) -> bytes:
    """The entropy-coded scan of quantized zigzag blocks [n, 64] in scan
    order, ``klass`` 0 for luma tables and 1 for chroma's, ``comp`` each
    block's component (its own DC predictor)."""
    dc_tab = [_codes(_DC_LUMA), _codes(_DC_CHROMA)]
    ac_tab = [_codes(_AC_LUMA), _codes(_AC_CHROMA)]
    n = len(zz)
    # DC differences against the previous block of the same component.
    dc = zz[:, 0].copy()
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        idx = np.nonzero(comp == c)[0]
        diff[idx] = np.diff(dc[idx], prepend=0)
    keys, vals, lens = [], [], []

    def token(key, k, sym, nbits, extra, tabs):
        code = np.where(k == 0, tabs[0][0][sym], tabs[1][0][sym])
        size = np.where(k == 0, tabs[0][1][sym], tabs[1][1][sym])
        keys.append(key)
        vals.append((code << nbits) | extra)
        lens.append(size + nbits)

    blk = np.arange(n)
    nbits, extra = _category(diff)
    token(blk * 130, klass, nbits, nbits, extra, dc_tab)
    b, pos = np.nonzero(zz[:, 1:])
    pos = pos + 1
    prev = np.where(np.r_[False, b[1:] == b[:-1]], np.r_[0, pos[:-1]], 0)
    run = pos - prev - 1
    nbits, extra = _category(zz[b, pos])
    zrl = run // 16
    if zrl.any():  # (15, 0) for each 16 zeros before a coefficient
        zb = np.repeat(b, zrl)
        zk = klass[zb]
        token(zb * 130 + 2 * np.repeat(pos, zrl), zk,
              np.full(len(zb), 0xF0), np.zeros(len(zb), np.int64),
              np.zeros(len(zb), np.int64), ac_tab)
    token(b * 130 + 2 * pos + 1, klass[b], ((run % 16) << 4) | nbits,
          nbits, extra, ac_tab)
    last = np.zeros(n, np.int64)
    last[b] = pos  # the last nonzero position of each block
    eob = np.nonzero(last < 63)[0]
    token(eob * 130 + 129, klass[eob], np.zeros(len(eob), np.int64),
          np.zeros(len(eob), np.int64), np.zeros(len(eob), np.int64),
          ac_tab)
    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order]
    # Bits, most significant first, padded with 1s to a byte.
    ends = np.cumsum(lens)
    tok = np.repeat(np.arange(len(lens)), lens)
    shift = ends[tok] - 1 - np.arange(int(ends[-1]))
    bits = (vals[tok] >> shift) & 1
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.int64)])
    data = np.packbits(bits.astype(np.uint8))
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()  # byte stuffing


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def encode(rgb: np.ndarray, quality: int = 90) -> bytes:
    """uint8 [H, W, 3] RGB -> baseline JFIF bytes, YCbCr 4:2:0."""
    rgb = np.asarray(rgb, np.float64)
    h, w = rgb.shape[:2]
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    rgb = np.pad(rgb, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    q = [quant_table(_LUMA_Q, quality), quant_table(_CHROMA_Q, quality)]

    def coded(plane, table):
        blocks = _blocks(np.clip(plane, 0, 255) - 128)
        f = _DCT @ blocks @ _DCT.T
        return np.round(f / table.reshape(8, 8)).astype(np.int64)

    def half(plane):
        return plane.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3))

    yq, cbq, crq = (coded(y, q[0]), coded(half(cb), q[1]),
                    coded(half(cr), q[1]))
    my, mx = ph // 16, pw // 16
    # One MCU: four luma blocks (2x2, row by row), then Cb, then Cr.
    luma = yq.reshape(my, 2, mx, 2, 8, 8).transpose(0, 2, 1, 3, 4, 5)
    mcu = np.concatenate([luma.reshape(my, mx, 4, 8, 8),
                          cbq[:, :, None], crq[:, :, None]], axis=2)
    zz = mcu.reshape(-1, 64)[:, ZIGZAG]
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    klass = np.minimum(comp, 1)
    head = b"\xff\xd8" + _segment(
        0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    head += _segment(0xDB, b"".join(
        bytes([t]) + bytes(q[t][ZIGZAG].astype(np.uint8)) for t in (0, 1)))
    head += _segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) +
                     bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    head += _segment(0xC4, b"".join(
        bytes([tc]) + bytes(counts) + symbols for tc, (counts, symbols) in (
            (0x00, _DC_LUMA), (0x10, _AC_LUMA), (0x01, _DC_CHROMA),
            (0x11, _AC_CHROMA))))
    head += _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return head + _scan(zz, klass, comp) + b"\xff\xd9"


def synthetic_photo(size=(640, 480), rng=None, freqs=(8.0, 6.0)
                    ) -> np.ndarray:
    """A photo-like uint8 [H, W, 3] image: smooth structure and mild noise,
    which compresses about as real photos do (the reference's
    ``synthetic_photo_jpeg`` image)."""
    if rng is None:
        rng = np.random.default_rng(0)
    xs = np.linspace(0, freqs[0] * np.pi, size[0])
    ys = np.linspace(0, freqs[1] * np.pi, size[1])
    base = (np.sin(xs)[None, :, None] * np.cos(ys)[:, None, None] * 0.5
            + 0.5) * 255
    return (base + rng.integers(0, 30, (size[1], size[0], 3))).clip(
        0, 255).astype(np.uint8)


def synthetic_photo_jpeg(size=(640, 480), quality: int = 90, rng=None,
                         freqs=(8.0, 6.0)) -> bytes:
    """:func:`synthetic_photo` as a JPEG at ``quality``."""
    return encode(synthetic_photo(size, rng, freqs), quality)
