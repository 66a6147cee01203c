"""The plain JPEG decoder: numpy only, the CPU half of the ImageNet decode
stage and the oracle that the card's nvJPEG stage is held against.

What the reference decodes with (``PIL.Image.open(...).convert("RGB")``,
libjpeg-turbo underneath) is reproduced step by step with libjpeg's own
integer arithmetic, so that a decode here is PIL's:

- baseline (SOF0) and extended (SOF1) sequential Huffman JPEG, 8-bit, one
  or more scans, restart intervals;
- one component (grey, returned as RGB with the value in all three, as
  ``convert("RGB")`` does) or three (YCbCr, or RGB where an Adobe marker
  says transform 0 or the component ids spell R, G, B);
- sampling 4:4:4, 4:2:2 and 4:2:0;
- the islow inverse DCT (``jidctint.c``: 13-bit constants, two passes, the
  post-IDCT range table), libjpeg's "fancy" triangle upsampling of chroma
  (``jdsample.c`` ``h2v1_fancy_upsample``/``h2v2_fancy_upsample``, edges
  replicated) and its YCbCr → RGB tables (``jdcolor.c``, 16-bit fixed
  point).

Anything else (progressive SOF2, lossless, arithmetic coding, 12-bit,
CMYK/YCCK, other samplings) raises ``ValueError`` naming what it found.
The Huffman decode is a Python loop over symbols with 16-bit lookup
tables; the IDCT, upsampling and colour conversion are vectorised.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# Natural-order index of each zigzag position.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)
_ZZ = ZIGZAG.tolist()

# Start-of-frame markers this decoder refuses, by name.
_SOF_NAMES = {0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
              0xC5: "differential sequential (SOF5)",
              0xC6: "differential progressive (SOF6)",
              0xC7: "differential lossless (SOF7)",
              0xC9: "arithmetic sequential (SOF9)",
              0xCA: "arithmetic progressive (SOF10)",
              0xCB: "arithmetic lossless (SOF11)",
              0xCD: "arithmetic differential (SOF13)",
              0xCE: "arithmetic differential progressive (SOF14)",
              0xCF: "arithmetic differential lossless (SOF15)"}
# (h, v) of the luma component → sampling name, chroma at (1, 1).
SAMPLINGS = {(1, 1): "4:4:4", (2, 1): "4:2:2", (2, 2): "4:2:0"}


def _huffman_lut(counts: List[int], symbols: bytes) -> List[int]:
    """16-bit lookup: entry = (code length << 8) | symbol, 0 where no code
    starts with those bits."""
    lut = np.zeros(1 << 16, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("corrupt JPEG: bad Huffman table")
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


class _Frame:
    def __init__(self):
        self.quant: Dict[int, np.ndarray] = {}
        self.dc: Dict[int, List[int]] = {}
        self.ac: Dict[int, List[int]] = {}
        self.restart = 0
        self.width = self.height = 0
        self.comps: List[dict] = []
        self.adobe_transform = None
        self.jfif = False


def _segments(scan: np.ndarray) -> List[np.ndarray]:
    """An entropy-coded run → its restart intervals, stuffed zero bytes
    removed."""
    ff = np.flatnonzero(scan[:-1] == 0xFF)
    nxt = scan[ff + 1]
    cuts = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    keep = np.ones(len(scan), bool)
    keep[ff[nxt == 0] + 1] = False
    out, start = [], 0
    for c in cuts.tolist() + [len(scan)]:
        out.append(scan[start:c][keep[start:c]])
        start = c + 2
    return out


def _words(seg: np.ndarray) -> List[int]:
    """Big-endian 32-bit words at every byte offset of ``seg`` (zeros past
    its end, as libjpeg inserts zeros where the data runs out)."""
    b = np.concatenate([seg, np.zeros(8, np.uint8)]).astype(np.int64)
    return (b[:-3] << 24 | b[1:-2] << 16 | b[2:-1] << 8 | b[3:]).tolist()


def _decode_scan(frame: _Frame, scomps: List[Tuple[dict, int, int]],
                 scan: np.ndarray) -> None:
    """Huffman-decode one sequential scan into the components' ``coef``
    lists (natural order, not dequantized)."""
    hmax = max(c["h"] for c in frame.comps)
    vmax = max(c["v"] for c in frame.comps)
    if len(scomps) == 1:  # non-interleaved: the component's own blocks
        c = scomps[0][0]
        units = [((0, (by * c["gw"] + bx) * 64),)
                 for by in range(c["bh"]) for bx in range(c["bw"])]
    else:
        mcux = -(-frame.width // (8 * hmax))
        mcuy = -(-frame.height // (8 * vmax))
        units = [tuple((ci, ((my * c["v"] + y) * c["gw"] + mx * c["h"] + x)
                        * 64)
                       for ci, (c, _, _) in enumerate(scomps)
                       for y in range(c["v"]) for x in range(c["h"]))
                 for my in range(mcuy) for mx in range(mcux)]
    comps = [(c["coef"], frame.dc[td], frame.ac[ta]) for c, td, ta in scomps]
    every = frame.restart or len(units)
    intervals = -(-len(units) // every)
    segs = _segments(scan)
    if len(segs) < intervals:
        raise ValueError("corrupt JPEG: missing restart intervals")
    zz = _ZZ
    for si in range(intervals):
        v = _words(segs[si])
        limit = 8 * len(segs[si]) + 32
        p = 0
        pred = [0] * len(comps)
        for unit in units[si * every:(si + 1) * every]:
            for ci, base in unit:
                coef, dclut, aclut = comps[ci]
                e = dclut[(v[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise ValueError("corrupt JPEG: bad Huffman code")
                p += e >> 8
                s = e & 0xFF
                if s:
                    x = (v[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    if x < 1 << (s - 1):
                        x -= (1 << s) - 1
                    pred[ci] += x
                coef[base] = pred[ci]
                k = 1
                while k < 64:
                    e = aclut[(v[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if not e:
                        raise ValueError("corrupt JPEG: bad Huffman code")
                    p += e >> 8
                    rs = e & 0xFF
                    s = rs & 15
                    if s:
                        k += rs >> 4
                        if k > 63:
                            raise ValueError("corrupt JPEG: AC index "
                                             "past 63")
                        x = (v[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                        p += s
                        if x < 1 << (s - 1):
                            x -= (1 << s) - 1
                        coef[base + zz[k]] = x
                        k += 1
                    elif rs == 0xF0:
                        k += 16
                    else:
                        break
            if p > limit:
                raise ValueError("corrupt JPEG: scan data ends early")


# --------------------------------------------------------- islow IDCT
_F = {name: val for name, val in (
    ("0_298631336", 2446), ("0_390180644", 3196), ("0_541196100", 4433),
    ("0_765366865", 6270), ("0_899976223", 7373), ("1_175875602", 9633),
    ("1_501321110", 12299), ("1_847759065", 15137), ("1_961570560", 16069),
    ("2_053119869", 16819), ("2_562915447", 20995),
    ("3_072711026", 25172))}
_CONST_BITS, _PASS1_BITS = 13, 2


def _idct_1d(d, shift: int):
    """One pass of ``jpeg_idct_islow`` over axis -1 of int64 ``d`` (8
    values), descaled by ``shift``."""
    def descale(x):
        return (x + (1 << (shift - 1))) >> shift
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * _F["0_541196100"]
    tmp2 = z1 + z3 * -_F["1_847759065"]
    tmp3 = z1 + z2 * _F["0_765366865"]
    tmp0 = (d[..., 0] + d[..., 4]) << _CONST_BITS
    tmp1 = (d[..., 0] - d[..., 4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F["1_175875602"]
    t0 = t0 * _F["0_298631336"]
    t1 = t1 * _F["2_053119869"]
    t2 = t2 * _F["3_072711026"]
    t3 = t3 * _F["1_501321110"]
    z1 = z1 * -_F["0_899976223"]
    z2 = z2 * -_F["2_562915447"]
    z3 = z3 * -_F["1_961570560"] + z5
    z4 = z4 * -_F["0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return np.stack([descale(tmp10 + t3), descale(tmp11 + t2),
                     descale(tmp12 + t1), descale(tmp13 + t0),
                     descale(tmp13 - t0), descale(tmp12 - t1),
                     descale(tmp11 - t2), descale(tmp10 - t3)], axis=-1)


def _range_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit, indexed by (value & 1023)."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_RANGE = _range_table()


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """int [N, 64] natural-order coefficients and quant [64] → uint8
    [N, 8, 8] samples, as libjpeg's ``jpeg_idct_islow``."""
    d = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    cols = _idct_1d(np.swapaxes(d, 1, 2), _CONST_BITS - _PASS1_BITS)
    ws = np.swapaxes(cols, 1, 2).astype(np.int32).astype(np.int64)
    rows = _idct_1d(ws, _CONST_BITS + _PASS1_BITS + 3)
    return _RANGE[rows & 1023]


# ---------------------------------------------------------- upsampling
def _fancy_h2(x: np.ndarray, bias_left: int, bias_right: int,
              shift: int) -> np.ndarray:
    """Horizontal triangle upsample by 2 of int rows ``x`` [R, W] (already
    weighted: 3·near + far per output, libjpeg's column sums for h2v2)."""
    pad = np.concatenate([x[:, :1], x, x[:, -1:]], axis=1)
    left = (3 * pad[:, 1:-1] + pad[:, :-2] + bias_left) >> shift
    right = (3 * pad[:, 1:-1] + pad[:, 2:] + bias_right) >> shift
    return np.stack([left, right], axis=2).reshape(x.shape[0], -1)


def upsample(plane: np.ndarray, h: int, v: int, width: int,
             height: int) -> np.ndarray:
    """A chroma plane sampled (1/h, 1/v) of the luma's → the image's
    [height, width], by libjpeg's fancy upsampling (h2v1 or h2v2)."""
    x = plane.astype(np.int64)
    if (h, v) == (1, 1):
        out = x
    elif x.shape[1] <= 2:  # libjpeg replicates where fancy has no room
        out = np.repeat(np.repeat(x, h, axis=1), v, axis=0)
    elif (h, v) == (2, 1):
        out = _fancy_h2(x, 1, 2, 2)
    else:  # (2, 2): vertical 3·near + far column sums, then horizontal
        pad = np.concatenate([x[:1], x, x[-1:]], axis=0)
        above = 3 * pad[1:-1] + pad[:-2]
        below = 3 * pad[1:-1] + pad[2:]
        sums = np.stack([above, below], axis=1).reshape(-1, x.shape[1])
        out = _fancy_h2(sums, 8, 7, 4)
    return out[:height, :width].astype(np.uint8)


# ------------------------------------------------------ colour convert
def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


_C = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _C + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _C + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _C
_CB_G = -_fix(0.34414) * _C + (1 << 15)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8 planes → uint8 [H, W, 3], libjpeg's ``ycc_rgb_convert``."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# -------------------------------------------------------------- parse
def _parse(data: bytes) -> Tuple[_Frame, list]:
    """Markers → the frame and its scans [(components, scan bytes)]."""
    buf = np.frombuffer(data, np.uint8)
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise ValueError("not a JPEG: no SOI marker")
    frame, scans = _Frame(), []
    pos, n = 2, len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG: no marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError("corrupt JPEG: truncated marker")
        length = data[pos] << 8 | data[pos + 1]
        body = data[pos + 2:pos + length]
        if len(body) != length - 2:
            raise ValueError(f"corrupt JPEG: truncated marker 0x{marker:02X}")
        pos += length
        if marker in (0xC0, 0xC1):
            if body[0] != 8:
                raise ValueError(f"unsupported JPEG: {body[0]}-bit samples")
            frame.height = body[1] << 8 | body[2]
            frame.width = body[3] << 8 | body[4]
            ncomp = body[5]
            for i in range(ncomp):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                frame.comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                                    "tq": tq})
        elif marker in _SOF_NAMES:
            raise ValueError(f"unsupported JPEG: {_SOF_NAMES[marker]}")
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                symbols = body[i + 17:i + 17 + sum(counts)]
                (frame.ac if tc else frame.dc)[th] = _huffman_lut(counts,
                                                                  symbols)
                i += 17 + sum(counts)
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                raw = np.frombuffer(body[i + 1:i + 1 + size],
                                    ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = raw
                frame.quant[tq] = q
                i += 1 + size
        elif marker == 0xDD:  # DRI
            frame.restart = body[0] << 8 | body[1]
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            frame.jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            frame.adobe_transform = body[11]
        elif marker == 0xDA:  # SOS
            if not frame.comps:
                raise ValueError("corrupt JPEG: SOS before SOF")
            ns = body[0]
            byid = {c["id"]: c for c in frame.comps}
            scomps = []
            for i in range(ns):
                cid, t = body[1 + 2 * i:3 + 2 * i]
                if cid not in byid:
                    raise ValueError("corrupt JPEG: unknown scan component")
                scomps.append((byid[cid], t >> 4, t & 15))
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                raise ValueError("unsupported JPEG: not a sequential scan")
            # The scan runs to the first marker that is not a restart.
            hit = np.flatnonzero(buf[pos:-1] == 0xFF)
            nxt = buf[pos + hit + 1]
            stop = hit[(nxt != 0) & ((nxt < 0xD0) | (nxt > 0xD7))]
            end = pos + int(stop[0]) if len(stop) else n
            scans.append((scomps, buf[pos:end]))
            pos = end
        elif marker in (0xC8, 0xCC, 0xDC, 0xDE, 0xDF):
            raise ValueError(f"unsupported JPEG: marker 0x{marker:02X}")
    if not frame.comps or not scans:
        raise ValueError("corrupt JPEG: no frame or no scan")
    return frame, scans


def _check(frame: _Frame) -> str:
    """The colour model this decoder produces, or ValueError."""
    comps = frame.comps
    if len(comps) == 4:
        raise ValueError("unsupported JPEG: CMYK/YCCK (4 components)")
    if len(comps) not in (1, 3):
        raise ValueError(f"unsupported JPEG: {len(comps)} components")
    if frame.width < 1 or frame.height < 1:
        raise ValueError("corrupt JPEG: empty image")
    if len(comps) == 3:
        luma = (comps[0]["h"], comps[0]["v"])
        if luma not in SAMPLINGS or any((c["h"], c["v"]) != (1, 1)
                                        for c in comps[1:]):
            raise ValueError("unsupported JPEG: sampling "
                             f"{[(c['h'], c['v']) for c in comps]}")
        if frame.jfif:
            return "ycc"
        if frame.adobe_transform is not None:
            return "rgb" if frame.adobe_transform == 0 else "ycc"
        return "rgb" if [c["id"] for c in comps] == [82, 71, 66] else "ycc"
    return "grey"


def decode(data: bytes) -> np.ndarray:
    """JPEG bytes → uint8 [H, W, 3] RGB, as PIL's ``open(...).convert(
    "RGB")`` gives it (see the module docstring for what is covered)."""
    frame, scans = _parse(data)
    model = _check(frame)
    hmax = max(c["h"] for c in frame.comps)
    vmax = max(c["v"] for c in frame.comps)
    mcux = -(-frame.width // (8 * hmax))
    mcuy = -(-frame.height // (8 * vmax))
    for c in frame.comps:
        c["dw"] = -(-frame.width * c["h"] // hmax)
        c["dh"] = -(-frame.height * c["v"] // vmax)
        c["bw"], c["bh"] = -(-c["dw"] // 8), -(-c["dh"] // 8)
        c["gw"], c["gh"] = mcux * c["h"], mcuy * c["v"]
        c["coef"] = [0] * (c["gw"] * c["gh"] * 64)
        if c["tq"] not in frame.quant:
            raise ValueError("corrupt JPEG: missing quantization table")
    for scomps, scan in scans:
        for _, td, ta in scomps:
            if td not in frame.dc or ta not in frame.ac:
                raise ValueError("corrupt JPEG: missing Huffman table")
        try:
            _decode_scan(frame, scomps, scan)
        except IndexError:
            raise ValueError("corrupt JPEG: scan data ends early") from None
    planes = []
    for c in frame.comps:
        blocks = idct_islow(np.array(c["coef"], np.int64).reshape(-1, 64),
                            frame.quant[c["tq"]])
        grid = blocks.reshape(c["gh"], c["gw"], 8, 8)[:c["bh"], :c["bw"]]
        plane = grid.transpose(0, 2, 1, 3).reshape(c["bh"] * 8,
                                                   c["bw"] * 8)
        plane = plane[:c["dh"], :c["dw"]]
        planes.append(upsample(plane, hmax // c["h"], vmax // c["v"],
                               frame.width, frame.height))
    if model == "grey":
        return np.repeat(planes[0][:, :, None], 3, axis=2)
    if model == "rgb":
        return np.stack(planes, axis=-1)
    return ycc_to_rgb(*planes)


def sampling(data: bytes) -> str:
    """"grey", "4:4:4", "4:2:2" or "4:2:0" of a JPEG this decoder takes."""
    frame, _ = _parse(data)
    if _check(frame) == "grey":
        return "grey"
    return SAMPLINGS[(frame.comps[0]["h"], frame.comps[0]["v"])]
