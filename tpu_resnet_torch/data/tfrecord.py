"""TFRecord framing and the ``tf.train.Example`` codec, numpy and stdlib only
(port of ``tpu_resnet/data/tfrecord.py``; the native reader is not ported).

ImageNet shards are Inception-style TFRecord files: records framed as
``uint64 length | uint32 masked_crc32c(length) | bytes data | uint32
masked_crc32c(data)``, the mask ``((crc >> 15 | crc << 17) + 0xa282ead8) &
0xffffffff`` over CRC-32C (Castagnoli), each record a serialized Example
whose features map ``image/encoded`` and ``image/class/label`` (the subset
of the protobuf wire format that Inception shards use).

:func:`masked_crc32c_fast` takes the place of the reference's native CRC:
the record is cut into chunks whose CRCs advance together as one numpy
vector, and the chunks' CRCs are then folded pairwise (CRC is linear over
GF(2), so a CRC moves past n zero bytes by a fixed 32x32 bit matrix).
"""

from __future__ import annotations

import functools
import os
import struct
from typing import Dict, Iterator, List, Union

import numpy as np

# ------------------------------------------------------------------ crc32c
_CRC32C_POLY = 0x82F63B78


def _make_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_CRC32C_POLY if crc & 1 else 0)
        table[i] = crc
    return table


_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    table = _TABLE
    crc_val = 0xFFFFFFFF
    for b in data:
        crc_val = (crc_val >> 8) ^ int(table[(crc_val ^ b) & 0xFF])
    return crc_val ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# Bytes a chunk of the vectorised CRC (a power of two), and the records
# below which the byte loop is quicker.
_CHUNK = 64
_FAST_MIN = 1024


def _apply(cols: np.ndarray, v: int) -> int:
    """The 32x32 GF(2) matrix with columns ``cols`` times the bits of v."""
    out = 0
    for j in range(32):
        if v >> j & 1:
            out ^= int(cols[j])
    return out


@functools.lru_cache(maxsize=None)
def _shift_tables(nbytes: int) -> np.ndarray:
    """uint32 [4, 256]: the CRC register moved past ``nbytes`` zero bytes,
    as four byte tables (``nbytes`` a power of two)."""
    if nbytes == 1:
        cols = np.array([(1 << j) >> 8 ^ int(_TABLE[(1 << j) & 0xFF])
                         for j in range(32)], np.uint32)
    else:
        half = _shift_tables(nbytes // 2)
        half_cols = np.array([_lookup(half, 1 << j) for j in range(32)],
                             np.uint32)
        cols = np.array([_apply(half_cols, int(c)) for c in half_cols],
                        np.uint32)
    tables = np.zeros((4, 256), np.uint32)
    for k in range(4):
        for bit in range(8):
            on = (np.arange(256) >> bit & 1).astype(bool)
            tables[k, on] ^= cols[8 * k + bit]
    return tables


def _lookup(tables: np.ndarray, v):
    """Apply a shift's byte tables to v (an int or a uint32 array)."""
    if isinstance(v, int):
        return int(tables[0, v & 0xFF] ^ tables[1, v >> 8 & 0xFF]
                   ^ tables[2, v >> 16 & 0xFF] ^ tables[3, v >> 24])
    return (tables[0, v & 0xFF] ^ tables[1, v >> 8 & 0xFF]
            ^ tables[2, v >> 16 & 0xFF] ^ tables[3, v >> 24])


def crc32c_fast(data: bytes) -> int:
    """``crc32c(data)``, vectorised over chunks of the record."""
    n = len(data)
    if n < _FAST_MIN:
        return crc32c(data)
    # The initial 0xffffffff equals XORing the first four bytes with 0xff
    # from a zero register; leading zero bytes leave a zero register as it
    # is, so the front is padded to a power-of-two count of chunks.
    chunks = 1 << (-(-n // _CHUNK) - 1).bit_length()
    buf = np.zeros(chunks * _CHUNK, np.uint8)
    buf[-n:] = np.frombuffer(data, np.uint8)
    buf[-n:-n + 4] ^= 0xFF
    rows = buf.reshape(chunks, _CHUNK).astype(np.uint32)
    crc = np.zeros(chunks, np.uint32)
    for i in range(_CHUNK):
        crc = (crc >> 8) ^ _TABLE[(crc ^ rows[:, i]) & 0xFF]
    span = _CHUNK
    while len(crc) > 1:
        crc = _lookup(_shift_tables(span), crc[0::2]) ^ crc[1::2]
        span *= 2
    return int(crc[0]) ^ 0xFFFFFFFF


def masked_crc32c_fast(data: bytes) -> int:
    """``masked_crc32c`` through :func:`crc32c_fast`, for verification on
    the read path."""
    crc = crc32c_fast(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ----------------------------------------------------------- record framing
def write_records(path: str, records: List[bytes]) -> None:
    with open(path, "wb") as f:
        for rec in records:
            length = struct.pack("<Q", len(rec))
            f.write(length)
            f.write(struct.pack("<I", masked_crc32c(length)))
            f.write(rec)
            f.write(struct.pack("<I", masked_crc32c_fast(rec)))


def record_index(path: str) -> List[tuple]:
    """[(payload_offset, payload_length)] for every record: a seek-only
    framing scan that reads 12 header bytes per record and skips payloads,
    so indexing a shard costs header IO only."""
    out = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos < size:
            f.seek(pos)
            header = f.read(12)
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            out.append((pos + 12, length))
            pos += 12 + length + 4
    if pos != size:
        raise ValueError(f"{path}: trailing bytes after last record")
    return out


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Stream raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (want,) = struct.unpack("<I", header[8:12])
                if masked_crc32c(header[:8]) != want:
                    raise ValueError(f"{path}: length CRC mismatch")
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"{path}: truncated record body")
            footer = f.read(4)
            if verify_crc:
                (want,) = struct.unpack("<I", footer)
                if masked_crc32c_fast(data) != want:
                    raise ValueError(f"{path}: data CRC mismatch")
            yield data


# ------------------------------------------------------- protobuf wire codec
def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _decode_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _encode_varint((field << 3) | wire)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _encode_varint(len(payload)) + payload


FeatureValue = Union[List[bytes], List[int], List[float]]


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Dict → serialized tf.train.Example. Value type picks the Feature kind:
    bytes → bytes_list, int → int64_list, float → float_list."""
    feat_entries = b""
    for key, values in features.items():
        if not isinstance(values, (list, tuple)):
            values = [values]
        if all(isinstance(v, bytes) for v in values):
            inner = b"".join(_len_delimited(1, v) for v in values)
            feature = _len_delimited(1, inner)
        elif all(isinstance(v, (int, np.integer)) for v in values):
            inner = b""
            for v in values:
                inner += _tag(1, 0) + _encode_varint(int(v) & (2**64 - 1))
            feature = _len_delimited(3, inner)
        elif all(isinstance(v, (float, np.floating)) for v in values):
            # float_list: packed floats under field 1
            packed = np.asarray(values, "<f4").tobytes()
            feature = _len_delimited(2, _len_delimited(1, packed))
        else:
            raise TypeError(f"mixed/unsupported feature values for {key!r}")
        entry = _len_delimited(1, key.encode()) + _len_delimited(2, feature)
        feat_entries += _len_delimited(1, entry)
    return _len_delimited(1, feat_entries)


def _parse_feature(buf: bytes):
    """Feature message → python list (bytes/ints/floats)."""
    pos = 0
    while pos < len(buf):
        tag, pos = _decode_varint(buf, pos)
        field = tag >> 3
        ln, pos = _decode_varint(buf, pos)
        payload = buf[pos:pos + ln]
        pos += ln
        if field == 1:  # BytesList
            out, p = [], 0
            while p < len(payload):
                t, p = _decode_varint(payload, p)
                l2, p = _decode_varint(payload, p)
                out.append(payload[p:p + l2])
                p += l2
            return out
        if field == 2:  # FloatList (packed under field 1)
            out, p = [], 0
            while p < len(payload):
                t, p = _decode_varint(payload, p)
                if t & 7 == 2:
                    l2, p = _decode_varint(payload, p)
                    out.extend(np.frombuffer(payload[p:p + l2],
                                             "<f4").tolist())
                    p += l2
                else:  # unpacked single float
                    out.append(np.frombuffer(payload[p:p + 4],
                                             "<f4")[0].item())
                    p += 4
            return out
        if field == 3:  # Int64List
            out, p = [], 0
            while p < len(payload):
                t, p = _decode_varint(payload, p)
                if t & 7 == 2:  # packed
                    l2, p = _decode_varint(payload, p)
                    end = p + l2
                    while p < end:
                        v, p = _decode_varint(payload, p)
                        out.append(v - 2**64 if v >= 2**63 else v)
                else:
                    v, p = _decode_varint(payload, p)
                    out.append(v - 2**64 if v >= 2**63 else v)
            return out
    return []


def parse_example(serialized: bytes) -> Dict[str, list]:
    """Serialized Example → {key: list-of-values} for the subset of the wire
    format Inception/ImageNet shards use."""
    out: Dict[str, list] = {}
    pos = 0
    buf = serialized
    while pos < len(buf):
        tag, pos = _decode_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire != 2:
            raise ValueError(f"unexpected wire type {wire} at top level")
        ln, pos = _decode_varint(buf, pos)
        features_buf = buf[pos:pos + ln]
        pos += ln
        if field != 1:
            continue
        fpos = 0
        while fpos < len(features_buf):
            _, fpos = _decode_varint(features_buf, fpos)
            fln, fpos = _decode_varint(features_buf, fpos)
            entry = features_buf[fpos:fpos + fln]
            fpos += fln
            # map entry: key=1 (string), value=2 (Feature)
            key = None
            value: list = []
            epos = 0
            while epos < len(entry):
                etag, epos = _decode_varint(entry, epos)
                eln, epos = _decode_varint(entry, epos)
                payload = entry[epos:epos + eln]
                epos += eln
                if etag >> 3 == 1:
                    key = payload.decode()
                elif etag >> 3 == 2:
                    value = _parse_feature(payload)
            if key is not None:
                out[key] = value
    return out
