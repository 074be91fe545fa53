"""TFRecord + tf.train.Example IO without TensorFlow.

The reference delegates record IO to tf.data's C++ pipeline
(model/dataloader.py:176, utils/data_utils.py:10-102). This module is the
self-contained replacement: a wire-format reader/writer for the TFRecord
framing (length + masked-crc32c framing) and a minimal protobuf parser /
serializer for tf.train.Example — the only proto the pipeline needs.

Formats (public specs):
  TFRecord record  = uint64le length | u32 masked_crc(length) | payload |
                     u32 masked_crc(payload)
  Example          = message{ Features features = 1 }
  Features         = map<string, Feature> feature = 1
  Feature          = oneof{ BytesList=1, FloatList=2, Int64List=3 }
                     (each wrapping repeated value = 1; float/int64 packed)

A copy of merlot_tpu/data/tfrecord.py. The C++ fast path
(merlot_tpu_torch.data._native, built at first use) computes the CRC and
scans the record framing when it builds; this file is the always-available
pure-python/numpy fallback.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np

from merlot_tpu_torch.data import _native

# ----------------------------------------------------------------------
# crc32c (Castagnoli), table-driven; numpy table built once
# ----------------------------------------------------------------------
def _build_crc32c_table() -> np.ndarray:
    poly = 0x82F63B78
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table[i] = crc
    return table

_CRC_TABLE = _build_crc32c_table()

def crc32c(data: bytes) -> int:
    native = _native.load()
    if native is not None:
        return native.crc32c(data)
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = (crc >> 8) ^ int(table[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ----------------------------------------------------------------------
# TFRecord framing
# ----------------------------------------------------------------------
def _open(path: str, mode: str):
    """Local or remote (gs://, s3://...) file handle — the tf.gfile analogue
    (reference: utils/data_utils.py GCS paths)."""
    if "://" in path:
        import fsspec
        return fsspec.open(path, mode).open()
    return open(path, mode)


class TFRecordWriter:
    def __init__(self, path: str):
        self._f = _open(path, "wb")

    def write(self, payload: bytes) -> None:
        length = struct.pack("<Q", len(payload))
        self._f.write(length)
        self._f.write(struct.pack("<I", masked_crc(length)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc(payload)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def record_spans(path: str) -> List[Tuple[int, int]]:
    """(payload offset, length) of each record of a tfrecord file, from its
    headers alone: the scan seeks past every payload."""
    native = _native.load()
    if native is not None and "://" not in path:
        return native.read_record_spans(path, False)
    spans = []
    with _open(path, "rb") as f:
        size = f.seek(0, 2)
        offset = 0
        while offset < size:
            f.seek(offset)
            header = f.read(12)
            if len(header) < 12:
                raise IOError(f"truncated header in {path}")
            (length,) = struct.unpack("<Q", header[:8])
            if offset + 16 + length > size:
                raise IOError(f"truncated record in {path}")
            spans.append((offset + 12, length))
            offset += 16 + length
    return spans


def read_tfrecords(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from a tfrecord file.

    Uses the native framing scanner when built (one C pass computing spans
    + length CRCs, then zero-copy-ish slicing of a single bulk read)."""
    native = _native.load()
    if native is not None and "://" not in path:
        spans = native.read_record_spans(path, verify_crc)
        with open(path, "rb") as f:
            raw = f.read()
        for off, length in spans:
            yield raw[off:off + length]
        return
    with _open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (lcrc,) = struct.unpack("<I", header[8:12])
                if masked_crc(header[:8]) != lcrc:
                    raise IOError(f"bad length crc in {path}")
            payload = f.read(length)
            if len(payload) < length:
                raise IOError(f"truncated record in {path}")
            tail = f.read(4)
            if verify_crc:
                (pcrc,) = struct.unpack("<I", tail)
                if masked_crc(payload) != pcrc:
                    raise IOError(f"bad payload crc in {path}")
            yield payload


# ----------------------------------------------------------------------
# protobuf wire helpers
# ----------------------------------------------------------------------
def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_tag(out: bytearray, field: int, wire: int) -> None:
    _write_varint(out, (field << 3) | wire)


def _write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_tag(out, field, 2)
    _write_varint(out, len(payload))
    out.extend(payload)


# ----------------------------------------------------------------------
# tf.train.Example serialize
# ----------------------------------------------------------------------
def _encode_feature(value) -> bytes:
    """Build a Feature message from bytes / str / ints / floats."""
    out = bytearray()
    inner = bytearray()
    if isinstance(value, (bytes, str)):
        value = [value]
    value = list(value)
    if len(value) and isinstance(value[0], (bytes, str)):
        for v in value:
            if isinstance(v, str):
                v = v.encode("utf-8")
            _write_len_delimited(inner, 1, v)
        _write_len_delimited(out, 1, bytes(inner))          # bytes_list
    elif len(value) and isinstance(value[0], (float, np.floating)):
        packed = np.asarray(value, dtype="<f4").tobytes()
        _write_len_delimited(inner, 1, packed)              # packed floats
        _write_len_delimited(out, 2, bytes(inner))          # float_list
    else:
        for v in value:
            _write_tag(inner, 1, 0)
            _write_varint(inner, int(v) & 0xFFFFFFFFFFFFFFFF)
        _write_len_delimited(out, 3, bytes(inner))          # int64_list
    return bytes(out)


def encode_example(features: Dict[str, Any]) -> bytes:
    """dict -> serialized tf.train.Example bytes."""
    fmap = bytearray()
    for key in sorted(features.keys()):
        entry = bytearray()
        _write_len_delimited(entry, 1, key.encode("utf-8"))
        _write_len_delimited(entry, 2, _encode_feature(features[key]))
        _write_len_delimited(fmap, 1, bytes(entry))
    out = bytearray()
    _write_len_delimited(out, 1, bytes(fmap))
    return bytes(out)


# ----------------------------------------------------------------------
# tf.train.Example parse
# ----------------------------------------------------------------------
def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"bad wire type {wire}")
    return pos


def _parse_feature(buf: bytes):
    """Feature message -> list of bytes / np.float32 array / np.int64 array."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire != 2:
            pos = _skip_field(buf, pos, wire)
            continue
        n, pos = _read_varint(buf, pos)
        inner = buf[pos:pos + n]
        pos += n
        if field == 1:      # BytesList
            out: List[bytes] = []
            ipos = 0
            while ipos < len(inner):
                itag, ipos = _read_varint(inner, ipos)
                if itag & 7 != 2:
                    ipos = _skip_field(inner, ipos, itag & 7)
                    continue
                ln, ipos = _read_varint(inner, ipos)
                out.append(inner[ipos:ipos + ln])
                ipos += ln
            return out
        if field == 2:      # FloatList (packed or repeated)
            vals: List[float] = []
            ipos = 0
            while ipos < len(inner):
                itag, ipos = _read_varint(inner, ipos)
                iw = itag & 7
                if iw == 2:
                    ln, ipos = _read_varint(inner, ipos)
                    vals.extend(np.frombuffer(inner, dtype="<f4",
                                              count=ln // 4, offset=ipos))
                    ipos += ln
                elif iw == 5:
                    vals.append(float(np.frombuffer(inner, "<f4", 1, ipos)[0]))
                    ipos += 4
                else:
                    ipos = _skip_field(inner, ipos, iw)
            return np.asarray(vals, np.float32)
        if field == 3:      # Int64List
            vals = []
            ipos = 0
            while ipos < len(inner):
                itag, ipos = _read_varint(inner, ipos)
                iw = itag & 7
                if iw == 2:
                    ln, ipos = _read_varint(inner, ipos)
                    iend = ipos + ln
                    while ipos < iend:
                        v, ipos = _read_varint(inner, ipos)
                        vals.append(v)
                elif iw == 0:
                    v, ipos = _read_varint(inner, ipos)
                    vals.append(v)
                else:
                    ipos = _skip_field(inner, ipos, iw)
            arr = np.asarray(vals, np.uint64).astype(np.int64)
            return arr
    return []


def parse_example(payload: bytes) -> Dict[str, Any]:
    """Serialized tf.train.Example -> {key: bytes-list | float32[] | int64[]}."""
    out: Dict[str, Any] = {}
    pos = 0
    end = len(payload)
    while pos < end:
        tag, pos = _read_varint(payload, pos)
        if tag >> 3 != 1 or tag & 7 != 2:   # features field
            pos = _skip_field(payload, pos, tag & 7)
            continue
        n, pos = _read_varint(payload, pos)
        fmap = payload[pos:pos + n]
        pos += n
        fpos = 0
        while fpos < len(fmap):
            ftag, fpos = _read_varint(fmap, fpos)
            if ftag >> 3 != 1 or ftag & 7 != 2:   # map entry
                fpos = _skip_field(fmap, fpos, ftag & 7)
                continue
            en, fpos = _read_varint(fmap, fpos)
            entry = fmap[fpos:fpos + en]
            fpos += en
            key = None
            value = None
            epos = 0
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                ef, ew = etag >> 3, etag & 7
                if ew != 2:
                    epos = _skip_field(entry, epos, ew)
                    continue
                ln, epos = _read_varint(entry, epos)
                body = entry[epos:epos + ln]
                epos += ln
                if ef == 1:
                    key = body.decode("utf-8")
                elif ef == 2:
                    value = _parse_feature(body)
            if key is not None:
                out[key] = value
    return out
