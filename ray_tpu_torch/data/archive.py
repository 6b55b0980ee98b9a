"""Sharded-archive datasources: TFRecord files and WebDataset-style tars.

These are the archive formats large image/text pipelines ship training
data in (reference capability: python/ray/data/_internal/datasource/
tfrecords_datasource.py and webdataset_datasource.py) — one archive file is
one read task, so a directory of shards parallelizes naturally and feeds
`iter_device_batches`'s host→device prefetch.

The TFRecord wire format (public spec): per record
  uint64 length | uint32 masked_crc32c(length) | bytes data |
  uint32 masked_crc32c(data)
implemented here without a tensorflow dependency (crc32c is the Castagnoli
polynomial, software table; records round-trip against the spec's test
vectors). Payload parsing is the caller's business — records surface as
{"bytes": ...} rows, with an optional tf.train.Example feature decoder for
the common case.
"""

from __future__ import annotations

import io
import json
import os
import struct
import tarfile
from typing import Any, Callable, Iterator

import numpy as np

from ray_tpu_torch.data.block import rows_to_block
from ray_tpu_torch.data.datasource import FileDatasource

# ------------------------------------------------------------------ crc32c


def _make_crc32c_table() -> list[int]:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc32c_table()


def _crc32c_py(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


try:  # the C implementations are ~100x the pure-Python table loop
    from crc32c import crc32c as crc32c  # type: ignore[no-redef]
except ImportError:
    try:
        from google_crc32c import value as crc32c  # type: ignore[no-redef]
    except ImportError:
        crc32c = _crc32c_py


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------------- tfrecord


def iter_tfrecords(path: str, *, verify_crc: bool = True) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise ValueError(f"truncated tfrecord header in {path}")
            (length,), (len_crc,) = (struct.unpack("<Q", head[:8]),
                                     struct.unpack("<I", head[8:]))
            if verify_crc and _masked_crc(head[:8]) != len_crc:
                raise ValueError(f"corrupt tfrecord length crc in {path}")
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"truncated tfrecord payload in {path}")
            crc_bytes = f.read(4)
            if len(crc_bytes) < 4:
                raise ValueError(f"truncated tfrecord crc in {path}")
            (data_crc,) = struct.unpack("<I", crc_bytes)
            if verify_crc and _masked_crc(data) != data_crc:
                raise ValueError(f"corrupt tfrecord data crc in {path}")
            yield data


def write_tfrecord_file(path: str, records) -> int:
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            rec = bytes(rec)
            head = struct.pack("<Q", len(rec))
            f.write(head)
            f.write(struct.pack("<I", _masked_crc(head)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))
            n += 1
    return n


def _pad_rows(rows: list[dict]) -> list[dict]:
    """Archive samples may have optional members/features: block columns
    are the key UNION, absent values become None (rows_to_block schemas
    off row 0, so ragged rows would KeyError or silently drop columns)."""
    keys: list[str] = []
    seen = set()
    for r in rows:
        for k in r:
            if k not in seen:
                seen.add(k)
                keys.append(k)
    return [{k: r.get(k) for k in keys} for r in rows]


class TFRecordDatasource(FileDatasource):
    """{"bytes": record} rows, or decoded feature columns with a decoder.

    `decode="example"` parses tf.train.Example protos with a minimal
    hand-rolled wire-format reader (bytes_list/float_list/int64_list) — no
    tensorflow/protobuf dependency.
    """

    suffixes = (".tfrecord", ".tfrecords")

    def __init__(self, paths, *, decode: str | Callable | None = None,
                 verify_crc: bool = True):
        super().__init__(paths)
        self.decode = decode
        self.verify_crc = verify_crc

    def read_file(self, path: str) -> list:
        rows = []
        for rec in iter_tfrecords(path, verify_crc=self.verify_crc):
            if self.decode is None:
                rows.append({"bytes": rec})
            elif self.decode == "example":
                rows.append(parse_example(rec))
            else:
                rows.append(self.decode(rec))
        return [rows_to_block(_pad_rows(rows))] if rows else []


# A minimal tf.train.Example reader. Wire format (public protobuf spec):
# Example{ features: Features{ feature: map<string, Feature> } } where
# Feature is a oneof of BytesList/FloatList/Int64List.


def _read_varint(buf: memoryview, i: int) -> tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(buf: memoryview) -> Iterator[tuple[int, int, Any]]:
    """(field_number, wire_type, value) for one message."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v, i = _read_varint(buf, i)
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:  # 32-bit
            v = buf[i:i + 4]
            i += 4
        elif wt == 1:  # 64-bit
            v = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, v


def _parse_feature(buf: memoryview):
    # protobuf repeated scalars arrive packed (one length-delimited blob)
    # OR unpacked (one wire entry per element) — parsers must accept both
    for field, _wt, v in _fields(buf):
        if field == 1:  # BytesList
            return [bytes(x) for f2, _w, x in _fields(v) if f2 == 1]
        if field == 2:  # FloatList.value
            vals: list = []
            for f2, w2, x in _fields(v):
                if f2 != 1:
                    continue
                if w2 == 2:  # packed
                    vals.extend(struct.unpack(f"<{len(x) // 4}f", bytes(x)))
                elif w2 == 5:  # unpacked fixed32
                    vals.extend(struct.unpack("<f", bytes(x)))
            return vals
        if field == 3:  # Int64List.value
            ints: list = []
            for f2, w2, x in _fields(v):
                if f2 != 1:
                    continue
                if w2 == 2:  # packed varints
                    i = 0
                    while i < len(x):
                        val, i = _read_varint(x, i)
                        if val >= 1 << 63:
                            val -= 1 << 64  # two's-complement int64
                        ints.append(val)
                elif w2 == 0:  # unpacked varint
                    val = x
                    if val >= 1 << 63:
                        val -= 1 << 64
                    ints.append(val)
            return ints
    return []


def parse_example(rec: bytes) -> dict:
    """tf.train.Example bytes → {feature_name: value(s)}; single-element
    lists unwrap to scalars, matching common pipelines."""
    row: dict = {}
    buf = memoryview(rec)
    for field, _wt, feats in _fields(buf):
        if field != 1:  # Example.features
            continue
        for f2, _w, entry in _fields(feats):
            if f2 != 1:  # Features.feature map entry
                continue
            name, value = None, []
            for f3, _w3, v3 in _fields(entry):
                if f3 == 1:
                    name = bytes(v3).decode()
                elif f3 == 2:
                    value = _parse_feature(v3)
            if name is not None:
                row[name] = value[0] if len(value) == 1 else value
    return row


def encode_example(row: dict) -> bytes:
    """{name: scalar|list of bytes/float/int} → tf.train.Example bytes
    (the writer-side twin of parse_example; used by write_tfrecords)."""

    def varint(n: int) -> bytes:
        if n < 0:
            n += 1 << 64
        out = bytearray()
        while True:
            b = n & 0x7F
            n >>= 7
            out.append(b | (0x80 if n else 0))
            if not n:
                return bytes(out)

    def ld(field: int, payload: bytes) -> bytes:
        return varint(field << 3 | 2) + varint(len(payload)) + payload

    entries = b""
    for name, val in row.items():
        vals = val if isinstance(val, (list, tuple, np.ndarray)) else [val]
        vals = list(vals)
        if all(isinstance(v, (bytes, str)) for v in vals):
            bl = b"".join(ld(1, v.encode() if isinstance(v, str) else v)
                          for v in vals)
            feature = ld(1, bl)
        elif all(isinstance(v, (int, np.integer)) for v in vals):
            packed = b"".join(varint(int(v)) for v in vals)
            feature = ld(3, ld(1, packed))
        else:
            packed = struct.pack(f"<{len(vals)}f", *[float(v) for v in vals])
            feature = ld(2, ld(1, packed))
        entries += ld(1, ld(1, name.encode()) + ld(2, feature))
    return ld(1, entries)


# --------------------------------------------------------------- webdataset


_WDS_DECODERS: dict[str, Callable[[bytes], Any]] = {
    "txt": lambda b: b.decode(),
    "cls": lambda b: int(b.decode()),
    "json": lambda b: json.loads(b.decode()),
    "npy": lambda b: np.load(io.BytesIO(b), allow_pickle=False),
}


def _decode_wds(ext: str, data: bytes, decode_images: bool):
    if ext in _WDS_DECODERS:
        return _WDS_DECODERS[ext](data)
    if decode_images and ext in ("jpg", "jpeg", "png", "bmp"):
        try:
            from PIL import Image
        except ImportError:
            return data
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return data


class WebDatasetDatasource(FileDatasource):
    """POSIX-tar shards where files sharing a basename prefix form one
    sample: ``000017.jpg`` + ``000017.cls`` → {"__key__": "000017",
    "jpg": <HWC array>, "cls": 17}. One tar = one read task."""

    suffixes = (".tar",)

    def __init__(self, paths, *, decode: bool = True):
        super().__init__(paths)
        self.decode_payloads = decode

    def read_file(self, path: str) -> list:
        samples: dict[str, dict] = {}
        order: list[str] = []
        with tarfile.open(path) as tf:
            for m in tf:
                if not m.isfile():
                    continue
                dirname, _, base = m.name.rpartition("/")
                stem, _, ext = base.partition(".")
                # WebDataset keys are the full member path minus the
                # extension: train/0001 and val/0001 are DIFFERENT samples
                key = f"{dirname}/{stem}" if dirname else stem
                ext = ext.lower()
                data = tf.extractfile(m).read()
                if key not in samples:
                    samples[key] = {"__key__": key}
                    order.append(key)
                samples[key][ext] = (
                    _decode_wds(ext, data, True) if self.decode_payloads
                    else data)
        rows = [samples[k] for k in order]
        return [rows_to_block(_pad_rows(rows))] if rows else []


def write_webdataset_shard(path: str, rows, *, index: int) -> str:
    """Rows → one tar shard; array/image members as .npy, str as .txt,
    int as .cls, dict/list as .json, bytes verbatim with their ext."""
    out = os.path.join(path, f"shard-{index:06d}.tar")
    os.makedirs(path, exist_ok=True)
    with tarfile.open(out, "w") as tf:
        for i, row in enumerate(rows):
            key = str(row.get("__key__", f"{index:06d}{i:06d}"))
            for name, val in row.items():
                if name == "__key__":
                    continue
                if isinstance(val, bytes):
                    ext, data = name, val
                elif isinstance(val, str):
                    ext, data = name, val.encode()
                elif isinstance(val, (int, np.integer)):
                    ext, data = name, str(int(val)).encode()
                elif isinstance(val, np.ndarray):
                    buf = io.BytesIO()
                    np.save(buf, val, allow_pickle=False)
                    ext, data = name, buf.getvalue()
                else:
                    ext, data = name, json.dumps(val).encode()
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return out
