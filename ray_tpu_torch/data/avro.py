"""Apache Avro object-container-file codec, dependency-free.

Implements the Avro 1.11 spec subset needed for data interchange and for
reading Iceberg manifest files: binary encoding (zigzag varints), the
object container file layout (header, codec'd data blocks, sync markers),
null/deflate codecs, and these schema types: null, boolean, int, long,
float, double, bytes, string, record, enum, array, map, union, fixed.

(reference capability: python/ray/data/read_api.py read_avro /
_internal/datasource/avro_datasource.py — which delegates to the `fastavro`
wheel; this is a from-scratch codec, no third-party reader in the image.)
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO

MAGIC = b"Obj\x01"

# ---------------------------------------------------------------- primitives


def _read_long(buf: BinaryIO) -> int:
    """Zigzag varint decode."""
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _zigzag(n: int) -> int:
    return (n << 1) if n >= 0 else ((-n) << 1) - 1


def _write_varint(out, n: int) -> None:
    v = _zigzag(n)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def _read_bytes(buf: BinaryIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise EOFError("truncated bytes")
    return data


# ------------------------------------------------------------------- decoder


class _Decoder:
    def __init__(self, schema: Any):
        self.schema = schema

    def read(self, buf: BinaryIO, schema: Any = None) -> Any:
        s = self.schema if schema is None else schema
        if isinstance(s, str):
            return self._read_primitive(buf, s)
        if isinstance(s, list):  # union: long index then value
            idx = _read_long(buf)
            return self.read(buf, s[idx])
        t = s["type"]
        if t == "record":
            return {f["name"]: self.read(buf, f["type"]) for f in s["fields"]}
        if t == "enum":
            return s["symbols"][_read_long(buf)]
        if t == "array":
            out = []
            while True:
                n = _read_long(buf)
                if n == 0:
                    break
                if n < 0:  # block with byte-size prefix
                    n = -n
                    _read_long(buf)
                for _ in range(n):
                    out.append(self.read(buf, s["items"]))
            return out
        if t == "map":
            out = {}
            while True:
                n = _read_long(buf)
                if n == 0:
                    break
                if n < 0:
                    n = -n
                    _read_long(buf)
                for _ in range(n):
                    k = _read_bytes(buf).decode()
                    out[k] = self.read(buf, s["values"])
            return out
        if t == "fixed":
            return buf.read(s["size"])
        return self._read_primitive(buf, t)

    def _read_primitive(self, buf: BinaryIO, t: str) -> Any:
        if t == "null":
            return None
        if t == "boolean":
            return buf.read(1) == b"\x01"
        if t in ("int", "long"):
            return _read_long(buf)
        if t == "float":
            return struct.unpack("<f", buf.read(4))[0]
        if t == "double":
            return struct.unpack("<d", buf.read(8))[0]
        if t == "bytes":
            return _read_bytes(buf)
        if t == "string":
            return _read_bytes(buf).decode()
        raise ValueError(f"unsupported avro type {t!r}")


# ------------------------------------------------------------------- encoder


class _Encoder:
    def __init__(self, schema: Any):
        self.schema = schema

    def write(self, out: io.BytesIO, value: Any, schema: Any = None) -> None:
        s = self.schema if schema is None else schema
        if isinstance(s, str):
            return self._write_primitive(out, value, s)
        if isinstance(s, list):  # union: pick the branch matching the value
            idx = self._union_index(s, value)
            _write_varint(out, idx)
            return self.write(out, value, s[idx])
        t = s["type"]
        if t == "record":
            for f in s["fields"]:
                self.write(out, value.get(f["name"]), f["type"])
            return
        if t == "enum":
            _write_varint(out, s["symbols"].index(value))
            return
        if t == "array":
            if value:
                _write_varint(out, len(value))
                for item in value:
                    self.write(out, item, s["items"])
            _write_varint(out, 0)
            return
        if t == "map":
            if value:
                _write_varint(out, len(value))
                for k, v in value.items():
                    kb = str(k).encode()
                    _write_varint(out, len(kb))
                    out.write(kb)
                    self.write(out, v, s["values"])
            _write_varint(out, 0)
            return
        if t == "fixed":
            out.write(value)
            return
        return self._write_primitive(out, value, t)

    @staticmethod
    def _union_index(union: list, value: Any) -> int:
        kind = ("null" if value is None else
                "boolean" if isinstance(value, bool) else
                "long" if isinstance(value, int) else
                "double" if isinstance(value, float) else
                "bytes" if isinstance(value, bytes) else
                "string")
        for i, branch in enumerate(union):
            b = branch if isinstance(branch, str) else branch.get("type")
            if b == kind or (kind == "long" and b in ("int", "float",
                                                      "double")) or (
                    kind == "double" and b == "float"):
                return i
        # complex (non-primitive) values route to the first structured
        # branch; a primitive with no matching branch must NOT fall back
        # (e.g. a float into a long branch would silently truncate)
        if isinstance(value, (list, tuple, dict)) or not isinstance(
                value, (bool, int, float, bytes, str)):
            for i, branch in enumerate(union):
                if branch != "null":
                    return i
        raise TypeError(
            f"no union branch in {union} for value of type {type(value)}")

    def _write_primitive(self, out: io.BytesIO, v: Any, t: str) -> None:
        if t == "null":
            return
        if t == "boolean":
            out.write(b"\x01" if v else b"\x00")
        elif t in ("int", "long"):
            _write_varint(out, int(v))
        elif t == "float":
            out.write(struct.pack("<f", float(v)))
        elif t == "double":
            out.write(struct.pack("<d", float(v)))
        elif t == "bytes":
            _write_varint(out, len(v))
            out.write(v)
        elif t == "string":
            b = str(v).encode()
            _write_varint(out, len(b))
            out.write(b)
        else:
            raise ValueError(f"unsupported avro type {t!r}")


# --------------------------------------------------------------- file layout


def _resolve_named(schema: Any, env: dict | None = None) -> Any:
    """Inline previously-defined named types referenced by name (Iceberg
    manifests use them) so the decoder never sees a bare reference."""
    env = {} if env is None else env
    if isinstance(schema, str):
        return env.get(schema, schema)
    if isinstance(schema, list):
        return [_resolve_named(s, env) for s in schema]
    if isinstance(schema, dict):
        out = dict(schema)
        if out.get("type") in ("record", "enum", "fixed") and "name" in out:
            env[out["name"]] = out
        for key in ("items", "values", "type"):
            if key in out and not isinstance(out[key], str):
                out[key] = _resolve_named(out[key], env)
        if "fields" in out:
            out["fields"] = [
                {**f, "type": _resolve_named(f["type"], env)}
                for f in out["fields"]]
        return out
    return schema


def read_avro_file(path: str) -> tuple[list[dict], dict]:
    """Read an Avro object container file → (records, metadata)."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: not an Avro object container file")
        meta_schema = {"type": "map", "values": "bytes"}
        dec = _Decoder(meta_schema)
        meta = dec.read(f, meta_schema)
        sync = f.read(16)
        schema = _resolve_named(json.loads(meta["avro.schema"].decode()))
        codec = meta.get("avro.codec", b"null").decode()
        rdec = _Decoder(schema)
        records: list = []
        while True:
            head = f.read(1)
            if not head:
                break
            f.seek(-1, os.SEEK_CUR)
            count = _read_long(f)
            size = _read_long(f)
            payload = f.read(size)
            if codec == "deflate":
                payload = zlib.decompress(payload, -15)
            elif codec != "null":
                raise ValueError(f"unsupported avro codec {codec!r}")
            if f.read(16) != sync:
                raise ValueError(f"{path}: sync marker mismatch")
            buf = io.BytesIO(payload)
            for _ in range(count):
                records.append(rdec.read(buf))
        return records, {k: v for k, v in meta.items()}


def infer_schema(rows: list[dict], name: str = "row") -> dict:
    """Infer a nullable record schema from python/numpy row values."""
    import numpy as np

    def widen(t: Any, cand: Any) -> Any:
        """Least common avro type of two inferred types; raises on
        incompatible mixes (no silent truncation)."""
        if t is None or t == cand:
            return cand
        if cand is None:
            return t
        if isinstance(t, str) and isinstance(cand, str) and \
                {t, cand} <= {"long", "double"}:
            return "double"
        if (isinstance(t, dict) and isinstance(cand, dict)
                and t.get("type") == cand.get("type") == "array"):
            return {"type": "array", "items": widen(t["items"], cand["items"])}
        raise TypeError(f"incompatible avro types {t} and {cand}")

    def of(v: Any) -> Any:
        if isinstance(v, bool) or isinstance(v, np.bool_):
            return "boolean"
        if isinstance(v, (int, np.integer)):
            return "long"
        if isinstance(v, (float, np.floating)):
            return "double"
        if isinstance(v, bytes):
            return "bytes"
        if isinstance(v, str):
            return "string"
        if isinstance(v, (list, tuple, np.ndarray)):
            inner: Any = None
            for el in v[:100]:  # widen over elements, not just element 0
                inner = widen(inner, of(el))
            return {"type": "array", "items": inner or "double"}
        if isinstance(v, dict):
            return {"type": "map", "values": "string"}
        if v is None:
            return "null"
        raise TypeError(f"cannot map {type(v)} to an avro type")

    # ONE pass over ALL rows: the key union must see every row (a column
    # first appearing after row 100 must not be silently dropped from
    # every written row), while type widening stops after the first 100
    # non-null values per key. dict preserves first-seen order with O(1)
    # membership.
    inferred: dict = {}  # key -> [widened type or None, non-null count]
    for r in rows:
        for k, v in r.items():
            ent = inferred.get(k)
            if ent is None:
                ent = inferred[k] = [None, 0]
            if v is None or ent[1] >= 100:
                continue
            try:
                ent[0] = widen(ent[0], of(v))
            except TypeError as e:
                raise TypeError(f"column {k!r} mixes incompatible types: {e}")
            ent[1] += 1
    fields = []
    for k, (t, _) in inferred.items():
        fields.append({"name": str(k),
                       "type": ["null", t] if t else "null"})
    return {"type": "record", "name": name, "fields": fields}


def write_avro_file(path: str, rows: list[dict], schema: dict | None = None,
                    *, codec: str = "deflate",
                    sync: bytes = b"ray_tpu_avro_syn") -> int:
    """Write rows as an Avro object container file. Returns row count."""
    import numpy as np

    if schema is None:
        if not rows:
            schema = {"type": "record", "name": "row", "fields": []}
        else:
            schema = infer_schema(rows)
    enc = _Encoder(schema)
    body = io.BytesIO()
    for r in rows:
        clean = {k: (v.tolist() if isinstance(v, np.ndarray)
                     else v.item() if isinstance(v, np.generic) else v)
                 for k, v in r.items()}
        enc.write(body, clean)
    payload = body.getvalue()
    if codec == "deflate":
        comp = zlib.compressobj(wbits=-15)
        payload = comp.compress(payload) + comp.flush()
    elif codec != "null":
        raise ValueError(f"unsupported avro codec {codec!r}")
    with open(path, "wb") as f:
        f.write(MAGIC)
        meta = {"avro.schema": json.dumps(schema).encode(),
                "avro.codec": codec.encode()}
        out = io.BytesIO()
        _write_varint(out, len(meta))
        for k, v in meta.items():
            kb = k.encode()
            _write_varint(out, len(kb))
            out.write(kb)
            _write_varint(out, len(v))
            out.write(v)
        _write_varint(out, 0)
        f.write(out.getvalue())
        f.write(sync)
        blk = io.BytesIO()
        _write_varint(blk, len(rows))
        _write_varint(blk, len(payload))
        f.write(blk.getvalue())
        f.write(payload)
        f.write(sync)
    return len(rows)
