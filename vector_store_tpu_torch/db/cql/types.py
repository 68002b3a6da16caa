"""CQL native-type codecs: wire bytes <-> Python values.

Covers the native types the reference handles in its JSON/CQL conversions
(httproutes.rs try_to_json over ~18 native types) plus collections, tuples,
and ScyllaDB's vector<float, n> (a custom type on the wire; fixed 4-byte
float elements, no per-element length prefix).
"""

from __future__ import annotations

import datetime as dt
import ipaddress
import re
import struct
import uuid as uuid_mod
from decimal import Decimal

from vector_store_tpu_torch.db.cql.frame import Reader

# type option ids
T_CUSTOM = 0x0000
T_ASCII = 0x0001
T_BIGINT = 0x0002
T_BLOB = 0x0003
T_BOOLEAN = 0x0004
T_COUNTER = 0x0005
T_DECIMAL = 0x0006
T_DOUBLE = 0x0007
T_FLOAT = 0x0008
T_INT = 0x0009
T_TIMESTAMP = 0x000B
T_UUID = 0x000C
T_VARCHAR = 0x000D
T_VARINT = 0x000E
T_TIMEUUID = 0x000F
T_INET = 0x0010
T_DATE = 0x0011
T_TIME = 0x0012
T_SMALLINT = 0x0013
T_TINYINT = 0x0014
T_DURATION = 0x0015
T_LIST = 0x0020
T_MAP = 0x0021
T_SET = 0x0022
T_UDT = 0x0030
T_TUPLE = 0x0031
# ScyllaDB native vector (protocol extension); also appears as CUSTOM
T_VECTOR = 0x0017

_EPOCH_DATE = 2**31  # wire 'date' is unsigned days with epoch at 2^31

_VECTOR_CLASS_RE = re.compile(
    r"VectorType\((?P<elem>[A-Za-z.]+?Type)\s*,\s*(?P<dim>\d+)\)"
)


class CqlType:
    """Parsed type option tree."""

    __slots__ = ("id", "custom", "subtypes", "vector_dim", "udt_fields")

    def __init__(self, id_: int, custom: str | None = None, subtypes=None, vector_dim=0, udt_fields=None):
        self.id = id_
        self.custom = custom
        self.subtypes: list[CqlType] = subtypes or []
        self.vector_dim = vector_dim
        self.udt_fields: list[tuple[str, CqlType]] = udt_fields or []

    def __repr__(self) -> str:
        return f"CqlType(0x{self.id:04x})"


def read_type(r: Reader) -> CqlType:
    tid = r.short()
    if tid == T_CUSTOM:
        cls = r.string()
        m = _VECTOR_CLASS_RE.search(cls)
        if m:
            elem = _class_to_type(m.group("elem"))
            return CqlType(T_VECTOR, custom=cls, subtypes=[elem], vector_dim=int(m.group("dim")))
        return CqlType(T_CUSTOM, custom=cls)
    if tid in (T_LIST, T_SET):
        return CqlType(tid, subtypes=[read_type(r)])
    if tid == T_MAP:
        return CqlType(tid, subtypes=[read_type(r), read_type(r)])
    if tid == T_TUPLE:
        n = r.short()
        return CqlType(tid, subtypes=[read_type(r) for _ in range(n)])
    if tid == T_UDT:
        r.string()  # keyspace
        r.string()  # name
        n = r.short()
        fields = [(r.string(), read_type(r)) for _ in range(n)]
        return CqlType(tid, udt_fields=fields)
    if tid == T_VECTOR:
        sub = read_type(r)
        dim = _read_unsigned_vint(r)
        return CqlType(T_VECTOR, subtypes=[sub], vector_dim=dim)
    return CqlType(tid)


def _read_unsigned_vint(r: Reader) -> int:
    value = 0
    shift = 0
    while True:
        b = r.byte()
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            return value
        shift += 7


def _class_to_type(cls: str) -> CqlType:
    name = cls.rsplit(".", 1)[-1]
    mapping = {
        "FloatType": T_FLOAT,
        "DoubleType": T_DOUBLE,
        "Int32Type": T_INT,
        "LongType": T_BIGINT,
        "ShortType": T_SMALLINT,
        "ByteType": T_TINYINT,
    }
    return CqlType(mapping.get(name, T_BLOB))


_FIXED_SIZE = {
    T_BOOLEAN: 1,
    T_TINYINT: 1,
    T_SMALLINT: 2,
    T_INT: 4,
    T_FLOAT: 4,
    T_DATE: 4,
    T_BIGINT: 8,
    T_COUNTER: 8,
    T_DOUBLE: 8,
    T_TIMESTAMP: 8,
    T_TIME: 8,
    T_UUID: 16,
    T_TIMEUUID: 16,
}


def decode_value(typ: CqlType, data: bytes | None):
    if data is None:
        return None
    tid = typ.id
    if tid in (T_ASCII, T_VARCHAR):
        return data.decode("utf-8")
    if tid == T_BLOB or tid == T_CUSTOM:
        return bytes(data)
    if tid == T_BOOLEAN:
        return data != b"\x00"
    if tid == T_TINYINT:
        return struct.unpack("!b", data)[0]
    if tid == T_SMALLINT:
        return struct.unpack("!h", data)[0]
    if tid in (T_INT,):
        return struct.unpack("!i", data)[0]
    if tid in (T_BIGINT, T_COUNTER):
        return struct.unpack("!q", data)[0]
    if tid == T_FLOAT:
        return struct.unpack("!f", data)[0]
    if tid == T_DOUBLE:
        return struct.unpack("!d", data)[0]
    if tid == T_VARINT:
        return int.from_bytes(data, "big", signed=True)
    if tid == T_DECIMAL:
        scale = struct.unpack("!i", data[:4])[0]
        unscaled = int.from_bytes(data[4:], "big", signed=True)
        return Decimal(unscaled).scaleb(-scale)
    if tid == T_TIMESTAMP:
        millis = struct.unpack("!q", data)[0]
        return dt.datetime.fromtimestamp(millis / 1e3, tz=dt.timezone.utc)
    if tid in (T_UUID, T_TIMEUUID):
        return uuid_mod.UUID(bytes=bytes(data))
    if tid == T_INET:
        return str(ipaddress.ip_address(bytes(data)))
    if tid == T_DATE:
        days = struct.unpack("!I", data)[0] - _EPOCH_DATE
        return dt.date(1970, 1, 1) + dt.timedelta(days=days)
    if tid == T_TIME:
        nanos = struct.unpack("!q", data)[0]
        micros, _ = divmod(nanos, 1000)
        seconds, micros = divmod(micros, 10**6)
        minutes, sec = divmod(seconds, 60)
        hours, minute = divmod(minutes, 60)
        return dt.time(hours, minute, sec, micros)
    if tid in (T_LIST, T_SET):
        r = Reader(data)
        n = r.int_()
        return [decode_value(typ.subtypes[0], r.bytes_value()) for _ in range(n)]
    if tid == T_MAP:
        r = Reader(data)
        n = r.int_()
        out = {}
        for _ in range(n):
            k = decode_value(typ.subtypes[0], r.bytes_value())
            v = decode_value(typ.subtypes[1], r.bytes_value())
            out[k] = v
        return out
    if tid == T_TUPLE:
        r = Reader(data)
        return tuple(decode_value(st, r.bytes_value()) for st in typ.subtypes)
    if tid == T_UDT:
        r = Reader(data)
        out = {}
        for name, st in typ.udt_fields:
            if r.remaining() <= 0:
                out[name] = None
            else:
                out[name] = decode_value(st, r.bytes_value())
        return out
    if tid == T_VECTOR:
        elem = typ.subtypes[0]
        size = _FIXED_SIZE.get(elem.id)
        if size is None:
            r = Reader(data)
            out = []
            while r.remaining() > 0:
                out.append(decode_value(elem, r.bytes_value()))
            return out
        n = len(data) // size
        if elem.id == T_FLOAT:
            # the full-scan hot loop: one vectorized big-endian decode per
            # row instead of a per-element Python list
            import numpy as np

            return np.frombuffer(data, dtype=">f4", count=n).astype(
                np.float32
            )
        return [
            decode_value(elem, data[i * size : (i + 1) * size]) for i in range(n)
        ]
    if tid == T_DURATION:
        return bytes(data)  # opaque for our purposes
    return bytes(data)


def encode_value(v) -> bytes | None:
    """Python value -> wire bytes, inferring the CQL representation (used
    for bound statement values; the server validates against column types)."""
    if v is None:
        return None
    if isinstance(v, bool):
        return b"\x01" if v else b"\x00"
    if isinstance(v, int):
        # bigint by default; larger magnitudes as varint are not inferable —
        # callers bind huge ints explicitly via Varint
        return struct.pack("!q", v)
    if isinstance(v, float):
        return struct.pack("!d", v)
    if isinstance(v, str):
        return v.encode("utf-8")
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    if isinstance(v, uuid_mod.UUID):
        return v.bytes
    if isinstance(v, Decimal):
        sign, digits, exponent = v.as_tuple()
        unscaled = int(v.scaleb(-exponent))
        return struct.pack("!i", -exponent) + unscaled.to_bytes(
            max(1, (unscaled.bit_length() + 8) // 8), "big", signed=True
        )
    if isinstance(v, dt.datetime):
        if v.tzinfo is None:
            v = v.replace(tzinfo=dt.timezone.utc)
        return struct.pack("!q", int(v.timestamp() * 1e3))
    if isinstance(v, dt.date):
        days = (v - dt.date(1970, 1, 1)).days + _EPOCH_DATE
        return struct.pack("!I", days)
    if isinstance(v, dt.time):
        nanos = ((v.hour * 60 + v.minute) * 60 + v.second) * 10**9 + v.microsecond * 1000
        return struct.pack("!q", nanos)
    if isinstance(v, (list, tuple)):
        if all(isinstance(x, float) for x in v):
            return struct.pack(f"!{len(v)}f", *v)  # vector<float, n>
        raise TypeError("cannot infer CQL encoding for this collection")
    raise TypeError(f"cannot encode {type(v).__name__} as CQL value")


class Int32:
    """Explicit int32 bind wrapper (plain python int binds as bigint)."""

    __slots__ = ("v",)

    def __init__(self, v: int) -> None:
        self.v = v


def encode_bind(v) -> bytes | None:
    if isinstance(v, Int32):
        return struct.pack("!i", v.v)
    return encode_value(v)
