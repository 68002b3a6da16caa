"""Compact, hashable encodings of primary / partition key tuples.

Parity with reference invariant_key.rs: keys are stored once as a compact
tagged byte string (1-byte value count, then per value a 1-byte type tag plus
a minimal payload) instead of a vector of boxed values; equality/hash/order
are byte-wise. The encoding is injective: two key tuples encode to the same
bytes iff they are the same logical CQL key (decimals are normalized so that
1.0 and 1.00 collide, mirroring primary_key.rs decimal normalization).
"""

from __future__ import annotations

import datetime as _dt
import struct
import uuid as _uuid
from decimal import Decimal
from typing import Iterable

MAX_COLUMNS = 255  # mirrors invariant_key.rs:115

_TAG_NULL = 0
_TAG_BOOL = 1
_TAG_INT = 2
_TAG_FLOAT = 3
_TAG_TEXT = 4
_TAG_BLOB = 5
_TAG_UUID = 6
_TAG_DECIMAL = 7
_TAG_TIMESTAMP = 8
_TAG_DATE = 9
_TAG_TIME = 10
_TAG_TUPLE = 11


def _write_varint(out: bytearray, n: int) -> None:
    """Unsigned LEB128."""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _int_to_min_bytes(n: int) -> bytes:
    """Minimal-length big-endian two's complement."""
    length = max(1, (n.bit_length() + 8) // 8)  # +8 keeps the sign bit
    return n.to_bytes(length, "big", signed=True)


def _encode_value(out: bytearray, v: object) -> None:
    if v is None:
        out.append(_TAG_NULL)
    elif isinstance(v, bool):  # must precede int check
        out.append(_TAG_BOOL)
        out.append(1 if v else 0)
    elif isinstance(v, int):
        out.append(_TAG_INT)
        b = _int_to_min_bytes(v)
        _write_varint(out, len(b))
        out.extend(b)
    elif isinstance(v, float):
        out.append(_TAG_FLOAT)
        out.extend(struct.pack(">d", v))
    elif isinstance(v, str):
        out.append(_TAG_TEXT)
        b = v.encode("utf-8")
        _write_varint(out, len(b))
        out.extend(b)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        out.append(_TAG_BLOB)
        b = bytes(v)
        _write_varint(out, len(b))
        out.extend(b)
    elif isinstance(v, _uuid.UUID):
        out.append(_TAG_UUID)
        out.extend(v.bytes)
    elif isinstance(v, Decimal):
        # Normalize so numerically-equal decimals encode identically
        # (mirrors primary_key.rs decimal clustering-key normalization).
        out.append(_TAG_DECIMAL)
        norm = v.normalize()
        b = str(norm).encode("ascii")
        _write_varint(out, len(b))
        out.extend(b)
    elif isinstance(v, _dt.datetime):
        out.append(_TAG_TIMESTAMP)
        if v.tzinfo is None:
            v = v.replace(tzinfo=_dt.timezone.utc)
        micros = int(v.timestamp() * 1e6)
        b = _int_to_min_bytes(micros)
        _write_varint(out, len(b))
        out.extend(b)
    elif isinstance(v, _dt.date):
        out.append(_TAG_DATE)
        days = (v - _dt.date(1970, 1, 1)).days
        b = _int_to_min_bytes(days)
        _write_varint(out, len(b))
        out.extend(b)
    elif isinstance(v, _dt.time):
        out.append(_TAG_TIME)
        nanos = ((v.hour * 60 + v.minute) * 60 + v.second) * 10**9 + v.microsecond * 1000
        b = _int_to_min_bytes(nanos)
        _write_varint(out, len(b))
        out.extend(b)
    elif isinstance(v, (tuple, list)):
        out.append(_TAG_TUPLE)
        _write_varint(out, len(v))
        for item in v:
            _encode_value(out, item)
    else:
        raise TypeError(f"Unsupported key value type: {type(v).__name__}")


def _decode_value(data: bytes, pos: int) -> tuple[object, int]:
    tag = data[pos]
    pos += 1
    if tag == _TAG_NULL:
        return None, pos
    if tag == _TAG_BOOL:
        return data[pos] != 0, pos + 1
    if tag == _TAG_INT:
        n, pos = _read_varint(data, pos)
        return int.from_bytes(data[pos : pos + n], "big", signed=True), pos + n
    if tag == _TAG_FLOAT:
        return struct.unpack(">d", data[pos : pos + 8])[0], pos + 8
    if tag == _TAG_TEXT:
        n, pos = _read_varint(data, pos)
        return data[pos : pos + n].decode("utf-8"), pos + n
    if tag == _TAG_BLOB:
        n, pos = _read_varint(data, pos)
        return bytes(data[pos : pos + n]), pos + n
    if tag == _TAG_UUID:
        return _uuid.UUID(bytes=bytes(data[pos : pos + 16])), pos + 16
    if tag == _TAG_DECIMAL:
        n, pos = _read_varint(data, pos)
        return Decimal(data[pos : pos + n].decode("ascii")), pos + n
    if tag == _TAG_TIMESTAMP:
        n, pos = _read_varint(data, pos)
        micros = int.from_bytes(data[pos : pos + n], "big", signed=True)
        return (
            _dt.datetime.fromtimestamp(micros / 1e6, tz=_dt.timezone.utc),
            pos + n,
        )
    if tag == _TAG_DATE:
        n, pos = _read_varint(data, pos)
        days = int.from_bytes(data[pos : pos + n], "big", signed=True)
        return _dt.date(1970, 1, 1) + _dt.timedelta(days=days), pos + n
    if tag == _TAG_TIME:
        n, pos = _read_varint(data, pos)
        nanos = int.from_bytes(data[pos : pos + n], "big", signed=True)
        return _decode_time(nanos), pos + n
    if tag == _TAG_TUPLE:
        n, pos = _read_varint(data, pos)
        items = []
        for _ in range(n):
            item, pos = _decode_value(data, pos)
            items.append(item)
        return tuple(items), pos
    raise ValueError(f"Unknown key tag: {tag}")


def _decode_time(nanos: int) -> _dt.time:
    total_micros = nanos // 1000
    seconds, micros = divmod(total_micros, 10**6)
    minutes, sec = divmod(seconds, 60)
    hours, minute = divmod(minutes, 60)
    return _dt.time(hours, minute, sec, micros)


class InvariantKey:
    """An immutable, hashable, byte-ordered CQL value tuple."""

    __slots__ = ("_data", "_hash")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._hash = hash(data)

    @classmethod
    def from_values(cls, values: Iterable[object]) -> "InvariantKey":
        values = tuple(values)
        if len(values) > MAX_COLUMNS:
            raise ValueError(f"Too many key columns: {len(values)} > {MAX_COLUMNS}")
        out = bytearray()
        out.append(len(values))
        for v in values:
            _encode_value(out, v)
        return cls(bytes(out))

    @property
    def data(self) -> bytes:
        return self._data

    def values(self) -> tuple[object, ...]:
        count = self._data[0]
        pos = 1
        items = []
        for _ in range(count):
            item, pos = _decode_value(self._data, pos)
            items.append(item)
        return tuple(items)

    def __len__(self) -> int:
        return self._data[0]

    def __eq__(self, other: object) -> bool:
        return isinstance(other, InvariantKey) and self._data == other._data

    def __hash__(self) -> int:
        return self._hash

    def __lt__(self, other: "InvariantKey") -> bool:
        return self._data < other._data

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.values()!r})"


class PrimaryKey(InvariantKey):
    """Full primary key (partition + clustering columns) of a base-table row."""


class PartitionKey(InvariantKey):
    """The partitioning prefix used to route rows of a local index."""
