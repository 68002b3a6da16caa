"""Write timestamps and LWW-timestamped values.

Parity with reference timestamp.rs: a Timestamp is a count of 100-nanosecond
ticks since the UNIX epoch, capped to 63 bits (the MSB is reserved);
Timestamped packs a tombstone flag into that reserved MSB.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import ClassVar, Generic, Optional, TypeVar

_MAX_100_NANOS = (1 << 63) - 1
_MAX_MICROS = _MAX_100_NANOS // 10
_MAX_MILLIS = _MAX_MICROS // 1_000
_MAX_SECONDS = _MAX_MILLIS // 1_000

_DELETED_FLAG = 1 << 63
_TIMESTAMP_MASK = _DELETED_FLAG - 1

T = TypeVar("T")


@dataclass(frozen=True, order=True)
class Timestamp:
    """100-ns ticks since the UNIX epoch, 63-bit (reference timestamp.rs:13-97)."""

    ticks: int

    def __post_init__(self) -> None:
        if not (0 <= self.ticks <= _MAX_100_NANOS):
            raise ValueError(f"Timestamp out of range: {self.ticks}")

    # MIN / MAX are attached after the class definition.
    MIN: ClassVar["Timestamp"]
    MAX: ClassVar["Timestamp"]

    @staticmethod
    def from_100_nanos(t: int) -> "Timestamp":
        return Timestamp(min(max(t, 0), _MAX_100_NANOS))

    @staticmethod
    def from_micros(t: int) -> "Timestamp":
        return Timestamp(min(max(t, 0), _MAX_MICROS) * 10)

    @staticmethod
    def from_millis(t: int) -> "Timestamp":
        return Timestamp(min(max(t, 0), _MAX_MILLIS) * 10_000)

    @staticmethod
    def from_seconds(t: int) -> "Timestamp":
        return Timestamp(min(max(t, 0), _MAX_SECONDS) * 10_000_000)

    @staticmethod
    def now() -> "Timestamp":
        return Timestamp.from_100_nanos(_time.time_ns() // 100)

    def elapsed_seconds(self) -> float:
        """Seconds from this timestamp until now; 0 when in the future
        (clock skew between ScyllaDB and this node, timestamp.rs:88-97)."""
        now = Timestamp.now()
        if self.ticks > now.ticks:
            return 0.0
        return (now.ticks - self.ticks) / 1e7

    def as_micros(self) -> int:
        return self.ticks // 10

    def as_seconds(self) -> float:
        return self.ticks / 1e7


Timestamp.MIN = Timestamp(0)
Timestamp.MAX = Timestamp(_MAX_100_NANOS)


class Timestamped(Generic[T]):
    """A value tagged with a write timestamp; tombstones carry no value.

    Packs the tombstone flag into the MSB of the tick count like the
    reference's Timestamped<T> (timestamp.rs:115-150), kept here as a plain
    (packed_int, value) pair.
    """

    __slots__ = ("_packed", "_value")

    def __init__(self, timestamp: Timestamp, value: Optional[T]) -> None:
        if value is None:
            self._packed = timestamp.ticks | _DELETED_FLAG
            self._value: Optional[T] = None
        else:
            self._packed = timestamp.ticks & _TIMESTAMP_MASK
            self._value = value

    @staticmethod
    def tombstone(timestamp: Timestamp) -> "Timestamped[T]":
        return Timestamped(timestamp, None)

    @property
    def packed(self) -> int:
        """The raw 64-bit representation (tombstone MSB | ticks) — the
        dense row-cache stores exactly this per cell (vec_chunks.rs)."""
        return self._packed

    @staticmethod
    def from_packed(packed: int, value: Optional[T] = None) -> "Timestamped[T]":
        out: Timestamped[T] = Timestamped.__new__(Timestamped)
        out._packed = packed
        out._value = value if (packed & _DELETED_FLAG) == 0 else None
        return out

    @property
    def is_valid(self) -> bool:
        return (self._packed & _DELETED_FLAG) == 0

    @property
    def is_tombstone(self) -> bool:
        return not self.is_valid

    @property
    def timestamp(self) -> Timestamp:
        return Timestamp(self._packed & _TIMESTAMP_MASK)

    @property
    def value(self) -> Optional[T]:
        return self._value if self.is_valid else None

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Timestamped)
            and self._packed == other._packed
            and self._value == other._value
        )

    def __hash__(self) -> int:
        return hash((self._packed, self._value))

    def __repr__(self) -> str:
        if self.is_tombstone:
            return f"Timestamped(tombstone @ {self.timestamp.ticks})"
        return f"Timestamped({self._value!r} @ {self.timestamp.ticks})"


TOMBSTONE_MIN_PACKED = _DELETED_FLAG  # tombstone at Timestamp.MIN
