"""ANN filter restrictions and their evaluation semantics.

Parity with the reference's Restriction enum (lib.rs:509-566: 12 variants
incl. tuple forms), Filter (restrictions + allow_filtering), and the row
predicate `is_valid_for` / CQL value comparison used by filtered search
(table/mod.rs:1183-1362). Numeric values compare numerically across int /
float / Decimal (varint/decimal big-number semantics); other types compare
only within their own type.
"""

from __future__ import annotations

import datetime as _dt
import enum
import uuid as _uuid
from dataclasses import dataclass, field
from decimal import Decimal
from typing import Callable, Sequence


class RestrictionKind(enum.Enum):
    # JSON tag values mirror httpapi lib.rs:320-366.
    EQ = "=="
    IN = "IN"
    LT = "<"
    LTE = "<="
    GT = ">"
    GTE = ">="
    EQ_TUPLE = "()==()"
    IN_TUPLE = "()IN()"
    LT_TUPLE = "()<()"
    LTE_TUPLE = "()<=()"
    GT_TUPLE = "()>()"
    GTE_TUPLE = "()>=()"

    @property
    def is_tuple(self) -> bool:
        return self.value.startswith("(")


@dataclass(frozen=True)
class Restriction:
    """One restriction from a CQL WHERE clause.

    For scalar kinds, ``lhs`` is a 1-tuple of column names and ``rhs`` depends
    on kind: EQ/LT/LTE/GT/GTE take a single value; IN takes a tuple of values.
    For tuple kinds, ``lhs`` is an n-tuple of columns; EQ/LT/... take an
    n-tuple of values, IN takes a tuple of n-tuples.
    """

    kind: RestrictionKind
    lhs: tuple[str, ...]
    rhs: object

    def __post_init__(self) -> None:
        if not self.lhs:
            raise ValueError("Restriction needs at least one column")
        if not self.kind.is_tuple and len(self.lhs) != 1:
            raise ValueError(f"{self.kind} takes exactly one column")

    @property
    def columns(self) -> tuple[str, ...]:
        return self.lhs

    # -- constructors --------------------------------------------------------

    @staticmethod
    def eq(column: str, value: object) -> "Restriction":
        return Restriction(RestrictionKind.EQ, (column,), value)

    @staticmethod
    def in_(column: str, values: Sequence[object]) -> "Restriction":
        return Restriction(RestrictionKind.IN, (column,), tuple(values))

    @staticmethod
    def lt(column: str, value: object) -> "Restriction":
        return Restriction(RestrictionKind.LT, (column,), value)

    @staticmethod
    def lte(column: str, value: object) -> "Restriction":
        return Restriction(RestrictionKind.LTE, (column,), value)

    @staticmethod
    def gt(column: str, value: object) -> "Restriction":
        return Restriction(RestrictionKind.GT, (column,), value)

    @staticmethod
    def gte(column: str, value: object) -> "Restriction":
        return Restriction(RestrictionKind.GTE, (column,), value)

    @staticmethod
    def eq_tuple(columns: Sequence[str], values: Sequence[object]) -> "Restriction":
        return Restriction(RestrictionKind.EQ_TUPLE, tuple(columns), tuple(values))

    @staticmethod
    def in_tuple(
        columns: Sequence[str], values: Sequence[Sequence[object]]
    ) -> "Restriction":
        return Restriction(
            RestrictionKind.IN_TUPLE, tuple(columns), tuple(tuple(v) for v in values)
        )

    @staticmethod
    def lt_tuple(columns: Sequence[str], values: Sequence[object]) -> "Restriction":
        return Restriction(RestrictionKind.LT_TUPLE, tuple(columns), tuple(values))

    @staticmethod
    def lte_tuple(columns: Sequence[str], values: Sequence[object]) -> "Restriction":
        return Restriction(RestrictionKind.LTE_TUPLE, tuple(columns), tuple(values))

    @staticmethod
    def gt_tuple(columns: Sequence[str], values: Sequence[object]) -> "Restriction":
        return Restriction(RestrictionKind.GT_TUPLE, tuple(columns), tuple(values))

    @staticmethod
    def gte_tuple(columns: Sequence[str], values: Sequence[object]) -> "Restriction":
        return Restriction(RestrictionKind.GTE_TUPLE, tuple(columns), tuple(values))

    # -- evaluation ----------------------------------------------------------

    def matches(self, get_value: Callable[[str], object]) -> bool:
        """Evaluate against a row; ``get_value(column)`` returns the row's
        value for a column (None when the cell is null/missing). A null cell
        never matches any restriction, like CQL filtering semantics."""
        kind = self.kind
        if not kind.is_tuple:
            row_val = get_value(self.lhs[0])
            if row_val is None:
                return False
            if kind is RestrictionKind.EQ:
                return cql_cmp(row_val, self.rhs) == 0
            if kind is RestrictionKind.IN:
                return any(cql_cmp(row_val, v) == 0 for v in self.rhs)  # type: ignore[union-attr]
            c = cql_cmp(row_val, self.rhs)
            if kind is RestrictionKind.LT:
                return c < 0
            if kind is RestrictionKind.LTE:
                return c <= 0
            if kind is RestrictionKind.GT:
                return c > 0
            return c >= 0

        row_tuple = tuple(get_value(col) for col in self.lhs)
        if any(v is None for v in row_tuple):
            return False
        if kind is RestrictionKind.EQ_TUPLE:
            return _tuple_cmp(row_tuple, self.rhs) == 0  # type: ignore[arg-type]
        if kind is RestrictionKind.IN_TUPLE:
            return any(_tuple_cmp(row_tuple, v) == 0 for v in self.rhs)  # type: ignore[union-attr]
        c = _tuple_cmp(row_tuple, self.rhs)  # type: ignore[arg-type]
        if kind is RestrictionKind.LT_TUPLE:
            return c < 0
        if kind is RestrictionKind.LTE_TUPLE:
            return c <= 0
        if kind is RestrictionKind.GT_TUPLE:
            return c > 0
        return c >= 0


@dataclass(frozen=True)
class Filter:
    """Restrictions from a CQL query + the ALLOW FILTERING flag
    (reference lib.rs:560-566)."""

    restrictions: tuple[Restriction, ...] = ()
    allow_filtering: bool = False

    def columns(self) -> set[str]:
        cols: set[str] = set()
        for r in self.restrictions:
            cols.update(r.columns)
        return cols

    def matches(self, get_value: Callable[[str], object]) -> bool:
        return all(r.matches(get_value) for r in self.restrictions)


_NUMERIC = (int, float, Decimal)


def _denumpy(v: object) -> object:
    """numpy array/scalar -> plain Python (tuple / int / float) so CQL
    comparison semantics below apply uniformly."""
    import numpy as _np

    if isinstance(v, _np.ndarray):
        return tuple(v.tolist())
    if isinstance(v, _np.generic):
        return v.item()
    return v


def cql_cmp(a: object, b: object) -> int:
    """Three-way compare of two CQL values (reference table/mod.rs:1320-1362).

    Numbers (tinyint..varint, float, double, decimal) compare numerically
    across representations; bool < comparisons follow false < true; text,
    blob, uuid, date/time types compare within their own type. Raises
    TypeError for incomparable combinations.
    """
    # the CQL wire decoder returns numpy for fixed-size float vectors (the
    # full-scan hot path, db/cql/types.py); restrictions may still target
    # such columns, so normalize numpy values to plain Python here
    a = _denumpy(a)
    b = _denumpy(b)
    if isinstance(a, bool) and isinstance(b, bool):
        return (a > b) - (a < b)
    if isinstance(a, bool) != isinstance(b, bool):
        raise TypeError(f"Cannot compare {type(a).__name__} with {type(b).__name__}")
    if isinstance(a, _NUMERIC) and isinstance(b, _NUMERIC):
        # Python compares int/float/Decimal numerically and exactly; Decimal
        # vs float goes through exact Fraction-like semantics via __eq__ but
        # Decimal < float raises in some versions — normalize floats first.
        if isinstance(a, Decimal) and isinstance(b, float):
            b = Decimal(repr(b))
        elif isinstance(b, Decimal) and isinstance(a, float):
            a = Decimal(repr(a))
        return (a > b) - (a < b)  # type: ignore[operator]
    if isinstance(a, str) and isinstance(b, str):
        return (a > b) - (a < b)
    if isinstance(a, (bytes, bytearray)) and isinstance(b, (bytes, bytearray)):
        a, b = bytes(a), bytes(b)
        return (a > b) - (a < b)
    if isinstance(a, _uuid.UUID) and isinstance(b, _uuid.UUID):
        return (a.bytes > b.bytes) - (a.bytes < b.bytes)
    if isinstance(a, _dt.datetime) and isinstance(b, _dt.datetime):
        a = a if a.tzinfo else a.replace(tzinfo=_dt.timezone.utc)
        b = b if b.tzinfo else b.replace(tzinfo=_dt.timezone.utc)
        return (a > b) - (a < b)
    if (
        isinstance(a, _dt.date)
        and isinstance(b, _dt.date)
        and not isinstance(a, _dt.datetime)
        and not isinstance(b, _dt.datetime)
    ):
        return (a > b) - (a < b)
    if isinstance(a, _dt.time) and isinstance(b, _dt.time):
        return (a > b) - (a < b)
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return _tuple_cmp(tuple(a), tuple(b))
    raise TypeError(f"Cannot compare {type(a).__name__} with {type(b).__name__}")


def _tuple_cmp(a: tuple[object, ...], b: tuple[object, ...]) -> int:
    """Lexicographic tuple comparison; shorter tuple is a prefix-match
    (CQL compares clustering tuples lexicographically)."""
    for x, y in zip(a, b):
        c = cql_cmp(x, y)
        if c != 0:
            return c
    return (len(a) > len(b)) - (len(a) < len(b))
