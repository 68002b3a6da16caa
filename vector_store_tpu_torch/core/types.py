"""Shared domain types.

Behavioral parity with the reference's domain types in
crates/vector-store/src/lib.rs:363-728 (SpaceType, Quantization,
Dimensions/Connectivity/ExpansionAdd/ExpansionSearch defaults, IndexMetadata,
DbIndexPartitioning, DbIndexedRow/Operation/Value) — re-expressed as plain
Python dataclasses. No I/O, no JAX.
"""

from __future__ import annotations

import enum
import uuid
from dataclasses import dataclass, field
from typing import NamedTuple, Union

from vector_store_tpu_torch.core.timestamp import Timestamp, Timestamped

# Name newtypes: plain strings. The reference wraps these (lib.rs:271-363) for
# type safety; in Python we keep aliases and rely on IndexKey for keyed maps.
KeyspaceName = str
IndexName = str
TableName = str
ColumnName = str

# Keyspaces created through ScyllaDB's DynamoDB-compatible API are prefixed
# with "alternator_" (reference lib.rs:115-134).
ALTERNATOR_KEYSPACE_PREFIX = "alternator_"
# Alternator stores non-key attributes in a single map column (reference
# db_index_backend.rs:22-62 reads from the ":attrs" map).
ALTERNATOR_ATTRS_COLUMN = ":attrs"


def is_alternator_keyspace(keyspace: str) -> bool:
    return keyspace.startswith(ALTERNATOR_KEYSPACE_PREFIX)


class IndexKey(NamedTuple):
    """Unique key of an index: (keyspace, index name). Reference: index_key.rs."""

    keyspace: KeyspaceName
    index: IndexName

    def __str__(self) -> str:  # used in log spans, mirrors "{ks}.{idx}"
        return f"{self.keyspace}.{self.index}"


class SpaceType(enum.Enum):
    """Distance space of an index. Reference lib.rs:441-461."""

    EUCLIDEAN = "EUCLIDEAN"
    COSINE = "COSINE"
    DOT_PRODUCT = "DOT_PRODUCT"
    HAMMING = "HAMMING"

    @classmethod
    def parse(cls, s: str) -> "SpaceType":
        try:
            return cls(s.upper())
        except ValueError:
            raise ValueError(f"Unknown space type: {s}") from None

    @classmethod
    def default(cls) -> "SpaceType":
        return cls.COSINE


class Quantization(enum.Enum):
    """On-device storage precision of indexed vectors. Reference lib.rs:463-495."""

    F32 = "F32"
    F16 = "F16"
    BF16 = "BF16"
    I8 = "I8"
    B1 = "B1"

    @classmethod
    def parse(cls, s: str) -> "Quantization":
        try:
            return cls(s.upper())
        except ValueError:
            raise ValueError(f"Unknown quantization type: {s}") from None

    @classmethod
    def default(cls) -> "Quantization":
        return cls.F32


DEFAULT_CONNECTIVITY = 16  # max neighbors per graph node (lib.rs:394)
DEFAULT_EXPANSION_ADD = 128  # construction beam width (lib.rs:412)
DEFAULT_EXPANSION_SEARCH = 64  # search beam width (lib.rs:430)


@dataclass(frozen=True)
class Dimensions:
    """Dimensionality of indexed embeddings; must be positive."""

    value: int

    def __post_init__(self) -> None:
        if self.value <= 0:
            raise ValueError(f"Dimensions must be positive, got {self.value}")

    def __int__(self) -> int:
        return self.value


@dataclass(frozen=True)
class Connectivity:
    value: int = DEFAULT_CONNECTIVITY

    def __post_init__(self) -> None:
        if self.value <= 0:
            raise ValueError(f"Connectivity must be positive, got {self.value}")

    def __int__(self) -> int:
        return self.value


@dataclass(frozen=True)
class ExpansionAdd:
    value: int = DEFAULT_EXPANSION_ADD

    def __post_init__(self) -> None:
        if self.value <= 0:
            raise ValueError(f"ExpansionAdd must be positive, got {self.value}")

    def __int__(self) -> int:
        return self.value


@dataclass(frozen=True)
class ExpansionSearch:
    value: int = DEFAULT_EXPANSION_SEARCH

    def __post_init__(self) -> None:
        if self.value <= 0:
            raise ValueError(f"ExpansionSearch must be positive, got {self.value}")

    def __int__(self) -> int:
        return self.value


MAX_LIMIT = 1_000_000


@dataclass(frozen=True)
class Limit:
    """Search result limit; >= 1 (reference lib.rs:497-507, default 1).
    Capped at MAX_LIMIT so a request can't demand unbounded result
    allocations (DoS hardening beyond the reference's NonZeroUsize)."""

    value: int = 1

    def __post_init__(self) -> None:
        if self.value <= 0:
            raise ValueError(f"Limit must be positive, got {self.value}")
        if self.value > MAX_LIMIT:
            raise ValueError(f"Limit must be <= {MAX_LIMIT}, got {self.value}")

    def __int__(self) -> int:
        return self.value


@dataclass(frozen=True, order=False)
class IndexVersion:
    """Index version timeuuid; ordered by gregorian timestamp ticks
    (reference lib.rs:568-596) so the newest index wins routing tie-breaks."""

    value: uuid.UUID

    @staticmethod
    def nil() -> "IndexVersion":
        return IndexVersion(uuid.UUID(int=0))

    def gregorian_ticks(self) -> int:
        # 60-bit timestamp of a version-1 UUID; 0 when not a time-based UUID.
        if self.value.version == 1:
            return self.value.time
        return 0

    def __lt__(self, other: "IndexVersion") -> bool:
        return self.gregorian_ticks() < other.gregorian_ticks()

    def __le__(self, other: "IndexVersion") -> bool:
        return self.gregorian_ticks() <= other.gregorian_ticks()

    def __gt__(self, other: "IndexVersion") -> bool:
        return self.gregorian_ticks() > other.gregorian_ticks()

    def __ge__(self, other: "IndexVersion") -> bool:
        return self.gregorian_ticks() >= other.gregorian_ticks()


@dataclass(frozen=True)
class IndexOptionsVs:
    """Vector-search index configuration (reference lib.rs:598-607).

    oversampling/rescoring are the CREATE INDEX options the reference's
    quantization_and_rescoring validator group drives: `oversampling` is
    the candidate-fetch multiplier over LIMIT, and `rescoring=false` turns
    off the exact re-rank so results keep storage-precision rank order.
    None means the engine picks its measured default per quantization."""

    dimensions: Dimensions
    connectivity: Connectivity = Connectivity()
    expansion_add: ExpansionAdd = ExpansionAdd()
    expansion_search: ExpansionSearch = ExpansionSearch()
    space_type: SpaceType = SpaceType.COSINE
    quantization: Quantization = Quantization.F32
    oversampling: float | None = None
    rescoring: bool | None = None


@dataclass(frozen=True)
class IndexOptionsFts:
    """Full-text-search index configuration (reference lib.rs:609-611)."""


class DbIndexKind(enum.Enum):
    """Kind of custom index declared in ScyllaDB (reference lib.rs:695-699)."""

    VECTOR_SEARCH = "vector_search"
    FULL_TEXT_SEARCH = "full_text_search"


@dataclass(frozen=True)
class DbIndexPartitioning:
    """Global index or local (per-partition) index keyed by pk columns
    (reference lib.rs:688-692)."""

    local_columns: tuple[ColumnName, ...] | None = None

    @property
    def is_global(self) -> bool:
        return self.local_columns is None

    @staticmethod
    def global_() -> "DbIndexPartitioning":
        return DbIndexPartitioning(None)

    @staticmethod
    def local(columns: tuple[ColumnName, ...]) -> "DbIndexPartitioning":
        if not columns:
            raise ValueError("local partitioning requires at least one column")
        return DbIndexPartitioning(columns)


@dataclass(frozen=True)
class IndexMetadata:
    """All metadata needed to build and serve one index
    (reference lib.rs:632-643)."""

    keyspace_name: KeyspaceName
    index_name: IndexName
    table_name: TableName
    primary_key_columns: tuple[ColumnName, ...]
    partition_key_count: int
    target_columns: tuple[ColumnName, ...]
    partitioning: DbIndexPartitioning
    filtering_columns: tuple[ColumnName, ...]
    version: IndexVersion
    # exactly one of vs / fts set
    vs_options: IndexOptionsVs | None = None
    fts_options: IndexOptionsFts | None = None

    def __post_init__(self) -> None:
        if (self.vs_options is None) == (self.fts_options is None):
            raise ValueError("IndexMetadata must have exactly one of vs/fts options")
        if not self.primary_key_columns:
            raise ValueError("primary_key_columns must be non-empty")
        if not self.target_columns:
            raise ValueError("target_columns must be non-empty")
        if not (1 <= self.partition_key_count <= len(self.primary_key_columns)):
            raise ValueError("partition_key_count out of range")

    @property
    def key(self) -> IndexKey:
        return IndexKey(self.keyspace_name, self.index_name)

    @property
    def target_column(self) -> ColumnName:
        return self.target_columns[0]

    def discard_version(self) -> "IndexMetadata":
        return IndexMetadata(
            keyspace_name=self.keyspace_name,
            index_name=self.index_name,
            table_name=self.table_name,
            primary_key_columns=self.primary_key_columns,
            partition_key_count=self.partition_key_count,
            target_columns=self.target_columns,
            partitioning=self.partitioning,
            filtering_columns=self.filtering_columns,
            version=IndexVersion.nil(),
            vs_options=self.vs_options,
            fts_options=self.fts_options,
        )

    def nonpk_partition_key_columns(self) -> tuple[ColumnName, ...]:
        """Local-partitioning columns that are not part of the base table's
        primary key (reference lib.rs:661-672)."""
        if self.partitioning.is_global:
            return ()
        return tuple(
            c
            for c in self.partitioning.local_columns or ()
            if c not in self.primary_key_columns
        )


@dataclass(frozen=True)
class DbCustomIndex:
    """A custom index discovered from the DB schema (reference lib.rs:701-717)."""

    keyspace: KeyspaceName
    index: IndexName
    table: TableName
    primary_key_columns: tuple[ColumnName, ...]
    partition_key_count: int
    target_columns: tuple[ColumnName, ...]
    partitioning: DbIndexPartitioning
    filtering_columns: tuple[ColumnName, ...]
    kind: DbIndexKind

    @property
    def key(self) -> IndexKey:
        return IndexKey(self.keyspace, self.index)


# ---------------------------------------------------------------------------
# Ingestion row types (reference lib.rs:708-728)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DbIndexedValue:
    """One indexed value read from a CDC row or full scan: a vector for a VS
    target column, a document for an FTS target, or a filtering value."""

    kind: str  # "vector" | "document" | "filtering"
    value: object  # list[float] | str | CqlValue-ish

    @staticmethod
    def vector(v: list[float] | object) -> "DbIndexedValue":
        return DbIndexedValue("vector", v)

    @staticmethod
    def document(text: str) -> "DbIndexedValue":
        return DbIndexedValue("document", text)

    @staticmethod
    def filtering(v: object) -> "DbIndexedValue":
        return DbIndexedValue("filtering", v)


@dataclass(frozen=True)
class DbIndexedOperation:
    """Upsert (timestamped values per target/filtering column) or Delete."""

    # "upsert": values is a non-empty tuple of Timestamped[DbIndexedValue]
    # "delete": timestamp of the deletion
    kind: str
    values: tuple[Timestamped, ...] = ()
    timestamp: Timestamp | None = None

    @staticmethod
    def upsert(values: tuple[Timestamped, ...]) -> "DbIndexedOperation":
        if not values:
            raise ValueError("upsert requires at least one value")
        return DbIndexedOperation("upsert", values=values)

    @staticmethod
    def delete(ts: Timestamp) -> "DbIndexedOperation":
        return DbIndexedOperation("delete", timestamp=ts)


@dataclass(frozen=True)
class DbIndexedRow:
    """A row read from a CDC stream or full scan."""

    primary_key: "PrimaryKey"  # keys.PrimaryKey; string annotation avoids cycle
    operation: DbIndexedOperation


@dataclass(frozen=True)
class Progress:
    """Percentage progress of a full scan, 0.0..=100.0 (reference
    lib.rs:857-886)."""

    percentage: float = 0.0

    def __post_init__(self) -> None:
        if not (0.0 <= self.percentage <= 100.0):
            raise ValueError(f"Progress out of range: {self.percentage}")

    @staticmethod
    def done() -> "Progress":
        return Progress(100.0)
