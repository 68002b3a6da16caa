"""Authoritative row cache: PrimaryKey→PrimaryId allocation, LWW timestamp
conflict resolution, partition bookkeeping, and Operation deltas feeding the
device index engines.

Behavioral parity with reference table/mod.rs: the 7-case ProcessingPartition
classification (get_partition_key, table/mod.rs:176-236), the timestamp gate
and UpdateWork matrix (update_index, table/mod.rs:759-1003), LWW column
updates guarded by strictly-newer timestamps (column_vec.rs:38-47), epoch
bumping on every accepted update so stale index hits are rejected
(primary_id epoch check, table/mod.rs:591-596), and the five Operation
variants (table/mod.rs:1394-1419).

Pure host-side Python, no JAX. The Operations it emits are consumed by the
monitor_items pump which batches them into device engine calls.
"""

from __future__ import annotations

import logging
from collections import deque
from dataclasses import dataclass
from typing import Iterable, Optional

from vector_store_tpu_torch.core.filters import Restriction, RestrictionKind
from vector_store_tpu_torch.core.ids import IndexId, IndexIdGenerator, PartitionId, PrimaryId, next_epoch
from vector_store_tpu_torch.core.keys import PartitionKey, PrimaryKey
import numpy as np

from vector_store_tpu_torch.core.timestamp import (
    TOMBSTONE_MIN_PACKED,
    Timestamp,
    Timestamped,
)
from vector_store_tpu_torch.core.types import (
    ColumnName,
    DbIndexedValue,
    IndexKey,
    IndexMetadata,
)
from vector_store_tpu_torch.utils import hotpath

logger = logging.getLogger(__name__)

RESERVE_PRIMARY_IDS = 1 << 10  # table/mod.rs:446
RESERVE_PARTITION_IDS = 1 << 8  # table/mod.rs:325


# ---------------------------------------------------------------------------
# Operations emitted to the index engines (table/mod.rs:1394-1419)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AddVector:
    primary_id: PrimaryId
    partition_id: PartitionId
    vector: object  # np.ndarray f32 (one dense row, not a per-float tuple)
    is_update: bool


@dataclass(frozen=True)
class AddVectorBlock:
    """Columnar bulk insert: N brand-new rows of one global index as ONE
    operation ([n] slots + [n] epochs + [n, d] f32 matrix) instead of N
    AddVector objects. Emitted only by Table.upsert_scan for rows whose
    full state machine provably reduces to UpdateWork::Add (fresh primary
    key, global partition, valid vector, no filtering columns) — the
    full-scan ingest hot path. The TPU-native analog of the reference's
    per-row Operation stream (table/mod.rs:1394-1419): the device engines
    consume columns, so the delta stays columnar end to end."""

    slots: object  # np.ndarray int64 [n]
    epochs: object  # np.ndarray int32 [n]
    partition_id: PartitionId
    vectors: object  # np.ndarray f32 [n, d]

    def __len__(self) -> int:
        return int(self.slots.shape[0])


@dataclass(frozen=True)
class AddDocument:
    primary_id: PrimaryId
    partition_id: PartitionId
    document: str
    is_update: bool


@dataclass(frozen=True)
class RemoveBeforeAddValue:
    primary_id: PrimaryId
    partition_id: PartitionId


@dataclass(frozen=True)
class RemoveValue:
    primary_id: PrimaryId
    partition_id: PartitionId


@dataclass(frozen=True)
class RemovePartition:
    partition_id: PartitionId


Operation = (
    AddVector
    | AddVectorBlock
    | AddDocument
    | RemoveBeforeAddValue
    | RemoveValue
    | RemovePartition
)


# ---------------------------------------------------------------------------
# Partition classification (table/mod.rs:302-321)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Processing:
    kind: str  # existing|new|add_to_existing|move_to_new|move_to_existing|missing_key|missing
    partition_id: PartitionId | None = None
    new_partition_id: PartitionId | None = None
    partition_key: PartitionKey | None = None

    @property
    def is_changing_partitions(self) -> bool:
        return self.kind in ("move_to_new", "move_to_existing", "missing_key", "new")


class _IndexData:
    """Global marker or local partition bookkeeping (table/mod.rs:98-287)."""

    def __init__(
        self,
        index_id: IndexId,
        partition_key_columns: tuple[ColumnName, ...] | None,
        primary_key_columns: tuple[ColumnName, ...],
    ) -> None:
        self.index_id = index_id
        self.is_global = partition_key_columns is None
        self.partition_key_columns = partition_key_columns or ()
        self.nonpk_partition_key_columns = tuple(
            c for c in self.partition_key_columns if c not in primary_key_columns
        )
        # local-only state
        self.map: dict[PartitionKey, PartitionId] = {}
        self.free_ids: deque[PartitionId] = deque()
        self.keys: list[PartitionKey | None] = []  # by partition slot
        self.sizes: list[int] = []
        self.ids: list[PartitionId | None] = []  # by primary slot
        self._next_partition_slot = 0

    def reserve_partition_ids(self) -> None:
        if self.is_global or self.free_ids:
            return
        start = self._next_partition_slot
        end = start + RESERVE_PARTITION_IDS
        for slot in range(start, end):
            self.free_ids.append(PartitionId.new(slot, self.index_id))
        self._next_partition_slot = end
        self.keys.extend([None] * (end - len(self.keys)))
        self.sizes.extend([0] * (end - len(self.sizes)))

    def resize_primary_ids(self, new_size: int) -> None:
        if not self.is_global and len(self.ids) < new_size:
            self.ids.extend([None] * (new_size - len(self.ids)))

    def create_partition(self, partition_key: PartitionKey) -> PartitionId:
        if self.is_global:
            raise RuntimeError("Global index does not support partition keys")
        existing = self.map.get(partition_key)
        if existing is not None:
            logger.debug("partition key already exists while creating partition")
            return existing
        partition_id = self.free_ids.popleft()
        self.map[partition_key] = partition_id
        self.keys[partition_id.slot] = partition_key
        self.sizes[partition_id.slot] = 0
        return partition_id

    def insert_row_into_partition(self, primary_id: PrimaryId, partition_id: PartitionId) -> None:
        if self.is_global:
            return
        self.ids[primary_id.slot] = partition_id
        self.sizes[partition_id.slot] += 1

    def remove_row_from_partition(
        self, primary_id: PrimaryId, partition_id: PartitionId
    ) -> bool:
        """Returns True if the partition became empty (and was dropped)."""
        if self.is_global:
            return False
        self.ids[primary_id.slot] = None
        slot = partition_id.slot
        if self.sizes[slot] > 0:
            self.sizes[slot] -= 1
        else:
            logger.debug("partition size should be > 0 when removing a row")
        if self.sizes[slot] == 0:
            key = self.keys[slot]
            if key is not None:
                self.keys[slot] = None
                self.map.pop(key, None)
                self.free_ids.append(partition_id)
            return True
        return False

    def classify(
        self,
        primary_id: PrimaryId,
        get_column_value,  # (column_name) -> value | None
    ) -> _Processing:
        """The 7-case partition transition (get_partition_key,
        table/mod.rs:176-236)."""
        if self.is_global:
            return _Processing("existing", PartitionId.global_for(self.index_id))

        cur = self.ids[primary_id.slot] if primary_id.slot < len(self.ids) else None

        if not self.nonpk_partition_key_columns and cur is not None:
            return _Processing("existing", cur)

        values = [get_column_value(c) for c in self.partition_key_columns]
        if any(v is None for v in values):
            if cur is not None:
                return _Processing("missing_key", cur)
            return _Processing("missing")
        pkey = PartitionKey.from_values(values)

        mapped = self.map.get(pkey)
        if mapped is None:
            if cur is not None:
                return _Processing("move_to_new", cur, partition_key=pkey)
            return _Processing("new", partition_key=pkey)
        if cur is None:
            return _Processing("add_to_existing", mapped)
        if mapped == cur:
            return _Processing("existing", cur)
        return _Processing("move_to_existing", cur, new_partition_id=mapped)


class _Index:
    """Per-index slot state: epoch + per-target-column value timestamps.

    Dense storage (table/vec_chunks.rs / chunk_timestamps.rs parity): one
    int32 epoch + target_count packed uint64 timestamps per row in numpy
    arrays — ~(4 + 8n) bytes/row instead of a Python list of Timestamped
    objects per cell (which costs ~170 bytes/row and GC pressure at
    millions of rows). Timestamped views materialize transiently on read.
    """

    def __init__(
        self,
        index_id: IndexId,
        data: _IndexData,
        filtering_columns: tuple[ColumnName, ...],
        target_count: int,
    ) -> None:
        self.index_id = index_id
        self.data = data
        self.filtering_columns = filtering_columns
        self.target_count = target_count
        # per primary slot: epoch (>=0), -1 when slot unused
        self.epochs = np.full(0, -1, dtype=np.int32)
        # per primary slot x target: packed (tombstone MSB | ticks)
        self.value_ts = np.full((0, target_count), TOMBSTONE_MIN_PACKED, dtype=np.uint64)

    def resize_primary_ids(self, new_size: int) -> None:
        if len(self.epochs) < new_size:
            cap = max(new_size, 2 * len(self.epochs))  # geometric growth
            epochs = np.full(cap, -1, dtype=np.int32)
            epochs[: len(self.epochs)] = self.epochs
            self.epochs = epochs
            vts = np.full(
                (cap, self.target_count), TOMBSTONE_MIN_PACKED, dtype=np.uint64
            )
            vts[: self.value_ts.shape[0]] = self.value_ts
            self.value_ts = vts
        self.data.resize_primary_ids(new_size)

    def slot_state(self, slot: int) -> tuple[int, list[Timestamped]]:
        epoch = int(self.epochs[slot])
        if epoch < 0:
            epoch = 0
            self.epochs[slot] = 0
            self.value_ts[slot, :] = TOMBSTONE_MIN_PACKED
        ts = [
            Timestamped.from_packed(int(p), ()) for p in self.value_ts[slot]
        ]
        return epoch, ts

    def set_slot(self, slot: int, epoch: int, timestamps: list[Timestamped]) -> None:
        self.epochs[slot] = epoch
        for j, tv in enumerate(timestamps[: self.target_count]):
            self.value_ts[slot, j] = np.uint64(tv.packed)


class DenseColumn:
    """Dense LWW filtering-column storage (column_vec.rs / vec_chunks.rs
    parity): packed uint64 write-timestamps in a numpy array + one Python
    object slot per row, instead of a Timestamped wrapper per cell.
    ~16 bytes/row fixed overhead at millions of rows."""

    __slots__ = ("ts", "values")

    def __init__(self, size: int) -> None:
        self.ts = np.full(size, TOMBSTONE_MIN_PACKED, dtype=np.uint64)
        self.values: list = [None] * size

    def __len__(self) -> int:
        return len(self.values)

    def resize(self, new_size: int) -> None:
        if new_size <= len(self.values):
            return
        cap = max(new_size, 2 * len(self.values))
        ts = np.full(cap, TOMBSTONE_MIN_PACKED, dtype=np.uint64)
        ts[: len(self.ts)] = self.ts
        self.ts = ts
        self.values.extend([None] * (cap - len(self.values)))

    def value(self, slot: int):
        """Current value; None when tombstoned."""
        if int(self.ts[slot]) & (1 << 63):
            return None
        return self.values[slot]

    def timestamp_ticks(self, slot: int) -> int:
        return int(self.ts[slot]) & ((1 << 63) - 1)

    def update(self, slot: int, ts: Timestamp, value) -> None:
        """LWW: strictly newer wins (column_vec.rs:38-47)."""
        if ts.ticks > self.timestamp_ticks(slot):
            tv = Timestamped(ts, value)
            self.ts[slot] = np.uint64(tv.packed)
            self.values[slot] = value


@dataclass
class _CompareTimestamps:
    is_cur_tombstone: bool
    is_new_tombstone: bool
    is_newer_timestamp: bool
    is_same_timestamp: bool


def _compare_timestamps(
    current: list[Timestamped], new: list[Timestamped]
) -> _CompareTimestamps:
    cmp = _CompareTimestamps(
        is_cur_tombstone=False,
        is_new_tombstone=True,
        is_newer_timestamp=False,
        is_same_timestamp=True,
    )
    for cur, nw in zip(current, new):
        if cur.is_tombstone:
            cmp.is_cur_tombstone = True
        if nw.is_valid:
            cmp.is_new_tombstone = False
        if cur.timestamp < nw.timestamp:
            cmp.is_newer_timestamp = True
        if cur.timestamp != nw.timestamp:
            cmp.is_same_timestamp = False
    return cmp


class Table:
    """One base table's cache serving one index (the reference wires one
    Table per index, engine.rs:215-231, though the structure supports
    several sharing it)."""

    def __init__(self, metadata: IndexMetadata) -> None:
        self.metadata = metadata
        self.primary_key_columns = metadata.primary_key_columns
        self.partition_primary_key_count = metadata.partition_key_count

        self.primary_ids: dict[PrimaryKey, PrimaryId] = {}
        self.free_primary_ids: deque[PrimaryId] = deque()
        self._next_primary_slot = 0
        self.primary_keys: list[PrimaryKey | None] = []
        # monotonically bumped on every upsert/delete — cheap staleness
        # stamp for caches derived from row state (e.g. the serving actor's
        # per-restriction matching-slot cache)
        self.mutations = 0

        # regular (non-pk) columns: name -> dense LWW column
        self.columns: dict[ColumnName, DenseColumn] = {}
        # mutation-stamped float64 views of numeric columns, built lazily by
        # matching_slots' vectorized path
        self._numeric_cols: dict[ColumnName, tuple[int, np.ndarray | None]] = {}

        self._id_gen = IndexIdGenerator()
        self.index_ids: dict[IndexKey, IndexId] = {}
        self.indexes: dict[IndexId, _Index] = {}

        self.add_index(metadata)

    # -- setup ---------------------------------------------------------------

    def add_index(self, metadata: IndexMetadata) -> None:
        index_id = self._id_gen.next(global_=metadata.partitioning.is_global)
        data = _IndexData(
            index_id,
            metadata.partitioning.local_columns,
            metadata.primary_key_columns,
        )
        index = _Index(
            index_id,
            data,
            metadata.filtering_columns,
            target_count=1,  # one target column per index (vector or document)
        )
        self.index_ids[metadata.key] = index_id
        self.indexes[index_id] = index
        size = len(self.primary_keys)
        index.resize_primary_ids(size)
        for col in list(data.nonpk_partition_key_columns) + list(metadata.filtering_columns):
            if col not in self.primary_key_columns:
                self.columns.setdefault(col, DenseColumn(size))

    # -- id plumbing -----------------------------------------------------------

    def _reserve_primary_ids(self) -> None:
        if self.free_primary_ids:
            return
        start = self._next_primary_slot
        end = start + RESERVE_PRIMARY_IDS
        for slot in range(start, end):
            self.free_primary_ids.append(PrimaryId.new(slot, 0))
        self._next_primary_slot = end
        self.primary_keys.extend([None] * (end - len(self.primary_keys)))
        for vec in self.columns.values():
            vec.resize(end)
        for index in self.indexes.values():
            index.resize_primary_ids(end)

    def _add_primary_key(self, primary_key: PrimaryKey) -> PrimaryId:
        existing = self.primary_ids.get(primary_key)
        if existing is not None:
            return existing
        primary_id = self.free_primary_ids.popleft()
        self.primary_ids[primary_key] = primary_id
        self.primary_keys[primary_id.slot] = primary_key
        return primary_id

    # -- column access ---------------------------------------------------------

    def _column_value(self, primary_id: PrimaryId, column: ColumnName):
        """Current value of a column for a row; None when tombstoned or
        unknown. Primary-key columns pass through to the key itself."""
        return self._slot_value(primary_id.slot, column)

    def _slot_value(self, slot: int, column: ColumnName):
        if column in self.primary_key_columns:
            pk = self.primary_keys[slot]
            if pk is None:
                return None
            offset = self.primary_key_columns.index(column)
            values = pk.values()
            return values[offset] if offset < len(values) else None
        vec = self.columns.get(column)
        if vec is None or slot >= len(vec):
            return None
        return vec.value(slot)

    def _update_columns(
        self,
        primary_id: PrimaryId,
        column_names: Iterable[ColumnName],
        values: list[tuple[Timestamp, object | None]],
    ) -> None:
        for (ts, value), name in zip(values, column_names):
            if name in self.primary_key_columns:
                continue  # pk columns are immutable pass-throughs
            vec = self.columns.get(name)
            if vec is None:
                raise KeyError(f"Column {name} not found in table columns")
            vec.update(primary_id.slot, ts, value)

    # -- modify (TableModify parity, table/mod.rs:1006-1119) -------------------

    @hotpath.measure
    def upsert(
        self,
        index_key: IndexKey,
        primary_key: PrimaryKey,
        values: tuple[Timestamped, ...],  # Timestamped[DbIndexedValue], 1+target
    ) -> list[Operation]:
        self._reserve_primary_ids()
        self.mutations += 1
        index_id = self.index_ids.get(index_key)
        if index_id is None:
            raise KeyError(f"Index key {index_key} not found")
        index = self.indexes[index_id]
        index.data.reserve_partition_ids()

        primary_id = self._add_primary_key(primary_key)

        # split: first value is the target (vector/document), the rest are
        # filtering values in [nonpk partition key cols] + [filtering cols]
        # order (split_values_filtering, table/mod.rs:709-756)
        head = values[0]
        target: DbIndexedValue | None = head.value
        if target is not None and target.kind == "filtering":
            raise ValueError("Expected vector or document for the target column")
        if target is not None and target.value is None:
            # NULL cell in the target column: the row exists but carries no
            # vector/document — it is never indexed, and nulling an indexed
            # row's value removes it (crud.rs null_vector_is_not_indexed)
            target = None
            head = Timestamped.tombstone(head.timestamp)
        timestamps = [
            Timestamped(head.timestamp, ())
            if head.is_valid
            else Timestamped.tombstone(head.timestamp)
        ]
        filtering: list[tuple[Timestamp, object | None]] = []
        for tv in values[1:]:
            v = tv.value
            if v is not None and v.kind != "filtering":
                raise ValueError("Expected filtering value for non-target column")
            filtering.append((tv.timestamp, v.value if v is not None else None))

        self._update_columns(
            primary_id,
            list(index.data.nonpk_partition_key_columns) + list(index.filtering_columns),
            filtering,
        )

        processing = index.data.classify(
            primary_id, lambda col: self._column_value(primary_id, col)
        )
        return self._update_index(primary_id, processing, index, target, timestamps)

    @hotpath.measure
    def upsert_scan(
        self,
        index_key: IndexKey,
        rows: list[tuple[PrimaryKey, tuple[Timestamped, ...]]],
    ) -> list[Operation]:
        """Bulk upsert for the full-scan ingest path. Rows whose state
        machine provably reduces to UpdateWork::Add — fresh primary key
        (not in the table, unique within the batch), global index with no
        non-pk partition-key or filtering columns, exactly the target
        value, valid non-null vector — are applied with vectorized slot
        state writes and compressed into ONE AddVectorBlock. Every other
        row goes through the canonical per-row upsert, in arrival order.
        Behavior is identical to calling upsert per row (asserted by
        tests); only the operation encoding differs."""
        self.mutations += 1  # fast-path rows bypass upsert's own bump
        index_id = self.index_ids.get(index_key)
        if index_id is None:
            raise KeyError(f"Index key {index_key} not found")
        index = self.indexes[index_id]

        bulk_capable = (
            index.data.is_global
            and not index.data.nonpk_partition_key_columns
            and not index.filtering_columns
        )
        # PKs seen more than once in the batch must replay in arrival
        # order through the canonical path (LWW between duplicates)
        pk_counts: dict[PrimaryKey, int] = {}
        if bulk_capable:
            for pk, _ in rows:
                pk_counts[pk] = pk_counts.get(pk, 0) + 1

        fast: list[tuple[PrimaryKey, int, np.ndarray]] = []  # pk, packed ts, row
        d0 = -1
        operations: list[Operation] = []

        def flush_fast() -> None:
            nonlocal fast, d0
            if not fast:
                return
            n = len(fast)
            while len(self.free_primary_ids) < n:
                start = self._next_primary_slot
                end = start + max(RESERVE_PRIMARY_IDS, n)
                for slot in range(start, end):
                    self.free_primary_ids.append(PrimaryId.new(slot, 0))
                self._next_primary_slot = end
                self.primary_keys.extend([None] * (end - len(self.primary_keys)))
                for vec in self.columns.values():
                    vec.resize(end)
                for ix in self.indexes.values():
                    ix.resize_primary_ids(end)
            slots = np.empty((n,), dtype=np.int64)
            packed = np.empty((n,), dtype=np.uint64)
            vecs = np.empty((n, d0), dtype=np.float32)
            for i, (pk, pk_packed, row) in enumerate(fast):
                pid = self.free_primary_ids.popleft()
                self.primary_ids[pk] = pid
                self.primary_keys[pid.slot] = pk
                slots[i] = pid.slot
                packed[i] = pk_packed
                vecs[i] = row
            # fresh slots: epoch -1 -> initialized 0 by slot_state, the
            # incoming valid value is strictly newer than the tombstone-at-
            # MIN baseline -> work=add with epoch bumped to 1
            index.epochs[slots] = 1
            index.value_ts[slots, 0] = packed
            operations.append(
                AddVectorBlock(
                    slots=slots,
                    epochs=np.ones((n,), dtype=np.int32),
                    partition_id=PartitionId.global_for(index.index_id),
                    vectors=vecs,
                )
            )
            fast, d0 = [], -1

        for pk, values in rows:
            head = values[0] if values else None
            target = head.value if head is not None else None
            eligible = (
                bulk_capable
                and len(values) == 1
                and head is not None
                and head.is_valid
                and target is not None
                and target.kind == "vector"
                and target.value is not None
                and pk_counts.get(pk) == 1
                and pk not in self.primary_ids
            )
            if eligible:
                row = np.asarray(target.value, dtype=np.float32)
                if row.ndim == 1 and (d0 < 0 or row.shape[0] == d0):
                    if d0 < 0:
                        d0 = int(row.shape[0])
                    fast.append((pk, head.packed, row))
                    continue
            # keep arrival order: a slow row flushes the pending block
            # (fast rows are unique fresh PKs, so only engine-visible
            # ordering matters, never same-PK LWW ordering)
            flush_fast()
            operations.extend(self.upsert(index_key, pk, values))
        flush_fast()
        return operations

    @hotpath.measure
    def delete(
        self, index_key: IndexKey, primary_key: PrimaryKey, timestamp: Timestamp
    ) -> list[Operation]:
        self._reserve_primary_ids()
        self.mutations += 1
        index_id = self.index_ids.get(index_key)
        if index_id is None:
            raise KeyError(f"Index key {index_key} not found")
        index = self.indexes[index_id]
        index.data.reserve_partition_ids()

        primary_id = self._add_primary_key(primary_key)

        # tombstone only filtering columns; partition-key columns cannot be
        # removed (table/mod.rs:1092-1102)
        self._update_columns(
            primary_id,
            list(index.filtering_columns),
            [(timestamp, None) for _ in index.filtering_columns],
        )

        processing = index.data.classify(
            primary_id, lambda col: self._column_value(primary_id, col)
        )
        return self._update_index(
            primary_id,
            processing,
            index,
            None,
            [Timestamped.tombstone(timestamp)],
        )

    # -- the UpdateWork state machine (table/mod.rs:759-1003) -------------------

    def _update_index(
        self,
        primary_id: PrimaryId,
        processing: _Processing,
        index: _Index,
        target: DbIndexedValue | None,
        timestamps: list[Timestamped],
    ) -> list[Operation]:
        operations: list[Operation] = []
        if processing.kind == "missing":
            logger.debug("Missing partition, skipping update")
            return operations

        cur_epoch, cur_ts = index.slot_state(primary_id.slot)
        cmp = _compare_timestamps(cur_ts, timestamps)
        if not cmp.is_newer_timestamp and (
            not cmp.is_same_timestamp or not processing.is_changing_partitions
        ):
            return operations

        # a row re-read that lost its target column behaves as a tombstone
        if target is None and not cmp.is_new_tombstone:
            cmp.is_new_tombstone = True
            timestamps = [Timestamped.tombstone(timestamps[0].timestamp)]

        work, work_partition, work_new_partition = self._classify_work(
            processing, cmp, index
        )

        cur_primary_id = primary_id.with_epoch(cur_epoch)
        new_epoch = next_epoch(cur_epoch)
        new_primary_id = primary_id.with_epoch(new_epoch)

        index.set_slot(primary_id.slot, new_epoch, timestamps)

        if work == "none":
            return operations

        if work == "move_inside":
            operations.append(
                RemoveBeforeAddValue(primary_id=cur_primary_id, partition_id=work_partition)
            )
        if work == "move_between":
            operations.append(
                RemoveBeforeAddValue(primary_id=cur_primary_id, partition_id=work_partition)
            )
            if index.data.remove_row_from_partition(cur_primary_id, work_partition):
                operations.append(RemovePartition(partition_id=work_partition))

        if target is not None and work in ("move_inside", "move_between", "add"):
            if work == "move_inside":
                pid, is_update = work_partition, True
            elif work == "move_between":
                pid, is_update = work_new_partition, True
            else:
                pid, is_update = work_partition, False
            if target.kind == "vector":
                operations.append(
                    AddVector(
                        primary_id=new_primary_id,
                        partition_id=pid,
                        # dense f32 row (a per-float Python tuple costs
                        # ~30x the memory and a slow per-element convert)
                        vector=np.asarray(target.value, dtype=np.float32),
                        is_update=is_update,
                    )
                )
            else:
                operations.append(
                    AddDocument(
                        primary_id=new_primary_id,
                        partition_id=pid,
                        document=str(target.value),
                        is_update=is_update,
                    )
                )
            if work in ("move_between", "add"):
                index.data.insert_row_into_partition(new_primary_id, pid)

        if work == "remove":
            operations.append(
                RemoveValue(primary_id=cur_primary_id, partition_id=work_partition)
            )
            if index.data.remove_row_from_partition(cur_primary_id, work_partition):
                operations.append(RemovePartition(partition_id=work_partition))

        return operations

    def _classify_work(
        self, processing: _Processing, cmp: _CompareTimestamps, index: _Index
    ) -> tuple[str | None, PartitionId | None, PartitionId | None]:
        """Maps (ProcessingPartition x CompareTimestamps) to work
        (UpdateWork::new, table/mod.rs:767-868). Returns
        (work, partition, new_partition) where work is one of
        {'none', 'move_inside', 'move_between', 'add', 'remove'}; 'none'
        still advances the row's epoch and timestamps (the reference's
        UpdateWork::None) but emits no operations."""
        k = processing.kind
        ct, nt = cmp.is_cur_tombstone, cmp.is_new_tombstone

        if k == "existing":
            pid = processing.partition_id
            if ct:
                return ("none", None, None) if nt else ("add", pid, None)
            return ("remove", pid, None) if nt else ("move_inside", pid, None)

        if k == "new":
            if nt:
                return ("none", None, None)
            pid = index.data.create_partition(processing.partition_key)  # type: ignore[arg-type]
            return ("add", pid, None)

        if k == "add_to_existing":
            if nt:
                return ("none", None, None)
            return ("add", processing.partition_id, None)

        if k == "move_to_new":
            cur = processing.partition_id
            if nt:
                if ct:
                    return ("none", None, None)
                return ("remove", cur, None)
            new_pid = index.data.create_partition(processing.partition_key)  # type: ignore[arg-type]
            if ct:
                return ("add", new_pid, None)
            return ("move_between", cur, new_pid)

        if k == "move_to_existing":
            cur, new = processing.partition_id, processing.new_partition_id
            if ct:
                return ("none", None, None) if nt else ("add", new, None)
            return ("remove", cur, None) if nt else ("move_between", cur, new)

        if k == "missing_key":
            # partition key vanished: the row can no longer be indexed
            if ct:
                return ("none", None, None)
            return ("remove", processing.partition_id, None)

        return ("none", None, None)

    # -- search-side (TableSearch parity, table/mod.rs:1122-1276) ---------------

    def index_id(self, index_key: IndexKey) -> IndexId | None:
        return self.index_ids.get(index_key)

    def is_valid_primary_id(self, partition_id: PartitionId, primary_id: PrimaryId) -> bool:
        index = self.indexes.get(partition_id.index_id)
        if index is None or primary_id.slot >= len(index.epochs):
            return False
        epoch = int(index.epochs[primary_id.slot])
        return epoch >= 0 and epoch == primary_id.epoch

    def partition_id(
        self,
        index_key: IndexKey,
        restrictions: Optional[list[Restriction]],
    ) -> Optional[tuple[PartitionId, Optional[list[Restriction]]]]:
        index_id = self.index_ids.get(index_key)
        if index_id is None:
            return None
        index = self.indexes[index_id]
        if index.data.is_global:
            return (PartitionId.global_for(index_id), restrictions)
        if restrictions is None:
            return None
        got = partition_key_from_restrictions(
            index.data.partition_key_columns, restrictions
        )
        if got is None:
            return None
        pkey, remaining = got
        pid = index.data.map.get(pkey)
        if pid is None:
            return None
        return (pid, remaining)

    def primary_key(
        self, partition_id: PartitionId, primary_id: PrimaryId
    ) -> PrimaryKey | None:
        if not self.is_valid_primary_id(partition_id, primary_id):
            return None
        if primary_id.slot >= len(self.primary_keys):
            return None
        return self.primary_keys[primary_id.slot]

    def is_valid_for(
        self,
        partition_id: PartitionId,
        primary_id: PrimaryId,
        restriction: Restriction,
    ) -> bool:
        if not self.is_valid_primary_id(partition_id, primary_id):
            return False
        try:
            return restriction.matches(
                lambda col: self._column_value(primary_id, col)
            )
        except TypeError:
            return False

    def matching_slots(
        self, partition_id: PartitionId, restrictions: list[Restriction]
    ) -> np.ndarray:
        """Slots of live rows matching ALL restrictions — the bulk form of
        is_valid_for for the serving actor's terminal filtered path
        (service/vs_index.py::_finish_terminal): one column-major scan per
        distinct filter instead of a per-candidate predicate per query.
        The reference evaluates the same predicate row-at-a-time
        (table/mod.rs:1183-1362); the dense columnar layout here makes the
        vectorized order the cheap one. Numeric scalar restrictions ride a
        cached float64 view of the column; everything else falls back to
        the exact per-row evaluation."""
        index = self.indexes.get(partition_id.index_id)
        if index is None:
            return np.empty(0, dtype=np.int64)
        cap = min(len(self.primary_keys), len(index.epochs))
        live = np.flatnonzero(index.epochs[:cap] >= 0).astype(np.int64)
        for r in restrictions:
            if live.size == 0:
                break
            live = live[self._restriction_mask(live, r)]
        return live

    def _restriction_mask(
        self, slots: np.ndarray, r: Restriction
    ) -> np.ndarray:
        kind = r.kind
        if not kind.is_tuple and r.lhs[0] not in self.primary_key_columns:
            rhs_vals = r.rhs if kind is RestrictionKind.IN else (r.rhs,)
            numeric_rhs = all(
                isinstance(v, (int, float))
                and not isinstance(v, bool)
                and abs(float(v)) < 2.0**53
                for v in rhs_vals  # type: ignore[union-attr]
            )
            if numeric_rhs:
                arr = self._numeric_column(r.lhs[0])
                if arr is not None:
                    vals = arr[slots]
                    # NaN marks null/tombstoned cells: every comparison below
                    # yields False for NaN, matching "null never matches"
                    if kind is RestrictionKind.EQ:
                        return vals == float(r.rhs)  # type: ignore[arg-type]
                    if kind is RestrictionKind.IN:
                        return np.isin(
                            vals, np.asarray([float(v) for v in rhs_vals])
                        )
                    rhs = float(r.rhs)  # type: ignore[arg-type]
                    if kind is RestrictionKind.LT:
                        return vals < rhs
                    if kind is RestrictionKind.LTE:
                        return vals <= rhs
                    if kind is RestrictionKind.GT:
                        return vals > rhs
                    return vals >= rhs
        out = np.empty(slots.size, dtype=bool)
        for i, s in enumerate(slots):
            s = int(s)
            try:
                out[i] = r.matches(lambda col: self._slot_value(s, col))
            except TypeError:
                out[i] = False
        return out

    def _numeric_column(self, column: ColumnName) -> np.ndarray | None:
        """Float64 view of a column for vectorized restriction evaluation
        (NaN = null); None when the column holds non-numeric values or
        ints beyond 2^53 (where float64 equality would lie). Cached per
        mutation stamp."""
        vec = self.columns.get(column)
        if vec is None:
            return None
        cached = self._numeric_cols.get(column)
        if cached is not None and cached[0] == self.mutations:
            return cached[1]
        n = len(vec.values)
        arr = np.empty(n, dtype=np.float64)
        tomb = (vec.ts[:n] >> np.uint64(63)).astype(bool)
        ok = True
        lim = 2.0**53
        for i, v in enumerate(vec.values):
            if v is None or tomb[i]:
                arr[i] = np.nan
            elif isinstance(v, bool) or not isinstance(v, (int, float)):
                ok = False
                break
            else:
                f = float(v)
                if abs(f) >= lim:
                    ok = False
                    break
                arr[i] = f
        result = arr if ok else None
        self._numeric_cols[column] = (self.mutations, result)
        return result

    # -- stats -------------------------------------------------------------------

    @property
    def row_count(self) -> int:
        return len(self.primary_ids)


def partition_key_from_restrictions(
    key_columns: tuple[ColumnName, ...], restrictions: list[Restriction]
) -> Optional[tuple[PartitionKey, Optional[list[Restriction]]]]:
    """Extract the local-index partition key from Eq restrictions covering
    every partition key column; the consumed restrictions are removed
    (table/mod.rs:1280-1316)."""
    values = []
    for column in key_columns:
        found = None
        for r in restrictions:
            if r.kind is RestrictionKind.EQ and r.lhs[0] == column:
                found = r.rhs
                break
        if found is None:
            return None
        values.append(found)
    remaining = [
        r
        for r in restrictions
        if not (r.kind is RestrictionKind.EQ and r.lhs[0] in key_columns)
    ]
    return PartitionKey.from_values(values), (remaining or None)
