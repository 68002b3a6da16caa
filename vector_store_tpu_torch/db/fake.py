"""In-memory fake DB: the integration-test linchpin (parity with the
reference's tests/integration/db_basic.rs).

Tests inject tables and indexes, provide scan feeds (lists of rows or
callables), push CDC events at runtime, and flip failure knobs; the whole
service then runs end-to-end with no ScyllaDB and no sockets.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from vector_store_tpu_torch.core.keys import PrimaryKey
from vector_store_tpu_torch.core.timestamp import Timestamp, Timestamped
from vector_store_tpu_torch.core.types import (
    ColumnName,
    DbCustomIndex,
    DbIndexedOperation,
    DbIndexedRow,
    DbIndexedValue,
    DbIndexKind,
    DbIndexPartitioning,
    IndexKey,
    IndexMetadata,
    IndexVersion,
    Progress,
)
from vector_store_tpu_torch.db import Db, DbIndex, ScanLatch
from vector_store_tpu_torch.service.monitor_items import AsyncInProgress

logger = logging.getLogger(__name__)


@dataclass
class FakeTable:
    keyspace: str
    table: str
    primary_key_columns: tuple[ColumnName, ...]
    partition_key_count: int = 1
    columns: dict[ColumnName, str] = field(default_factory=dict)  # name -> cql type


@dataclass
class FakeIndex:
    """A CUSTOM index registered in the fake schema."""

    metadata: IndexMetadata
    # scan rows: list of DbIndexedRow, or a callable returning an iterable
    scan: object = ()
    # a pending scan never finishes until `release_scan` is called
    pending: bool = False
    _release: asyncio.Event = field(default_factory=asyncio.Event)


class FakeDbIndex(DbIndex):
    def __init__(self, db: "FakeDb", index: FakeIndex) -> None:
        super().__init__()
        self.db = db
        self.index = index
        self.progress = Progress(0.0)
        self._task: asyncio.Task | None = None
        self._cdc_queue: asyncio.Queue = asyncio.Queue()
        self._stopped = False
        self.latch: ScanLatch | None = None

    def start(self, on_scan_started, on_scan_finished) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self._run(on_scan_started, on_scan_finished)
        )

    async def _run(self, on_scan_started, on_scan_finished) -> None:
        on_scan_started()

        def done() -> None:
            self.progress = Progress.done()
            on_scan_finished()

        self.latch = ScanLatch(done)

        if self.index.pending:
            await self.index._release.wait()

        rows = self.index.scan
        if callable(rows):
            rows = rows()
        rows = list(rows)
        total = max(len(rows), 1)
        for i, row in enumerate(rows):
            self.latch.row_emitted()
            marker = AsyncInProgress("fullscan", latch=self.latch)
            await self.feed.put((row, marker))
            self.progress = Progress(min(100.0 * (i + 1) / total, 99.9))
        self.latch.finish_emitting()

        # continuous CDC phase
        while not self._stopped:
            item = await self._cdc_queue.get()
            await self.feed.put(item)

    def full_scan_progress(self) -> Progress:
        return self.progress

    async def get_table_columns(self) -> dict[str, str]:
        md = self.index.metadata
        table = self.db.tables.get((md.keyspace_name, md.table_name))
        return dict(table.columns) if table else {}

    async def stop(self) -> None:
        self._stopped = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass

    # -- test-side injection ---------------------------------------------------

    async def push_cdc(self, row: DbIndexedRow, change_ts: float | None = None) -> None:
        import time

        marker = AsyncInProgress("cdc", change_seconds=change_ts or time.time())
        await self._cdc_queue.put((row, marker))


class FakeDb(Db):
    def __init__(self) -> None:
        self.tables: dict[tuple[str, str], FakeTable] = {}
        self.indexes: dict[IndexKey, FakeIndex] = {}
        self.db_indexes: dict[IndexKey, FakeDbIndex] = {}
        self._schema_version = uuid.uuid4()
        # failure knobs (db_basic.rs:295-308)
        self.next_get_db_index_failed = False
        self.endless_get_indexes = False

    # -- schema management (test-side) ----------------------------------------

    def add_table(self, table: FakeTable) -> None:
        self.tables[(table.keyspace, table.table)] = table
        self._schema_version = uuid.uuid4()

    def add_index(self, index: FakeIndex) -> None:
        self.indexes[index.metadata.key] = index
        self._schema_version = uuid.uuid4()

    def drop_index(self, key: IndexKey) -> None:
        self.indexes.pop(key, None)
        self._schema_version = uuid.uuid4()

    def release_scan(self, key: IndexKey) -> None:
        self.indexes[key]._release.set()

    # -- Db interface ----------------------------------------------------------

    async def latest_schema_version(self):
        if self.endless_get_indexes:
            await asyncio.sleep(3600)
        return self._schema_version

    async def get_indexes(self) -> list[DbCustomIndex]:
        out = []
        for key, idx in self.indexes.items():
            md = idx.metadata
            out.append(
                DbCustomIndex(
                    keyspace=md.keyspace_name,
                    index=md.index_name,
                    table=md.table_name,
                    primary_key_columns=md.primary_key_columns,
                    partition_key_count=md.partition_key_count,
                    target_columns=md.target_columns,
                    partitioning=md.partitioning,
                    filtering_columns=md.filtering_columns,
                    kind=DbIndexKind.VECTOR_SEARCH
                    if md.vs_options is not None
                    else DbIndexKind.FULL_TEXT_SEARCH,
                )
            )
        return out

    async def get_index_version(self, key: IndexKey):
        idx = self.indexes.get(key)
        return idx.metadata.version if idx else None

    async def get_index_target_dimensions(self, key: IndexKey):
        idx = self.indexes.get(key)
        if idx is None or idx.metadata.vs_options is None:
            return None
        return int(idx.metadata.vs_options.dimensions)

    async def get_index_params(self, key: IndexKey) -> dict:
        idx = self.indexes.get(key)
        if idx is None or idx.metadata.vs_options is None:
            return {}
        vs = idx.metadata.vs_options
        params = {
            "connectivity": vs.connectivity,
            "expansion_add": vs.expansion_add,
            "expansion_search": vs.expansion_search,
            "space_type": vs.space_type,
            "quantization": vs.quantization,
        }
        if vs.oversampling is not None:
            params["oversampling"] = vs.oversampling
        if vs.rescoring is not None:
            params["rescoring"] = vs.rescoring
        return params

    async def is_valid_index(self, key: IndexKey) -> bool:
        return key in self.indexes

    def get_db_index(self, metadata: IndexMetadata) -> FakeDbIndex:
        if self.next_get_db_index_failed:
            self.next_get_db_index_failed = False
            raise RuntimeError("simulated get_db_index failure")
        db_index = FakeDbIndex(self, self.indexes[metadata.key])
        self.db_indexes[metadata.key] = db_index
        return db_index


# -- helpers to build scan rows (db_basic scan_fn_* parity) -------------------


def vector_row(
    pk_values: tuple,
    vector: list[float],
    millis: int,
    filtering: Iterable[tuple[int, object]] = (),
) -> DbIndexedRow:
    """A full-scan/CDC upsert row: vector + optional filtering values, each
    (millis, value)."""
    values = [
        Timestamped(Timestamp.from_millis(millis), DbIndexedValue.vector(vector))
    ]
    for f_ms, f_val in filtering:
        values.append(
            Timestamped(
                Timestamp.from_millis(f_ms),
                DbIndexedValue.filtering(f_val) if f_val is not None else None,
            )
        )
    return DbIndexedRow(
        primary_key=PrimaryKey.from_values(pk_values),
        operation=DbIndexedOperation.upsert(tuple(values)),
    )


def document_row(pk_values: tuple, document: str, millis: int) -> DbIndexedRow:
    return DbIndexedRow(
        primary_key=PrimaryKey.from_values(pk_values),
        operation=DbIndexedOperation.upsert(
            (
                Timestamped(
                    Timestamp.from_millis(millis), DbIndexedValue.document(document)
                ),
            )
        ),
    )


def delete_row(pk_values: tuple, millis: int) -> DbIndexedRow:
    return DbIndexedRow(
        primary_key=PrimaryKey.from_values(pk_values),
        operation=DbIndexedOperation.delete(Timestamp.from_millis(millis)),
    )


def make_vs_metadata(
    keyspace: str = "ks",
    index: str = "idx",
    table: str = "tbl",
    dimensions: int = 3,
    primary_key_columns: tuple[str, ...] = ("pk",),
    partition_key_count: int = 1,
    target_column: str = "emb",
    filtering_columns: tuple[str, ...] = (),
    partitioning: DbIndexPartitioning | None = None,
    version: IndexVersion | None = None,
    **vs_kwargs,
) -> IndexMetadata:
    from vector_store_tpu_torch.core.types import Dimensions, IndexOptionsVs

    return IndexMetadata(
        keyspace_name=keyspace,
        index_name=index,
        table_name=table,
        primary_key_columns=primary_key_columns,
        partition_key_count=partition_key_count,
        target_columns=(target_column,),
        partitioning=partitioning or DbIndexPartitioning.global_(),
        filtering_columns=filtering_columns,
        version=version or IndexVersion(uuid.uuid1()),
        vs_options=IndexOptionsVs(dimensions=Dimensions(dimensions), **vs_kwargs),
    )
