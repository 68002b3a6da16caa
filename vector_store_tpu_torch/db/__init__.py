"""DB access layer.

The reference talks to ScyllaDB through a session actor (db.rs), per-index
full-scan + CDC ingestion (db_index.rs, db_cdc/), and schema discovery
queries. This package defines the injectable interface those roles need —
designed injectable from day one so the whole service runs against FakeDb
in-process (the reference's highest-leverage test asset is exactly such a
fake, tests/integration/db_basic.rs).

Implementations:
- fake.FakeDb — in-memory schema + scripted scans/CDC feeds (db_basic parity)
- scylla (later rounds) — real CQL driver + CDC readers
"""

from __future__ import annotations

import abc
import asyncio
from typing import Callable, Optional

from vector_store_tpu_torch.core.types import (
    DbCustomIndex,
    IndexKey,
    IndexMetadata,
    IndexVersion,
    Progress,
)


class ScanLatch:
    """Tracks full-scan completion: the scan is finished when every emitted
    row has been *consumed* by the pipeline (the reference's
    AsyncInProgress::Fullscan markers gate completion the same way)."""

    def __init__(self, on_done: Callable[[], None]) -> None:
        self._on_done = on_done
        self.emitted = 0
        self.completed = 0
        self._emitting_done = False
        self._fired = False

    def row_emitted(self) -> None:
        self.emitted += 1

    def row_done(self) -> None:
        self.completed += 1
        self._check()

    def finish_emitting(self) -> None:
        self._emitting_done = True
        self._check()

    @property
    def fired(self) -> bool:
        return self._fired

    def _check(self) -> None:
        if self._emitting_done and self.completed >= self.emitted and not self._fired:
            self._fired = True
            self._on_done()


class DbIndex(abc.ABC):
    """Per-index ingestion: one feed queue of (DbIndexedRow, AsyncInProgress)
    items, filled by the initial full scan and then by CDC."""

    def __init__(self) -> None:
        self.feed: asyncio.Queue = asyncio.Queue()

    @abc.abstractmethod
    def start(
        self,
        on_scan_started: Callable[[], None],
        on_scan_finished: Callable[[], None],
    ) -> None:
        """Begin the full scan (then continuous CDC)."""

    @abc.abstractmethod
    def full_scan_progress(self) -> Progress:
        ...

    @abc.abstractmethod
    async def stop(self) -> None:
        ...

    async def get_table_columns(self) -> dict[str, str]:
        """Base-table column name -> CQL type string, used for typed
        filter-value conversion (reference db_index get_table_columns)."""
        return {}


class Db(abc.ABC):
    """Schema discovery + session surface used by the control plane."""

    @abc.abstractmethod
    async def latest_schema_version(self) -> Optional[object]:
        ...

    @abc.abstractmethod
    async def get_indexes(self) -> list[DbCustomIndex]:
        ...

    @abc.abstractmethod
    async def get_index_version(self, key: IndexKey) -> Optional[IndexVersion]:
        ...

    @abc.abstractmethod
    async def get_index_target_dimensions(self, key: IndexKey) -> Optional[int]:
        ...

    @abc.abstractmethod
    async def get_index_params(self, key: IndexKey) -> dict:
        """connectivity / expansion_add / expansion_search / space_type /
        quantization overrides parsed from index options."""

    @abc.abstractmethod
    async def is_valid_index(self, key: IndexKey) -> bool:
        ...

    @abc.abstractmethod
    def get_db_index(self, metadata: IndexMetadata) -> DbIndex:
        ...
