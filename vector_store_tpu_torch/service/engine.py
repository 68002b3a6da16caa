"""Index lifecycle (reference engine.rs): AddIndex builds the Table cache,
starts ingestion, spawns the index actor and the monitor_items pump, and
registers everything in the Indexes registry; DelIndex tears it down; a
periodic tick copies status/progress from node_state and the scan into the
registry entries (engine.rs:182-403).
"""

from __future__ import annotations

import asyncio
import logging

import torch

from vector_store_tpu_torch.core.types import IndexKey, IndexMetadata
from vector_store_tpu_torch.db import Db
from vector_store_tpu_torch.service.indexes import (
    FtsIndexEntry,
    Indexes,
    VsIndexEntry,
)
from vector_store_tpu_torch.service.monitor_items import MonitorItems
from vector_store_tpu_torch.service.node_state import IndexStatus, NodeState
from vector_store_tpu_torch.service.vs_index import VsIndexActor
from vector_store_tpu_torch.table import Table

logger = logging.getLogger(__name__)

UPDATE_TICK = 1.0


class Engine:
    def __init__(
        self,
        db: Db,
        indexes: Indexes,
        node_state: NodeState,
        memory=None,
        metrics=None,
        internals=None,
        engine_kind: str = "auto",
        shards: int = 0,
        *,
        device: torch.device,
    ) -> None:
        self.db = db
        self.indexes = indexes
        self.node_state = node_state
        self.memory = memory
        self.metrics = metrics
        self.internals = internals
        self.engine_kind = engine_kind
        self.shards = shards
        self.device = device
        self._task: asyncio.Task | None = None
        self._stopped = False

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._tick_loop())

    async def stop(self) -> None:
        self._stopped = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        for key in list(self.indexes.keys()):
            await self.del_index(key)

    # -- lifecycle -------------------------------------------------------------

    async def add_index(self, metadata: IndexMetadata) -> None:
        key = metadata.key
        if self.indexes.get_vs(key) or self.indexes.get_fts(key):
            logger.debug("index %s already exists", key)
            return
        logger.info("adding index %s", key)

        table = Table(metadata)
        db_index = self.db.get_db_index(metadata)

        if metadata.vs_options is not None:
            actor = VsIndexActor(
                metadata,
                table,
                memory=self.memory,
                metrics=self.metrics,
                engine_kind=self.engine_kind,
                shards=self.shards,
                internals=self.internals,
                device=self.device,
            )
            actor.start()
            monitor = MonitorItems(
                key, db_index.feed, table, actor, metrics=self.metrics
            )
            monitor.start()
            table_columns = {}
            try:
                table_columns = await db_index.get_table_columns()
            except Exception:
                logger.debug("get_table_columns failed for %s", key)
            entry = VsIndexEntry(
                actor=actor,
                monitor=monitor,
                db_index=db_index,
                metadata=metadata,
                table_columns=table_columns,
            )
            self.indexes.insert_vs(key, entry)
        else:
            from vector_store_tpu_torch.service.fts_index import FtsIndexActor

            actor = FtsIndexActor(metadata, table, metrics=self.metrics)
            actor.start()
            monitor = MonitorItems(
                key, db_index.feed, table, actor, metrics=self.metrics
            )
            monitor.start()
            entry = FtsIndexEntry(
                actor=actor, monitor=monitor, db_index=db_index, metadata=metadata
            )
            self.indexes.insert_fts(key, entry)

        if self.metrics is not None:
            def refresh(actor=actor, key=key):
                self.metrics.size.with_labels(key.keyspace, key.index).set(
                    actor.engine.size if hasattr(actor, "engine") else actor.size
                )

            entry.size_refresher = refresh  # type: ignore[attr-defined]
            self.metrics.add_refresher(refresh)

        db_index.start(
            on_scan_started=lambda: self.node_state.full_scan_started(metadata),
            on_scan_finished=lambda: self.node_state.full_scan_finished(metadata),
        )

    async def del_index(self, key: IndexKey) -> None:
        entry = self.indexes.remove(key)
        if entry is None:
            return
        logger.info("removing index %s", key)
        await entry.db_index.stop()
        await entry.monitor.stop()
        await entry.actor.stop()
        if self.metrics is not None:
            refresher = getattr(entry, "size_refresher", None)
            if refresher is not None:
                self.metrics.remove_refresher(refresher)
            self.metrics.drop_index_labels(key.keyspace, key.index)

    # -- periodic status sync (engine.rs:360-403) -------------------------------

    async def _tick_loop(self) -> None:
        while not self._stopped:
            await asyncio.sleep(UPDATE_TICK)
            self.update_entries()

    def update_entries(self) -> None:
        for key, entry in list(self.indexes.vs_entries.items()) + list(
            self.indexes.fts_entries.items()
        ):
            status = self.node_state.get_index_status(key.keyspace, key.index)
            if status is not None:
                entry.status = status
            entry.progress = entry.db_index.full_scan_progress()
