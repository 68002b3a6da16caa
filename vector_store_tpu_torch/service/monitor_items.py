"""Pipeline pump: drains (DbIndexedRow, marker) from the ingestion feed,
applies rows to the Table, forwards resulting Operations to the index actor
(reference monitor_items.rs:160-350).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from vector_store_tpu_torch.core.types import DbIndexedRow, IndexKey
from vector_store_tpu_torch.table import (
    AddDocument,
    AddVector,
    AddVectorBlock,
    Operation,
    RemoveValue,
    Table,
)

logger = logging.getLogger(__name__)

BATCH = 1024


class AsyncInProgress:
    """RAII marker riding each row (reference async_in_progress.rs):
    - fullscan rows hold a scan-completion latch,
    - CDC rows carry the change timestamp for the indexing-lag histogram.
    """

    __slots__ = ("kind", "latch", "change_seconds", "_done")

    def __init__(self, kind: str = "none", latch=None, change_seconds: float = 0.0):
        self.kind = kind
        self.latch = latch
        self.change_seconds = change_seconds
        self._done = False

    def complete(self, metrics=None, index_key: IndexKey | None = None) -> None:
        if self._done:
            return
        self._done = True
        if self.kind == "fullscan" and self.latch is not None:
            self.latch.row_done()
        elif self.kind == "cdc" and metrics is not None and index_key is not None:
            lag = max(0.0, time.time() - self.change_seconds)
            metrics.indexing_lag.with_labels(
                index_key.keyspace, index_key.index
            ).observe(lag)


class MonitorItems:
    def __init__(
        self,
        index_key: IndexKey,
        feed: asyncio.Queue,  # items: (DbIndexedRow, AsyncInProgress)
        table: Table,
        index_actor,  # VsIndexActor | FtsIndexActor (apply_operations)
        metrics=None,
    ) -> None:
        self.index_key = index_key
        self.feed = feed
        self.table = table
        self.index_actor = index_actor
        self.metrics = metrics
        self._task: asyncio.Task | None = None
        self._stopped = False

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stopped = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass

    async def _run(self) -> None:
        while not self._stopped:
            item = await self.feed.get()
            items = [item]
            while len(items) < BATCH:
                try:
                    items.append(self.feed.get_nowait())
                except asyncio.QueueEmpty:
                    break
            ops: list[Operation] = []
            # consecutive upserts go through the table's bulk scan path
            # (fresh rows compress into columnar AddVectorBlocks); a delete
            # is a run boundary so arrival order is preserved exactly
            run: list[tuple] = []  # (primary_key, values) upsert run

            def flush_run() -> None:
                if not run:
                    return
                try:
                    ops.extend(self.table.upsert_scan(self.index_key, run))
                except Exception:
                    logger.exception("monitor_items: failed to apply upsert run")
                run.clear()

            for row, marker in items:
                try:
                    if row.operation.kind == "upsert":
                        run.append((row.primary_key, row.operation.values))
                    else:
                        flush_run()
                        ops.extend(self._apply(row))
                except Exception:
                    logger.exception("monitor_items: failed to apply row")
                finally:
                    marker.complete(self.metrics, self.index_key)
            flush_run()
            if ops:
                self.index_actor.apply_operations(ops)
                self._count_ops(ops)
            # let the index actor's loop run between batches
            await asyncio.sleep(0)

    def _apply(self, row: DbIndexedRow) -> list[Operation]:
        if row.operation.kind == "upsert":
            return self.table.upsert(
                self.index_key, row.primary_key, row.operation.values
            )
        return self.table.delete(
            self.index_key, row.primary_key, row.operation.timestamp
        )

    def _count_ops(self, ops: list[Operation]) -> None:
        if self.metrics is None:
            return
        ins = upd = rem = 0
        for op in ops:
            if isinstance(op, AddVectorBlock):
                ins += len(op)  # bulk inserts are never updates
            elif isinstance(op, (AddVector, AddDocument)):
                if op.is_update:
                    upd += 1
                else:
                    ins += 1
            elif isinstance(op, RemoveValue):
                rem += 1
        ks, ix = self.index_key
        if ins:
            self.metrics.modified.with_labels(ks, ix, "insert").inc(ins)
        if upd:
            self.metrics.modified.with_labels(ks, ix, "update").inc(upd)
        if rem:
            self.metrics.modified.with_labels(ks, ix, "remove").inc(rem)
