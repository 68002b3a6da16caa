"""FTS index actor (reference fts_index/): applies AddDocument/Remove
operations into the inverted index with commit batching, serves BM25
searches, and reports stats. Uncommitted docs keep in-progress guards so an
index only reaches SERVING once its scan data is searchable
(tantivy.rs:80-119).
"""

from __future__ import annotations

import asyncio
import logging

from vector_store_tpu_torch.core.ids import PartitionId, PrimaryId
from vector_store_tpu_torch.core.keys import PrimaryKey
from vector_store_tpu_torch.core.types import IndexMetadata
from vector_store_tpu_torch.fts import COMMIT_DOCS, COMMIT_INTERVAL, InvertedIndex
from vector_store_tpu_torch.table import (
    AddDocument,
    AddVector,
    AddVectorBlock,
    Operation,
    RemoveBeforeAddValue,
    RemoveValue,
    Table,
)

logger = logging.getLogger(__name__)


class FtsIndexActor:
    def __init__(self, metadata: IndexMetadata, table: Table, metrics=None) -> None:
        self.metadata = metadata
        self.table = table
        self.metrics = metrics
        # native C++ core when the toolchain allows, python fallback else
        from vector_store_tpu_torch.fts.native import make_inverted_index

        self.index = make_inverted_index()
        # slot -> epoch of the indexed doc (stale hits rejected like VS)
        self._epochs: dict[int, int] = {}
        self._task: asyncio.Task | None = None
        self._stopped = False

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._commit_loop())

    async def stop(self) -> None:
        self._stopped = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass

    async def _commit_loop(self) -> None:
        while not self._stopped:
            await asyncio.sleep(COMMIT_INTERVAL)
            self._maybe_commit(force=True)

    def _maybe_commit(self, force: bool = False) -> None:
        if self.index.uncommitted and (force or self.index.uncommitted >= COMMIT_DOCS):
            n = self.index.commit()
            logger.debug("fts commit of %d docs for %s", n, self.metadata.key)
            if self.metrics is not None:
                ks, ix = self.metadata.key
                self.metrics.fts_index_size_bytes.with_labels(ks, ix).set(
                    self.index.size_bytes()
                )
                self.metrics.fts_segment_count.with_labels(ks, ix).set(1)

    # -- pipeline interface -----------------------------------------------------

    def apply_operations(self, ops: list[Operation]) -> None:
        for op in ops:
            if isinstance(op, AddDocument):
                self.index.add_document(op.primary_id.slot, op.document)
                self._epochs[op.primary_id.slot] = op.primary_id.epoch
            elif isinstance(op, (RemoveValue,)):
                self.index.delete_document(op.primary_id.slot)
                self._epochs.pop(op.primary_id.slot, None)
            elif isinstance(op, RemoveBeforeAddValue):
                continue  # the following AddDocument replaces in place
            elif isinstance(op, (AddVector, AddVectorBlock)):
                logger.warning("vector op sent to an FTS index; ignoring")
        if self.index.uncommitted >= COMMIT_DOCS:
            self._maybe_commit(force=True)

    @property
    def has_uncommitted(self) -> bool:
        return self.index.uncommitted > 0

    # -- queries ---------------------------------------------------------------

    async def count(self) -> int:
        return self.index.num_docs

    async def search(self, query: str, limit: int) -> tuple[list[PrimaryKey], list[float]]:
        self._maybe_commit(force=True)  # serve-fresh: flush pending
        pid = PartitionId.global_for(self.table.index_id(self.metadata.key))
        keys: list[PrimaryKey] = []
        scores: list[float] = []
        for slot, score in self.index.search(query, limit):
            epoch = self._epochs.get(slot)
            if epoch is None:
                continue
            pk = self.table.primary_key(pid, PrimaryId.new(slot, epoch))
            if pk is None:
                continue
            keys.append(pk)
            scores.append(score)
        return keys, scores

    @property
    def size(self) -> int:
        return self.index.num_docs
