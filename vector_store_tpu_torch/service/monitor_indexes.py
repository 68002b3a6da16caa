"""Index discovery actor (reference monitor_indexes.rs): periodically
compares the DB's schema version, diffs the discovered custom indexes
against the running set, and drives engine.add_index / del_index.
"""

from __future__ import annotations

import asyncio
import logging

from vector_store_tpu_torch.core.types import (
    DbCustomIndex,
    DbIndexKind,
    IndexMetadata,
    IndexOptionsFts,
    IndexOptionsVs,
    IndexVersion,
)
from vector_store_tpu_torch.core.types import Dimensions
from vector_store_tpu_torch.db import Db
from vector_store_tpu_torch.service.engine import Engine
from vector_store_tpu_torch.service.node_state import NodeState

logger = logging.getLogger(__name__)

DEFAULT_INTERVAL = 1.0


class MonitorIndexes:
    def __init__(
        self,
        db: Db,
        engine: Engine,
        node_state: NodeState,
        interval: float = DEFAULT_INTERVAL,
        alter_index_simulator: bool = False,
    ) -> None:
        self.db = db
        self.engine = engine
        self.node_state = node_state
        self.interval = interval
        # simulates missing ALTER INDEX support: keep serving the old index
        # when parameters change, skip version checks (monitor_indexes.rs
        # alter_index_simulator mode)
        self.alter_index_simulator = alter_index_simulator
        self._schema_version = None
        self._known: dict = {}  # IndexKey -> IndexMetadata
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
            # re-announced each tick: a no-op once past the state, but it
            # lets a late DB connection (auth granted, cluster reachable)
            # move CONNECTING_TO_DB -> DISCOVERING_INDEXES
            self.node_state.discovering_indexes()
            try:
                await self.tick()
            except Exception:
                logger.exception("monitor_indexes tick failed")
                self._schema_version = None  # retry discovery next tick
            await asyncio.sleep(self.interval)

    async def tick(self) -> None:
        version = await self.db.latest_schema_version()
        if version is None or version == self._schema_version:
            return
        discovered = await self._discover()
        self.node_state.indexes_discovered(set(discovered.values()))

        # removals first
        for key in list(self._known):
            if key not in discovered:
                if self.alter_index_simulator:
                    continue
                await self.engine.del_index(key)
                del self._known[key]
            elif discovered[key] != self._known[key]:
                if self.alter_index_simulator and discovered[
                    key
                ].discard_version() == self._known[key].discard_version():
                    # only the version changed: keep the running index
                    self._known[key] = discovered[key]
                    continue
                if self.alter_index_simulator:
                    continue
                await self.engine.del_index(key)
                del self._known[key]
        # additions
        failed = False
        for key, metadata in discovered.items():
            if key not in self._known:
                try:
                    await self.engine.add_index(metadata)
                    self._known[key] = metadata
                except Exception:
                    logger.exception("add_index failed for %s", key)
                    failed = True
        if failed:
            # reset so discovery retries (monitor_indexes.rs:130-134)
            self._schema_version = None
        else:
            self._schema_version = version

    async def _discover(self) -> dict:
        out = {}
        for custom in await self.db.get_indexes():
            # one poisoned index (bad options, invalid params) must not take
            # down the whole discovery tick for its siblings — the reference
            # validates per index and skips (db.rs get_index_* returning None)
            try:
                metadata = await self._resolve(custom)
            except Exception:
                logger.exception("skipping undiscoverable index %s", custom.key)
                continue
            if metadata is not None:
                out[metadata.key] = metadata
        return out

    async def _resolve(self, custom: DbCustomIndex) -> IndexMetadata | None:
        key = custom.key
        if not await self.db.is_valid_index(key):
            return None
        version = await self.db.get_index_version(key)
        if version is None:
            version = IndexVersion.nil()
        if custom.kind is DbIndexKind.FULL_TEXT_SEARCH:
            return IndexMetadata(
                keyspace_name=custom.keyspace,
                index_name=custom.index,
                table_name=custom.table,
                primary_key_columns=custom.primary_key_columns,
                partition_key_count=custom.partition_key_count,
                target_columns=custom.target_columns,
                partitioning=custom.partitioning,
                filtering_columns=custom.filtering_columns,
                version=version,
                fts_options=IndexOptionsFts(),
            )
        dims = await self.db.get_index_target_dimensions(key)
        if dims is None:
            logger.debug("index %s target is not a vector column; skipping", key)
            return None
        params = await self.db.get_index_params(key)
        vs = IndexOptionsVs(dimensions=Dimensions(dims), **{
            k: v
            for k, v in params.items()
            if k in (
                "connectivity",
                "expansion_add",
                "expansion_search",
                "space_type",
                "quantization",
                "oversampling",
                "rescoring",
            )
        })
        return IndexMetadata(
            keyspace_name=custom.keyspace,
            index_name=custom.index,
            table_name=custom.table,
            primary_key_columns=custom.primary_key_columns,
            partition_key_count=custom.partition_key_count,
            target_columns=custom.target_columns,
            partitioning=custom.partitioning,
            filtering_columns=custom.filtering_columns,
            version=version,
            vs_options=vs,
        )
