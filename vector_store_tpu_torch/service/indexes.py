"""Index registry + ANN query routing (reference indexes.rs).

Indexes over the same (keyspace, table, target column) form a routing group;
an ANN request addressed to one index may be served by any serving group
member. Candidates are scored by NeedsFiltering — how many restriction
columns the index does NOT cover (fewer is better; a local index whose
partition columns are all equality-restricted covers them) — with ties
broken by the newest IndexVersion (indexes.rs:203-238, 373-431).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

from vector_store_tpu_torch.core.types import (
    ColumnName,
    IndexKey,
    IndexMetadata,
    IndexVersion,
    Progress,
)
from vector_store_tpu_torch.service.node_state import IndexStatus


@dataclass(frozen=True)
class RoutingGroupKey:
    keyspace: str
    table: str
    columns: tuple[ColumnName, ...]

    @staticmethod
    def of(metadata: IndexMetadata) -> "RoutingGroupKey":
        return RoutingGroupKey(
            metadata.keyspace_name, metadata.table_name, metadata.target_columns
        )


@dataclass
class VsIndexEntry:
    actor: object  # VsIndexActor
    monitor: object  # MonitorItems
    db_index: object  # ingestion feed handle (FakeDbIndex / DbIndex)
    metadata: IndexMetadata
    status: IndexStatus = IndexStatus.INITIALIZING
    progress: Progress = field(default_factory=Progress)
    # base-table column -> CQL type string, for typed filter conversion
    table_columns: dict = field(default_factory=dict)

    @property
    def routing_group(self) -> RoutingGroupKey:
        return RoutingGroupKey.of(self.metadata)

    def score(
        self,
        equality_columns: list[ColumnName],
        range_columns: list[ColumnName],
    ) -> Optional[int]:
        """Returns the number of uncovered restriction columns, or None when
        this index cannot serve the query (indexes.rs:score_index). The
        coverable set = primary key columns + non-pk partition columns +
        declared filtering columns (VsIndexEntry::new, indexes.rs:162-169)."""
        md = self.metadata
        filtering = (
            set(md.primary_key_columns)
            | set(md.nonpk_partition_key_columns())
            | set(md.filtering_columns)
        )
        if not all(c in filtering for c in list(equality_columns) + list(range_columns)):
            return None
        if md.partitioning.is_global:
            return len(equality_columns) + len(range_columns)
        pk_cols = md.partitioning.local_columns or ()
        if not all(c in equality_columns for c in pk_cols):
            return None
        return len(equality_columns) - len(pk_cols) + len(range_columns)


@dataclass
class FtsIndexEntry:
    actor: object
    monitor: object
    db_index: object
    metadata: IndexMetadata
    status: IndexStatus = IndexStatus.INITIALIZING
    progress: Progress = field(default_factory=Progress)


class BestIndexKind(enum.Enum):
    NOT_FOUND = "not_found"
    NOT_SERVING = "not_serving"
    NO_GLOBAL_INDEX = "no_global_index"
    SERVING = "serving"


@dataclass
class BestIndex:
    kind: BestIndexKind
    key: IndexKey | None = None
    entry: VsIndexEntry | None = None
    needs_filtering: int = 0
    progress: Progress | None = None


class Indexes:
    def __init__(self) -> None:
        self.vs_entries: dict[IndexKey, VsIndexEntry] = {}
        self.vs_routing: dict[RoutingGroupKey, list[IndexKey]] = {}
        self.fts_entries: dict[IndexKey, FtsIndexEntry] = {}

    # -- registration ---------------------------------------------------------

    def insert_vs(self, key: IndexKey, entry: VsIndexEntry) -> None:
        self.vs_entries[key] = entry
        self.vs_routing.setdefault(entry.routing_group, [])
        if key not in self.vs_routing[entry.routing_group]:
            self.vs_routing[entry.routing_group].append(key)

    def insert_fts(self, key: IndexKey, entry: FtsIndexEntry) -> None:
        self.fts_entries[key] = entry

    def remove(self, key: IndexKey) -> VsIndexEntry | FtsIndexEntry | None:
        entry = self.vs_entries.pop(key, None)
        if entry is not None:
            group = self.vs_routing.get(entry.routing_group)
            if group and key in group:
                group.remove(key)
                if not group:
                    del self.vs_routing[entry.routing_group]
            return entry
        return self.fts_entries.pop(key, None)

    def get_vs(self, key: IndexKey) -> VsIndexEntry | None:
        return self.vs_entries.get(key)

    def get_fts(self, key: IndexKey) -> FtsIndexEntry | None:
        return self.fts_entries.get(key)

    def keys(self) -> set[IndexKey]:
        return set(self.vs_entries) | set(self.fts_entries)

    # -- routing ---------------------------------------------------------------

    def best_index(
        self,
        key: IndexKey,
        equality_columns: list[ColumnName],
        range_columns: list[ColumnName],
    ) -> BestIndex:
        requested = self.vs_entries.get(key)
        if requested is None:
            return BestIndex(BestIndexKind.NOT_FOUND)
        candidates = self.vs_routing.get(requested.routing_group, [])

        best: tuple[int, IndexVersion, IndexKey, VsIndexEntry] | None = None
        has_serving = False
        for ckey in candidates:
            entry = self.vs_entries.get(ckey)
            if entry is None or entry.status is not IndexStatus.SERVING:
                continue
            has_serving = True
            score = entry.score(equality_columns, range_columns)
            if score is None:
                continue
            cand = (score, entry.metadata.version, ckey, entry)
            if best is None:
                best = cand
            else:
                # lower score wins; tie-break by newest version
                if score < best[0] or (
                    score == best[0] and cand[1] > best[1]
                ):
                    best = cand
        if best is not None:
            score, _, bkey, bentry = best
            return BestIndex(
                BestIndexKind.SERVING,
                key=bkey,
                entry=bentry,
                needs_filtering=score,
            )
        if has_serving:
            return BestIndex(BestIndexKind.NO_GLOBAL_INDEX)
        return BestIndex(BestIndexKind.NOT_SERVING, progress=requested.progress)
