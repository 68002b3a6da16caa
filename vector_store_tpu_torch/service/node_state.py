"""Node and index status state machine (reference node_state.rs:20-227).

Node: Initializing -> ConnectingToDb -> DiscoveringIndexes ->
IndexingEmbeddings -> Serving. The node becomes Serving once every index of
the INITIAL discovered set has finished its full scan (indexes added later
do not hold the node back).

Single-threaded asyncio: plain method calls, no queue needed.
"""

from __future__ import annotations

import enum
import logging

from vector_store_tpu_torch.core.types import IndexKey, IndexMetadata

logger = logging.getLogger(__name__)


class NodeStatus(enum.Enum):
    INITIALIZING = "INITIALIZING"
    CONNECTING_TO_DB = "CONNECTING_TO_DB"
    DISCOVERING_INDEXES = "DISCOVERING_INDEXES"
    INDEXING_EMBEDDINGS = "INDEXING_EMBEDDINGS"
    SERVING = "SERVING"


class IndexStatus(enum.Enum):
    INITIALIZING = "INITIALIZING"
    FULL_SCANNING = "FULL_SCANNING"
    SERVING = "SERVING"


# HTTP surface statuses (httpapi lib.rs:130-140, 295-307): both node
# DiscoveringIndexes/IndexingEmbeddings and index FullScanning map to
# BOOTSTRAPPING.
def node_status_http(s: NodeStatus) -> str:
    return {
        NodeStatus.INITIALIZING: "INITIALIZING",
        NodeStatus.CONNECTING_TO_DB: "CONNECTING_TO_DB",
        NodeStatus.DISCOVERING_INDEXES: "BOOTSTRAPPING",
        NodeStatus.INDEXING_EMBEDDINGS: "BOOTSTRAPPING",
        NodeStatus.SERVING: "SERVING",
    }[s]


def index_status_http(s: IndexStatus) -> str:
    return {
        IndexStatus.INITIALIZING: "INITIALIZING",
        IndexStatus.FULL_SCANNING: "BOOTSTRAPPING",
        IndexStatus.SERVING: "SERVING",
    }[s]


class NodeState:
    def __init__(self) -> None:
        self.status = NodeStatus.INITIALIZING
        self._initial: set[IndexMetadata] | None = None
        self._indexes: dict[IndexKey, IndexStatus] = {}

    # -- events (node_state.rs Event enum) -----------------------------------

    def connecting_to_db(self) -> None:
        self._db_connected = False
        self.status = NodeStatus.CONNECTING_TO_DB

    def connected_to_db(self) -> None:
        self._db_connected = True

    def discovering_indexes(self) -> None:
        # the node must not advance past CONNECTING_TO_DB while the DB
        # session has never connected (auth failure / unreachable cluster
        # keep it there — node_state.rs transition order, validator
        # auth.rs asserts exactly this)
        if not getattr(self, "_db_connected", True):
            return
        if self.status in (NodeStatus.INITIALIZING, NodeStatus.CONNECTING_TO_DB):
            if self._initial is not None:
                if not self._initial:
                    self.status = NodeStatus.SERVING
                else:
                    self.status = NodeStatus.INDEXING_EMBEDDINGS
            else:
                self.status = NodeStatus.DISCOVERING_INDEXES

    def indexes_discovered(self, indexes: set[IndexMetadata]) -> None:
        initial = False
        if self._initial is None:
            initial = True
            self._initial = set(indexes)

        keys = {m.key for m in indexes}
        self._indexes = {
            k: s for k, s in self._indexes.items() if k in keys
        }
        for k in keys:
            self._indexes.setdefault(k, IndexStatus.INITIALIZING)

        self._initial = {
            m for m in self._initial if m.key in self._indexes and m in indexes
        }
        if not self._initial:
            if self.status is not NodeStatus.SERVING:
                self.status = NodeStatus.SERVING
                logger.info(
                    "Service is running, no %sinitial indexes to build",
                    "" if initial else "more ",
                )
            return
        self.status = NodeStatus.INDEXING_EMBEDDINGS

    def full_scan_started(self, metadata: IndexMetadata) -> None:
        if metadata.key in self._indexes:
            self._indexes[metadata.key] = IndexStatus.FULL_SCANNING

    def full_scan_finished(self, metadata: IndexMetadata) -> None:
        if metadata.key in self._indexes:
            self._indexes[metadata.key] = IndexStatus.SERVING
        if self._initial is None:
            logger.error(
                "Received FullScanFinished for %s but initial set is None",
                metadata.key,
            )
            return
        self._initial.discard(metadata)
        if not self._initial and self.status is not NodeStatus.SERVING:
            self.status = NodeStatus.SERVING
            logger.info("Service is running, finished building initial indexes")

    # -- queries ---------------------------------------------------------------

    def get_status(self) -> NodeStatus:
        return self.status

    def get_index_status(self, keyspace: str, index: str) -> IndexStatus | None:
        return self._indexes.get(IndexKey(keyspace, index))
