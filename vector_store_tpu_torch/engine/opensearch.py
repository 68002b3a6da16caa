"""Remote OpenSearch engine (parity with reference vs_index/opensearch.rs):
when VECTOR_STORE_OPENSEARCH_URI is set, indexes live in a remote OpenSearch
cluster (knn_vector/hnsw mapping) instead of the local device. Synchronous
HTTP (requests) — engine calls already run on worker threads.
"""

from __future__ import annotations

import json
import logging

import numpy as np

from vector_store_tpu_torch.core.types import Quantization, SpaceType
from vector_store_tpu_torch.engine.flat import SearchResult

logger = logging.getLogger(__name__)

_SPACE_MAP = {
    SpaceType.EUCLIDEAN: "l2",
    SpaceType.COSINE: "cosinesimil",
    SpaceType.DOT_PRODUCT: "innerproduct",
    SpaceType.HAMMING: "hamming",
}


class OpenSearchIndex:
    """Engine surface compatible with what VsIndexActor drives."""

    def __init__(
        self,
        base_url: str,
        index_name: str,
        dimensions: int,
        space_type: SpaceType = SpaceType.COSINE,
        quantization: Quantization = Quantization.F32,
        connectivity: int = 16,
        expansion_add: int = 128,
        expansion_search: int = 64,
        session: requests.Session | None = None,
        **_: object,
    ) -> None:
        import requests  # where a session opens: importing the port needs no requests
        self.base_url = base_url.rstrip("/")
        self.index_name = index_name.lower()
        self.dimensions = dimensions
        self.space_type = space_type
        self.quantization = quantization
        self.http = session or requests.Session()
        self._size = 0

        mapping = {
            "settings": {"index": {"knn": True}},
            "mappings": {
                "properties": {
                    "emb": {
                        "type": "knn_vector",
                        "dimension": dimensions,
                        "method": {
                            "name": "hnsw",
                            "space_type": _SPACE_MAP[space_type],
                            "engine": "faiss",
                            "parameters": {
                                "m": connectivity,
                                "ef_construction": expansion_add,
                                "ef_search": expansion_search,
                            },
                        },
                    },
                    "epoch": {"type": "integer"},
                    "part": {"type": "integer"},
                }
            },
        }
        resp = self.http.put(f"{self.base_url}/{self.index_name}", json=mapping)
        if resp.status_code not in (200, 400):  # 400 = already exists
            resp.raise_for_status()

    @property
    def size(self) -> int:
        import requests
        try:
            resp = self.http.get(f"{self.base_url}/{self.index_name}/_count")
            resp.raise_for_status()
            return int(resp.json().get("count", 0))
        except requests.RequestException:
            return self._size

    @property
    def capacity(self) -> int:
        return self.size

    def upsert_batch(self, slots, epochs, vectors, partitions=None) -> None:
        lines = []
        slots = np.asarray(slots)
        for i, s in enumerate(slots.tolist()):
            lines.append(json.dumps({"index": {"_index": self.index_name, "_id": str(s)}}))
            doc = {
                "emb": np.asarray(vectors[i], dtype=np.float32).tolist(),
                "epoch": int(np.asarray(epochs)[i]),
            }
            if partitions is not None:
                doc["part"] = int(np.asarray(partitions)[i])
            lines.append(json.dumps(doc))
        if not lines:
            return
        resp = self.http.post(
            f"{self.base_url}/_bulk",
            data="\n".join(lines) + "\n",
            headers={"Content-Type": "application/x-ndjson"},
        )
        resp.raise_for_status()
        self._size += slots.size

    def remove_batch(self, slots) -> None:
        lines = [
            json.dumps({"delete": {"_index": self.index_name, "_id": str(s)}})
            for s in np.asarray(slots).tolist()
        ]
        if not lines:
            return
        resp = self.http.post(
            f"{self.base_url}/_bulk",
            data="\n".join(lines) + "\n",
            headers={"Content-Type": "application/x-ndjson"},
        )
        resp.raise_for_status()

    def search(self, queries, k, partitions=None, allow_mask=None):
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        results = []
        for row in range(queries.shape[0]):
            body = {
                "size": k,
                "query": {"knn": {"emb": {"vector": queries[row].tolist(), "k": k}}},
            }
            if partitions is not None and partitions[row] >= 0:
                body["query"] = {
                    "bool": {
                        "must": [body["query"]],
                        "filter": [{"term": {"part": int(partitions[row])}}],
                    }
                }
            resp = self.http.post(
                f"{self.base_url}/{self.index_name}/_search", json=body
            )
            resp.raise_for_status()
            hits = resp.json().get("hits", {}).get("hits", [])
            slots_, epochs_, dists = [], [], []
            for h in hits:
                slot = int(h["_id"])
                if allow_mask is not None and (
                    slot >= len(allow_mask) or not allow_mask[slot]
                ):
                    continue
                slots_.append(slot)
                epochs_.append(int(h.get("_source", {}).get("epoch", 0)))
                dists.append(self._score_to_distance(float(h.get("_score", 0.0))))
            results.append(
                SearchResult(
                    slots=np.asarray(slots_, dtype=np.int64),
                    epochs=np.asarray(epochs_, dtype=np.int32),
                    distances=np.asarray(dists, dtype=np.float32),
                )
            )
        return results

    def _score_to_distance(self, score: float) -> float:
        """OpenSearch kNN scores: l2 -> 1/(1+d); cosinesimil -> (2-d)/2;
        innerproduct -> variants. Invert to the engine's distance."""
        st = self.space_type
        if st is SpaceType.EUCLIDEAN:
            return max(0.0, 1.0 / max(score, 1e-30) - 1.0)
        if st in (SpaceType.COSINE, SpaceType.DOT_PRODUCT):
            return 2.0 - 2.0 * score
        return max(0.0, 1.0 / max(score, 1e-30) - 1.0)
