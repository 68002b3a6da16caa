"""Simulator index engine (reference usearch_simulator, usearch.rs:253-438):
an exact host-side engine with configurable artificial delays for
search / add+remove / reserve, so pipeline and control-plane behavior can be
tested without a device. Enabled by VECTOR_STORE_USEARCH_SIMULATOR
("search:add-remove:reserve" durations, e.g. "5ms:1ms:100ms")."""

from __future__ import annotations

import time

import numpy as np

from vector_store_tpu_torch.core.types import Quantization, SpaceType
from vector_store_tpu_torch.engine.flat import SearchResult
from vector_store_tpu_torch.ops.distance import effective_space


def parse_delays(spec: str) -> tuple[float, float, float]:
    from vector_store_tpu_torch.service.config import parse_duration

    parts = spec.split(":")
    if len(parts) != 3:
        raise ValueError("simulator spec must be 'search:add-remove:reserve'")
    return tuple(parse_duration(p) for p in parts)  # type: ignore[return-value]


class SimulatorIndex:
    """Exact numpy engine with spin-wait delays. API mirrors
    FlatDeviceIndex's subset the actor uses."""

    def __init__(
        self,
        dimensions: int,
        space_type: SpaceType = SpaceType.COSINE,
        quantization: Quantization = Quantization.F32,
        delays: tuple[float, float, float] = (0.0, 0.0, 0.0),
        **_: object,
    ) -> None:
        self.dimensions = dimensions
        self.space_type = space_type
        self.quantization = quantization
        self.search_delay, self.modify_delay, self.reserve_delay = delays
        self._vectors: dict[int, np.ndarray] = {}
        self._epochs: dict[int, int] = {}
        self._parts: dict[int, int] = {}
        self._reserved = 0

    @staticmethod
    def _spin(seconds: float) -> None:
        if seconds <= 0:
            return
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            pass

    @property
    def size(self) -> int:
        return len(self._vectors)

    @property
    def capacity(self) -> int:
        return max(self._reserved, len(self._vectors))

    def upsert_batch(self, slots, epochs, vectors, partitions=None) -> None:
        slots = np.asarray(slots)
        if slots.size and int(slots.max()) >= self._reserved:
            self._spin(self.reserve_delay)
            self._reserved = int(slots.max()) + 1024
        self._spin(self.modify_delay)
        for i, s in enumerate(slots.tolist()):
            self._vectors[s] = np.asarray(vectors[i], dtype=np.float32)
            self._epochs[s] = int(np.asarray(epochs)[i])
            if partitions is not None:
                self._parts[s] = int(np.asarray(partitions)[i])

    def remove_batch(self, slots) -> None:
        self._spin(self.modify_delay)
        for s in np.asarray(slots).tolist():
            self._vectors.pop(s, None)
            self._epochs.pop(s, None)
            self._parts.pop(s, None)

    def search(self, queries, k, partitions=None, allow_mask=None):
        self._spin(self.search_delay)
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        results = []
        space = effective_space(self.space_type, self.quantization)
        items = list(self._vectors.items())
        if not items:
            return [
                SearchResult(
                    slots=np.empty(0, np.int64),
                    epochs=np.empty(0, np.int32),
                    distances=np.empty(0, np.float32),
                )
                for _ in range(queries.shape[0])
            ]
        slots = np.asarray([s for s, _ in items], dtype=np.int64)
        mat = np.stack([v for _, v in items])
        for row in range(queries.shape[0]):
            q = queries[row]
            if space is SpaceType.EUCLIDEAN:
                d = ((mat - q) ** 2).sum(-1)
            elif space is SpaceType.DOT_PRODUCT:
                d = 1.0 - mat @ q
            elif space is SpaceType.COSINE:
                qn = np.linalg.norm(q) or 1e-30
                vn = np.linalg.norm(mat, axis=-1)
                d = 1.0 - (mat @ q) / np.maximum(qn * vn, 1e-30)
            else:  # hamming over sign bits
                d = ((mat > 0) != (q > 0)).sum(-1).astype(np.float32)
            keep = np.ones(len(items), dtype=bool)
            if partitions is not None and partitions[row] >= 0:
                keep &= np.asarray(
                    [self._parts.get(int(s), -1) == int(partitions[row]) for s in slots]
                )
            if allow_mask is not None:
                keep &= np.asarray(
                    [bool(allow_mask[s]) if s < len(allow_mask) else False for s in slots]
                )
            d = np.where(keep, d, np.inf)
            order = np.argsort(d, kind="stable")[:k]
            order = order[np.isfinite(d[order])]
            results.append(
                SearchResult(
                    slots=slots[order],
                    epochs=np.asarray(
                        [self._epochs[int(s)] for s in slots[order]], dtype=np.int32
                    ),
                    distances=d[order].astype(np.float32),
                )
            )
        return results
