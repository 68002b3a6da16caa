"""Serving adapters: the sharded engines behind the VsIndexActor protocol.

Counterpart of vector_store_tpu/parallel/serving.py. The factory picks the
index implementation per index (service/vs_index.py::make_engine); this
module gives it the sharded engines (parallel/ivf_sharded.py,
parallel/graph_sharded.py), turning their array results into the
per-query SearchResult lists the actor consumes and providing the
maintain() hook the actor runs in idle slots. Neither engine has
``search_begin``: the actor serves them on its non-pipelined path.

Freshness:
- ivf-sharded: every upsert is searchable at once (it lands in the
  sharded flat delta; builds recluster in idle slots once the delta grows).
- graph-sharded: upserts land in the device arrays at once AND in a host
  delta that search() ranks exactly until the next idle-slot build folds
  them into the per-shard graphs.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from vector_store_tpu_torch.core.types import Quantization, SpaceType
from vector_store_tpu_torch.engine.flat import SearchResult
from vector_store_tpu_torch.parallel.graph_sharded import ShardedGraphIndex
from vector_store_tpu_torch.parallel.ivf_sharded import ShardedIvfIndex
from vector_store_tpu_torch.parallel.sharded import Mesh

logger = logging.getLogger(__name__)


def _exact_subset_from_store(
    queries: np.ndarray,
    slots: np.ndarray,
    *,
    dimensions: int,
    space_type: SpaceType,
    get_row,
    get_epoch,
    rows_prenormalized: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact f32 distances from each query to the given slots only, over a
    host slot -> row store (dead slots come back +inf): the sharded
    engines' grouped-terminal hook (service/vs_index.py::_finish_terminal),
    one product for a whole filtered request group. Returns (distances
    [Q, m] f32, epochs [m] i32)."""
    qs = np.atleast_2d(np.asarray(queries, dtype=np.float32))[:, :dimensions]
    if space_type is SpaceType.COSINE:
        qs = qs / np.maximum(np.linalg.norm(qs, axis=1, keepdims=True), 1e-30)
    slots = np.asarray(slots, dtype=np.int64).reshape(-1)
    m = slots.size
    rows = np.zeros((m, dimensions), dtype=np.float32)
    live = np.zeros((m,), dtype=bool)
    epochs = np.full((m,), -1, dtype=np.int32)
    for i, s in enumerate(slots):
        v = get_row(int(s))
        if v is not None:
            rows[i] = v
            live[i] = True
            epochs[i] = get_epoch(int(s))
    if space_type is SpaceType.COSINE and not rows_prenormalized:
        rows = rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True), 1e-30)
    dot = qs @ rows.T  # (Q, m)
    if space_type is SpaceType.EUCLIDEAN:
        n2 = np.einsum("md,md->m", rows, rows)
        q2 = np.einsum("qd,qd->q", qs, qs)
        d = np.maximum(n2[None, :] - 2.0 * dot + q2[:, None], 0.0)
    else:  # cosine / dot product: 1 - dot (the device paths' convention)
        d = 1.0 - dot
        if space_type is SpaceType.COSINE:
            d = np.clip(d, 0.0, 2.0)
    d = np.where(live[None, :], d, np.inf)
    return d.astype(np.float32), epochs


def _exact_host_top_k(subset_fn, query, slots: np.ndarray, k: int) -> SearchResult:
    """search_exact_host through the engine's own search_exact_host_subset:
    rank the given slots exactly, return the top k live ones."""
    if slots.size == 0:
        z = np.zeros((0,))
        return SearchResult(slots=z.astype(np.int64), epochs=z.astype(np.int32), distances=z.astype(np.float32))
    q = np.asarray(query, dtype=np.float32).reshape(1, -1)
    dists, epochs = subset_fn(q, slots)
    order = np.argsort(dists[0], kind="stable")[:k]
    order = order[np.isfinite(dists[0][order])]
    return SearchResult(
        slots=slots[order].astype(np.int64),
        epochs=epochs[order].astype(np.int32),
        distances=dists[0][order].astype(np.float32),
    )


def _to_results(dist, slot, epoch, b_real: int) -> list[SearchResult]:
    """(dist [B, k], slot [B, k], epoch [B, k]) arrays -> per-query
    SearchResult lists with invalid (-1 / inf) lanes stripped."""
    out: list[SearchResult] = []
    for row in range(b_real):
        ok = (slot[row] >= 0) & np.isfinite(dist[row])
        out.append(
            SearchResult(
                slots=slot[row][ok].astype(np.int64),
                epochs=epoch[row][ok].astype(np.int32),
                distances=dist[row][ok].astype(np.float32),
            )
        )
    return out


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class ShardedIvfServingEngine:
    """ShardedIvfIndex behind the actor's engine protocol (global indexes
    only: the factory sends local indexes to the flat engine)."""

    def __init__(
        self,
        mesh: Mesh,
        dimensions: int,
        *,
        space_type: SpaceType = SpaceType.COSINE,
        quantization: Quantization = Quantization.BF16,
        nprobe: int = 32,
        min_build: int = 4096,
    ) -> None:
        self.mesh = mesh
        self.dimensions = dimensions
        self._idx = ShardedIvfIndex(
            mesh, dimensions, space_type=space_type, quantization=quantization, nprobe=nprobe
        )
        self.min_build = min_build
        self._pending = 0  # rows upserted since the last build
        # (rows, seconds) of every build, in order
        self.build_log: list[tuple[int, float]] = []

    @property
    def size(self) -> int:
        return self._idx.size

    @property
    def n_shards(self) -> int:
        return int(self.mesh.shape["model"]) * int(self.mesh.shape["data"])

    @property
    def device_bytes(self) -> int:
        idx = self._idx
        main = [] if idx.main_vecs is None else idx.main_vecs + idx.main_paux + idx.main_pos2slot + idx.centroids
        return _tensor_bytes(main + idx._delta.tensors())

    def _build(self, reserve: int = 0) -> None:
        t0 = time.perf_counter()
        self._idx.build(reserve)
        self._pending = 0
        self.build_log.append((self._idx.size, time.perf_counter() - t0))
        logger.info("sharded IVF build: %d rows, nlist %d, %.2f s", self._idx.size, self._idx.nlist, self.build_log[-1][1])

    def upsert_batch(self, slots, epochs, vectors, partitions=None) -> None:
        if partitions is not None and (np.asarray(partitions) >= 0).any():
            raise ValueError("sharded IVF engine serves global indexes only")
        n_new = int(np.asarray(slots).size)
        # the flat delta is bounded; recluster rather than overflow it
        if self._idx._delta_next + n_new > (self._idx._delta.capacity * 3) // 4:
            self._build(reserve=n_new)
        self._pending += n_new  # counted first: a reader sees the build due
        self._idx.upsert_batch(slots, epochs, vectors)

    def remove_batch(self, slots) -> None:
        self._idx.remove_batch(np.asarray(slots, dtype=np.int64))

    @property
    def maintenance_due(self) -> bool:
        """min_build rows are pending, or the delta is half full."""
        near_full = self._idx._delta_next >= self._idx._delta.capacity // 2
        return self._pending >= self.min_build or near_full

    def maintain(self, budget: int = 0) -> bool:
        """Recluster when maintenance is due; the actor calls it in idle
        slots."""
        if self.maintenance_due:
            self._build()
            return True
        return False

    def search(self, queries, k: int, partitions=None) -> list[SearchResult]:
        # no build from here: the actor may run two search batches at once,
        # and a build swaps the main region under the other's feet; the
        # delta's bound is kept at the one mutation site (upsert_batch),
        # and mutations never overlap searches in the actor
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        b = queries.shape[0]
        k = max(1, min(k, max(self.size, 1)))
        d, s, e = self._idx.search(queries, k)
        return _to_results(d, s, e, b)

    def search_exact_host(self, query, k: int) -> SearchResult:
        """Exact host ranking over every live row (the actor's terminal
        step for low-selectivity filters)."""
        slots = np.fromiter(self._idx._vecs_host.keys(), dtype=np.int64)
        return _exact_host_top_k(self.search_exact_host_subset, query, slots, k)

    def search_exact_host_subset(self, queries: np.ndarray, slots: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Grouped terminal for low-selectivity filters (one product a
        filter group; see _exact_subset_from_store)."""
        idx = self._idx
        return _exact_subset_from_store(
            queries,
            slots,
            dimensions=self.dimensions,
            space_type=idx.space_type,
            get_row=idx._vecs_host.get,
            get_epoch=lambda s: idx._epochs_host.get(s, -1),
            rows_prenormalized=True,  # upsert_batch normalizes for cosine
        )


class ShardedGraphServingEngine:
    """ShardedGraphIndex behind the actor's engine protocol. The host is
    the capacity tier (slot -> row); the sharded device graph is (re)built
    from it in idle slots, sized to the live slot range. Rows not yet in
    the per-shard graphs are ranked exactly on the host until the next
    build, so every upsert is searchable at once."""

    def __init__(
        self,
        mesh: Mesh,
        dimensions: int,
        *,
        space_type: SpaceType = SpaceType.COSINE,
        quantization: Quantization = Quantization.BF16,
        connectivity: int = 16,
        expansion_add: int = 64,
        expansion_search: int = 64,
        row_block: int = 512,
        min_build: int = 1024,
    ) -> None:
        self.mesh = mesh
        self.dimensions = dimensions
        self.space_type = space_type
        self.quantization = quantization
        self.connectivity = connectivity
        self.expansion_add = expansion_add
        self.expansion_search = expansion_search
        self.row_block = row_block
        self.min_build = min_build
        self._idx: ShardedGraphIndex | None = None
        # slot -> (f32 vector, epoch): every live row (capacity tier)
        self._store: dict[int, tuple[np.ndarray, int]] = {}
        # slots not yet reachable through the built per-shard graphs
        self._delta: set[int] = set()
        # (rows, seconds) of every build, in order
        self.build_log: list[tuple[int, float]] = []

    @property
    def size(self) -> int:
        return len(self._store)

    @property
    def n_shards(self) -> int:
        return int(self.mesh.shape["model"]) * int(self.mesh.shape["data"])

    @property
    def device_bytes(self) -> int:
        return 0 if self._idx is None else _tensor_bytes(self._idx.tensors())

    def upsert_batch(self, slots, epochs, vectors, partitions=None) -> None:
        if partitions is not None and (np.asarray(partitions) >= 0).any():
            raise ValueError("sharded graph engine serves global indexes only")
        slots = np.asarray(slots, dtype=np.int64)
        epochs = np.asarray(epochs, dtype=np.int32)
        vectors = np.asarray(vectors, dtype=np.float32)
        for i, s in enumerate(slots):
            s = int(s)
            self._store[s] = (vectors[i], int(epochs[i]))
            self._delta.add(s)
        if self._idx is not None and slots.size:
            fits = slots < self._idx.capacity
            if fits.any():
                # rows land in the device arrays now (searchable through
                # the host delta until the next build wires their edges);
                # slots past the capacity wait for the next build's resize
                self._idx.load_rows(slots[fits], epochs[fits], vectors[fits])

    def remove_batch(self, slots) -> None:
        slots = np.asarray(slots, dtype=np.int64)
        for s in slots:
            self._store.pop(int(s), None)
            self._delta.discard(int(s))
        if self._idx is not None:
            keep = slots[(slots >= 0) & (slots < self._idx.capacity)]
            if keep.size:
                # the beam skips dead nodes in its results; edges rebuild
                # at the next build
                self._idx.invalidate(keep)

    @property
    def maintenance_due(self) -> bool:
        """Rows wait for the graphs: any before the first build, then
        min_build of them."""
        return bool(self._delta) and (self._idx is None or len(self._delta) >= self.min_build)

    def maintain(self, budget: int = 0) -> bool:
        """(Re)build the per-shard graphs from the host store when
        maintenance is due; the actor calls it in idle slots."""
        if self.maintenance_due:
            self._build()
            return True
        return False

    def _build(self) -> None:
        if not self._store:
            return
        t0 = time.perf_counter()
        model = int(self.mesh.shape["model"])
        need = max(self._store.keys()) + 1
        align = model * self.row_block
        cap = -(-need // align) * align
        if self._idx is None or self._idx.capacity < cap:
            self._idx = ShardedGraphIndex(
                self.mesh,
                self.dimensions,
                space_type=self.space_type,
                quantization=self.quantization,
                capacity=cap,
                connectivity=self.connectivity,
                expansion_add=self.expansion_add,
                expansion_search=self.expansion_search,
                row_block=self.row_block,
            )
            slots = np.fromiter(self._store.keys(), dtype=np.int64)
            self._idx.load_rows(
                slots,
                np.asarray([self._store[int(s)][1] for s in slots], np.int32),
                np.stack([self._store[int(s)][0] for s in slots]),
            )
        self._idx.build()
        self._delta.clear()
        self.build_log.append((len(self._store), time.perf_counter() - t0))
        logger.info("sharded graph build: %d rows over %d shards, %.2f s", len(self._store), self.n_shards,
                    self.build_log[-1][1])

    def search(self, queries, k: int, partitions=None) -> list[SearchResult]:
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        b = queries.shape[0]
        k = max(1, min(k, max(self.size, 1)))
        main = None
        if self._idx is not None:
            d, s, e = self._idx.search(queries, k)
            main = (d, s.astype(np.int64), e)
        delta = self._delta_exact(queries, k)
        if main is None and delta is None:
            z = np.zeros((b, 0))
            return _to_results(z, z.astype(np.int64), z.astype(np.int32), b)
        if delta is None:
            d, s, e = main
        elif main is None:
            d, s, e = delta
        else:
            # a slot re-upserted after a build is in both: the delta copy is
            # newer, so the main lane goes
            md, ms, me = main
            dd, ds, de = delta
            md = np.where(np.isin(ms, ds[ds >= 0]), np.inf, md)
            d = np.concatenate([md, dd], axis=1)
            s = np.concatenate([ms, ds], axis=1)
            e = np.concatenate([me, de], axis=1)
        d = np.where(s >= 0, d, np.inf)
        sel = np.argsort(d, axis=1, kind="stable")[:, :k]
        d = np.take_along_axis(d, sel, axis=1)
        s = np.take_along_axis(s, sel, axis=1)
        e = np.take_along_axis(e, sel, axis=1)
        s = np.where(np.isfinite(d), s, -1)
        return _to_results(d, s, e, b)

    def search_exact_host(self, query, k: int) -> SearchResult:
        """Exact host ranking over every live row (the terminal step for
        low-selectivity filters). Read-only: a concurrent search batch must
        never see a mutated delta set."""
        slots = np.fromiter(self._store.keys(), dtype=np.int64)
        return _exact_host_top_k(self.search_exact_host_subset, query, slots, k)

    def search_exact_host_subset(self, queries: np.ndarray, slots: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Grouped terminal for low-selectivity filters (one product a
        filter group; see _exact_subset_from_store)."""
        store = self._store
        return _exact_subset_from_store(
            queries,
            slots,
            dimensions=self.dimensions,
            space_type=self.space_type,
            get_row=lambda s: store[s][0] if s in store else None,
            get_epoch=lambda s: store[s][1] if s in store else -1,
            rows_prenormalized=False,  # the store keeps raw f32 rows
        )

    def _delta_exact(self, queries: np.ndarray, k: int):
        """Exact host scan over the rows not yet built into the graphs
        (at most min_build + one modify batch after the first build)."""
        if not self._delta:
            return None
        slots = np.fromiter(self._delta, dtype=np.int64)
        rows = np.stack([self._store[int(s)][0] for s in slots])
        eps = np.asarray([self._store[int(s)][1] for s in slots], np.int32)
        if self.space_type is SpaceType.COSINE:
            qn = queries / np.maximum(np.linalg.norm(queries, axis=-1, keepdims=True), 1e-30)
            rn = rows / np.maximum(np.linalg.norm(rows, axis=-1, keepdims=True), 1e-30)
            dist = 1.0 - qn @ rn.T
        elif self.space_type is SpaceType.EUCLIDEAN:
            dist = (queries**2).sum(-1)[:, None] + (rows**2).sum(-1)[None, :] - 2.0 * queries @ rows.T
            dist = np.maximum(dist, 0.0)
        else:  # dot product: 1 - dot (graph_sharded.py's pair convention)
            dist = 1.0 - queries @ rows.T
        kk = min(k, slots.size)
        sel = np.argsort(dist, axis=1, kind="stable")[:, :kk]
        return np.take_along_axis(dist, sel, axis=1).astype(np.float32), slots[sel], eps[sel]
