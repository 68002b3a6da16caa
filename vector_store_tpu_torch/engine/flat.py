"""Exact (brute-force) device-resident vector index.

Counterpart of vector_store_tpu/engine/flat.py for global float indexes
(F32/F16/BF16). It serves small indexes and is the IVF engine's delta
region. Device state, slot-indexed like the reference's PrimaryId slots:

- vectors [cap, Dp]  storage dtype
- a, b    [cap] f32  rank coefficients of the fused scan (b = INVALID_BIAS
                     for never-written or removed slots)

Validity, epochs and an f32 copy of every stored vector live in host
mirrors: a search ships only [B, k] int32 winner slots back, and the host
recomputes exact f32 distances and attaches epochs (ids_postprocess; the
reference resolves ids host-side the same way, usearch.rs:1067-1154).
Mutations update the device tensors in place (the JAX package donated
buffers to the same effect). Capacity grows by the reserve increment
(1M for global indexes, usearch.rs:442-443).

Not ported yet (ROADMAP.md, port queue): the partition directory of local
indexes and the I8/B1 search with its bf16 rescore tier.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from vector_store_tpu.core.types import Quantization, SpaceType
from vector_store_tpu.utils import hotpath
from vector_store_tpu_torch.ops.distance import prepare_queries
from vector_store_tpu_torch.ops.fused_scan import (
    INVALID_BIAS,
    block_rows_for,
    paux_coeffs,
    rank_search,
)
from vector_store_tpu_torch.ops.quantize import padded_dim, storage_dtype

logger = logging.getLogger(__name__)

GLOBAL_RESERVE_INCREMENT = 1_000_000


@dataclass
class SearchResult:
    """Host-side search output; invalid lanes already stripped."""

    slots: np.ndarray  # [k'] int64
    epochs: np.ndarray  # [k'] int32
    distances: np.ndarray  # [k'] float32

    def truncated(self, k: int) -> "SearchResult":
        """First k entries (rows are already distance-ordered)."""
        if self.slots.shape[0] <= k:
            return self
        return SearchResult(
            slots=self.slots[:k], epochs=self.epochs[:k], distances=self.distances[:k]
        )


@dataclass
class PendingSearch:
    """In-flight device search. Kernels run asynchronously on the device;
    the result tensors are pulled to the host at collect time.

    ``packed`` is [B, k] int32 winner slots (-1 empty); exact distances
    and epochs come from the host mirrors. A raw search (the IVF engine's
    delta region) leaves ``packed`` [B, k] f32 rank values and ``rows``
    [B, k] int32 rows instead, for the engine's own merge."""

    packed: torch.Tensor
    b_real: int
    k: int
    rows: torch.Tensor | None = None
    q_f32: np.ndarray | None = None  # [B, D] normalized f32 queries


def pull_packed(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> host numpy (waits for the kernels that make it)."""
    return t.cpu().numpy()


def ids_postprocess(
    vecs_host: np.ndarray,  # [cap, D] f32 storage-representation mirror
    epochs_host: np.ndarray,  # [cap] i32
    space: SpaceType,
    dims: int,
    ids: np.ndarray,  # [b, k] int32 winner ids (-1 empty)
    q_f32: np.ndarray,  # [b, D] f32 queries (normalized for cosine)
    keep_order: bool = False,
) -> list[SearchResult]:
    """Shared ids-only resolution: recompute exact f32 distances from the
    host mirror, attach epochs, restore strict distance order.

    keep_order=True (index option `rescoring: false`) preserves the
    device's storage-precision rank order; only invalid ids move to the
    back (validator quantization_and_rescoring.rs)."""
    from vector_store_tpu_torch.engine.rescore import native_rescore

    i = np.asarray(ids)
    safe = np.maximum(i, 0)
    q = q_f32[:, :dims]
    d = native_rescore(vecs_host, i, q, space)
    if d is None:  # no native toolchain / layout mismatch: numpy fallback
        v = vecs_host[safe]  # [b, k, D]
        if space is SpaceType.EUCLIDEAN:
            d = ((q[:, None, :] - v) ** 2).sum(-1)
        else:
            d = 1.0 - np.einsum("bd,bkd->bk", q, v)
            if space is SpaceType.COSINE:
                d = np.clip(d, 0.0, 2.0)
    e = epochs_host[safe]
    valid = i >= 0
    d = np.where(valid, d, np.inf).astype(np.float32, copy=False)
    if keep_order:
        order = np.argsort(np.where(valid, 0, 1), axis=1, kind="stable")
    else:
        order = np.argsort(d, axis=1, kind="stable")
    sl = np.take_along_axis(i, order, 1).astype(np.int64)
    dd = np.take_along_axis(d, order, 1)
    ee = np.take_along_axis(e, order, 1)
    if valid.all():  # the common case: row views, no per-row slicing
        return [
            SearchResult(slots=sl[row], epochs=ee[row], distances=dd[row])
            for row in range(i.shape[0])
        ]
    counts = valid.sum(1).tolist()
    return [
        SearchResult(slots=sl[row, :n], epochs=ee[row, :n], distances=dd[row, :n])
        for row, n in enumerate(counts)
    ]


def normalize_rows(x: np.ndarray) -> np.ndarray:
    """Unit rows (cosine storage and queries)."""
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-30)


def require_global(partitions) -> None:
    if partitions is not None and (np.asarray(partitions) >= 0).any():
        raise NotImplementedError(
            "local (per-partition) indexes are not ported yet (ROADMAP.md, "
            "port queue: partition_rank_scan with local indexes)"
        )


class FlatDeviceIndex:
    """Exact search over slot-addressed device tensors."""

    def __init__(
        self,
        dimensions: int,
        space_type: SpaceType = SpaceType.COSINE,
        quantization: Quantization = Quantization.F32,
        *,
        device: torch.device,
        initial_capacity: int = 8192,
        reserve_increment: int = GLOBAL_RESERVE_INCREMENT,
        block_rows: int | None = None,
        rescoring: bool = True,
    ) -> None:
        self.dimensions = dimensions
        self.space_type = space_type
        self.quantization = quantization
        self.device = torch.device(device)
        self.dtype = storage_dtype(quantization)  # raises for I8/B1
        self.dp = padded_dim(dimensions, quantization)
        self.block_rows = block_rows or block_rows_for(self.dp)
        self.reserve_increment = reserve_increment
        # rescoring=False (index option): device rank order is the result
        # order; the exact f32 recompute only supplies the distances
        self.rescoring = rescoring
        cap = self._round_cap(max(initial_capacity, self.block_rows))
        self.vectors = torch.zeros((cap, self.dp), dtype=self.dtype, device=self.device)
        self.a = torch.zeros((cap,), dtype=torch.float32, device=self.device)
        self.b = torch.full((cap,), INVALID_BIAS, dtype=torch.float32, device=self.device)
        self._live = 0
        self._valid_host = np.zeros((cap,), dtype=bool)
        self._epochs_host = np.full((cap,), -1, dtype=np.int32)
        self._vecs_host = np.zeros((cap, dimensions), dtype=np.float32)

    # -- capacity ------------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def size(self) -> int:
        """Number of live vectors."""
        return self._live

    @property
    def device_bytes(self) -> int:
        return self.capacity * (self.vectors.element_size() * self.dp + 8)

    @property
    def host_bytes(self) -> int:
        return self._valid_host.nbytes + self._epochs_host.nbytes + self._vecs_host.nbytes

    def _round_cap(self, n: int) -> int:
        return -(-n // self.block_rows) * self.block_rows

    def reserve(self, max_slot: int) -> None:
        """Ensure capacity covers slots [0, max_slot]; grows by the reserve
        increment."""
        old = self.capacity
        if max_slot < old:
            return
        new = self._round_cap(max(max_slot + 1, old + self.reserve_increment))
        grow = new - old
        self.vectors = torch.cat(
            [self.vectors, self.vectors.new_zeros((grow, self.dp))]
        )
        self.a = torch.cat([self.a, self.a.new_zeros((grow,))])
        self.b = torch.cat([self.b, self.b.new_full((grow,), INVALID_BIAS)])
        self._valid_host = np.concatenate([self._valid_host, np.zeros(grow, bool)])
        self._epochs_host = np.concatenate(
            [self._epochs_host, np.full(grow, -1, np.int32)]
        )
        self._vecs_host = np.concatenate(
            [self._vecs_host, np.zeros((grow, self.dimensions), np.float32)]
        )

    # -- mutation --------------------------------------------------------------

    def _store(self, slots: torch.Tensor | slice, rows_f32: torch.Tensor) -> None:
        """Quantize f32 rows [n, D] (normalized for cosine) on their device
        and write them with their rank coefficients."""
        pad = self.dp - rows_f32.shape[1]
        vals = torch.nn.functional.pad(rows_f32, (0, pad)).to(self.dtype)
        a, b = paux_coeffs(self.space_type, vals)
        self.vectors[slots] = vals
        self.a[slots] = a
        self.b[slots] = b

    @hotpath.measure
    def upsert_batch(
        self,
        slots: np.ndarray,
        epochs: np.ndarray,
        vectors: np.ndarray,  # [n, D] f32
        partitions: np.ndarray | None = None,
    ) -> None:
        require_global(partitions)
        slots = np.asarray(slots, dtype=np.int64)
        if slots.size == 0:
            return
        epochs = np.asarray(epochs, dtype=np.int32)
        vectors = np.asarray(vectors, dtype=np.float32)
        if np.unique(slots).size != slots.size:
            # LWW within the batch: keep each slot's LAST occurrence
            rev_first = np.unique(slots[::-1], return_index=True)[1]
            keep = np.sort(slots.size - 1 - rev_first)
            slots, epochs, vectors = slots[keep], epochs[keep], vectors[keep]
        self.reserve(int(slots.max()))
        if self.space_type is SpaceType.COSINE:
            vectors = normalize_rows(vectors)
        self._store(
            torch.from_numpy(slots).to(self.device),
            torch.from_numpy(np.ascontiguousarray(vectors)).to(self.device),
        )
        self._live += int((~self._valid_host[slots]).sum())
        self._valid_host[slots] = True
        self._epochs_host[slots] = epochs
        self._vecs_host[slots] = vectors

    def upsert_bulk_device(
        self,
        lo: int,
        hi: int,
        rows_dev: torch.Tensor,  # [hi-lo, D] f32 on this index's device
        rows_host: np.ndarray,  # [hi-lo, D] f32 host twin of the same rows
        epoch: int = 0,
        epochs: np.ndarray | None = None,  # [hi-lo] i32 per row (wins over epoch)
    ) -> None:
        """Bulk path for contiguous fresh slots [lo, hi) whose rows are
        already on the device (e.g. gathered from a rebuild snapshot):
        normalize/quantize/coefficients run on the device, so no vector
        bytes cross the host link. ``rows_host`` feeds the host mirrors."""
        n = int(hi) - int(lo)
        if n <= 0:
            return
        if tuple(rows_dev.shape) != (n, self.dimensions):
            raise ValueError(f"rows_dev shape {tuple(rows_dev.shape)} != {(n, self.dimensions)}")
        self.reserve(hi - 1)
        if self._valid_host[lo:hi].any():
            raise ValueError("bulk device ingest requires fresh slots")
        rows = rows_dev.float()
        rh = np.asarray(rows_host, dtype=np.float32)
        if self.space_type is SpaceType.COSINE:
            rows = rows / torch.clamp(rows.norm(dim=-1, keepdim=True), min=1e-30)
            rh = normalize_rows(rh)
        self._store(slice(lo, hi), rows)
        self._valid_host[lo:hi] = True
        self._epochs_host[lo:hi] = epoch if epochs is None else epochs
        self._vecs_host[lo:hi] = rh
        self._live += n

    def remove_batch(self, slots: np.ndarray) -> None:
        slots = np.asarray(slots, dtype=np.int64)
        slots = np.unique(slots[slots < self.capacity])  # dupes would
        if slots.size == 0:  # double-decrement the live count
            return
        self.b[torch.from_numpy(slots).to(self.device)] = INVALID_BIAS
        self._live -= int(self._valid_host[slots].sum())
        self._valid_host[slots] = False

    # -- search ----------------------------------------------------------------

    def query_tensor(self, queries_f32: np.ndarray) -> torch.Tensor:
        """[B, D] (normalized) f32 queries -> device storage rows [B, Dp]."""
        qs, _ = prepare_queries(queries_f32, self.space_type, self.quantization)
        return qs.to(self.device)

    def search(
        self, queries: np.ndarray, k: int, partitions: np.ndarray | None = None
    ) -> list[SearchResult]:
        return self.search_collect(self.search_begin(queries, k, partitions))

    @hotpath.measure
    def search_begin(
        self,
        queries: np.ndarray,
        k: int,
        partitions: np.ndarray | None = None,
        raw: bool = False,
        queries_dev: torch.Tensor | None = None,
    ) -> PendingSearch:
        """Launch the scan and return a handle without waiting. raw=True
        keeps the rank values (kind "rank") for the IVF engine's region
        merge; queries_dev is an already device-resident [B, Dp] query
        tensor (the IVF engine shares one upload across its two regions)."""
        require_global(partitions)
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if self.space_type is SpaceType.COSINE:
            queries = normalize_rows(queries)
        qs = self.query_tensor(queries) if queries_dev is None else queries_dev
        rank, rows = rank_search(
            self.vectors, self.a, self.b, qs, k=k, block_rows=self.block_rows
        )
        if raw:
            return PendingSearch(packed=rank, rows=rows, b_real=queries.shape[0], k=k)
        return PendingSearch(packed=rows, b_real=queries.shape[0], k=k, q_f32=queries)

    @hotpath.measure
    def search_collect(self, pending: PendingSearch) -> list[SearchResult]:
        return self._postprocess(pending, pull_packed(pending.packed))

    def collect_many(self, pendings: list[PendingSearch]) -> list[list[SearchResult]]:
        return [self.search_collect(p) for p in pendings]

    def _postprocess(self, pending: PendingSearch, host: np.ndarray) -> list[SearchResult]:
        b_real = pending.b_real
        return ids_postprocess(
            self._vecs_host,
            self._epochs_host,
            self.space_type,
            self.dimensions,
            host[:b_real],
            pending.q_f32[:b_real],
            keep_order=not self.rescoring,
        )
