"""Exact (brute-force) device-resident vector index.

Counterpart of vector_store_tpu/engine/flat.py for every storage kind
(F32/F16/BF16, I8 and B1). It serves small global indexes, every local
(per-partition) index and every B1 or Hamming index, and is the IVF
engine's delta region. Device state, slot-indexed like the reference's
PrimaryId slots:

- vectors [cap, Dp]  storage dtype (packed bytes for B1)
- a, b    [cap] f32  rank coefficients of the fused scan (b = INVALID_BIAS
                     for never-written or removed slots)
- aux     [cap] f32  |v| for cosine, popcount for B1 (zeros otherwise),
                     for the exact scans
- parts   [cap] i32  partition slot of each row (-1 = none)

Float storage ranks with the fused scan (kernel 1, ops/fused_scan.py) and
ships only [B, k] int32 winner slots back: the host recomputes exact f32
distances from its f32 mirror of every stored vector and attaches epochs
(ids_postprocess; the reference resolves ids host-side the same way,
usearch.rs:1067-1154).

Lossy storage (I8, B1) has no fused scan (the JAX package ran it as XLA,
not Pallas): its search is an exact scan of the slots ever written
(``_flat_search``: integer products for I8, Hamming distances for B1,
ranked in one pass where the batch and the extent fit) that fetches
``oversample`` x k candidates (k and the count rounded up to the JAX
package's k buckets), re-ranked by the bf16 rescore tier
(``rescore_vectors`` [cap, Dp'] bf16 and ``rescore_aux``,
``_rescore_stage``): the reference's oversampling and rescoring index
options. Its results carry the device's distances (the tier's bf16
distance in the declared space, or the scan's own with rescoring off), as
the JAX package returns them, so it keeps no host mirror of the vectors.
A B1 index keeps its rows' scale (no cosine normalization), as in the JAX
package.

Mutations update the device tensors in place (the JAX package donated
buffers to the same effect). Capacity grows by the reserve increment (1M
for global indexes, 1k for local ones, usearch.rs:442-443).

Local indexes keep a partition directory: per-partition slot lists
(``part_rows`` [P_cap, pmax], bucket order and swap-removes as in the JAX
package). For float storage a partition-major mirror of the rows
(``part_vecs`` [P_cap * pmax, Dp] with its own a, b) feeds the partition
scan (kernel 3, ops/partition_scan.py), one bucket per query; lossy
storage gathers each query's bucket from the flat tensors instead
(``_part_gather``, the JAX package's _part_search) and re-ranks it with
the tier. A query naming a partition costs O(pmax) rows instead of a
masked scan of the table.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from vector_store_tpu_torch.core.types import Quantization, SpaceType
from vector_store_tpu_torch.utils import hotpath, spans
from vector_store_tpu_torch.ops.distance import (
    pairwise_distance,
    prepare_queries,
    query_block_distance,
    vector_aux,
)
from vector_store_tpu_torch.ops.fused_scan import (
    INVALID_BIAS,
    INVALID_CUTOFF,
    LANES,
    apply_allow_to_paux,
    block_rows_for,
    paux_coeffs,
    rank_search,
)
from vector_store_tpu_torch.ops.partition_scan import (
    PLAIN_CHUNK_ELEMS,
    partition_candidates,
)
from vector_store_tpu_torch.ops.quantize import (
    LOSSY_QUANTIZATIONS,
    padded_dim,
    storage_dtype,
    to_storage_rows,
)
from vector_store_tpu_torch.ops.topk import merge_min_k, stable_min_k

logger = logging.getLogger(__name__)

GLOBAL_RESERVE_INCREMENT = 1_000_000
LOCAL_RESERVE_INCREMENT = 1_000

# Directory/masked crossover. On the H100 both paths grow with the batch
# (the masked scan is a product of the batch with the whole capacity); at
# B = 2048 a (query, row) of the masked scan costs 0.27 of one of the
# directory's (1M rows, pmax 1024, BF16, k 10; chip_smoke.py phase 3 on an
# NVIDIA H100 80GB HBM3 at 700.00 W, with the partition scan that reads a
# bucket once a tile: 0.291 and 0.247 in two runs, their mean; 0.220-0.245
# with the scan before it; PERF.md), and at smaller batches the masked
# scan's fixed cost favours the directory more. So the directory serves
# while pmax <= PART_CROSSOVER * capacity, whatever the batch; the JAX
# package's TPU rule (B * pmax <= 3 * capacity) read the table once a
# batch.
PART_CROSSOVER = 0.27
# The same rule for lossy storage (I8, B1), whose directory is the exact
# gather of the bucket (no partition scan kernel) and whose masked scan is
# an integer product: at B = 2048 a (query, row) of the masked I8 scan
# costs 0.017 of one of the gather's (1M rows, pmax 1024, k 40;
# chip_smoke.py phase 10 on an NVIDIA H100 80GB HBM3 at 700.00 W: 0.021
# and 0.012 in two runs, their mean; 0.05 and 0.03 at B = 64; PERF.md).
PART_CROSSOVER_LOSSY = 0.017

# The JAX package's k buckets. A lossy search rounds k up to one of them
# before it oversamples, and rounds the candidate count up to one again
# (vector_store_tpu/engine/flat.py:53-58,1454-1458,1578-1582): at k 10 and
# oversample 4 it re-ranks 64 candidates, not 40. They are kept for that
# effect on the answer, as the graph engine keeps them for its beam's
# width; no shape is padded to them.
K_BUCKETS = (16, 64, 256, 1024)


def k_bucket(n: int, buckets: tuple[int, ...] = K_BUCKETS) -> int:
    """The smallest bucket holding n; past the last, n rounded up to a
    multiple of the last."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


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
    and epochs come from the host mirrors. A raw search of float storage
    (the IVF engine's delta region) leaves ``packed`` [B, k] f32 rank
    values and ``rows`` [B, k] int32 rows instead, for the engine's own
    merge. Lossy storage (I8, B1) always leaves ``packed`` [B, k] f32
    distances and ``rows`` (``is_dist``)."""

    packed: torch.Tensor
    b_real: int
    k: int
    rows: torch.Tensor | None = None
    q_f32: np.ndarray | None = None  # [B, D] normalized f32 queries
    is_dist: bool = False  # ``packed`` holds distances of ``rows`` (I8, B1)
    # the IVF engine's slot filter as its scans read it (the main region's
    # masked bias, the delta's position mask), for a retry of the batch
    main_b: torch.Tensor | None = None
    delta_allow: torch.Tensor | None = None


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
        with spans.span("ivf.rescore_numpy"):
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


def dist_results(d: np.ndarray, i: np.ndarray, epochs_host: np.ndarray) -> list[SearchResult]:
    """Results of the device's distances d [b, k] of slots i [b, k], in the
    device's order (a -1 slot or a distance that is not finite is empty),
    with epochs from the host mirror (the JAX package's "xla" kind)."""
    e = epochs_host[np.maximum(i, 0)]
    ok = np.isfinite(d) & (i >= 0)
    return [
        SearchResult(slots=i[r][ok[r]].astype(np.int64), epochs=e[r][ok[r]], distances=d[r][ok[r]])
        for r in range(d.shape[0])
    ]


def normalize_rows(x: np.ndarray) -> np.ndarray:
    """Unit rows (cosine storage and queries)."""
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-30)


def _grown(arr: np.ndarray, n: int, fill) -> np.ndarray:
    """``arr`` extended along axis 0 to n rows of ``fill``."""
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


class FlatDeviceIndex:
    """Exact search over slot-addressed device tensors."""

    _PART_PMAX0 = 128  # initial per-partition row capacity (pow2 ladder)
    _PART_PMAX_CAP = 16384  # beyond this a partition ~= a full scan
    _PART_PCAP0 = 256  # initial bucket count (the table reserves 256 partitions)

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
        oversample: int = 4,
    ) -> None:
        self.dimensions = dimensions
        self.space_type = space_type
        self.quantization = quantization
        self.device = torch.device(device)
        self.dtype = storage_dtype(quantization)
        self.dp = padded_dim(dimensions, quantization)
        self.block_rows = block_rows or block_rows_for(self.dp)
        self.reserve_increment = reserve_increment
        # rescoring=False (index option): device rank order is the result
        # order; the exact f32 recompute only supplies the distances
        self.rescoring = rescoring
        # I8 and B1 keep a bf16 copy of every row: their scan fetches
        # oversample x k candidates and the tier re-ranks them (off with
        # rescoring=False: storage-precision order and distances end to end)
        self.lossy = quantization in LOSSY_QUANTIZATIONS
        self.rescore = self.lossy and rescoring
        self.oversample = oversample if self.rescore else 1
        # cosine rows and queries are stored and scanned as unit vectors,
        # but for B1, whose sign bits and rescore tier take them as given
        self.normalize = space_type is SpaceType.COSINE and quantization is not Quantization.B1
        self.dp_rescore = padded_dim(dimensions, Quantization.BF16)
        cap = self._round_cap(max(initial_capacity, self.block_rows))
        self.vectors = torch.zeros((cap, self.dp), dtype=self.dtype, device=self.device)
        self.a = torch.zeros((cap,), dtype=torch.float32, device=self.device)
        self.b = torch.full((cap,), INVALID_BIAS, dtype=torch.float32, device=self.device)
        self.aux = torch.zeros((cap,), dtype=torch.float32, device=self.device)
        self.parts = torch.full((cap,), -1, dtype=torch.int32, device=self.device)
        self.rescore_vectors: torch.Tensor | None = None  # [cap, dp_rescore] bf16
        self.rescore_aux: torch.Tensor | None = None  # [cap] f32 (|v| for cosine)
        if self.rescore:
            self.rescore_vectors = torch.zeros(
                (cap, self.dp_rescore), dtype=torch.bfloat16, device=self.device
            )
            self.rescore_aux = torch.zeros((cap,), dtype=torch.float32, device=self.device)
        self._live = 0
        self.high = 0  # slots at or past it were never written
        # rows the exact scan read and the capacity it was offered, summed
        # over its calls (``flat_scans``)
        self.scan_rows = 0
        self.scan_capacity_rows = 0
        self._valid_host = np.zeros((cap,), dtype=bool)
        self._epochs_host = np.full((cap,), -1, dtype=np.int32)
        # the f32 mirror feeds the exact distances of float storage only
        self._vecs_host = None if self.lossy else np.zeros((cap, dimensions), dtype=np.float32)

        # partition directory, made at the first partitioned upsert; turned
        # off for good if a partition outgrows _PART_PMAX_CAP (the masked
        # scan then serves the index)
        self._part_bucket: dict[int, int] = {}  # partition slot -> bucket
        self._part_rows_host: np.ndarray | None = None  # [P_cap, pmax] i32
        self._part_count: np.ndarray | None = None  # [P_cap] i32
        self._slot_part = np.full((cap,), -1, dtype=np.int64)
        self._slot_pos = np.full((cap,), -1, dtype=np.int32)
        self._part_overflow = False
        self.part_rows: torch.Tensor | None = None  # device copy of the lists
        # partition-major mirror read by the partition scan (float storage
        # only: the JAX package's partition kernel takes F32/F16/BF16), kept in sync
        # from the flat tensors: a full rebuild when P_cap or pmax grows,
        # whole buckets after swap-removes, single positions for appends
        # and in-place vector updates
        self.part_vecs: torch.Tensor | None = None  # [P_cap * pmax, Dp]
        self.part_a: torch.Tensor | None = None  # [P_cap * pmax] f32
        self.part_b: torch.Tensor | None = None  # [P_cap * pmax] f32
        self._part_pending: list[tuple[np.ndarray, np.ndarray]] = []  # (pos, slot)
        self._part_refresh: set[int] = set()  # buckets to re-derive
        self._part_rebuild = False

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
        """Device footprint: the slot tensors, the rescore tier of lossy
        storage, and for a local index the directory and, for float
        storage, its partition-major mirror (a second copy of the rows)."""
        total = self.capacity * (self.vectors.element_size() * self.dp + 16)
        if self.rescore:
            total += self.capacity * (2 * self.dp_rescore + 4)
        if self.part_rows is not None:
            total += 4 * self.part_rows.numel()
        if self.part_vecs is not None:
            total += self.part_vecs.element_size() * self.part_vecs.numel()
            total += 8 * self.part_a.numel()
        return total

    @property
    def host_bytes(self) -> int:
        total = self._valid_host.nbytes + self._epochs_host.nbytes
        total += self._slot_part.nbytes + self._slot_pos.nbytes
        if self._vecs_host is not None:
            total += self._vecs_host.nbytes
        if self._part_rows_host is not None:
            total += self._part_rows_host.nbytes
        return total

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
        self.aux = torch.cat([self.aux, self.aux.new_zeros((grow,))])
        self.parts = torch.cat([self.parts, self.parts.new_full((grow,), -1)])
        if self.rescore:
            self.rescore_vectors = torch.cat(
                [self.rescore_vectors, self.rescore_vectors.new_zeros((grow, self.dp_rescore))]
            )
            self.rescore_aux = torch.cat([self.rescore_aux, self.rescore_aux.new_zeros((grow,))])
        self._valid_host = _grown(self._valid_host, new, False)
        self._epochs_host = _grown(self._epochs_host, new, -1)
        if self._vecs_host is not None:
            self._vecs_host = _grown(self._vecs_host, new, 0.0)
        self._slot_part = _grown(self._slot_part, new, -1)
        self._slot_pos = _grown(self._slot_pos, new, -1)

    # -- mutation --------------------------------------------------------------

    def _store(self, slots: torch.Tensor | slice, rows_f32: torch.Tensor) -> None:
        """Quantize f32 rows [n, D] (normalized where ``self.normalize``)
        on their device and write them with their rank coefficients (and,
        for lossy storage, their bf16 rescore rows)."""
        vals = to_storage_rows(rows_f32, self.quantization, self.dp)
        a, b = paux_coeffs(self.space_type, vals)
        self.vectors[slots] = vals
        self.a[slots] = a
        self.b[slots] = b
        self.aux[slots] = vector_aux(vals, self.space_type, self.quantization)
        if self.rescore:
            rvals = torch.nn.functional.pad(
                rows_f32, (0, self.dp_rescore - rows_f32.shape[1])
            ).to(torch.bfloat16)
            self.rescore_vectors[slots] = rvals
            self.rescore_aux[slots] = vector_aux(rvals, self.space_type, Quantization.BF16)

    @hotpath.measure
    def upsert_batch(
        self,
        slots: np.ndarray,
        epochs: np.ndarray,
        vectors: np.ndarray,  # [n, D] f32
        partitions: np.ndarray | None = None,  # [n] partition slots (-1 none)
    ) -> None:
        slots = np.asarray(slots, dtype=np.int64)
        if slots.size == 0:
            return
        epochs = np.asarray(epochs, dtype=np.int32)
        vectors = np.asarray(vectors, dtype=np.float32)
        parts = (
            np.full((slots.size,), -1, dtype=np.int64)
            if partitions is None
            else np.asarray(partitions, dtype=np.int64)
        )
        if np.unique(slots).size != slots.size:
            # LWW within the batch: keep each slot's LAST occurrence
            rev_first = np.unique(slots[::-1], return_index=True)[1]
            keep = np.sort(slots.size - 1 - rev_first)
            slots, epochs, vectors, parts = slots[keep], epochs[keep], vectors[keep], parts[keep]
        self.reserve(int(slots.max()))
        self.high = max(self.high, int(slots.max()) + 1)
        was_valid = self._valid_host[slots]
        if self.normalize:
            vectors = normalize_rows(vectors)
        slots_dev = torch.from_numpy(slots).to(self.device)
        self._store(slots_dev, torch.from_numpy(np.ascontiguousarray(vectors)).to(self.device))
        self.parts[slots_dev] = torch.from_numpy(parts.astype(np.int32)).to(self.device)
        self._live += int((~was_valid).sum())
        if (parts >= 0).any() or self._part_rows_host is not None:
            # after the device writes: the mirror copies from the flat tensors
            self._part_upsert(slots, parts, was_valid)
        self._valid_host[slots] = True
        self._epochs_host[slots] = epochs
        if self._vecs_host is not None:
            self._vecs_host[slots] = vectors

    def upsert_bulk_device(
        self,
        lo: int,
        hi: int,
        rows_dev: torch.Tensor,  # [hi-lo, D] f32 on this index's device
        rows_host: np.ndarray,  # [hi-lo, D] f32 host twin of the same rows
        partitions: np.ndarray | None = None,  # [hi-lo] partition slots
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
        if self.quantization is Quantization.B1:
            raise ValueError("bulk device ingest does not support B1 packing")
        if tuple(rows_dev.shape) != (n, self.dimensions):
            raise ValueError(f"rows_dev shape {tuple(rows_dev.shape)} != {(n, self.dimensions)}")
        self.reserve(hi - 1)
        if self._valid_host[lo:hi].any():
            raise ValueError("bulk device ingest requires fresh slots")
        rows = rows_dev.float()
        rh = np.asarray(rows_host, dtype=np.float32)
        if self.normalize:
            rows = rows / torch.clamp(rows.norm(dim=-1, keepdim=True), min=1e-30)
            rh = normalize_rows(rh)
        self._store(slice(lo, hi), rows)
        self.high = max(self.high, int(hi))
        if partitions is not None:
            parts = np.asarray(partitions, dtype=np.int64)
            self.parts[lo:hi] = torch.from_numpy(parts.astype(np.int32)).to(self.device)
            # fresh slots: plain appends to the directory
            self._part_upsert(np.arange(lo, hi, dtype=np.int64), parts, np.zeros(n, bool))
        self._valid_host[lo:hi] = True
        self._epochs_host[lo:hi] = epoch if epochs is None else epochs
        if self._vecs_host is not None:
            self._vecs_host[lo:hi] = rh
        self._live += n

    def remove_batch(self, slots: np.ndarray) -> None:
        slots = np.asarray(slots, dtype=np.int64)
        slots = np.unique(slots[slots < self.capacity])  # dupes would
        if slots.size == 0:  # double-decrement the live count
            return
        was_valid = self._valid_host[slots]
        self.b[torch.from_numpy(slots).to(self.device)] = INVALID_BIAS
        self._live -= int(was_valid.sum())
        self._valid_host[slots] = False
        if self._part_rows_host is not None:
            dirty: set[int] = set()
            for slot, wv in zip(slots.tolist(), was_valid.tolist()):
                if wv and self._slot_part[slot] >= 0:
                    self._part_remove_one(slot, int(self._slot_part[slot]), dirty)
                    self._slot_part[slot] = -1
            self._flush_part_dirty(dirty)

    # -- partition directory ---------------------------------------------------

    def partition_count(self, part_slot: int) -> int:
        """Live rows in one partition (O(1) from the directory; the serving
        actor stops its k-escalation once a whole partition was seen)."""
        if self._part_count is not None:
            b = self._part_bucket.get(int(part_slot))
            return int(self._part_count[b]) if b is not None else 0
        valid = self._valid_host[: self._slot_part.shape[0]]
        return int(((self._slot_part == int(part_slot)) & valid).sum())

    def _part_upsert(self, slots: np.ndarray, parts: np.ndarray, was_valid: np.ndarray) -> None:
        old_parts = self._slot_part[slots].copy()
        self._slot_part[slots] = parts  # kept current even after overflow
        if self._part_overflow:
            return
        dirty: set[int] = set()
        # pure adds (the ingest shape: every row new) append per partition,
        # vectorized; moves and removals go row by row
        is_add = (~was_valid) & (parts >= 0)
        slow = ~is_add
        if is_add.any():
            a_slots, a_parts = slots[is_add], parts[is_add]
            order = np.argsort(a_parts, kind="stable")
            sp, ss = a_parts[order], a_slots[order]
            uniq, starts, counts = np.unique(sp, return_index=True, return_counts=True)
            for p, st, c in zip(uniq.tolist(), starts.tolist(), counts.tolist()):
                b = self._part_bucket.get(p)
                if b is None:
                    b = self._part_new_bucket(p)
                base = int(self._part_count[b])
                while base + c > self._part_rows_host.shape[1]:
                    if not self._part_grow_pmax():
                        return  # overflowed: directory disabled
                pmax = self._part_rows_host.shape[1]
                seg = ss[st : st + c]
                self._part_rows_host[b, base : base + c] = seg
                self._slot_pos[seg] = np.arange(base, base + c, dtype=np.int32)
                self._part_count[b] = base + c
                self._part_pending.append((np.arange(b * pmax + base, b * pmax + base + c), seg))
                dirty.add(b)
        for slot, p, old, wv in zip(
            slots[slow].tolist(),
            parts[slow].tolist(),
            old_parts[slow].tolist(),
            was_valid[slow].tolist(),
        ):
            if wv and old == p:
                if p >= 0:
                    # a new vector in the same partition: the directory
                    # keeps its position, the mirror takes the new row (the
                    # JAX package skips this and serves the old vector)
                    pos = self._part_bucket[p] * self._part_rows_host.shape[1]
                    pos += int(self._slot_pos[slot])
                    self._part_pending.append((np.array([pos]), np.array([slot])))
                continue
            if wv and old >= 0:
                self._part_remove_one(slot, int(old), dirty)
            if p >= 0:
                self._part_add_one(slot, int(p), dirty)
                if self._part_overflow:
                    return
        self._flush_part_dirty(dirty)

    def _part_add_one(self, slot: int, p: int, dirty: set[int]) -> None:
        b = self._part_bucket.get(p)
        if b is None:
            b = self._part_new_bucket(p)
        c = int(self._part_count[b])
        if c >= self._part_rows_host.shape[1]:
            if not self._part_grow_pmax():
                return  # overflowed: directory disabled
        pmax = self._part_rows_host.shape[1]
        self._part_rows_host[b, c] = slot
        self._slot_pos[slot] = c
        self._part_count[b] = c + 1
        self._part_pending.append((np.array([b * pmax + c]), np.array([slot])))
        dirty.add(b)

    def _part_remove_one(self, slot: int, p: int, dirty: set[int]) -> None:
        """Swap-remove: the bucket's last row takes the removed row's
        position."""
        b = self._part_bucket.get(p)
        if b is None:
            return
        pos = int(self._slot_pos[slot])
        c = int(self._part_count[b]) - 1
        if pos < 0 or c < 0:
            return
        last = int(self._part_rows_host[b, c])
        self._part_rows_host[b, pos] = last
        self._slot_pos[last] = pos
        self._part_rows_host[b, c] = -1
        self._part_count[b] = c
        self._slot_pos[slot] = -1
        self._part_refresh.add(b)  # swap-moves re-derive the whole bucket
        dirty.add(b)

    def _part_new_bucket(self, p: int) -> int:
        if self._part_rows_host is None:
            self._part_rows_host = np.full(
                (self._PART_PCAP0, self._PART_PMAX0), -1, dtype=np.int32
            )
            self._part_count = np.zeros((self._PART_PCAP0,), dtype=np.int32)
        b = len(self._part_bucket)
        if b >= self._part_rows_host.shape[0]:
            pcap = self._part_rows_host.shape[0] * 2
            self._part_rows_host = _grown(self._part_rows_host, pcap, -1)
            self._part_count = _grown(self._part_count, pcap, 0)
        self._part_bucket[p] = b
        return b

    def _part_grow_pmax(self) -> bool:
        """Double the per-partition capacity; False (and the directory off)
        past the cap: the masked scan serves such indexes."""
        pmax = self._part_rows_host.shape[1] * 2
        if pmax > self._PART_PMAX_CAP:
            logger.warning(
                "partition exceeded %d rows; partition-directory search "
                "disabled for this index (the masked scan serves it)",
                self._PART_PMAX_CAP,
            )
            self._part_overflow = True
            self._part_rows_host = self._part_count = None
            self.part_rows = self.part_vecs = self.part_a = self.part_b = None
            self._part_pending.clear()
            self._part_refresh.clear()
            return False
        grown = np.full((self._part_rows_host.shape[0], pmax), -1, dtype=np.int32)
        grown[:, : self._part_rows_host.shape[1]] = self._part_rows_host
        self._part_rows_host = grown
        return True

    def _flush_part_dirty(self, dirty: set[int]) -> None:
        """Copy the changed buckets' slot lists to the device (all of them
        after a geometry change), then bring the mirror up to date."""
        if self._part_rows_host is None:
            return
        if self.part_rows is None or tuple(self.part_rows.shape) != self._part_rows_host.shape:
            self.part_rows = torch.tensor(self._part_rows_host, device=self.device)
        elif dirty:
            idx = np.fromiter(dirty, np.int64, len(dirty))
            self.part_rows[torch.from_numpy(idx).to(self.device)] = torch.from_numpy(
                self._part_rows_host[idx]
            ).to(self.device)
        self._part_device_sync()

    def _part_device_sync(self) -> None:
        """Bring the partition-major mirror up to date, with in-place writes
        except for the full rebuild. Every vector comes from the device's
        flat tensors (no second upload). Lossy storage keeps no mirror."""
        if self.lossy:
            self._part_pending.clear()
            self._part_refresh.clear()
            self._part_rebuild = False
            return
        pmax = self._part_rows_host.shape[1]
        npos = self._part_rows_host.shape[0] * pmax
        if self.part_vecs is None or self.part_vecs.shape[0] != npos or self._part_rebuild:
            rows = self.part_rows.view(-1)
            safe = torch.clamp(rows, min=0).long()
            self.part_vecs = self.part_a = self.part_b = None  # free before the copy
            self.part_vecs = self.vectors[safe]
            self.part_a = self.a[safe]
            self.part_b = torch.where(rows >= 0, self.b[safe], INVALID_BIAS)
            self._part_rebuild = False
            self._part_pending.clear()
            self._part_refresh.clear()
            return
        if self._part_refresh:
            idx = torch.tensor(sorted(self._part_refresh), device=self.device)
            self._part_refresh.clear()
            rows = self.part_rows[idx].view(-1)
            safe = torch.clamp(rows, min=0).long()
            flat = (idx[:, None] * pmax + torch.arange(pmax, device=self.device)).view(-1)
            self.part_vecs[flat] = self.vectors[safe]
            self.part_a[flat] = self.a[safe]
            self.part_b[flat] = torch.where(rows >= 0, self.b[safe], INVALID_BIAS)
        if self._part_pending:
            pos = np.concatenate([p for p, _ in self._part_pending])
            slots = np.concatenate([s for _, s in self._part_pending])
            self._part_pending.clear()
            # a later swap-remove of the same batch may have moved the row;
            # its bucket's refresh already placed it
            keep = self._part_rows_host.reshape(-1)[pos] == slots
            pos_t = torch.from_numpy(pos[keep]).to(self.device)
            slots_t = torch.from_numpy(slots[keep].astype(np.int64)).to(self.device)
            self.part_vecs[pos_t] = self.vectors[slots_t]
            self.part_a[pos_t] = self.a[slots_t]
            self.part_b[pos_t] = self.b[slots_t]

    def load_state(self, state: dict) -> None:
        """Take over the state of a JAX FlatDeviceIndex, given as
        ``np.asarray`` of its attributes ``vectors``, ``paux`` (rows 0-1 =
        a, b), ``valid``, ``epochs`` and ``_vecs_host``, and its partition
        directory ``_part_bucket`` (a dict), ``_part_rows_host``,
        ``_part_count`` (both None without a directory), ``_slot_part``,
        ``_slot_pos`` and ``_part_overflow``. An I8 or B1 index also takes
        its rescore tier ``rescore_vectors`` and ``rescore_aux`` (when
        rescoring is on) and no ``_vecs_host``; its rank coefficients come
        from the vectors (the JAX package keeps none for lossy storage:
        validity is ``valid`` alone). Capacity is rounded up to this engine's
        scan block; rows are cut to its padded row length (the JAX package
        pads to 128 elements, or 128 bytes for B1)."""
        dev = self.device
        valid = np.asarray(state["valid"], dtype=bool)
        n = valid.shape[0]
        cap = self._round_cap(n)
        paux = np.asarray(state["paux"], dtype=np.float32)
        vecs = np.asarray(state["vectors"]).astype(np.float32)[:, : self.dp]
        self.vectors = torch.zeros((cap, self.dp), dtype=self.dtype, device=dev)
        self.vectors[:n] = torch.from_numpy(np.ascontiguousarray(vecs)).to(self.dtype).to(dev)
        self.a = torch.zeros((cap,), dtype=torch.float32, device=dev)
        self.b = torch.full((cap,), INVALID_BIAS, dtype=torch.float32, device=dev)
        if self.lossy:
            paux = np.stack([t.cpu().numpy() for t in paux_coeffs(self.space_type, self.vectors[:n])])
        self.a[:n] = torch.from_numpy(paux[0].copy()).to(dev)
        self.b[:n] = torch.from_numpy(np.where(valid, paux[1], INVALID_BIAS)).to(dev)
        self.aux = vector_aux(self.vectors, self.space_type, self.quantization)
        self._valid_host = _grown(valid, cap, False)
        self._epochs_host = _grown(np.asarray(state["epochs"], dtype=np.int32), cap, -1)
        if self._vecs_host is not None:
            self._vecs_host = _grown(np.asarray(state["_vecs_host"], dtype=np.float32), cap, 0.0)
        if self.rescore:
            rv = np.asarray(state["rescore_vectors"]).astype(np.float32)[:, : self.dp_rescore]
            self.rescore_vectors = torch.zeros((cap, self.dp_rescore), dtype=torch.bfloat16, device=dev)
            self.rescore_vectors[:n] = torch.from_numpy(np.ascontiguousarray(rv)).to(dev)
            self.rescore_aux = torch.zeros((cap,), dtype=torch.float32, device=dev)
            self.rescore_aux[:n] = torch.from_numpy(np.array(state["rescore_aux"], dtype=np.float32)).to(dev)
        self._live = int(valid.sum())
        self.high = int(np.flatnonzero(valid)[-1]) + 1 if valid.any() else 0
        self._slot_part = _grown(np.asarray(state["_slot_part"], dtype=np.int64), cap, -1)
        self._slot_pos = _grown(np.asarray(state["_slot_pos"], dtype=np.int32), cap, -1)
        self.parts = torch.tensor(self._slot_part.astype(np.int32), device=dev)
        self._part_bucket = {int(p): int(b) for p, b in state["_part_bucket"].items()}
        rows = state["_part_rows_host"]
        self._part_rows_host = None if rows is None else np.array(rows, dtype=np.int32)
        count = state["_part_count"]
        self._part_count = None if count is None else np.array(count, dtype=np.int32)
        self._part_overflow = bool(state["_part_overflow"])
        self.part_rows = self.part_vecs = self.part_a = self.part_b = None
        self._part_pending.clear()
        self._part_refresh.clear()
        self._part_rebuild = False
        self._flush_part_dirty(set())

    # -- search ----------------------------------------------------------------

    def query_tensor(self, queries_f32: np.ndarray) -> torch.Tensor:
        """[B, D] (normalized) f32 queries -> device storage rows [B, Dp]."""
        qs, _ = prepare_queries(queries_f32, self.space_type, self.quantization)
        return qs.to(self.device)

    def search(
        self,
        queries: np.ndarray,
        k: int,
        partitions: np.ndarray | None = None,
        allow_mask: np.ndarray | None = None,
    ) -> list[SearchResult]:
        return self.search_collect(self.search_begin(queries, k, partitions, allow_mask))

    def masked_bias(self, allow_mask: np.ndarray | torch.Tensor) -> torch.Tensor:
        """``b`` with every slot that ``allow_mask`` does not allow biased to
        INVALID_BIAS, so that the scans never rank those rows (the JAX
        package's apply_allow_to_paux). The mask is a host [n] bool array
        (slots past its end are not allowed) or a [capacity] bool tensor on
        this index's device. A new tensor; ``self.b`` is untouched."""
        if isinstance(allow_mask, torch.Tensor):
            if tuple(allow_mask.shape) != (self.capacity,):
                raise ValueError(f"a device allow mask must hold {self.capacity} slots")
            return apply_allow_to_paux(self.b, allow_mask)
        allow_mask = np.asarray(allow_mask, dtype=bool)
        am = np.zeros((self.capacity,), dtype=bool)
        am[: allow_mask.shape[0]] = allow_mask[: self.capacity]
        return apply_allow_to_paux(self.b, torch.from_numpy(am).to(self.device))

    @hotpath.measure
    def search_begin(
        self,
        queries: np.ndarray,
        k: int,
        partitions: np.ndarray | None = None,  # [B] partition slots (-1 = all)
        allow_mask: np.ndarray | torch.Tensor | None = None,  # bool slot filter
        raw: bool = False,
        queries_dev: torch.Tensor | None = None,
    ) -> PendingSearch:
        """Launch the scan and return a handle without waiting. raw=True
        keeps the rank values (kind "rank") for the IVF engine's region
        merge; queries_dev is an already device-resident [B, Dp] query
        tensor (the IVF engine shares one upload across its two regions).
        With ``partitions`` each query sees only its partition's rows. With
        ``allow_mask`` only the slots it allows are ranked (the scans read
        a copy of ``b`` that biases the others out); the partition
        directory serves only unmasked searches, as in the JAX package. An
        I8 or B1 index ranks by its own scan and the rescore tier; its
        result holds the device's distances (``is_dist``), raw or not."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if self.normalize:
            queries = normalize_rows(queries)
        qs = self.query_tensor(queries) if queries_dev is None else queries_dev
        b_real = queries.shape[0]
        b = self.b if allow_mask is None else self.masked_bias(allow_mask)
        psel = None
        if partitions is not None:
            if raw:
                raise ValueError("a partitioned search has no raw form")
            psel = np.asarray(partitions, dtype=np.int64)
        if self.lossy:
            dist, rows = self._lossy_search(queries, qs, k, b, psel, directory=allow_mask is None)
            return PendingSearch(packed=dist, rows=rows, b_real=b_real, k=k, is_dist=True)
        if psel is not None:
            if allow_mask is None:
                ids = self._partitioned_ids(qs, psel, k)
            else:
                ids = self._masked_scan(qs, torch.from_numpy(psel.astype(np.int32)).to(self.device), k, b)
            return PendingSearch(packed=ids, b_real=b_real, k=k, q_f32=queries)
        rank, rows = rank_search(
            self.vectors, self.a, b, qs, k=k, block_rows=self.block_rows
        )
        if raw:
            return PendingSearch(packed=rank, rows=rows, b_real=b_real, k=k)
        return PendingSearch(packed=rows, b_real=b_real, k=k, q_f32=queries)

    def _part_directory_wins(self) -> bool:
        """Does the directory (pmax rows a query) beat the masked scan (the
        whole capacity a query) at the H100's measured cost ratio?"""
        crossover = PART_CROSSOVER_LOSSY if self.lossy else PART_CROSSOVER
        return self._part_rows_host.shape[1] <= crossover * self.capacity

    def _directory_buckets(self, psel: np.ndarray) -> torch.Tensor | None:
        """[B] i32 directory bucket of each query (-1: a partition with no
        rows) when the directory serves the batch: it exists, every query
        names a partition, and it wins the crossover. None otherwise."""
        if (
            self._part_rows_host is None
            or not bool((psel >= 0).all())
            or not self._part_directory_wins()
        ):
            return None
        bsel = np.fromiter((self._part_bucket.get(int(p), -1) for p in psel), np.int32, psel.shape[0])
        return torch.from_numpy(bsel).to(self.device)

    def _partitioned_ids(self, qs: torch.Tensor, psel: np.ndarray, k: int) -> torch.Tensor:
        """[B, k] i32 winner slots of a partitioned search of float storage
        (-1 empty). Where the directory serves the batch, k <= 128 runs the
        partition scan kernel, larger k (the actor's oversample steps) an
        exact gather of the buckets. Otherwise a masked scan of the whole
        capacity, where psel -1 means every partition."""
        bsel = self._directory_buckets(psel)
        if bsel is None:
            return self._masked_scan(qs, torch.from_numpy(psel.astype(np.int32)).to(self.device), k)
        pmax = self._part_rows_host.shape[1]
        if k <= LANES:
            return partition_candidates(
                self.part_vecs, self.part_a, self.part_b, self.part_rows, qs, bsel, k=k, pmax=pmax,
            )
        return self._part_gather(qs, bsel, k)[1]

    def _part_gather(
        self, qs: torch.Tensor, bsel: torch.Tensor, k: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact directory search (the JAX package's _part_search): gather
        each query's bucket from the flat tensors, rank by exact storage
        distance, top-k with ties to the earlier bucket position; a chunk
        of queries at a time. Returns (dist [B, k] f32 ascending, inf for
        empty; slot [B, k] i32 or -1)."""
        nq, dp = qs.shape
        pmax = self.part_rows.shape[1]
        rows = torch.where(
            bsel[:, None] >= 0, self.part_rows[torch.clamp(bsel, min=0).long()], -1
        )  # [B, pmax]
        q_aux = vector_aux(qs, self.space_type, self.quantization)
        kk = min(k, pmax)
        out_d = torch.full((nq, k), float("inf"), device=self.device)
        out_i = torch.full((nq, k), -1, dtype=torch.int32, device=self.device)
        width = 8 * dp if self.quantization is Quantization.B1 else dp  # unpacked bits
        step = max(1, PLAIN_CHUNK_ELEMS // (pmax * width))
        for lo in range(0, nq, step):
            r = rows[lo : lo + step]
            safe = torch.clamp(r, min=0).long()
            d = query_block_distance(
                qs[lo : lo + step], self.vectors[safe], self.space_type, self.quantization,
                q_aux[lo : lo + step], self.aux[safe],
            )
            d = torch.where((r >= 0) & (self.b[safe] < INVALID_CUTOFF), d, float("inf"))
            bd, sel = stable_min_k(d, kk)
            out_d[lo : lo + step, :kk] = bd
            out_i[lo : lo + step, :kk] = torch.where(
                torch.isfinite(bd), torch.gather(r, 1, sel), -1
            )
        return out_d, out_i

    def _flat_search(
        self,
        qs: torch.Tensor,
        k: int,
        psel: torch.Tensor | None = None,
        b: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact scan (the JAX package's _flat_search) of the blocks up to
        ``high``: every slot past it has the invalid bias, so the answer is
        that of the whole capacity. The extent is ranked a chunk at a time,
        each chunk as many whole blocks as keep both its [B, rows]
        storage-precision distances and its rows' operand (bits unpacked
        for B1) within PLAIN_CHUNK_ELEMS elements, so a batch over a small
        extent ranks in one pass; chunks merge into a running top-k (for
        lossy storage with ties to the lower slot, as lax.top_k breaks
        them). ``psel`` [B] masks each query to its partition (-1 = every
        partition); rows whose bias (``b``, by default ``self.b``) is
        INVALID_BIAS are skipped. Returns (dist [B, k] f32 ascending, inf
        for empty; slot [B, k] i32 or -1)."""
        b = self.b if b is None else b
        nq = qs.shape[0]
        extent = min(self._round_cap(self.high), self.capacity)
        self.scan_rows += extent
        self.scan_capacity_rows += self.capacity
        width = 8 * self.dp if self.quantization is Quantization.B1 else self.dp
        step = max(1, PLAIN_CHUNK_ELEMS // (max(nq, width) * self.block_rows)) * self.block_rows
        q_aux = vector_aux(qs, self.space_type, self.quantization)
        best_d = torch.full((nq, k), float("inf"), device=self.device)
        best_i = torch.full((nq, k), -1, dtype=torch.int32, device=self.device)
        for lo in range(0, extent, step):
            hi = min(lo + step, extent)
            d = pairwise_distance(
                qs, self.vectors[lo:hi], self.space_type, self.quantization, q_aux, self.aux[lo:hi]
            )
            keep = (b[lo:hi] < INVALID_CUTOFF)[None, :]
            if psel is not None:
                keep = keep & (
                    (psel[:, None] < 0) | (self.parts[lo:hi][None, :] == psel[:, None])
                )
            d = torch.where(keep, d, float("inf"))
            kb = min(k, hi - lo)
            if self.lossy:
                bd, bi = stable_min_k(d, kb)
            else:
                bd, bi = torch.topk(d, kb, dim=1, largest=False)
            bi = (bi + lo).to(torch.int32)
            if lo == 0 and kb == k:  # the first chunk: nothing to merge yet
                best_d, best_i = bd, bi
            else:
                best_d, best_i = merge_min_k(best_d, best_i, bd, bi, stable=self.lossy)
        return best_d, torch.where(torch.isfinite(best_d), best_i, -1)

    def flat_scans(self) -> tuple[int, int]:
        """(rows the exact scan read, capacity it was offered), summed over
        its calls: how far ``high`` bounds the scan."""
        return self.scan_rows, self.scan_capacity_rows

    def _masked_scan(
        self, qs: torch.Tensor, psel: torch.Tensor, k: int, b: torch.Tensor | None = None
    ) -> torch.Tensor:
        """[B, k] i32 winner slots of the exact scan with a per-query
        partition mask (the JAX package's _flat_search with use_parts)."""
        return self._flat_search(qs, k, psel, b)[1]

    def _rescore_stage(
        self,
        cand: torch.Tensor,  # [B, K'] i32 candidate slots (-1 empty)
        rqs: torch.Tensor,  # [B, dp_rescore] bf16 queries
        rq_aux: torch.Tensor,  # [B] f32
        k: int,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Re-rank the lossy scan's oversampled candidates by their bf16
        distances in the declared space (the JAX package's _rescore_stage;
        ties to the earlier candidate), a chunk of queries at a time.
        Returns (dist [B, k] f32 ascending, slot [B, k] i32 or -1)."""
        nq, kc = cand.shape
        kk = min(k, kc)
        out_d = torch.full((nq, k), float("inf"), device=self.device)
        out_i = torch.full((nq, k), -1, dtype=torch.int32, device=self.device)
        step = max(1, PLAIN_CHUNK_ELEMS // (kc * self.dp_rescore))
        for lo in range(0, nq, step):
            ci = cand[lo : lo + step]
            safe = torch.clamp(ci, min=0).long()
            nd = query_block_distance(
                rqs[lo : lo + step], self.rescore_vectors[safe], self.space_type,
                Quantization.BF16, rq_aux[lo : lo + step], self.rescore_aux[safe],
            )
            nd = torch.where(ci >= 0, nd, float("inf"))
            bd, pos = stable_min_k(nd, kk)
            out_d[lo : lo + step, :kk] = bd
            out_i[lo : lo + step, :kk] = torch.where(
                torch.isfinite(bd), torch.gather(ci, 1, pos), -1
            )
        return out_d, out_i

    def _lossy_search(
        self,
        queries: np.ndarray,
        qs: torch.Tensor,
        k: int,
        b: torch.Tensor,
        psel: np.ndarray | None = None,
        directory: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """I8 or B1 search of [B, D] f32 queries (normalized where
        ``self.normalize``), ``qs`` their storage rows on the device, over
        the rows whose bias ``b`` is valid; ``psel`` restricts each query to
        its partition. The directory's exact gather (where it serves the
        batch and ``directory`` allows it) or the block-wise scan fetches
        ``lossy_fetch(k)`` candidates, and the rescore tier keeps k (with
        rescoring off, the scan's k in storage precision): the JAX
        package's _part_begin and search_begin.
        Returns (dist [B, k] f32 ascending, slot [B, k] i32 or -1)."""
        bsel = self._directory_buckets(psel) if psel is not None and directory else None
        if bsel is not None:
            dist, rows = self._part_gather(qs, bsel, self.lossy_fetch(k, self._part_rows_host.shape[1]))
        else:
            psel_t = None if psel is None else torch.from_numpy(psel.astype(np.int32)).to(self.device)
            dist, rows = self._flat_search(qs, min(self.lossy_fetch(k), self.capacity), psel_t, b)
        if not self.rescore:
            return dist[:, :k], rows[:, :k]
        rqs, rq_aux = prepare_queries(queries, self.space_type, Quantization.BF16)
        return self._rescore_stage(rows, rqs.to(self.device), rq_aux.to(self.device), k)

    def lossy_fetch(self, k: int, pmax: int | None = None) -> int:
        """The candidates a lossy search fetches for k results, as the JAX
        engine counts them: k rounded up to its bucket, times the
        oversample with rescoring on, capped by the capacity and rounded up
        to a bucket again; from a partition's bucket (``pmax`` rows) the
        same count capped by pmax."""
        kp = k_bucket(k)
        if not self.rescore:
            return kp if pmax is None else min(kp, pmax)
        if pmax is None:
            return k_bucket(min(kp * self.oversample, self.capacity))
        return min(k_bucket(min(kp * self.oversample, pmax)), pmax)

    @hotpath.measure
    def search_collect(self, pending: PendingSearch) -> list[SearchResult]:
        return self._postprocess(pending, pull_packed(pending.packed))

    def collect_many(self, pendings: list[PendingSearch]) -> list[list[SearchResult]]:
        return [self.search_collect(p) for p in pendings]

    def _postprocess(self, pending: PendingSearch, host: np.ndarray) -> list[SearchResult]:
        b_real = pending.b_real
        if pending.is_dist:
            return dist_results(
                host[:b_real, : pending.k], pull_packed(pending.rows)[:b_real, : pending.k], self._epochs_host
            )
        return ids_postprocess(
            self._vecs_host,
            self._epochs_host,
            self.space_type,
            self.dimensions,
            host[:b_real],
            pending.q_f32[:b_real],
            keep_order=not self.rescoring,
        )
