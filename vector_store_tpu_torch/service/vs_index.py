"""VS index actor: owns one device index and schedules device work.

Counterpart of vector_store_tpu/service/vs_index.py (the usearch actor of
the reference, vs_index/usearch.rs). The device serves hundreds of queries
per kernel launch, so the actor's core is a micro-batching loop:

- incoming ANN requests accumulate in a queue; the loop drains whatever is
  pending (bounded by MAX_SEARCH_BATCH) into ONE device search;
- search is prioritized over modifications (the reference's biased recv,
  vs_index/mod.rs:30-45); modify batches apply between search batches, and
  an aged modify preempts new dispatch for one bounded batch;
- searches are pipelined: kernels launch as batches arrive while one
  collector task pulls finished batches. The host engines (simulator,
  OpenSearch) have no search_begin: they take the legacy path, one
  executor call a batch (at most two in flight) that walks the oversample
  ladder itself;
- the engine's rebuild runs as background slices alongside searches, with
  only its swap and re-entry slices exclusive;
- filtered search on a global index takes one of three regimes, chosen by
  the density of the filter's match set (S matching rows of N):
  the post-filter ladder (an oversampled result set is filtered against
  the table, the oversample growing 1 -> 4 -> 16 -> 64, and the step a
  filter needed is remembered for its next queries); the device-masked
  scan, for a filter the ladder proved costly (step >= 16) while
  S >= N/32 (the filter becomes an allow-mask handle on the device and
  the IVF scans rank only matching rows); and the grouped subset-exact
  terminal, for S*64 < N or a filter that exhausted the ladder (one exact
  host pass over the match set for every query of a group). Match sets are
  cached per filter and stamped with the table's mutation count;
- adds are dropped when the memory governor says Cannot (usearch.rs:1156).

Engine choice, as in the JAX package: global F32/F16/BF16/I8 indexes over
euclidean/cosine/dot get the IVF engine ("auto" or "ivf") or the flat
engine ("flat"); every B1 or Hamming index gets the flat engine under
"auto" and "ivf"; "graph" gives a global index of any storage the graph
engine; and a local (per-partition) index of any storage gets the flat
engine whatever the kind says (its partition directory serves a query
naming its partition). ``sim[:search:add-remove:reserve]`` and
``opensearch:<uri>`` give every index the host engine of that name, as in
the JAX package. An engine kind not ported yet (a sharded one on a global
index) raises NotImplementedError naming its ROADMAP.md entry; no other
engine stands in.

The graph engine has no sliced maintenance API (``maintain_pending``): its
delta merges and refinement slices run as the JAX actor runs them, one
exclusive ``maintain(MERGE_BATCH)`` whenever the pipeline is idle.
"""

from __future__ import annotations

import asyncio
import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vector_store_tpu_torch.core.distance import Distance
from vector_store_tpu_torch.core.filters import Restriction
from vector_store_tpu_torch.core.ids import PartitionId, PrimaryId
from vector_store_tpu_torch.core.keys import PrimaryKey
from vector_store_tpu_torch.core.types import IndexMetadata, Quantization, SpaceType
from vector_store_tpu_torch.table import (
    AddDocument,
    AddVector,
    AddVectorBlock,
    Operation,
    RemoveBeforeAddValue,
    RemovePartition,
    RemoveValue,
    Table,
)
from vector_store_tpu_torch.utils import hotpath
from vector_store_tpu_torch.engine.flat import (
    GLOBAL_RESERVE_INCREMENT,
    LOCAL_RESERVE_INCREMENT,
    FlatDeviceIndex,
    SearchResult,
)
from vector_store_tpu_torch.engine.graph import GraphDeviceIndex
from vector_store_tpu_torch.engine.ivf import AllowMaskHandle, IvfDeviceIndex, ivf_supports
from vector_store_tpu_torch.engine.opensearch import OpenSearchIndex
from vector_store_tpu_torch.engine.simulator import SimulatorIndex, parse_delays

logger = logging.getLogger(__name__)

MAX_SEARCH_BATCH = 2048
MAX_MODIFY_BATCH = 8192
MERGE_BATCH = 4096
# a modify that has waited this long (or a full batch) preempts NEW search
# dispatch for one bounded batch, so query load cannot starve ingestion
MODIFY_MAX_AGE_S = 0.10
OVERSAMPLE_STEPS = (4, 16, 64)
MAX_INFLIGHT = 4  # dispatched batches awaiting their pull
LADDER_CACHE_MAX = 4096  # learned oversample steps (per filter)
MATCH_CACHE_MAX = 128  # cached exact match sets (per filter)
# ...and a byte bound: a dense match set is selectivity * N int64s (4 MB at
# 50% of 1M rows), so a count alone could hold hundreds of MB
MATCH_CACHE_MAX_BYTES = 64 << 20
# a filter whose learned step reached this is costly on the ladder: its
# match set is computed once and later queries are filtered on the device
MASKED_MIN_STEP = 16
# ...while the match set is dense enough that the probed clusters still
# hold the limit's true neighbours among matching rows: below 1/32 of the
# table the grouped subset-exact terminal is exact and cheaper
MASKED_MIN_DENOM = 32
ALLOW_CACHE_MAX = 8  # device allow-mask handles (per filter)
# a masked query fetches limit * 2: every candidate already matches, so the
# headroom covers removed or stale rows only
MASKED_OVERSAMPLE = 2
EXCLUSIVE_SLICES = ("swap", "reenter")  # maintenance that mutates serving state


class DimensionMismatch(ValueError):
    """Query vector dimensionality differs from the index
    (vs_index/validator.rs -> HTTP 400)."""


def make_engine(
    metadata: IndexMetadata, engine_kind: str, device: torch.device
) -> IvfDeviceIndex | FlatDeviceIndex | GraphDeviceIndex | SimulatorIndex | OpenSearchIndex:
    """The engine for one index (a host engine for the ``sim`` and
    ``opensearch:`` kinds), or NotImplementedError for what the port does
    not serve yet."""
    vs = metadata.vs_options
    is_local = not metadata.partitioning.is_global
    if is_local and (engine_kind in ("auto", "ivf", "graph") or engine_kind.endswith("-sharded")):
        # local indexes stay on one card's flat engine (the JAX package's
        # routing: the IVF, graph and sharded engines are global-index paths)
        engine_kind = "flat"
    elif engine_kind in ("auto", "ivf") and not ivf_supports(vs.space_type, vs.quantization):
        # B1 storage and Hamming distance: the exact flat engine (its
        # Hamming scan and bf16 rescore tier), as in the JAX package
        engine_kind = "flat"
    if engine_kind.startswith("sim") or engine_kind.startswith("opensearch:"):
        return _host_engine(metadata, engine_kind)
    if engine_kind not in ("auto", "ivf", "flat", "graph"):
        raise NotImplementedError(
            f"engine {engine_kind!r} is not ported yet (ROADMAP.md, port queue: sharded engines)"
        )
    rescoring = vs.rescoring is not False
    oversample = None if vs.oversampling is None else math.ceil(vs.oversampling)
    if engine_kind == "graph":
        return GraphDeviceIndex(
            int(vs.dimensions),
            space_type=vs.space_type,
            quantization=vs.quantization,
            connectivity=int(vs.connectivity),
            expansion_add=int(vs.expansion_add),
            expansion_search=int(vs.expansion_search),
            device=device,
            oversample=oversample,
            rescoring=rescoring,
        )
    if engine_kind == "flat":
        return FlatDeviceIndex(
            int(vs.dimensions),
            space_type=vs.space_type,
            quantization=vs.quantization,
            device=device,
            reserve_increment=LOCAL_RESERVE_INCREMENT if is_local else GLOBAL_RESERVE_INCREMENT,
            **({} if oversample is None else {"oversample": oversample}),
            rescoring=rescoring,
        )
    # expansion_search plays the nprobe role (reference ef_search 64)
    return IvfDeviceIndex(
        int(vs.dimensions),
        space_type=vs.space_type,
        quantization=vs.quantization,
        device=device,
        nprobe=max(8, int(vs.expansion_search) // 2),
        oversample=oversample,
        rescoring=rescoring,
    )


def _host_engine(metadata: IndexMetadata, engine_kind: str) -> SimulatorIndex | OpenSearchIndex:
    """The host engines of the JAX package, chosen as it chooses them:
    ``sim[:search:add-remove:reserve]`` (the reference's usearch simulator,
    an exact numpy engine with delays) and ``opensearch:<uri>`` (a remote
    OpenSearch cluster). Neither holds device state."""
    vs = metadata.vs_options
    if vs.oversampling is not None or vs.rescoring is not None:
        # only the device engines implement the oversample + rescore
        # contract; dropping the options must be visible, not silent
        logger.warning(
            "index %s: oversampling/rescoring options are not supported by "
            "engine %r and were ignored", metadata.key, engine_kind,
        )
    if engine_kind.startswith("sim"):
        spec = engine_kind.partition(":")[2]
        return SimulatorIndex(
            int(vs.dimensions),
            space_type=vs.space_type,
            quantization=vs.quantization,
            delays=parse_delays(spec) if spec else (0.0, 0.0, 0.0),
        )
    return OpenSearchIndex(
        engine_kind.partition(":")[2],
        f"{metadata.keyspace_name}-{metadata.index_name}",
        int(vs.dimensions),
        space_type=vs.space_type,
        quantization=vs.quantization,
        connectivity=int(vs.connectivity),
        expansion_add=int(vs.expansion_add),
        expansion_search=int(vs.expansion_search),
    )


@dataclass
class _SearchRequest:
    vector: np.ndarray
    limit: int
    restrictions: Optional[list[Restriction]]
    future: asyncio.Future
    oversample: int = 1  # grows on the post-filter ladder
    partition: Optional[PartitionId] = None  # local indexes: the query's partition
    sig: Optional[tuple] = None  # the restrictions' signature (cache key)
    masked: bool = False  # rides the device-masked regime


def _restriction_sig(restrictions: list[Restriction]) -> tuple:
    """Order-insensitive hashable signature of a restriction set (the reprs
    of the frozen restriction dataclasses are stable)."""
    return tuple(sorted(repr(r) for r in restrictions))


class VsIndexActor:
    def __init__(
        self,
        metadata: IndexMetadata,
        table: Table,
        memory=None,  # MemoryGovernor | None
        metrics=None,  # Metrics | None
        engine_kind: str = "auto",
        internals=None,  # Internals | None (debug counters)
        *,
        device: torch.device,
    ) -> None:
        self.metadata = metadata
        self.table = table
        self.memory = memory
        self.metrics = metrics
        self.internals = internals
        vs = metadata.vs_options
        self.dimensions = int(vs.dimensions)
        self.space_type = vs.space_type
        self.quantization = vs.quantization
        self.is_local = not metadata.partitioning.is_global
        # an index this port cannot serve stays registered and answers every
        # request with the NotImplementedError (the routes report it)
        self.unsupported: NotImplementedError | None = None
        self.engine = None
        try:
            self.engine = make_engine(metadata, engine_kind, device)
        except NotImplementedError as exc:
            logger.error("index %s cannot be served: %s", metadata.key, exc)
            self.unsupported = exc
        self.engine_kind = engine_kind
        if self.memory is not None and hasattr(self.engine, "device_bytes"):
            self.memory.register_engine(self.engine)
        # engines without search_begin (the host engines) take the legacy
        # one-call-a-batch path
        self._pipelined = hasattr(self.engine, "search_begin")

        self._search_queue: asyncio.Queue = asyncio.Queue()
        self._modify_queue: list[Operation] = []
        self._modify_event = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._stopped = False
        self._dropped_adds = 0
        self._escalations = 0  # post-filter oversample requeues
        self._exact_fallbacks = 0  # exact host-scan completions
        self._masked_dispatches = 0  # requests sent to the device-masked regime
        # learned filtered-search state, keyed by restriction signature:
        # the oversample step each filter needed; the exact match set of
        # filters that reached the terminal or the mask, stamped with
        # table.mutations (any table write invalidates it); the device
        # allow-mask handles of mask-promoted filters (a signature present,
        # even stamp-stale, marks the filter as promoted). Worker threads
        # share them: the lock guards each update; a value is recomputed
        # whole, so a race costs work, never a wrong result
        self._ladder_cache: dict[tuple, int] = {}
        self._match_cache: dict[tuple, tuple[int, np.ndarray]] = {}
        self._match_bytes = 0
        self._allow_cache: dict[tuple, tuple[int, AllowMaskHandle]] = {}
        self._cache_lock = threading.Lock()
        # dispatched (batch, pending) pairs awaiting one collector pass
        self._inflight_collects: list[tuple[list[_SearchRequest], object]] = []
        self._collector: asyncio.Task | None = None
        # background maintenance slice in flight (and its kind)
        self._maintain_fut: asyncio.Future | None = None
        self._maintain_kind: str | None = None
        self._modify_oldest = 0.0  # enqueue time of the oldest unapplied modify

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self.engine is not None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stopped = True
        self._modify_event.set()
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass

    # -- public API (VsIndexSearch/Modify parity, vs_index/actor.rs) ----------

    async def ann(self, vector: list[float], limit: int) -> list[tuple[PrimaryKey, Distance]]:
        return await self._submit(vector, limit, None)

    async def ann_many(self, vectors: np.ndarray, limit: int) -> list[list[tuple[PrimaryKey, Distance]]]:
        """Bulk unfiltered ANN: n queries submitted together, so they
        coalesce into the same device batches (one await for the caller)."""
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        return await asyncio.gather(*(self._submit(v, limit, None) for v in vectors))

    async def filtered_ann(
        self, vector: list[float], restrictions: list[Restriction], limit: int
    ) -> list[tuple[PrimaryKey, Distance]]:
        partition = None
        if self.is_local and self.unsupported is None:
            routed = self.table.partition_id(self.metadata.key, restrictions)
            if routed is None:
                # unknown partition -> empty result (the reference resolves
                # the partition from Eq restrictions, usearch.rs:781-864)
                return []
            partition, restrictions = routed
        return await self._submit(vector, limit, restrictions, partition)

    async def count(self) -> int:
        if self.unsupported is not None:
            raise self.unsupported
        return self.engine.size

    def apply_operations(self, ops: list[Operation]) -> None:
        """Called by the monitor_items pump."""
        if self.engine is None:
            return  # unsupported index: nothing to apply the rows to
        if not self._modify_queue:
            self._modify_oldest = time.monotonic()
        self._modify_queue.extend(ops)
        self._modify_event.set()

    @property
    def backlog(self) -> int:
        return len(self._modify_queue)

    # -- scheduling -------------------------------------------------------------

    async def _submit(self, vector, limit, restrictions, partition=None):
        if self.unsupported is not None:
            raise self.unsupported
        v = np.asarray(vector, dtype=np.float32)
        if v.ndim != 1 or v.shape[0] != self.dimensions:
            raise DimensionMismatch(
                f"Invalid query vector size {v.shape[-1] if v.ndim else 0}, "
                f"expected {self.dimensions}"
            )
        fut = asyncio.get_running_loop().create_future()
        req = _SearchRequest(v, limit, restrictions or None, fut, partition=partition)
        if req.restrictions:
            # a filter seen before starts at the step it needed last time
            req.sig = _restriction_sig(req.restrictions)
            req.oversample = self._ladder_cache.get(req.sig, 1)
        await self._search_queue.put(req)
        return await fut

    async def _run(self) -> None:
        """Scheduling loop: dispatch searches first (pipelined), apply aged
        or drained modifies, run maintenance slices (concurrent ones beside
        searches, the swap/re-entry ones exclusively), else wait."""
        loop = asyncio.get_running_loop()
        inflight: set[asyncio.Future] = set()
        has_pending_api = hasattr(self.engine, "maintain_pending")
        # the graph engine: maintain() without the sliced API. Its slices run
        # exclusively, one whenever the pipeline is idle, until one finds no
        # work; a modify batch makes the next one due
        whole_maintain = hasattr(self.engine, "maintain") and not has_pending_api
        whole_due = whole_maintain
        maintain_recheck = 0.0  # throttle for the idle maintain_pending scan
        exclusive_after = 0.0  # grace window between exclusive slices

        def modify_ok() -> bool:
            """May a modify batch apply now? Always without a maintenance
            slice in flight; beside every slice but the `start` snapshot
            (which reads the host tables a modify writes) for engines that
            track mid-build mutations."""
            if self._maintain_fut is None:
                return True
            return (
                getattr(self.engine, "maintain_modify_safe", False)
                and self._maintain_kind != "start"
            )

        def _maintain_done(f: asyncio.Future) -> None:
            self._maintain_fut = None
            self._maintain_kind = None
            if not f.cancelled() and f.exception() is not None:
                logger.error(
                    "background maintenance slice failed", exc_info=f.exception()
                )
            self._modify_event.set()  # wake the idle wait

        def launch_legacy(batch: list[_SearchRequest]) -> None:
            fut = loop.run_in_executor(None, self._execute_search_batch, batch)

            def _done(f: asyncio.Future, batch=batch) -> None:
                inflight.discard(f)
                exc = f.exception() if not f.cancelled() else None
                if exc is not None:
                    for req in batch:
                        if not req.future.done():
                            req.future.set_exception(exc)

            fut.add_done_callback(_done)
            inflight.add(fut)

        def launch(batches: list[list[_SearchRequest]]) -> asyncio.Future:
            fut = loop.run_in_executor(None, self._begin_window, batches)

            def _done(f: asyncio.Future, batches=batches) -> None:
                inflight.discard(f)
                if f.cancelled():
                    return
                exc = f.exception()
                if exc is not None:
                    for b in batches:
                        for req in b:
                            if not req.future.done():
                                req.future.set_exception(exc)
                    return
                self._inflight_collects.extend(f.result())
                if self._collector is None or self._collector.done():
                    self._collector = loop.create_task(self._collect_loop())

            fut.add_done_callback(_done)
            inflight.add(fut)
            return fut

        while not self._stopped:
            # 0) background maintenance: every slice but swap/reenter runs
            # beside live searches, so rebuilds progress under load
            now = loop.time()
            kind = None
            if has_pending_api and self._maintain_fut is None and now >= maintain_recheck:
                kind = self.engine.maintain_pending()
                if kind is None:
                    # idle: look again after the next state change, and not
                    # more often than this under search load
                    maintain_recheck = now + 0.05
                elif kind not in EXCLUSIVE_SLICES:
                    self._maintain_kind = kind
                    fut = loop.run_in_executor(None, self.engine.maintain, 1)
                    fut.add_done_callback(_maintain_done)
                    self._maintain_fut = fut
            # exclusive slices stop new dispatch, drain, and run in step 3;
            # after one, a grace window lets queued searches dispatch first
            swap_due = kind in EXCLUSIVE_SLICES and now >= exclusive_after
            wake_at = exclusive_after if kind in EXCLUSIVE_SLICES and not swap_due else None

            modify_due = (
                self._modify_queue
                and modify_ok()
                and (
                    time.monotonic() - self._modify_oldest >= MODIFY_MAX_AGE_S
                    or len(self._modify_queue) >= MAX_MODIFY_BATCH
                )
            )

            # 1) searches first (biased recv)
            searches = not swap_due and not modify_due and not self._search_queue.empty()
            if searches and self._pipelined and len(inflight) + len(self._inflight_collects) < MAX_INFLIGHT:
                batches = [self._drain_searches()]
                while not self._search_queue.empty() and len(batches) < MAX_INFLIGHT:
                    batches.append(self._drain_searches())
                await launch(batches)
                continue
            if searches and not self._pipelined and len(inflight) < 2:
                launch_legacy(self._drain_searches())
                continue

            if inflight:
                await asyncio.wait(inflight, return_when=asyncio.FIRST_COMPLETED)
                continue
            if self._collector is not None and not self._collector.done():
                # a pull is in flight; new searches may still arrive
                getter = asyncio.ensure_future(self._search_queue.get())
                done, _ = await asyncio.wait(
                    [getter, self._collector], return_when=asyncio.FIRST_COMPLETED
                )
                if getter in done:
                    self._search_queue.put_nowait(getter.result())
                else:
                    getter.cancel()
                    try:
                        await getter
                    except (asyncio.CancelledError, Exception):
                        pass
                continue

            # 2) modifications (pipeline drained)
            if self._modify_queue and modify_ok():
                ops = self._modify_queue[:MAX_MODIFY_BATCH]
                del self._modify_queue[: len(ops)]
                self._modify_oldest = time.monotonic()
                try:
                    await loop.run_in_executor(None, self._apply_ops_batch, ops)
                except Exception:
                    # a poisoned batch must not kill the actor loop
                    logger.exception("dropping modify batch of %d ops after failure", len(ops))
                maintain_recheck = 0.0  # the batch may have made a rebuild due
                whole_due = whole_maintain
                continue

            # 3) exclusive maintenance (swap / re-entry slices)
            if swap_due:
                try:
                    await loop.run_in_executor(None, self.engine.maintain, MERGE_BATCH)
                except Exception:
                    logger.exception("exclusive maintenance slice failed")
                exclusive_after = loop.time() + 0.25
                maintain_recheck = 0.0
                continue
            if whole_due:
                # the JAX actor stamps its recheck throttle 0.25 s ahead after
                # such a slice; the throttle gates the sliced API only, so
                # the next slice follows as soon as the pipeline is idle
                # again (queued searches dispatch first, in step 1)
                try:
                    whole_due = await loop.run_in_executor(None, self.engine.maintain, MERGE_BATCH)
                except Exception:
                    logger.exception("exclusive maintenance slice failed")
                    whole_due = False
                continue

            # idle: wait for work (clear-then-recheck against lost wakeups)
            self._modify_event.clear()
            if not self._search_queue.empty() or (self._modify_queue and modify_ok()):
                continue
            getter = asyncio.ensure_future(self._search_queue.get())
            waiter = asyncio.ensure_future(self._modify_event.wait())
            timeout = None if wake_at is None else max(0.0, wake_at - loop.time())
            try:
                done, pending = await asyncio.wait(
                    [getter, waiter], timeout=timeout, return_when=asyncio.FIRST_COMPLETED
                )
            except asyncio.CancelledError:
                getter.cancel()
                waiter.cancel()
                raise
            for p in pending:
                p.cancel()
                try:
                    await p
                except (asyncio.CancelledError, Exception):
                    pass
            if getter in done:
                self._search_queue.put_nowait(getter.result())

    def _drain_searches(self) -> list[_SearchRequest]:
        batch: list[_SearchRequest] = []
        while len(batch) < MAX_SEARCH_BATCH:
            try:
                batch.append(self._search_queue.get_nowait())
            except asyncio.QueueEmpty:
                break
        return batch

    async def _collect_loop(self) -> None:
        """Drains in-flight searches until none remain (one at a time)."""
        loop = asyncio.get_running_loop()
        while self._inflight_collects and not self._stopped:
            items = self._inflight_collects
            self._inflight_collects = []
            try:
                await loop.run_in_executor(None, self._collect_batches, items)
            except Exception as exc:
                for batch, _ in items:
                    for req in batch:
                        if not req.future.done():
                            req.future.set_exception(exc)

    # executed in a worker thread
    @hotpath.measure
    def _begin_window(self, batches: list[list[_SearchRequest]]):
        """Triage the filtered requests, then launch one device search per
        batch and per masked filter group (no waiting). With S rows
        matching a filter of a global index of N rows:

        - S * 64 < N: the grouped subset-exact terminal, no device work
          (the ladder's top step could not find limit matches);
        - S >= N / 32 and the filter proved costly on the ladder (learned
          step >= 16) or was promoted before: the device-masked scan at
          k = limit * 2, one search per filter with its allow-mask handle;
        - otherwise the post-filter ladder.

        A filter's match set is computed only once it reaches the terminal
        or the mask, once per table mutation stamp."""
        direct: list[_SearchRequest] = []
        masked_groups: dict[tuple, list[_SearchRequest]] = {}
        can_mask = hasattr(self.engine, "upload_allow_mask")
        if not self.is_local and (self._match_cache or can_mask):
            stamp = self.table.mutations
            n_total = max(self.engine.size, 1)
            kept: list[list[_SearchRequest]] = []
            for batch in batches:
                keep: list[_SearchRequest] = []
                for req in batch:
                    if req.sig is None:
                        keep.append(req)
                        continue
                    # promotion needs an allow-cache slot: under traffic of
                    # ever new filters the rest stay on the ladder, which
                    # keeps no device state per filter
                    promoted = req.sig in self._allow_cache
                    want_mask = can_mask and (
                        promoted
                        or (len(self._allow_cache) < ALLOW_CACHE_MAX and req.oversample >= MASKED_MIN_STEP)
                    )
                    hit = self._match_cache.get(req.sig)
                    slots = hit[1] if hit is not None and hit[0] == stamp else None
                    if slots is None and want_mask:
                        slots = self._matching_slots_stamped(req, stamp)
                    if slots is None:
                        keep.append(req)
                    elif slots.size * OVERSAMPLE_STEPS[-1] < n_total:
                        direct.append(req)
                    elif want_mask and slots.size * MASKED_MIN_DENOM >= n_total:
                        if not req.masked:
                            req.masked = True
                            req.oversample = MASKED_OVERSAMPLE
                        masked_groups.setdefault(req.sig, []).append(req)
                    else:
                        keep.append(req)
                kept.append(keep)
            batches = kept
        if direct:
            self._finish_terminal(direct)
        units: list[tuple[list[_SearchRequest], AllowMaskHandle | None]] = [
            (b, None) for b in batches if b
        ]
        if masked_groups:
            stamp = self.table.mutations
            for sig, group in masked_groups.items():
                units.append((group, self._allow_handle(sig, group[0], stamp)))
                self._masked_dispatches += len(group)
                self._count("masked_dispatches", len(group))
        out = []
        for batch, handle in units:
            k = max(r.limit * r.oversample for r in batch)
            k = min(k, max(self.engine.size, 1))
            queries = np.stack([r.vector for r in batch])
            if handle is None:
                pending = self.engine.search_begin(queries, k, self._partitions(batch))
            else:
                pending = self.engine.search_begin(queries, k, allow_mask=handle)
            out.append((batch, pending))
        return out

    # executed in a worker thread
    def _matching_slots_stamped(self, req: _SearchRequest, stamp: int) -> np.ndarray:
        """The filter's match set, computed (one O(N) host pass) and cached
        under ``stamp``; the cache is an LRU bounded by count and bytes."""
        pid = PartitionId.global_for(self.table.index_id(self.metadata.key))
        slots = self.table.matching_slots(pid, req.restrictions or [])
        with self._cache_lock:
            old = self._match_cache.pop(req.sig, None)
            if old is not None:
                self._match_bytes -= old[1].nbytes
            while self._match_cache and (
                len(self._match_cache) >= MATCH_CACHE_MAX
                or self._match_bytes + slots.nbytes > MATCH_CACHE_MAX_BYTES
            ):
                _, evicted = self._match_cache.pop(next(iter(self._match_cache)))
                self._match_bytes -= evicted.nbytes
            self._match_cache[req.sig] = (stamp, slots)
            self._match_bytes += slots.nbytes
        return slots

    def _fresh_match_set(self, sig: tuple, req: _SearchRequest, stamp: int) -> np.ndarray:
        """The filter's match set at ``stamp``: cached, or computed now (a
        concurrent window may have evicted or re-stamped the entry)."""
        hit = self._match_cache.get(sig)
        return hit[1] if hit is not None and hit[0] == stamp else self._matching_slots_stamped(req, stamp)

    # executed in a worker thread
    def _allow_handle(self, sig: tuple, req: _SearchRequest, stamp: int) -> AllowMaskHandle:
        """The stamp-fresh allow-mask handle of a mask-promoted filter. The
        handle keeps its device state across searches; a table mutation
        makes a new one from the refreshed match set, so rows written since
        are reachable."""
        hit = self._allow_cache.get(sig)
        if hit is not None and hit[0] == stamp:
            return hit[1]
        slots = self._fresh_match_set(sig, req, stamp)
        mask = np.zeros((int(slots.max()) + 1 if slots.size else 1,), dtype=bool)
        mask[slots] = True
        handle = self.engine.upload_allow_mask(mask)
        with self._cache_lock:
            self._allow_cache.pop(sig, None)  # LRU: a re-stamp moves it to the end
            if len(self._allow_cache) >= ALLOW_CACHE_MAX:
                self._allow_cache.pop(next(iter(self._allow_cache)))
            self._allow_cache[sig] = (stamp, handle)
        return handle

    # executed in a worker thread
    @hotpath.measure
    def _collect_batches(self, items) -> None:
        """Pull and resolve every in-flight batch. Filtered requests whose
        post-filtered results come up short are requeued with a larger
        oversample; past the top step they finish on the terminal. An
        unmasked filter's step is remembered when it finishes."""
        all_results = self.engine.collect_many([p for _, p in items])
        finished: list[tuple[_SearchRequest, list]] = []
        requeue: list[_SearchRequest] = []
        terminal: list[_SearchRequest] = []
        loop = None
        for (batch, _), results in zip(items, all_results):
            k_used = max(r.limit * r.oversample for r in batch)
            for req, res in zip(batch, results):
                loop = loop or req.future.get_loop()
                resolved = self._resolve(req, res)
                if len(resolved) >= req.limit or self._exhausted(req, res, k_used):
                    finished.append((req, resolved[: req.limit]))
                    if req.sig is not None and not req.masked:
                        # a masked request ran pre-filtered: its small
                        # oversample says nothing about the ladder
                        self._remember_ladder(req.sig, req.oversample)
                elif req.oversample >= OVERSAMPLE_STEPS[-1]:
                    if req.sig is not None and not req.masked:
                        self._remember_ladder(req.sig, OVERSAMPLE_STEPS[-1])
                    terminal.append(req)
                else:
                    req.oversample = next(s for s in OVERSAMPLE_STEPS if s > req.oversample)
                    self._escalations += 1
                    self._count("oversample_escalations")
                    requeue.append(req)
        if terminal:
            self._finish_terminal(terminal)
        if loop is not None and (finished or requeue):
            # one loop wakeup for the whole collect
            loop.call_soon_threadsafe(self._finish_many, finished, requeue)

    def _finish_many(self, finished, requeue) -> None:
        for req, result in finished:
            if not req.future.done():
                req.future.set_result(result)
        for req in requeue:
            if not req.future.done():
                self._search_queue.put_nowait(req)
        if requeue:
            self._modify_event.set()  # wake the scheduler if idle

    # executed in a worker thread
    @hotpath.measure
    def _execute_search_batch(self, batch: list[_SearchRequest]) -> None:
        """The legacy path (engines without search_begin): the batch walks
        the oversample ladder with one engine search a rung, each request
        entering at the rung its filter learned. A repeat filter whose
        fresh match set is ladder-hopeless (S * 64 < N) goes straight to the
        grouped subset-exact terminal, as _begin_window triages it; a
        request that exhausts the ladder ends there too."""
        pending = batch
        if not self.is_local and self._match_cache and hasattr(self.engine, "search_exact_host_subset"):
            stamp = self.table.mutations
            n_total = max(self.engine.size, 1)
            direct: list[_SearchRequest] = []
            keep: list[_SearchRequest] = []
            for req in pending:
                hit = self._match_cache.get(req.sig) if req.sig is not None else None
                if hit is not None and hit[0] == stamp and hit[1].size * OVERSAMPLE_STEPS[-1] < n_total:
                    direct.append(req)
                else:
                    keep.append(req)
            if direct:
                self._finish_terminal(direct)
            pending = keep
        for step in (1,) + OVERSAMPLE_STEPS:
            ready = [r for r in pending if r.oversample <= step]
            if not ready:
                continue
            k = min(max(r.limit * step for r in ready), max(self.engine.size, 1))
            results = self.engine.search(np.stack([r.vector for r in ready]), k, self._partitions(ready))
            later = [r for r in pending if r.oversample > step]
            pending = []
            for req, res in zip(ready, results):
                resolved = self._resolve(req, res)
                if len(resolved) >= req.limit or self._exhausted(req, res, k):
                    if req.sig is not None:
                        req.oversample = step  # the rung that answered
                        self._remember_ladder(req.sig, step)
                    self._finish(req, resolved[: req.limit])
                else:
                    self._escalations += 1
                    self._count("oversample_escalations")
                    pending.append(req)
            pending += later
        if pending:  # the ladder is exhausted
            for req in pending:
                if req.sig is not None:
                    self._remember_ladder(req.sig, OVERSAMPLE_STEPS[-1])
            self._finish_terminal(pending)

    def _count(self, name: str, amount: int = 1) -> None:
        """Mirror a filtered-path counter into /api/internals/counters."""
        if self.internals is not None:
            self.internals.increment(f"vs_index_{name}", amount)

    def _remember_ladder(self, sig: tuple, step: int) -> None:
        with self._cache_lock:
            if len(self._ladder_cache) >= LADDER_CACHE_MAX and sig not in self._ladder_cache:
                self._ladder_cache.pop(next(iter(self._ladder_cache)))  # one cold entry
            self._ladder_cache[sig] = step

    def _partitions(self, batch: list[_SearchRequest]) -> np.ndarray | None:
        """Per-query partition slots of a local index's batch (-1 none)."""
        if not self.is_local:
            return None
        return np.asarray(
            [r.partition.slot if r.partition else -1 for r in batch], dtype=np.int32
        )

    def _exhausted(self, req: _SearchRequest, res, k_used: int) -> bool:
        """Has the whole candidate population been considered? For a
        partitioned (local) query that is the partition, whose size the
        flat engine's directory reads in O(1)."""
        if res.slots.size >= self.engine.size or k_used >= self.engine.size:
            return True
        if req.partition is not None and hasattr(self.engine, "partition_count"):
            return k_used >= max(self.engine.partition_count(req.partition.slot), 1)
        return False

    # executed in a worker thread
    def _finish_terminal(self, reqs: list[_SearchRequest]) -> None:
        """Terminal of ladder-exhausted and sparse filtered requests,
        grouped by signature: one (cached) match set a filter and one exact
        host pass over just those rows for the whole group, O(S * d) once
        instead of O(N * d) a query. Requests of local indexes, without a
        signature, or on an engine without the subset scan finish on
        ``_finish_last``."""
        groups: dict[tuple, list[_SearchRequest]] = {}
        fallback: list[_SearchRequest] = []
        subset = not self.is_local and hasattr(self.engine, "search_exact_host_subset")
        for req in reqs:
            if subset and req.sig is not None:
                groups.setdefault(req.sig, []).append(req)
            else:
                fallback.append(req)
        if groups:
            pid = PartitionId.global_for(self.table.index_id(self.metadata.key))
            stamp = self.table.mutations
            for sig, group in groups.items():
                slots = self._fresh_match_set(sig, group[0], stamp)
                self._exact_fallbacks += len(group)
                self._count("exact_host_fallbacks", len(group))
                if slots.size == 0:
                    for req in group:
                        self._finish(req, [])
                    continue
                dists, epochs = self.engine.search_exact_host_subset(
                    np.stack([r.vector for r in group]), slots
                )
                for req, drow in zip(group, dists):
                    self._finish_subset(req, slots, drow, epochs, pid)
        for req in fallback:
            self._finish_last(req)

    def _finish_subset(
        self,
        req: _SearchRequest,
        slots: np.ndarray,
        drow: np.ndarray,
        epochs: np.ndarray,
        pid: PartitionId,
    ) -> None:
        """Resolve one request from its distances to the match set. Rows
        are validated again (epoch and restrictions), so a write since the
        match set's stamp costs a wider pass, never a wrong result."""
        kk = min(max(req.limit * 2, req.limit + 8), slots.size)
        while True:
            if kk >= slots.size:
                order = np.argsort(drow, kind="stable")
            else:
                part = np.argpartition(drow, kk - 1)[:kk]
                order = part[np.argsort(drow[part], kind="stable")]
            out: list[tuple[PrimaryKey, Distance]] = []
            for j in order:
                if not np.isfinite(drow[j]):
                    break
                primary_id = PrimaryId.new(int(slots[j]), int(epochs[j]))
                if req.restrictions and not all(
                    self.table.is_valid_for(pid, primary_id, r) for r in req.restrictions
                ):
                    continue
                pk = self.table.primary_key(pid, primary_id)
                if pk is None:
                    continue
                out.append((pk, self._distance(float(drow[j]))))
                if len(out) >= req.limit:
                    break
            if len(out) >= req.limit or kk >= slots.size:
                break
            kk = min(slots.size, kk * 4)
        self._finish(req, out[: req.limit])

    # executed in a worker thread
    def _finish_last(self, req: _SearchRequest) -> None:
        """Oversample steps exhausted. The IVF engine ranks the whole index
        exactly on the host mirror (its device path caps candidates at
        nprobe*128 per query), then post-filters in bounded chunks; the flat
        engine searches its candidate population (a local query's partition)
        with a growing k until enough rows pass."""
        self._exact_fallbacks += 1
        self._count("exact_host_fallbacks")
        if not hasattr(self.engine, "search_exact_host"):
            size = max(self.engine.size, 1)
            if req.partition is not None and hasattr(self.engine, "partition_count"):
                size = max(min(size, self.engine.partition_count(req.partition.slot)), 1)
            k = min(size, req.limit * OVERSAMPLE_STEPS[-1] * 4)
            while True:
                res = self.engine.search(req.vector[None, :], k, self._partitions([req]))[0]
                resolved = self._resolve(req, res)
                if len(resolved) >= req.limit or k >= size or res.slots.size >= size:
                    self._finish(req, resolved[: req.limit])
                    return
                k = min(size, k * 4)
        res = self.engine.search_exact_host(req.vector, self.engine.size)
        out: list = []
        step = max(req.limit * OVERSAMPLE_STEPS[-1], 1024)
        for lo in range(0, res.slots.size, step):
            chunk = slice(lo, lo + step)
            out.extend(
                self._resolve(
                    req,
                    SearchResult(res.slots[chunk], res.epochs[chunk], res.distances[chunk]),
                )
            )
            if len(out) >= req.limit:
                break
        self._finish(req, out[: req.limit])

    def _resolve(self, req: _SearchRequest, res: SearchResult) -> list:
        """Slot/epoch hits -> (PrimaryKey, Distance), dropping stale epochs
        and rows failing the restrictions (usearch.rs:1067-1154)."""
        out: list[tuple[PrimaryKey, Distance]] = []
        pid = req.partition or PartitionId.global_for(self.table.index_id(self.metadata.key))
        for slot, epoch, dist in zip(res.slots, res.epochs, res.distances):
            primary_id = PrimaryId.new(int(slot), int(epoch))
            if req.restrictions and not all(
                self.table.is_valid_for(pid, primary_id, r) for r in req.restrictions
            ):
                continue
            pk = self.table.primary_key(pid, primary_id)
            if pk is None:
                continue
            out.append((pk, self._distance(float(dist))))
        return out

    def _distance(self, d: float) -> Distance:
        """The engine's distance as the API reports it. A B1 index reports a
        Hamming distance: the rounded engine distance, which with rescoring
        on is the rescore tier's distance in the declared space (the JAX
        package's behaviour, kept)."""
        st = self.space_type
        if self.quantization is Quantization.B1:
            st = SpaceType.HAMMING
        if st is SpaceType.HAMMING:
            return Distance(float(max(0.0, round(d))), st, self.dimensions)
        if st is SpaceType.COSINE:
            d = min(max(d, 0.0), 2.0)
        elif st is SpaceType.EUCLIDEAN:
            d = max(d, 0.0)
        return Distance(d, st)

    def _finish(self, req: _SearchRequest, result) -> None:
        loop = req.future.get_loop()
        loop.call_soon_threadsafe(
            lambda: req.future.set_result(result) if not req.future.done() else None
        )

    # executed in a worker thread
    @hotpath.measure
    def _apply_ops_batch(self, ops: list[Operation]) -> None:
        """Batch Operation deltas into bulk device calls."""
        can_add = self.memory.can_allocate if self.memory is not None else True
        add_slots: list[int] = []
        add_epochs: list[int] = []
        add_vecs: list[np.ndarray] = []
        add_parts: list[int] = []  # partition slot per add (read for local indexes)
        remove_slots: list[int] = []
        seen_add: dict[int, int] = {}  # slot -> position in add arrays
        rm_before_add: set[int] = set()  # slots whose old value must go away
        blocks: list[AddVectorBlock] = []  # columnar bulk inserts (fresh slots)

        for op in ops:
            if isinstance(op, AddVectorBlock):
                if not can_add:
                    self._dropped_adds += len(op)
                elif op.vectors.shape[1] != self.dimensions:
                    logger.warning(
                        "dropping %d-row bulk insert with wrong dimensions %d != %d",
                        len(op), op.vectors.shape[1], self.dimensions,
                    )
                else:
                    blocks.append(op)
            elif isinstance(op, AddVector):
                if not can_add:
                    self._dropped_adds += 1
                    continue
                vec = np.asarray(op.vector, dtype=np.float32)
                if vec.shape[0] != self.dimensions:
                    logger.warning(
                        "dropping vector with wrong dimensions %d != %d",
                        vec.shape[0], self.dimensions,
                    )
                    continue
                slot = op.primary_id.slot
                part = op.partition_id.slot
                pos = seen_add.get(slot)
                if pos is not None:  # LWW within the batch
                    add_epochs[pos] = op.primary_id.epoch
                    add_vecs[pos] = vec
                    add_parts[pos] = part
                else:
                    seen_add[slot] = len(add_slots)
                    add_slots.append(slot)
                    add_epochs.append(op.primary_id.epoch)
                    add_vecs.append(vec)
                    add_parts.append(part)
            elif isinstance(op, RemoveValue):
                slot = op.primary_id.slot
                pos = seen_add.pop(slot, None)
                if pos is not None:  # add then remove within one batch
                    add_slots[pos] = -1
                remove_slots.append(slot)
            elif isinstance(op, RemoveBeforeAddValue):
                # the paired add overwrites the slot with a new epoch, but it
                # may be dropped (memory gate, wrong dims): remember the slot
                rm_before_add.add(op.primary_id.slot)
            elif isinstance(op, RemovePartition):
                continue  # an emptied partition simply holds no rows
            elif isinstance(op, AddDocument):
                logger.warning("AddDocument sent to a VS index; ignoring")

        # RemoveBeforeAddValue whose paired add did not land: remove the
        # old-epoch vector explicitly
        landed = {add_slots[p] for p in seen_add.values() if add_slots[p] >= 0}
        remove_slots.extend(rm_before_add - landed)
        if remove_slots:
            self.engine.remove_batch(np.asarray(remove_slots, dtype=np.int64))
        # ONE engine dispatch for per-row adds and columnar blocks together
        # (block slots are fresh and unique: Table.upsert_scan)
        live = [i for i, s in enumerate(add_slots) if s >= 0]
        if live or blocks:
            slots = [b.slots for b in blocks]
            epochs = [b.epochs for b in blocks]
            vecs = [b.vectors for b in blocks]
            parts = [np.full((len(b),), b.partition_id.slot, dtype=np.int32) for b in blocks]
            if live:
                slots.append(np.asarray([add_slots[i] for i in live], dtype=np.int64))
                epochs.append(np.asarray([add_epochs[i] for i in live], dtype=np.int32))
                vecs.append(np.stack([add_vecs[i] for i in live]))
                parts.append(np.asarray([add_parts[i] for i in live], dtype=np.int32))
            self.engine.upsert_batch(
                np.concatenate(slots),
                np.concatenate(epochs),
                np.concatenate(vecs),
                partitions=np.concatenate(parts) if self.is_local else None,
            )
