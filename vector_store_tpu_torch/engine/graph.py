"""Device-resident navigable-graph ANN index with lockstep beam search.

Counterpart of vector_store_tpu/engine/graph.py (``ENGINE=graph``): the
whole query batch traverses a fixed-degree graph in lockstep instead of
one CPU thread chasing pointers per query (the reference's USearch HNSW,
vs_index/usearch.rs):

- adjacency lives on the device as a padded [cap, degree] int32 tensor;
- each round expands the ``expand`` best unexpanded beam candidates of
  every query at once: one [B, expand, degree] neighbour gather, one
  batched distance contraction, one beam merge;
- tombstones and filters mask the result accumulator but never the beam,
  so traversal routes through deleted or filtered nodes.

New vectors are searchable at once through an exact delta (the store's
scan restricted to the not-yet-merged slots) and are wired into the graph
by batched merges: exact construction candidates from the store's scan
among the merged nodes (kernel 1 for float storage), a batched Vamana
alpha prune, hash-random bridges in a protected tail of every row, and a
reverse-edge repair. An empty graph with a large contiguous backlog is
built in three device passes instead (``bulk_build_device``: exact kNN of
the stored rows themselves through kernel 1, a prune per chunk, one
whole-graph reverse pass).

The store is the port's FlatDeviceIndex. Its float storage keeps an f32
host mirror, so beam results resolve as ids with exact f32 host
distances (the JAX package's TPU path); I8 and B1 storage scan by their
own distances, and with rescoring on the graph keeps an f32 mirror of its
own to re-rank the oversampled beam. The store has no device validity or
epoch tensor: a dead slot's ``b`` is INVALID_BIAS, and epochs resolve on
the host at collect.

Every selection breaks ties as ``lax.top_k`` does, to the lower position
(``ops/topk.py::stable_min_k``), and every multi-key sort is a chain of
stable sorts, so on the same inputs the port's passes give the JAX
package's rows. The JAX package's batch and entry padding for its jit
shapes is left out, but for two sizes that change results: the k bucket
(it sets the beam width, ``ef = max(ef, k_pad)``) and the entry bucket
(an entry set narrower than the beam starts it unsorted).

The preview-guided traversal of the JAX package
(``_graph_beam_search_preview``) is not ported: it measured recall
0.37-0.38 against 0.9664 (PARITY.md) and was rejected.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from vector_store_tpu_torch.core.types import Quantization, SpaceType
from vector_store_tpu_torch.engine.flat import (
    GLOBAL_RESERVE_INCREMENT,
    FlatDeviceIndex,
    PendingSearch,
    SearchResult,
    dist_results,
    ids_postprocess,
    k_bucket,
    normalize_rows,
    pull_packed,
)
from vector_store_tpu_torch.ops.distance import (
    pairwise_distance,
    prepare_queries,
    query_block_distance,
)
from vector_store_tpu_torch.ops.fused_scan import INVALID_CUTOFF, rank_to_distance
from vector_store_tpu_torch.ops.quantize import I8_SCALE, unpack_b1
from vector_store_tpu_torch.ops.topk import merge_min_k, min_k, stable_min_k
from vector_store_tpu_torch.utils import hotpath

DEFAULT_ENTRIES = 32
# result width of a beam search: k (times the oversample) rounded up to
# one of flat.K_BUCKETS; the beam is at least this wide (the JAX package's
# k buckets, kept because they decide the beam's width and so the recall)
INF = float("inf")


def _lex_order(primary: torch.Tensor, secondary: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Positions that sort by (primary, secondary) along ``dim``, ties kept
    in place: lax.sort with num_keys=2, as two stable sorts."""
    first = torch.sort(secondary, dim=dim, stable=True).indices
    second = torch.sort(torch.gather(primary, dim, first), dim=dim, stable=True).indices
    return torch.gather(first, dim, second)


@dataclass
class GraphPendingSearch:
    """In-flight graph search: the beam's results and the exact delta
    scan, pulled together at collect time."""

    graph_d: torch.Tensor | None  # [B, k_pad] f32 beam distances
    graph_i: torch.Tensor | None  # [B, k'] i32 beam slots (-1 empty)
    delta_pending: PendingSearch | None
    b_real: int
    k: int
    # ids mode (float storage): distances resolve from the store's f32
    # host mirror, epochs from its epoch mirror
    graph_ids: bool = False
    q_f32: np.ndarray | None = None  # [B, D] queries, normalized for cosine
    k_fetch: int = 0  # the oversampled fetch width (k x oversample)


def graph_beam_search(
    vectors: torch.Tensor,  # [cap, Dp] storage dtype
    aux: torch.Tensor,  # [cap] f32
    valid: torch.Tensor,  # [cap] bool
    allow: torch.Tensor,  # [cap] bool (True = may appear in results)
    adjacency: torch.Tensor,  # [cap, deg] i32, -1 padded
    entries: torch.Tensor,  # [E] i32, -1 padded
    queries: torch.Tensor,  # [B, Dp] storage dtype
    q_aux: torch.Tensor,  # [B] f32
    *,
    space: SpaceType,
    quant: Quantization,
    k: int,
    beam_width: int,
    iters: int,
    filtered: bool,
    expand: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lockstep beam search (the JAX package's _graph_beam_search).
    ``iters`` is the total expansion budget; ``expand`` nodes are expanded
    a round (rounds = iters / expand), and neighbours drawn from the same
    round's lists are dedup'd so the beam and the result never hold an id
    twice. Returns (dist [B, k] f32 ascending, slot [B, k] i32, -1 where
    the distance is not finite)."""
    b = queries.shape[0]
    e = entries.shape[0]
    deg = adjacency.shape[1]
    el = beam_width
    ex = max(1, min(expand, el))
    rounds = max(1, iters // ex)
    dev = queries.device

    # the beam starts from the entry points
    evalid = entries >= 0
    esafe = torch.clamp(entries, min=0).long()
    d0 = pairwise_distance(queries, vectors[esafe], space, quant, q_aux, aux[esafe])
    d0 = torch.where(evalid[None, :], d0, INF)
    eids = entries[None, :].expand(b, e)
    if el > e:
        beam_d = torch.cat([d0, d0.new_full((b, el - e), INF)], dim=1)
        beam_i = torch.cat([eids, eids.new_full((b, el - e), -1)], dim=1)
    else:
        beam_d, beam_i = min_k(d0, eids, el, stable=True)
    expanded = torch.zeros((b, el), dtype=torch.bool, device=dev)

    # the result accumulator sees only live (and allowed) nodes
    res_ok0 = valid[esafe] & evalid
    if filtered:
        res_ok0 = res_ok0 & allow[esafe]
    res_d, res_i = min_k(torch.where(res_ok0[None, :], d0, INF), eids, k, stable=True)

    visited = torch.full((b, rounds * ex), -1, dtype=torch.int32, device=dev)
    fresh_x = torch.zeros((b, ex * deg), dtype=torch.bool, device=dev)
    for t in range(rounds):
        cand_d = torch.where(expanded | (beam_i < 0), INF, beam_d)
        sel_d, j = stable_min_k(cand_d, ex)  # the nearest unexpanded
        has = torch.isfinite(sel_d)
        u = torch.where(has, torch.gather(beam_i, 1, j), -1)
        expanded = expanded.scatter(1, j, torch.gather(expanded, 1, j) | has)
        visited[:, t * ex : (t + 1) * ex] = u

        nbrs = adjacency[torch.clamp(u, min=0).long()]  # [B, ex, deg]
        nbrs = torch.where(has[:, :, None], nbrs, -1).reshape(b, ex * deg)
        if ex > 1:
            # a neighbour listed by several of this round's nodes is kept
            # at its first occurrence only
            srt, order = torch.sort(nbrs, dim=1, stable=True)
            rep = torch.zeros_like(fresh_x)
            rep[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
            nbrs = torch.where(torch.zeros_like(rep).scatter(1, order, rep), -1, nbrs)

        # drop ids already in the beam or already expanded
        dup_beam = (nbrs[:, :, None] == beam_i[:, None, :]).any(-1)
        dup_vis = (nbrs[:, :, None] == visited[:, None, :]).any(-1)
        fresh = (nbrs >= 0) & ~dup_beam & ~dup_vis

        safe = torch.clamp(nbrs, min=0).long()
        nd = query_block_distance(queries, vectors[safe], space, quant, q_aux, aux[safe])
        nfresh = torch.where(fresh, nbrs, -1)
        all_d = torch.cat([beam_d, torch.where(fresh, nd, INF)], dim=1)
        all_i = torch.cat([beam_i, nfresh], dim=1)
        all_x = torch.cat([expanded, fresh_x], dim=1)
        beam_d, pos = stable_min_k(all_d, el)
        beam_i = torch.gather(all_i, 1, pos)
        expanded = torch.gather(all_x, 1, pos)

        res_ok = fresh & valid[safe]
        if filtered:
            res_ok = res_ok & allow[safe]
        res_d, res_i = merge_min_k(res_d, res_i, torch.where(res_ok, nd, INF), nfresh, stable=True)

    return res_d, torch.where(torch.isfinite(res_d), res_i, -1)


def intra_batch_topk(
    vecs: torch.Tensor,  # [n, Dp] storage dtype
    aux: torch.Tensor,  # [n]
    *,
    k: int,
    space: SpaceType,
    quant: Quantization,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each batch row's k nearest peers (the diagonal excluded), as
    (dist [n, k], position [n, k])."""
    d = pairwise_distance(vecs, vecs, space, quant, aux, aux)
    d = d + torch.where(torch.eye(d.shape[0], dtype=torch.bool, device=d.device), INF, 0.0)
    return stable_min_k(d, k)


def alpha_prune(
    cand_i: torch.Tensor,  # [B, C] candidate ids, distance-ascending, -1 pad
    cand_d: torch.Tensor,  # [B, C] distances to the new node
    cand_vecs: torch.Tensor,  # [B, C, Dp] candidate rows (storage dtype)
    cand_aux: torch.Tensor,  # [B, C]
    *,
    m: int,
    alpha: float,
    space: SpaceType,
    quant: Quantization,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched Vamana robust prune: keep candidates greedily, dropping a
    candidate c when an already-kept s has alpha * d(s, c) <= d(u, c).
    Returns ([B, m] ids, [B, m] dists), -1 / inf padded. The candidates'
    pairwise block is built in the declared space from the rows' values
    (I8 codes / 127; a B1 row's packed bytes by squared L2, as the JAX
    package does)."""
    b, c, _ = cand_vecs.shape
    fv = cand_vecs.float()
    if quant is Quantization.I8:
        fv = fv / I8_SCALE
    eff = space if quant is not Quantization.B1 else SpaceType.HAMMING
    dots = torch.bmm(fv, fv.transpose(1, 2))
    if eff is SpaceType.COSINE:
        pair = 1.0 - dots / torch.clamp(cand_aux[:, :, None] * cand_aux[:, None, :], min=1e-30)
    elif eff is SpaceType.DOT_PRODUCT:
        pair = 1.0 - dots
    else:  # euclidean, and Hamming approximated by L2^2
        sq = (fv * fv).sum(-1)
        pair = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * dots, min=0.0)
    # dominated[:, i, s]: a kept s would drop candidate i
    dominated = alpha * pair <= cand_d[:, :, None]
    valid_c = cand_i >= 0
    selected = torch.zeros((b, c), dtype=torch.bool, device=cand_d.device)
    n_sel = torch.zeros((b,), dtype=torch.int32, device=cand_d.device)
    for i in range(c):
        dom = (selected & dominated[:, i, :]).any(1)
        keep = valid_c[:, i] & ~dom & (n_sel < m)
        selected[:, i] = keep
        n_sel += keep
    # the kept candidates, still distance-ascending, compacted into [B, m]
    out_d, out_i = min_k(torch.where(selected, cand_d, INF), cand_i, m, stable=True)
    return torch.where(torch.isfinite(out_d), out_i, -1), out_d


# --- device-chained bulk build ------------------------------------------------
#
# exact kNN of the stored rows (kernel 1) -> a prune per chunk -> ONE
# whole-graph reverse pass, every intermediate on the device: the CAGRA
# construction shape. The host bulk_build round-trips each pass instead.

_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 of int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def ava_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 avalanche of uint32 values held in int64 (deterministic
    pseudo-randomness on the device, bit for bit the JAX package's)."""
    x = x & _U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def bulk_prune_chunk(
    packed: torch.Tensor,  # [b, k'] raw scan ranks (or distances, ``is_dist``)
    rows: torch.Tensor,  # [b, k'] i32 slots, -1 empty
    lo: int,  # the chunk's slots are lo + arange(b) (a contiguous block)
    base: int,  # first slot of the whole bulk block
    n_rows: int,  # rows in the bulk block (the random bridges' range)
    q2: torch.Tensor | None,  # [b] f32 |q|^2 (euclidean ranks)
    vectors: torch.Tensor,
    aux: torch.Tensor,
    *,
    is_dist: bool,
    space: SpaceType,
    quant: Quantization,
    m: int,
    alpha: float,
    k: int,
    r_rand: int,
    m_bridge: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A chunk's raw kNN -> ([b, m + m_bridge] edge ids, dists), pruned on
    the device: the first ``m`` columns are the alpha-pruned exact-kNN
    near edges, the last ``m_bridge`` hash-random bridges pruned only
    against each other. Bridges get a region of their own because on
    clustered data every near candidate is intra-cluster: competing in one
    prune, no bridge survives and the graph falls apart into cluster
    islands (the JAX package measured recall 0.087 at 1M)."""
    ids = rows[:, :k]
    if is_dist:  # lossy storage: the scan's distances
        dist = packed[:, :k]
    else:
        rank = packed[:, :k]
        dist = torch.where(rank < INVALID_CUTOFF, rank_to_distance(space, rank, q2), INF)
    b = ids.shape[0]
    slots = lo + torch.arange(b, dtype=torch.int32, device=ids.device)
    bad = (ids == slots[:, None]) | (ids < 0) | ~torch.isfinite(dist)
    dist = torch.where(bad, INF, dist)
    ids = torch.where(bad, -1, ids)
    dist, order = torch.sort(dist, dim=1, stable=True)
    ids = torch.gather(ids, 1, order)
    safe = torch.clamp(ids, min=0).long()
    near_i, near_d = alpha_prune(
        ids, dist, vectors[safe], aux[safe], m=m, alpha=alpha, space=space, quant=quant
    )
    if r_rand <= 0 or m_bridge <= 0:
        return near_i, near_d

    seed = ava_u32(
        slots.long()[:, None] * r_rand + torch.arange(r_rand, device=ids.device)[None, :]
    )
    rand = base + seed % max(n_rows, 1)  # [b, R] i64
    qv = vectors[torch.clamp(slots.long(), max=vectors.shape[0] - 1)].float()
    rv = vectors[rand].float()  # [b, R, Dp]
    dots = torch.einsum("bd,brd->br", qv, rv)
    if space is SpaceType.EUCLIDEAN:
        rd = torch.clamp((qv * qv).sum(-1)[:, None] + (rv * rv).sum(-1) - 2.0 * dots, min=0.0)
    else:  # cosine (unit storage) and dot
        rd = 1.0 - dots
    rand = rand.to(torch.int32)
    rd = torch.where(rand == slots[:, None], INF, rd)
    # bridges compete only with each other, nearest first
    rd, order = torch.sort(rd, dim=1, stable=True)
    rand = torch.gather(rand, 1, order)
    rsafe = torch.clamp(rand, min=0).long()
    br_i, br_d = alpha_prune(
        rand, rd, vectors[rsafe], aux[rsafe], m=m_bridge, alpha=alpha, space=space, quant=quant
    )
    # a draw that repeats a kept near edge goes: rows stay duplicate-free
    dup = (br_i[:, :, None] == near_i[:, None, :]).any(-1)
    br_i = torch.where(dup, -1, br_i)
    br_d = torch.where(dup, INF, br_d)
    return torch.cat([near_i, br_i], dim=1), torch.cat([near_d, br_d], dim=1)


def segment_rank(keys: torch.Tensor) -> torch.Tensor:
    """Position of each element within its run of equal keys (keys sorted)."""
    idx = torch.arange(keys.shape[0], device=keys.device)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    return idx - torch.cummax(torch.where(first, idx, 0), dim=0).values


def bulk_reverse(
    adjacency: torch.Tensor,  # [cap, m] i32 forward edges of every node (-1 pads)
    vectors: torch.Tensor,
    aux: torch.Tensor,
    live: torch.Tensor,  # [cap] bool
    *,
    space: SpaceType,
    quant: Quantization,
    m: int,
    r: int,
    alpha: float,
    max_forced: int,
    row_block: int,
) -> torch.Tensor:
    """One whole-graph reverse-edge pass. Every target of a forward edge
    merges its edges with up to ``r`` nearest incoming back-links, drops
    repeats and is alpha-pruned to ``m``; then every node is forced into
    the tail of its nearest neighbour's row (at most ``max_forced`` a
    target) so outliers stay reachable. Row blocks of ``row_block`` bound
    the gathers."""
    cap = adjacency.shape[0]
    dev = adjacency.device

    # d(i, adjacency[i, j]), a block of rows at a time
    edge_d = torch.empty((cap, m), dtype=torch.float32, device=dev)
    for lo in range(0, cap, row_block):
        rows = adjacency[lo : lo + row_block]
        safe = torch.clamp(rows, min=0).long()
        d = query_block_distance(
            vectors[lo : lo + row_block], vectors[safe], space, quant, aux[lo : lo + row_block], aux[safe]
        )
        edge_d[lo : lo + row_block] = torch.where(rows >= 0, d, INF)

    # incoming edges grouped by target, nearest first
    src = torch.arange(cap, dtype=torch.int32, device=dev).repeat_interleave(m)
    tgt = adjacency.reshape(-1)
    dist = edge_d.reshape(-1)
    ok = (tgt >= 0) & live[src.long()] & torch.isfinite(dist)
    tgt_s = torch.where(ok, tgt, cap)  # invalid edges sort last
    dist_s = torch.where(ok, dist, INF)
    order = _lex_order(tgt_s, dist_s, dim=0)
    tgt_s, dist_s, src_s = tgt_s[order], dist_s[order], src[order]
    pos = segment_rank(tgt_s)
    keep = (pos < r) & (tgt_s < cap)
    kt, kp = tgt_s[keep].long(), pos[keep]
    inc_i = torch.full((cap, r), -1, dtype=torch.int32, device=dev)
    inc_d = torch.full((cap, r), INF, dtype=torch.float32, device=dev)
    inc_i[kt, kp] = src_s[keep]
    inc_d[kt, kp] = dist_s[keep]
    touched = torch.zeros((cap,), dtype=torch.bool, device=dev)
    touched[kt] = True

    # each target's candidates: its edges and its incoming ones, by id
    # then distance; a repeated id keeps its nearest copy
    all_i = torch.cat([adjacency, inc_i], dim=1)
    all_d = torch.cat([torch.where(adjacency >= 0, edge_d, INF), inc_d], dim=1)
    order = _lex_order(all_i, all_d, dim=1)
    si, sd = torch.gather(all_i, 1, order), torch.gather(all_d, 1, order)
    dup = torch.zeros_like(si, dtype=torch.bool)
    dup[:, 1:] = (si[:, 1:] == si[:, :-1]) & (si[:, 1:] >= 0)
    sd = torch.where(dup | (si < 0), INF, sd)
    sd, order = torch.sort(sd, dim=1, stable=True)
    si = torch.where(torch.isfinite(sd), torch.gather(si, 1, order), -1)

    new_rows = torch.empty((cap, m), dtype=torch.int32, device=dev)
    for lo in range(0, cap, row_block):
        ci, cd = si[lo : lo + row_block], sd[lo : lo + row_block]
        safe = torch.clamp(ci, min=0).long()
        new_rows[lo : lo + row_block] = alpha_prune(
            ci, cd, vectors[safe], aux[safe], m=m, alpha=alpha, space=space, quant=quant
        )[0]

    # in-degree floor: node u goes into the tail of its top-1 target's
    # row, nearest first, at most max_forced a target, unless it is an
    # edge there already (a duplicate would evict a long-range edge)
    top_v = adjacency[:, 0]
    d0 = edge_d[:, 0]
    u_ok = live & (top_v >= 0) & torch.isfinite(d0)
    tv = torch.where(u_ok, top_v, cap)
    order = _lex_order(tv, torch.where(u_ok, d0, INF), dim=0)
    tv, us = tv[order], order.to(torch.int32)
    fpos = segment_rank(tv)
    f_ok = (fpos < max_forced) & (tv < cap)
    trows = new_rows[torch.where(f_ok, tv, 0).long()]
    f_ok &= ~(trows == us[:, None]).any(1)
    new_rows[tv[f_ok].long(), (m - 1 - fpos[f_ok])] = us[f_ok]
    return torch.where(touched[:, None], new_rows, adjacency)


class GraphDeviceIndex:
    """Navigable-graph ANN index over a FlatDeviceIndex's storage, plus an
    exact delta for not-yet-merged inserts."""

    BULK_BUILD_THRESHOLD = 65536  # empty graph + this many pending -> bulk
    _ENTRY_BUCKETS = (32, 128, 512, 2048, 4096)

    def __init__(
        self,
        dimensions: int,
        space_type: SpaceType = SpaceType.COSINE,
        quantization: Quantization = Quantization.F32,
        connectivity: int = 16,
        expansion_add: int = 128,
        expansion_search: int = 64,
        initial_capacity: int = 8192,
        reserve_increment: int = GLOBAL_RESERVE_INCREMENT,
        n_entries: int = DEFAULT_ENTRIES,
        alpha: float = 1.2,
        max_delta: int = 65536,
        *,
        device: torch.device,
        oversample: int | None = None,
        rescoring: bool = True,
        preview_dims: int | None = None,
    ) -> None:
        preview = preview_dims if preview_dims is not None else int(
            os.environ.get("VECTOR_STORE_GRAPH_PREVIEW", "0") or 0
        )
        if preview > 0:
            raise NotImplementedError(
                "the graph engine's preview-guided traversal is not ported: it "
                "measured recall 0.37-0.38 against 0.9664 and was rejected "
                "(ROADMAP.md, 'Do not carry over')"
            )
        # oversampling/rescoring index options: with lossy storage the beam
        # fetches k x oversample candidates at storage precision and an
        # exact f32 host re-rank keeps k; rescoring=False keeps storage
        # order end to end (and fetches k)
        if not rescoring:
            oversample = 1
        elif oversample is None:
            oversample = 4 if quantization in (Quantization.I8, Quantization.B1) else 1
        self.oversample = max(1, int(oversample))
        self.rescoring = rescoring
        self.store = FlatDeviceIndex(
            dimensions,
            space_type=space_type,
            quantization=quantization,
            device=device,
            initial_capacity=initial_capacity,
            reserve_increment=reserve_increment,
            rescoring=rescoring,
        )
        self.device = self.store.device
        # lossy storage keeps no f32 mirror in the store; the rescoring
        # contract still asks for an exact f32 re-rank of the beam
        self._rescore_host: np.ndarray | None = None
        if rescoring and self.store._vecs_host is None:
            self._rescore_host = np.zeros((self.store.capacity, dimensions), dtype=np.float32)
        self.space_type = space_type
        self.quantization = quantization
        self.dimensions = dimensions
        self.connectivity = connectivity
        self.degree = 2 * connectivity  # like HNSW level 0 (2 M)
        # the last bridge_q columns of every row hold hash-random bridges
        # that near-edge pruning never evicts (see bulk_prune_chunk)
        self.bridge_q = max(2, self.degree // 8)
        self.near_deg = self.degree - self.bridge_q
        # expansions a lockstep round: fewer serialized gather rounds at
        # the same rows gathered
        self.beam_expand = 4
        self.expansion_add = expansion_add
        self.expansion_search = expansion_search
        self.alpha = alpha
        self.n_entries = n_entries
        self.max_delta = max_delta

        cap = self.store.capacity
        self.adjacency = torch.full((cap, self.degree), -1, dtype=torch.int32, device=self.device)
        self._entries: list[int] = []  # entry-point slots
        self._entries_seen = 0  # reservoir-sampling counter
        # one generator for the entry reservoir and the incremental
        # bridges, drawn in the JAX engine's order
        self._rng = np.random.default_rng(0xC0FFEE)
        self._graph_nodes = 0
        self._graph_slots: list[int] = []  # merged slots, in merge order
        self._pool = np.empty(0, dtype=np.int32)  # _graph_slots as an array (bridge draws)
        self._members = np.zeros(cap, dtype=bool)  # merged-node mask
        self._refine_cursor: int | None = None  # in-progress refinement pass
        self._last_refined_nodes = 0
        # the delta: staged slots, searched exactly through the store
        self._delta_slots: list[int] = []
        self._delta_set: set[int] = set()
        # build path of the last bulk merge ("device", "host") or None
        self.last_build: str | None = None

    # -- properties ------------------------------------------------------------

    @property
    def size(self) -> int:
        return self.store.size

    @property
    def capacity(self) -> int:
        return self.store.capacity

    @property
    def delta_count(self) -> int:
        return len(self._delta_slots)

    @property
    def graph_nodes(self) -> int:
        return self._graph_nodes

    def flat_scans(self) -> tuple[int, int]:
        """The store's exact-scan counters (FlatDeviceIndex.flat_scans)."""
        return self.store.flat_scans()

    @property
    def device_bytes(self) -> int:
        """Device footprint: the vector store plus the adjacency."""
        return self.store.device_bytes + self.adjacency.shape[0] * self.degree * 4

    @property
    def host_bytes(self) -> int:
        total = self.store.host_bytes + self._members.nbytes
        if self._rescore_host is not None:
            total += self._rescore_host.nbytes
        return total

    def _valid(self) -> torch.Tensor:
        """[cap] bool liveness of every slot (a dead slot's b is invalid)."""
        return self.store.b < INVALID_CUTOFF

    # -- entry points ------------------------------------------------------------

    def _entry_target(self) -> int:
        """Entry-set size, ~2 sqrt(N) in buckets: on clustered data a
        query's cluster is reached through the entry set itself (the
        lockstep counterpart of HNSW's upper layers)."""
        want = int(2.0 * np.sqrt(max(self._graph_nodes, 1)))
        want = max(self.n_entries, min(want, self._ENTRY_BUCKETS[-1]))
        return k_bucket(want, self._ENTRY_BUCKETS)

    def _note_entries(self, batch) -> None:
        """Reservoir-maintain the entry set over all merged nodes: the
        oldest half stays pinned, the younger half is a uniform sample."""
        target = self._entry_target()
        half = target // 2
        for s in batch:
            self._entries_seen += 1
            if len(self._entries) < target:
                self._entries.append(int(s))
            else:
                j = int(self._rng.integers(0, self._entries_seen))
                if half <= j < target:
                    self._entries[j] = int(s)

    def _entries_tensor(self) -> torch.Tensor:
        """The entries padded with -1 to their bucket (the beam starts
        unsorted when the set is narrower than the beam)."""
        n = len(self._entries)
        pad = next((b for b in self._ENTRY_BUCKETS if n <= b), n)
        e = np.full((pad,), -1, dtype=np.int32)
        e[:n] = self._entries
        return torch.from_numpy(e).to(self.device)

    # -- mutation --------------------------------------------------------------

    def upsert_batch(
        self,
        slots: np.ndarray,
        epochs: np.ndarray,
        vectors: np.ndarray,
        partitions: np.ndarray | None = None,
    ) -> None:
        """Store vectors and stage them in the delta: searchable at once
        (exact), merged into the graph by ``maintain``."""
        slots = np.asarray(slots, dtype=np.int64)
        if slots.size == 0:
            return
        self.store.upsert_batch(slots, epochs, vectors, partitions)
        self._mirror_rows(slots, np.asarray(vectors, dtype=np.float32))
        for s in slots.tolist():
            if s not in self._delta_set:
                self._delta_set.add(s)
                self._delta_slots.append(s)

    def _mirror_rows(self, slots: np.ndarray, vectors: np.ndarray) -> None:
        if self._rescore_host is None:
            return
        top = int(np.max(slots)) + 1
        if top > self._rescore_host.shape[0]:
            grown = np.zeros((max(top, self.store.capacity), self.dimensions), np.float32)
            grown[: self._rescore_host.shape[0]] = self._rescore_host
            self._rescore_host = grown
        rows = vectors[:, : self.dimensions]
        if self.space_type is SpaceType.COSINE and self.quantization is not Quantization.B1:
            rows = normalize_rows(rows)  # unit rows, as the store keeps them
        self._rescore_host[slots] = rows

    def upsert_bulk_device(
        self,
        lo: int,
        hi: int,
        rows_dev: torch.Tensor,
        rows_host: np.ndarray,
        partitions: np.ndarray | None = None,
        epoch: int = 0,
    ) -> None:
        """Bulk path for contiguous fresh slots whose rows are already on
        the device (FlatDeviceIndex.upsert_bulk_device); staged in the
        delta like any upsert."""
        if int(hi) <= int(lo):
            return
        self.store.upsert_bulk_device(lo, hi, rows_dev, rows_host, partitions=partitions, epoch=epoch)
        self._mirror_rows(np.arange(lo, hi), np.asarray(rows_host, dtype=np.float32))
        self._sync_capacity()
        fresh = [s for s in range(lo, hi) if s not in self._delta_set]
        self._delta_slots.extend(fresh)
        self._delta_set.update(fresh)

    def remove_batch(self, slots: np.ndarray) -> None:
        """Tombstone: masked from results; its edges stay navigable."""
        self.store.remove_batch(slots)
        removed = set(np.asarray(slots, dtype=np.int64).tolist())
        if removed & self._delta_set:
            self._delta_slots = [s for s in self._delta_slots if s not in removed]
            self._delta_set -= removed

    def load_state(self, state: dict) -> None:
        """Take over a JAX GraphDeviceIndex's state, as numpy: ``store``
        (what FlatDeviceIndex.load_state takes), ``adjacency``,
        ``_entries``, ``_entries_seen``, ``_graph_nodes``, ``_graph_slots``,
        ``_members``, ``_delta_slots``, ``_rescore_host``,
        ``_refine_cursor``, ``_last_refined_nodes`` and ``_rng`` (its bit
        generator's state). Capacity is rounded up to the store's block."""
        self.store.load_state(state["store"])
        cap = self.store.capacity
        adj = np.array(state["adjacency"], dtype=np.int32)
        self.adjacency = torch.full((cap, self.degree), -1, dtype=torch.int32, device=self.device)
        self.adjacency[: adj.shape[0]] = torch.from_numpy(adj).to(self.device)
        self._entries = [int(s) for s in state["_entries"]]
        self._entries_seen = int(state["_entries_seen"])
        self._graph_nodes = int(state["_graph_nodes"])
        self._graph_slots = [int(s) for s in state["_graph_slots"]]
        self._pool = np.empty(0, dtype=np.int32)
        members = np.asarray(state["_members"], dtype=bool)
        self._members = np.zeros(max(cap, members.shape[0]), dtype=bool)
        self._members[: members.shape[0]] = members
        self._delta_slots = [int(s) for s in state["_delta_slots"]]
        self._delta_set = set(self._delta_slots)
        self._refine_cursor = state["_refine_cursor"]
        self._last_refined_nodes = int(state["_last_refined_nodes"])
        self._rng.bit_generator.state = state["_rng"]
        if self._rescore_host is not None:
            self._rescore_host = np.zeros((cap, self.dimensions), dtype=np.float32)
            rh = np.asarray(state["_rescore_host"], dtype=np.float32)
            self._rescore_host[: rh.shape[0]] = rh

    # -- maintenance -----------------------------------------------------------

    def needs_merge(self) -> bool:
        return len(self._delta_slots) >= self.max_delta

    def _refine_due(self) -> bool:
        """Has the graph grown 25% since the last refinement pass?"""
        return self._graph_nodes >= 4096 and self._graph_nodes >= int(self._last_refined_nodes * 1.25)

    @property
    def maintenance_due(self) -> bool:
        """Would ``maintain`` find work?"""
        return bool(self._delta_slots) or self._refine_cursor is not None or self._refine_due()

    def maintain(self, max_batch: int = 4096) -> bool:
        """One unit of background maintenance; True when work was done.
        The delta drains first; then, once the graph has grown 25% since
        the last pass, a refinement pass runs a slice at a time."""
        if self._delta_slots:
            self.merge_delta(max_batch)
            return True
        if self._refine_cursor is not None:
            self.refine_step(max_batch)
            return True
        if self._refine_due():
            self._refine_cursor = 0
            return True
        return False

    def refine_step(self, max_batch: int = 4096) -> int:
        """One slice of an in-progress refinement pass."""
        if self._refine_cursor is None:
            self._refine_cursor = 0
        if self._refine_cursor >= len(self._graph_slots):
            self._refine_cursor = None
            self._last_refined_nodes = self._graph_nodes
            return 0
        batch = np.asarray(
            self._graph_slots[self._refine_cursor : self._refine_cursor + max_batch], dtype=np.int64
        )
        self._refine_cursor += len(batch)
        self._insert_into_graph(batch, include_current=True)
        return len(batch)

    def refine(self, max_batch: int = 4096, rounds: int = 1) -> None:
        """Re-search every node's neighbourhood and re-prune it from its
        current edges and fresh candidates: early nodes link to later
        arrivals."""
        for _ in range(rounds):
            slots_all = np.asarray(self._graph_slots, dtype=np.int64)
            for lo in range(0, len(slots_all), max_batch):
                self._insert_into_graph(slots_all[lo : lo + max_batch], include_current=True)

    def compact(self) -> int:
        """Rebuild the graph without tombstoned nodes; returns the live
        nodes re-linked."""
        live = [s for s in self._graph_slots if self.store._valid_host[s]]
        self.adjacency = torch.full(
            (self.store.capacity, self.degree), -1, dtype=torch.int32, device=self.device
        )
        self._entries = []
        self._entries_seen = 0
        self._graph_nodes = 0
        self._graph_slots = []
        self._pool = np.empty(0, dtype=np.int32)
        self._members[:] = False
        self._refine_cursor = None
        self._last_refined_nodes = 0
        for s in live:  # re-staged behind the pending delta
            if s not in self._delta_set:
                self._delta_slots.append(s)
                self._delta_set.add(s)
        while self.merge_delta(max_batch=4096):
            pass
        return len(live)

    def _merged(self, slots: np.ndarray) -> None:
        """Graph bookkeeping of merged slots (before any reverse pass)."""
        self._graph_nodes += len(slots)
        self._graph_slots.extend(int(s) for s in slots)
        self._members[slots] = True
        self._note_entries(slots)

    @hotpath.measure
    def bulk_build(self, efc: int | None = None) -> int:
        """The graph of ALL pending delta rows in three passes with host
        round trips: exact kNN through the store's scan, a batched prune,
        one reverse-edge pass."""
        if not self._delta_slots:
            return 0
        self._sync_capacity()
        self.last_build = "host"
        slots = np.asarray(self._delta_slots, dtype=np.int64)
        n = len(slots)
        store = self.store
        efc = efc or min(self.expansion_add, 63)
        mask = np.zeros(store.capacity, dtype=bool)
        mask[slots] = True
        slots_t = torch.from_numpy(slots).to(self.device)
        queries = self._dequant(store.vectors[slots_t])

        # pass 1: exact kNN among the nodes being built (+1: the self-hit)
        mask_t = torch.from_numpy(mask).to(self.device)
        pendings = [
            (lo, store.search_begin(queries[lo : lo + 2048], efc + 1, allow_mask=mask_t))
            for lo in range(0, n, 2048)
        ]
        cand_i = np.full((n, efc + 1), -1, dtype=np.int64)
        cand_d = np.full((n, efc + 1), np.inf, dtype=np.float32)
        for (lo, _), results in zip(pendings, store.collect_many([p for _, p in pendings])):
            for r, res in enumerate(results):
                w = min(len(res.slots), efc + 1)
                cand_i[lo + r, :w] = res.slots[:w]
                cand_d[lo + r, :w] = res.distances[:w]
        self_mask = cand_i == slots[:, None]
        cand_d[self_mask] = np.inf
        cand_i[self_mask] = -1

        # random long-range bridges for the protected tail
        bridge_i = np.full((n, self.bridge_q), -1, dtype=np.int32)
        bridge_d = np.full((n, self.bridge_q), np.inf, dtype=np.float32)
        if self.quantization is not Quantization.B1 and n > 1:
            r_rand = 8
            rng_pos = np.random.default_rng(0xB41D6E).integers(0, n, size=(n, r_rand))
            rand_ids = slots[rng_pos]
            rd = np.empty((n, r_rand), dtype=np.float32)
            for blo in range(0, n, 65536):  # bounds the [*, r, D] temporaries
                qb = queries[blo : blo + 65536]
                rb = queries[rng_pos[blo : blo + 65536]]
                if self.space_type is SpaceType.EUCLIDEAN:
                    rd[blo : blo + 65536] = ((qb[:, None, :] - rb) ** 2).sum(-1)
                else:
                    rd[blo : blo + 65536] = 1.0 - np.einsum("nd,nrd->nr", qb, rb)
            rd = np.where(rand_ids == slots[:, None], np.inf, rd)
            # repeated draws of a row go, nearest first
            order = np.argsort(rd, axis=1, kind="stable")
            rand_ids = np.take_along_axis(rand_ids, order, axis=1)
            rd = np.take_along_axis(rd, order, axis=1)
            dup = np.zeros_like(rd, dtype=bool)
            dup[:, 1:] = rand_ids[:, 1:] == rand_ids[:, :-1]
            rd[dup] = np.inf
            order = np.argsort(rd, axis=1, kind="stable")
            bridge_i[:] = np.take_along_axis(rand_ids, order, axis=1)[:, : self.bridge_q]
            bridge_d[:] = np.take_along_axis(rd, order, axis=1)[:, : self.bridge_q]
            bridge_i[~np.isfinite(bridge_d)] = -1

        order = np.argsort(cand_d, axis=1, kind="stable")
        cand_i = np.take_along_axis(cand_i, order, axis=1)
        cand_d = np.take_along_axis(cand_d, order, axis=1)
        cand_i[~np.isfinite(cand_d)] = -1

        # pass 2: the prune of every neighbourhood on the device
        sel_i = np.empty((n, self.degree), dtype=np.int32)
        sel_d = np.empty((n, self.degree), dtype=np.float32)
        sel_i[:, self.near_deg :] = bridge_i
        sel_d[:, self.near_deg :] = bridge_d
        for lo in range(0, n, 8192):
            oi, od = self._prune(cand_i[lo : lo + 8192], cand_d[lo : lo + 8192], self.near_deg)
            sel_i[lo : lo + 8192, : self.near_deg] = oi
            sel_d[lo : lo + 8192, : self.near_deg] = od

        self._scatter_rows(slots, sel_i)
        self._delta_slots = []
        self._delta_set = set()
        self._merged(slots)  # the reverse pass reads the members

        # pass 3: one reverse-edge pass
        self._apply_reverse_edges(slots, sel_i, sel_d)
        return n

    @hotpath.measure
    def bulk_build_device(self, efc: int | None = None, chunk: int = 2048) -> int:
        """The three bulk passes with every intermediate on the device: the
        stored rows themselves query kernel 1 a chunk at a time, each
        chunk's raw candidates are pruned where they lie, and one reverse
        pass covers the whole graph. From-empty contiguous blocks only;
        anything else takes the host ``bulk_build``."""
        if not self._delta_slots:
            return 0
        slots = np.asarray(sorted(self._delta_slots), dtype=np.int64)
        n = len(slots)
        lo0 = int(slots[0])
        if self._graph_nodes != 0 or not np.array_equal(slots, np.arange(lo0, lo0 + n)):
            return self.bulk_build(efc)
        self._sync_capacity()
        self.last_build = "device"
        store = self.store
        cap = store.capacity
        efc = efc or min(self.expansion_add, 63)
        k = efc + 1  # +1 for the self-hit
        euclid = self.space_type is SpaceType.EUCLIDEAN

        sel_parts = []
        for lo in range(lo0, lo0 + n, chunk):
            hi = min(lo + chunk, lo0 + n)
            qd = store.vectors[lo:hi]
            if store._vecs_host is not None:
                hq = store._vecs_host[lo:hi]
            else:
                hq = self._dequant(qd)
            pending = store.search_begin(hq, k, raw=True, queries_dev=qd)
            q2 = None
            if euclid and not pending.is_dist:
                q2 = torch.from_numpy((hq.astype(np.float64) ** 2).sum(-1).astype(np.float32))
                q2 = q2.to(self.device)
            sel_i, _ = bulk_prune_chunk(
                pending.packed, pending.rows, lo, lo0, n, q2, store.vectors, store.aux,
                is_dist=pending.is_dist, space=self.space_type, quant=self.quantization,
                m=self.near_deg, alpha=self.alpha, k=k, r_rand=8, m_bridge=self.bridge_q,
            )
            sel_parts.append(sel_i)
        self.adjacency[lo0 : lo0 + n] = torch.cat(sel_parts, dim=0)

        rb = next((d for d in (8192, 4096, 2048, 1024, 512, 256, 128, 64) if cap % d == 0), cap)
        # the reverse pass repairs the near region only: re-pruning the
        # bridge columns against dense incoming intra-cluster links would
        # evict the long-range edges that keep islands connected
        near = bulk_reverse(
            self.adjacency[:, : self.near_deg].contiguous(), store.vectors, store.aux, self._valid(),
            space=self.space_type, quant=self.quantization, m=self.near_deg, r=8,
            alpha=self.alpha, max_forced=max(1, self.near_deg // 4), row_block=rb,
        )
        self.adjacency[:, : self.near_deg] = near

        self._delta_slots = []
        self._delta_set = set()
        self._merged(slots)
        return n

    @hotpath.measure
    def merge_delta(self, max_batch: int = 4096) -> int:
        """Wire up to max_batch pending delta rows into the graph; returns
        the number merged. An empty graph with a backlog of at least
        BULK_BUILD_THRESHOLD rows is built in bulk instead."""
        if not self._delta_slots:
            return 0
        if self._graph_nodes == 0 and len(self._delta_slots) >= self.BULK_BUILD_THRESHOLD:
            return self.bulk_build_device()
        # an upsert may have grown the store past the adjacency's rows
        self._sync_capacity()
        batch = self._delta_slots[:max_batch]
        slots = np.asarray(batch, dtype=np.int64)
        if self._graph_nodes == 0:
            self._bootstrap(slots)
        else:
            self._insert_into_graph(slots)
        self._delta_slots = self._delta_slots[len(batch) :]
        self._delta_set -= set(batch)
        # entry points: the oldest half pinned (old nodes gather dense
        # in-link sets), the younger half a reservoir sample of the rest
        self._merged(slots)
        return len(batch)

    def _bootstrap(self, slots: np.ndarray) -> None:
        """First batch: the exact kNN graph among the batch itself."""
        n = len(slots)
        slots_t = torch.from_numpy(slots).to(self.device)
        qv, qa = self.store.vectors[slots_t], self.store.aux[slots_t]
        d = pairwise_distance(qv, qv, self.space_type, self.quantization, qa, qa).cpu().numpy()
        np.fill_diagonal(d, np.inf)
        m = min(self.degree, max(n - 1, 1))
        rows = np.full((n, self.degree), -1, dtype=np.int32)
        if n > 1:
            rows[:, :m] = slots[np.argsort(d, axis=1)[:, :m]]
        self._scatter_rows(slots, rows)

    def _dequant(self, storage_rows: torch.Tensor) -> np.ndarray:
        """Storage rows -> host f32 queries [n, D] that quantize back to the
        same storage rows (so the scan's candidate distances are storage
        distances)."""
        if self.quantization is Quantization.B1:
            return unpack_b1(storage_rows, self.dimensions).cpu().numpy()
        rows = storage_rows[:, : self.dimensions].float()
        if self.quantization is Quantization.I8:
            rows = rows / I8_SCALE
        return rows.cpu().numpy()

    @hotpath.measure
    def _candidate_search(self, queries: np.ndarray, efc: int) -> tuple[np.ndarray, np.ndarray]:
        """Construction candidates: the exact top-efc among the merged
        nodes through the store's scan (kernel 1 for float storage; the
        JAX package measured the exact scan ~100x faster than beam-search
        insertion, and its candidates are better). Returns ([n, efc] ids,
        dists), -1 / inf padded."""
        store = self.store
        members = torch.from_numpy(self._members[: store.capacity]).to(self.device)
        n = len(queries)
        cand_i = np.full((n, efc), -1, dtype=np.int32)
        cand_d = np.full((n, efc), np.inf, dtype=np.float32)
        pendings = [
            (lo, store.search_begin(queries[lo : lo + 2048], efc, allow_mask=members))
            for lo in range(0, n, 2048)
        ]
        for (lo, _), results in zip(pendings, store.collect_many([p for _, p in pendings])):
            for r, res in enumerate(results):
                w = min(len(res.slots), efc)
                cand_i[lo + r, :w] = res.slots[:w]
                cand_d[lo + r, :w] = res.distances[:w]
        return cand_i, cand_d

    def _prune(self, cand_i: np.ndarray, cand_d: np.ndarray, m: int) -> tuple[np.ndarray, np.ndarray]:
        """alpha_prune of host candidate lists on the device, back on the host."""
        store = self.store
        ci = torch.from_numpy(np.ascontiguousarray(cand_i, dtype=np.int32)).to(self.device)
        cd = torch.from_numpy(np.ascontiguousarray(cand_d, dtype=np.float32)).to(self.device)
        safe = torch.clamp(ci, min=0).long()
        oi, od = alpha_prune(
            ci, cd, store.vectors[safe], store.aux[safe], m=m, alpha=self.alpha,
            space=self.space_type, quant=self.quantization,
        )
        return oi.cpu().numpy(), od.cpu().numpy()

    @staticmethod
    def _sorted_candidates(cand_i: np.ndarray, cand_d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        order = np.argsort(cand_d, axis=1, kind="stable")
        cand_i = np.take_along_axis(cand_i, order, axis=1)
        cand_d = np.take_along_axis(cand_d, order, axis=1)
        cand_i[~np.isfinite(cand_d)] = -1
        return cand_i, cand_d

    @hotpath.measure
    def _insert_into_graph(self, slots: np.ndarray, include_current: bool = False) -> None:
        self._sync_capacity()
        store = self.store
        n = len(slots)
        slots_t = torch.from_numpy(slots).to(self.device)
        vecs, aux = store.vectors[slots_t], store.aux[slots_t]
        # 1. exact scan candidates among the merged nodes
        cand_i, cand_d = self._candidate_search(self._dequant(vecs), self.expansion_add)

        if include_current:
            # refinement: the node is in the graph; drop its self-hit and
            # offer its current near edges again (bridges are redrawn)
            self_mask = cand_i == slots[:, None]
            cand_d[self_mask] = np.inf
            cand_i[self_mask] = -1
            cur = self.adjacency[slots_t][:, : self.near_deg]
            safe = torch.clamp(cur, min=0).long()
            cur_d = query_block_distance(
                vecs, store.vectors[safe], self.space_type, self.quantization, aux, store.aux[safe]
            ).cpu().numpy()
            cur = cur.cpu().numpy()
            cur_d[cur < 0] = np.inf
            cand_i, cand_d = self._sorted_candidates(
                np.concatenate([cand_i, cur], axis=1), np.concatenate([cand_d, cur_d], axis=1)
            )

        # 1b. the batch's own nearest peers (not in the graph yet, so the
        # scan cannot find them): clusters inserted together stay linked
        if n > 1 and not include_current:
            kb = min(16, n - 1)
            pd, pp = intra_batch_topk(vecs, aux, k=kb, space=self.space_type, quant=self.quantization)
            peer_i = slots[pp.cpu().numpy()].astype(np.int32)
            cand_i, cand_d = self._sorted_candidates(
                np.concatenate([cand_i, peer_i], axis=1),
                np.concatenate([cand_d, pd.cpu().numpy()], axis=1),
            )

        # 2-3. prune and assemble the rows; bridges pay off only once the
        # graph outgrows its entry set (below that the near edges take
        # the whole degree)
        use_bridges = len(self._graph_slots) >= 4096
        m_near = self.near_deg if use_bridges else self.degree
        near_i, near_d = self._prune(cand_i, cand_d, m_near)
        sel_i = np.full((n, self.degree), -1, dtype=np.int32)
        sel_d = np.full((n, self.degree), np.inf, dtype=np.float32)
        sel_i[:, :m_near] = near_i
        sel_d[:, :m_near] = near_d
        if use_bridges:
            if len(self._pool) != len(self._graph_slots):  # merged slots, as an array
                self._pool = np.asarray(self._graph_slots, dtype=np.int32)
            pool = self._pool
            rand_edges = pool[self._rng.integers(0, pool.size, size=(n, self.bridge_q))]
            ok = rand_edges != slots[:, None]
            tail = sel_i[:, self.near_deg :]
            tail[ok] = rand_edges[ok]
            sel_d[:, self.near_deg :][ok] = np.float32(1e30)
        self._scatter_rows(slots, sel_i)

        # 4. reverse edges
        self._apply_reverse_edges(slots, sel_i, sel_d)

    @hotpath.measure
    def _apply_reverse_edges(self, slots: np.ndarray, sel_i: np.ndarray, sel_d: np.ndarray) -> None:
        """Back-links of freshly linked ``slots`` (their rows ``sel_i`` at
        distances ``sel_d``): every target re-prunes its near edges with up
        to r nearest incoming ones, then each slot is forced into its
        nearest neighbour's row. The JAX package's host pass, with the
        per-target candidate lists kept on the device (the same stable
        sorts, so the same rows)."""
        deg = sel_i.shape[1]
        src = np.repeat(slots.astype(np.int64), deg)
        tgt = sel_i.reshape(-1).astype(np.int64)
        dist = sel_d.reshape(-1)
        ok = tgt >= 0
        src, tgt, dist = src[ok], tgt[ok], dist[ok]
        if tgt.size == 0:
            return

        # up to r nearest incoming edges a target this round
        uniq, inv = np.unique(tgt, return_inverse=True)
        u = uniq.size
        r = 8
        order = np.lexsort((dist, inv))  # by target, then distance
        inv_sorted = inv[order]
        group_start = np.zeros(u, dtype=np.int64)
        first = np.ones(len(inv_sorted), dtype=bool)
        first[1:] = inv_sorted[1:] != inv_sorted[:-1]
        group_start[inv_sorted[first]] = np.flatnonzero(first)
        pos = np.arange(len(inv_sorted)) - group_start[inv_sorted]
        keep = pos < r
        incoming_i = np.full((u, r), -1, dtype=np.int64)
        incoming_d = np.full((u, r), np.inf, dtype=np.float32)
        incoming_i[inv_sorted[keep], pos[keep]] = src[order][keep]
        incoming_d[inv_sorted[keep], pos[keep]] = dist[order][keep]

        # the targets' current rows and their distances, a chunk at a time
        # (one gather of every touched target is [U, deg, Dp])
        store = self.store
        uniq_t = torch.from_numpy(uniq).to(self.device)
        cur_rows = self.adjacency[uniq_t]
        cur_d = torch.empty(cur_rows.shape, dtype=torch.float32, device=self.device)
        for lo in range(0, u, 65536):
            ut, rows = uniq_t[lo : lo + 65536], cur_rows[lo : lo + 65536]
            safe = torch.clamp(rows, min=0).long()
            cur_d[lo : lo + 65536] = query_block_distance(
                store.vectors[ut], store.vectors[safe], self.space_type, self.quantization,
                store.aux[ut], store.aux[safe],
            )

        # candidates: the current near edges and the incoming ones (the
        # bridge tail is protected and re-attached as it was); a repeated
        # id keeps its first copy
        near = cur_rows[:, : self.near_deg]
        all_i = torch.cat([near.long(), torch.from_numpy(incoming_i).to(self.device)], dim=1)
        all_d = torch.cat([
            torch.where(near >= 0, cur_d[:, : self.near_deg], INF),
            torch.from_numpy(incoming_d).to(self.device),
        ], dim=1)
        by_id = torch.sort(all_i, dim=1, stable=True)
        rep = torch.zeros_like(all_i, dtype=torch.bool)
        rep[:, 1:] = (by_id.values[:, 1:] == by_id.values[:, :-1]) & (by_id.values[:, 1:] >= 0)
        dup = torch.zeros_like(rep).scatter(1, by_id.indices, rep)
        all_d = torch.where(dup | (all_i < 0), INF, all_d)

        # re-prune every touched target by the diversity rule, which keeps
        # long-range edges (outlier inserts still get back-links)
        sd, order = torch.sort(all_d, dim=1, stable=True)
        si = torch.where(torch.isfinite(sd), torch.gather(all_i, 1, order), -1)
        new_rows = torch.empty((u, self.near_deg), dtype=torch.int32, device=self.device)
        for lo in range(0, u, 4096):
            ci = si[lo : lo + 4096]
            safe = torch.clamp(ci, min=0)
            new_rows[lo : lo + 4096] = alpha_prune(
                ci, sd[lo : lo + 4096], store.vectors[safe], store.aux[safe], m=self.near_deg,
                alpha=self.alpha, space=self.space_type, quant=self.quantization,
            )[0]
        new_rows = new_rows.cpu().numpy()

        # in-degree floor: each inserted node goes into the tail of its
        # nearest neighbour's row (at most max_forced a target)
        top_v = sel_i[:, 0].astype(np.int64)
        max_forced = max(1, self.near_deg // 4)
        forced_count: dict[int, int] = {}
        for row_idx in np.argsort(sel_d[:, 0], kind="stable"):
            v = int(top_v[row_idx])
            if v < 0:
                continue
            s = int(slots[row_idx])
            row = new_rows[np.searchsorted(uniq, v)]  # top_v is a target: in uniq
            c = forced_count.get(v, 0)
            if s in row or c >= max_forced:
                continue
            row[self.near_deg - 1 - c] = s
            forced_count[v] = c + 1

        self.adjacency[uniq_t] = torch.cat(
            [torch.from_numpy(new_rows).to(self.device), cur_rows[:, self.near_deg :]], dim=1
        )

    def _scatter_rows(self, row_ids: np.ndarray, rows: np.ndarray) -> None:
        self.adjacency[torch.from_numpy(np.asarray(row_ids, dtype=np.int64)).to(self.device)] = (
            torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int32)).to(self.device)
        )

    def _sync_capacity(self) -> None:
        cap = self.store.capacity
        if self.adjacency.shape[0] < cap:
            grow = cap - self.adjacency.shape[0]
            self.adjacency = torch.cat([self.adjacency, self.adjacency.new_full((grow, self.degree), -1)])
        if len(self._members) < cap:
            grown = np.zeros(cap, dtype=bool)
            grown[: len(self._members)] = self._members
            self._members = grown

    # -- search ----------------------------------------------------------------

    def search(
        self,
        queries: np.ndarray,
        k: int,
        partitions: np.ndarray | None = None,
        allow_mask: np.ndarray | None = None,
        expansion: int | None = None,
    ) -> list[SearchResult]:
        """Beam search of the graph and exact search of the delta, merged.
        Per-query partitions are a local-index concern, which the flat
        engine serves: the graph engine refuses them."""
        return self.search_collect(self.search_begin(queries, k, partitions, allow_mask, expansion))

    @hotpath.measure
    def search_begin(
        self,
        queries: np.ndarray,
        k: int,
        partitions: np.ndarray | None = None,
        allow_mask: np.ndarray | None = None,
        expansion: int | None = None,
    ) -> GraphPendingSearch:
        """Launch the beam search and the delta's exact scan without
        waiting; pair with search_collect / collect_many."""
        if partitions is not None:
            raise ValueError("GraphDeviceIndex does not support per-query partitions")
        self._sync_capacity()
        store = self.store
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        b_real = queries.shape[0]

        graph_d = graph_i = None
        graph_ids = False
        qn: np.ndarray | None = None
        k_fetch = k
        if self._graph_nodes > 0:
            # the oversampled fetch pays off only where a host mirror
            # re-ranks the extra candidates in exact f32
            ids_path = store._vecs_host is not None
            mirror_path = self._rescore_host is not None
            if (ids_path or mirror_path) and self.oversample > 1:
                k_fetch = min(k * self.oversample, max(self._graph_nodes, 1))
            k_pad = k_bucket(k_fetch)
            qs, q_aux = prepare_queries(queries, self.space_type, self.quantization)
            ef = max(expansion or self.expansion_search, k_pad)
            filtered = allow_mask is not None
            if filtered:
                am = np.zeros((store.capacity,), dtype=bool)
                am[: allow_mask.shape[0]] = allow_mask[: store.capacity]
                allow = torch.from_numpy(am).to(self.device)
            else:
                allow = torch.ones((store.capacity,), dtype=torch.bool, device=self.device)
            graph_d, graph_i = graph_beam_search(
                store.vectors, store.aux, self._valid(), allow, self.adjacency,
                self._entries_tensor(), qs.to(self.device), q_aux.to(self.device),
                space=self.space_type, quant=self.quantization, k=k_pad, beam_width=ef,
                iters=ef, filtered=filtered, expand=self.beam_expand,
            )
            if ids_path:
                # winner ids only: exact f32 distances and epochs come from
                # the store's host mirrors at collect time
                graph_i = graph_i[:, : min(k_fetch, k_pad)]
                graph_d = None
                graph_ids = True
            if ids_path or mirror_path:
                qn = normalize_rows(queries) if self.space_type is SpaceType.COSINE else queries

        delta_pending = None
        if self._delta_slots:
            dm = np.zeros((store.capacity,), dtype=bool)
            dm[np.asarray(self._delta_slots, dtype=np.int64)] = True
            if allow_mask is not None:
                dm[: allow_mask.shape[0]] &= allow_mask[: store.capacity]
            delta_pending = store.search_begin(queries, k, allow_mask=dm)

        return GraphPendingSearch(
            graph_d=graph_d, graph_i=graph_i, delta_pending=delta_pending, b_real=b_real, k=k,
            graph_ids=graph_ids, q_f32=qn, k_fetch=k_fetch,
        )

    @hotpath.measure
    def search_collect(self, pending: GraphPendingSearch) -> list[SearchResult]:
        return self._postprocess(pending)

    def collect_many(self, pendings: list[GraphPendingSearch]) -> list[list[SearchResult]]:
        return [self.search_collect(p) for p in pendings]

    def _postprocess(self, pending: GraphPendingSearch) -> list[SearchResult]:
        b_real, k = pending.b_real, pending.k
        store = self.store
        graph_results: list[SearchResult] | None = None
        if pending.graph_ids:
            graph_results = ids_postprocess(
                store._vecs_host, store._epochs_host, self.space_type, self.dimensions,
                pull_packed(pending.graph_i)[:b_real], pending.q_f32[:b_real],
                # rescoring=False: the storage-precision beam order stays
                keep_order=not self.rescoring,
            )
        elif pending.graph_i is not None:
            kf = max(pending.k_fetch, k)
            d = pull_packed(pending.graph_d)[:b_real, :kf]
            i = pull_packed(pending.graph_i)[:b_real, :kf]
            if self._rescore_host is not None:
                # the graph's own f32 mirror re-ranks the storage-precision
                # beam candidates (the oversampling/rescoring contract)
                graph_results = ids_postprocess(
                    self._rescore_host, store._epochs_host, self.space_type, self.dimensions,
                    np.where(np.isfinite(d), i, -1), pending.q_f32[:b_real],
                )
            else:
                graph_results = dist_results(d, i, store._epochs_host)

        delta_results = None
        if pending.delta_pending is not None:
            delta_results = store.search_collect(pending.delta_pending)

        if graph_results is None and delta_results is None:
            return [
                SearchResult(
                    slots=np.empty(0, np.int64), epochs=np.empty(0, np.int32), distances=np.empty(0, np.float32)
                )
                for _ in range(b_real)
            ]
        # the k contract: after the exact re-rank only k leave the engine
        if graph_results is None:
            return [r.truncated(k) for r in delta_results]
        if delta_results is None:
            return [r.truncated(k) for r in graph_results]

        merged = []
        for g, dl in zip(graph_results, delta_results):
            slots = np.concatenate([g.slots, dl.slots])
            eps = np.concatenate([g.epochs, dl.epochs])
            dist = np.concatenate([g.distances, dl.distances])
            # a slot may sit in both regions in a race
            _, first = np.unique(slots, return_index=True)
            slots, eps, dist = slots[first], eps[first], dist[first]
            # the cross-region merge ranks by distance even with
            # rescoring=False: a fresh delta row that is the true nearest
            # must not lose to k older graph candidates
            order = np.argsort(dist, kind="stable")[:k]
            merged.append(SearchResult(slots=slots[order], epochs=eps[order], distances=dist[order]))
        return merged
