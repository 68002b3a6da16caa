"""IVF (inverted-file) partitioned scan: k-means + the grouped scan (kernel 2).

Counterpart of vector_store_tpu/ops/ivf.py:

1. k-means clusters the stored rows; storage is laid out cluster-major
   ([nlist * cmax, Dp], each cluster padded to ``cmax`` rows). I8 rows are
   scanned by true-scale bf16 queries, with the 127x storage scale folded
   into the rank coefficients by the engine.
2. A search batch scores all centroids with one matrix product and picks
   ``nprobe`` clusters per query.
3. The (query, cluster) pairs are sorted by cluster, stably (a cluster
   keeps its pairs in arrival order), and the first S pairs of each
   cluster win it; the rest drop, as in the JAX engine, whose static
   shapes laid them out in per-cluster query slots of the budget S.
4. The kernel scans each cluster's rows against its pairs: the same
   affine rank and per-lane group minimum as the flat scan.
5. Each query's nprobe * 128 candidates merge with an exact top-k.

Two layouts of step 3 and 4. The JAX package's is the dense slot plane
(``regroup_pairs`` and ``grouped_scan``: nlist * S query rows, most of
them empty once S is raised for a skewed batch); the search path
(``ivf_candidates``) takes the compact pair list (``compact_pairs`` and
``grouped_scan_pairs``: the B * nprobe pairs in (cluster, arrival)
order, each cluster's winners a contiguous run), whose work is the pairs
that are scanned whatever S is. Both drop the same pairs, so S only
decides which pairs drop.

The probe, sort and merge are plain PyTorch, as they were XLA outside
the Pallas kernel. Both scans take their plain versions for CPU tensors
and launch csrc/grouped_scan.cu for CUDA tensors (tensor-core MMAs with
f32 accumulation for F16/BF16/I8 rows, f32 FMAs on the CUDA cores for
F32 rows, any row length); the dense scan takes ``g`` clusters per CUDA
block (the Pallas kernel's g clusters per grid step, kernel 4 of the JAX
package's scripts/ivf_stage_opt2.py).
"""

from __future__ import annotations

import collections
import math

import torch

from vector_store_tpu_torch.ops import kernels
from vector_store_tpu_torch.ops.fused_scan import (
    INVALID_BIAS,
    INVALID_CUTOFF,
    LANES,
    check_scan_inputs,
    require_cuda,
)

# -- geometry ----------------------------------------------------------------

CLUSTER_CHUNK = LANES  # cmax granularity: whole lane groups


def choose_nlist(n: int) -> int:
    """Cluster count ~ 2*sqrt(N), power of two, clamped to [64, 8192]
    (smaller clusters spread a query's top-k over several cells, which
    divides the lane-collision rate of the group minimum)."""
    if n <= 0:
        return 64
    exp = int(round(math.log2(max(math.sqrt(n), 1.0)))) + 1
    return min(max(2**exp, 64), 8192)


def choose_cmax(n: int, nlist: int, headroom: float = 1.6) -> int:
    """Per-cluster row capacity: average fill x headroom, rounded up to a
    whole number of 128-row lane groups. (The JAX package rounded up to a
    coarse ladder so rebuilds reused compiled programs; PyTorch compiles
    nothing per shape.)"""
    avg = max(1, -(-n // nlist))
    need = math.ceil(avg * headroom)
    return -(-need // CLUSTER_CHUNK) * CLUSTER_CHUNK


def choose_budget(b: int, nprobe: int, nlist: int) -> int:
    """Per-cluster query-slot budget S: 2x the balanced average, rounded
    to a power of two >= 16."""
    avg = max(1, (b * nprobe) // max(nlist, 1))
    s = 16
    while s < 2 * avg and s < 1024:
        s *= 2
    return s


# -- k-means -------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in f32: the JAX package's k-means and
    probe products took bf16 operands with f32 accumulation."""
    return x.to(torch.bfloat16).float()


def _affinity(xb: torch.Tensor, cent: torch.Tensor, spherical: bool) -> torch.Tensor:
    dot = _bf16(xb) @ _bf16(cent).T
    if spherical:
        norm = cent.square().sum(-1).sqrt()
        return dot / torch.clamp(norm, min=1e-20)[None, :]
    return 2.0 * dot - cent.square().sum(-1)[None, :]


def kmeans_step(
    x: torch.Tensor,  # [N, Dp] storage dtype (I8: the raw int8 codes)
    w: torch.Tensor | None,  # [N] f32 weights (None = all 1)
    cent: torch.Tensor,  # [nlist, Dp] f32
    *,
    block: int = 16384,
    spherical: bool = False,
) -> torch.Tensor:
    """One Lloyd iteration over row blocks -> new centroids (empty clusters
    keep their centroid)."""
    nlist, dp = cent.shape
    sums = torch.zeros((nlist, dp), dtype=torch.float32, device=x.device)
    counts = torch.zeros((nlist,), dtype=torch.float32, device=x.device)
    for lo in range(0, x.shape[0], block):
        xb = x[lo : lo + block]
        lbl = _affinity(xb, cent, spherical).argmax(dim=-1)
        if w is None:
            sums.index_add_(0, lbl, _bf16(xb))
            counts.index_add_(0, lbl, torch.ones_like(lbl, dtype=torch.float32))
        else:
            wb = w[lo : lo + block]
            sums.index_add_(0, lbl, _bf16(xb) * wb[:, None])
            counts.index_add_(0, lbl, wb)
    newc = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where((counts > 0.5)[:, None], newc, cent)


def kmeans_assign(
    x: torch.Tensor,  # [N, Dp]
    cent: torch.Tensor,  # [nlist, Dp] f32
    *,
    block: int = 16384,
    spherical: bool = False,
    top2: bool = False,
) -> torch.Tensor:
    """Nearest-centroid labels [N] i32, or [N, 2] (nearest, second
    nearest) with ``top2`` for the layout's second-choice placement."""
    out = []
    for lo in range(0, x.shape[0], block):
        aff = _affinity(x[lo : lo + block], cent, spherical)
        if top2:
            out.append(torch.topk(aff, 2, dim=-1).indices)
        else:
            out.append(aff.argmax(dim=-1))
    return torch.cat(out).to(torch.int32)


def kmeans(
    x: torch.Tensor,
    w: torch.Tensor | None,
    *,
    nlist: int,
    generator: torch.Generator,
    iters: int = 8,
    block: int = 16384,
    spherical: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k-means over [N, Dp] rows from ``nlist`` random rows (drawn with
    ``generator``, which must live on x's device). Returns (centroids f32
    [nlist, Dp], labels i32 [N])."""
    idx = torch.randint(
        0, x.shape[0], (nlist,), generator=generator, device=x.device
    )
    cent = x[idx].float()
    for _ in range(iters):
        cent = kmeans_step(x, w, cent, block=block, spherical=spherical)
    return cent, kmeans_assign(x, cent, block=block, spherical=spherical)


# -- cluster-major layout ------------------------------------------------------


def _rank_in_run(key: torch.Tensor):
    """Stable sort by key -> (order, sorted keys, rank within each key's
    run: rows keep their arrival order inside a cluster)."""
    sk, order = torch.sort(key, stable=True)
    idx = torch.arange(key.shape[0], device=key.device)
    is_new = torch.ones_like(sk, dtype=torch.bool)
    is_new[1:] = sk[1:] != sk[:-1]
    seg_start = torch.cummax(torch.where(is_new, idx, 0), dim=0).values
    return order, sk, idx - seg_start


def ivf_layout(
    labels: torch.Tensor,  # [N] i32 nearest cluster
    live: torch.Tensor,  # [N] bool
    *,
    nlist: int,
    cmax: int,
    labels2: torch.Tensor | None = None,  # [N] i32 second-nearest cluster
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cluster-major position per row: (pos [N] i64, label*cmax + rank or
    -1 for dead rows and rows that fit no cluster; overflow [N] bool, live
    rows that must spill to the delta region).

    With ``labels2``, rows overflowing their first cluster take a slot in
    their second cluster after that cluster's first-round rows, when it
    has room; only rows overflowing both spill."""
    n = labels.shape[0]
    labels = labels.long()
    key = torch.where(live, labels, nlist)  # dead rows sort last
    order, sk, rank = _rank_in_run(key)
    fits = (rank < cmax) & (sk < nlist)
    pos = torch.empty((n,), dtype=torch.long, device=labels.device)
    pos[order] = torch.where(fits, sk * cmax + rank, -1)
    overflow = torch.empty((n,), dtype=torch.bool, device=labels.device)
    overflow[order] = (~fits) & (sk < nlist)
    if labels2 is None:
        return pos, overflow
    count1 = torch.bincount(torch.where(fits, sk, nlist), minlength=nlist + 1)
    key2 = torch.where(overflow, labels2.long(), nlist)
    order2, sk2, rank2 = _rank_in_run(key2)
    base2 = count1[sk2]
    fits2 = (rank2 + base2 < cmax) & (sk2 < nlist)
    pos2 = torch.empty((n,), dtype=torch.long, device=labels.device)
    pos2[order2] = torch.where(fits2, sk2 * cmax + base2 + rank2, -1)
    placed2 = overflow & (pos2 >= 0)
    return torch.where(placed2, pos2, pos), overflow & ~placed2


# -- grouped scan (kernels 2 and 4): the dense slot plane and the pair list -------


def choose_g() -> int:
    """Clusters per CUDA block of the grouped scan.

    On the TPU a grid step had a fixed cost that g clusters per step
    amortised, and _choose_g took the largest g its VMEM budget allowed.
    On the H100 the blocks run in parallel; a block sets up its ring once
    and then scans its g clusters one after the other, each exactly as a
    block of its own would, so g only trades the block count (and that
    set-up) for the work of each block. The rule is the g sweep of
    chip_smoke.py at two shapes (NVIDIA H100 80GB HBM3, 700 W; PERF.md
    section 5), g = 1 / 2 / 4 / 8 in two runs of the tensor-core and
    register-tiled cores: at the stage ablation's shape (BF16 nlist 2048 x
    cmax 1024, s 128) 0.403 / 0.392 / 0.389 / 0.383 ms and 0.390 / 0.403 /
    0.381 / 0.390 ms, no g ahead of g = 1 in both; at the global smoke's
    (F32 nlist 2048 x cmax 768, s 32) 0.415 / 0.454 / 0.455 / 0.463 ms and
    0.481 / 0.486 / 0.487 / 0.489 ms, g = 1 ahead in both. So one cluster
    per block, at every shape."""
    return 1


def grouped_scan_plain(
    queries_grouped: torch.Tensor,  # [nlist*s, Dp]
    vectors: torch.Tensor,  # [nlist*cmax, Dp]
    a: torch.Tensor,  # [nlist*cmax] f32
    b: torch.Tensor,  # [nlist*cmax] f32
    s: int,
    cmax: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: per slot and lane, the smallest
    rank among the slot's cluster rows at that lane and its absolute row.
    Queries and rows may differ in dtype (bf16 queries over I8 rows); both
    are taken in f32. Returns (rank [nlist*s, 128] f32, row [nlist*s, 128]
    i32)."""
    dp = vectors.shape[1]
    nlist = vectors.shape[0] // cmax
    q = queries_grouped.float().view(nlist, s, dp)
    v = vectors.float().view(nlist, cmax, dp)
    rank = a.view(nlist, 1, cmax) * torch.bmm(q, v.transpose(1, 2)) + b.view(
        nlist, 1, cmax
    )
    rank, j = rank.view(nlist, s, cmax // LANES, LANES).min(dim=2)
    base = torch.arange(nlist, device=vectors.device).view(nlist, 1, 1) * cmax
    row = base + j * LANES + torch.arange(LANES, device=vectors.device)
    return rank.reshape(nlist * s, LANES), row.to(torch.int32).reshape(-1, LANES)


def grouped_scan(
    queries_grouped: torch.Tensor,
    vectors: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    s: int,
    cmax: int,
    g: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(slot, lane) minimum rank over the slot's cluster; see the
    module docstring. ``g`` clusters per CUDA block (None: ``choose_g``)
    must divide nlist; the result does not depend on it. Rows are float
    with queries of their dtype, or int8 (I8 storage) with bf16 queries.
    CPU tensors take the plain version, CUDA tensors the kernel."""
    check_scan_inputs(queries_grouped, vectors, a, b, i8_rows=True)
    npos, dp = vectors.shape
    nlist = npos // cmax
    if cmax % LANES or npos != nlist * cmax or queries_grouped.shape[0] != nlist * s:
        raise ValueError(
            f"grouped scan shapes: vectors {npos} rows for cmax {cmax} "
            f"(a multiple of {LANES}), queries {queries_grouped.shape[0]} "
            f"rows for s {s}"
        )
    if g is None:
        g = choose_g()
    if g < 1 or nlist % g:
        raise ValueError(f"g = {g} clusters per block must divide nlist = {nlist}")
    if vectors.device.type == "cpu":
        return grouped_scan_plain(queries_grouped, vectors, a, b, s, cmax)
    require_cuda(vectors)
    rank = torch.empty((nlist * s, LANES), dtype=torch.float32, device=vectors.device)
    row = torch.empty((nlist * s, LANES), dtype=torch.int32, device=vectors.device)
    if nlist:
        kernels.launch(
            "vst_grouped_scan",
            [queries_grouped, vectors, a, b, rank, row],
            [nlist, s, cmax, dp, kernels.DTYPE_CODES[vectors.dtype], g],
        )
        with kernels.count_lock:
            grouped_scan.launches += 1
            grouped_scan.launches_by[str(vectors.dtype).removeprefix("torch."), g] += 1
    return rank, row


grouped_scan.launches = 0
# (storage dtype name, g) -> launches: the I8 instantiation and g > 1
# (kernel 4) are counted apart from the float scan at g = 1, and the
# compact scan's launches (grouped_scan_pairs) under g = PAIRS
grouped_scan.launches_by = collections.Counter()
PAIRS = "pairs"


def grouped_scan_pairs_plain(
    queries: torch.Tensor,  # [P, Dp] the pairs' queries in (cluster, arrival) order
    vectors: torch.Tensor,  # [nlist*cmax, Dp]
    a: torch.Tensor,  # [nlist*cmax] f32
    b: torch.Tensor,  # [nlist*cmax] f32
    starts: torch.Tensor,  # [nlist] i32 first pair of each cluster
    counts: torch.Tensor,  # [nlist] i32 pairs each cluster scans
    cmax: int,
    clusters: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the compact kernel: pair starts[c] + i (i <
    counts[c]) against cluster c's rows, per lane the smallest rank and its
    absolute row, with the dense plain version's tie rule (it is that
    version, over the pairs of ``clusters`` clusters at a time padded to
    the largest count among them). Returns (rank [P, 128] f32, row [P,
    128] i32); rows of pairs that are not scanned hold INVALID_BIAS and -1
    (the kernel leaves them unwritten)."""
    dev = vectors.device
    nlist = vectors.shape[0] // cmax
    rank = torch.full((queries.shape[0], LANES), INVALID_BIAS, dtype=torch.float32, device=dev)
    row = torch.full((queries.shape[0], LANES), -1, dtype=torch.int32, device=dev)
    width_of = counts.tolist()
    for c0 in range(0, nlist, clusters):
        c1 = min(nlist, c0 + clusters)
        width = max(width_of[c0:c1])
        if width == 0:
            continue
        i = torch.arange(width, device=dev)
        keep = i < counts[c0:c1, None]
        take = torch.where(keep, starts[c0:c1, None].long() + i, 0)  # [clusters, width]
        r, p = grouped_scan_plain(
            queries[take.reshape(-1)], vectors[c0 * cmax : c1 * cmax],
            a[c0 * cmax : c1 * cmax], b[c0 * cmax : c1 * cmax], width, cmax,
        )
        rank[take[keep]] = r.view(c1 - c0, width, LANES)[keep]
        row[take[keep]] = p.view(c1 - c0, width, LANES)[keep] + c0 * cmax
    return rank, row


def grouped_scan_pairs(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    *,
    cmax: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The grouped scan over a compact pair list (``compact_pairs``): per
    scanned pair and lane, the minimum rank over its cluster's rows and
    that row. Rows of pairs that are not scanned are left unwritten (CUDA)
    or hold INVALID_BIAS and -1 (CPU). Rows are float with queries of
    their dtype, or int8 (I8 storage) with bf16 queries. CPU tensors take
    the plain version, CUDA tensors csrc/grouped_scan.cu's compact entry,
    whose work is the scanned pairs: its grid follows B * nprobe, never
    the slot budget."""
    check_scan_inputs(queries, vectors, a, b, i8_rows=True)
    npos, dp = vectors.shape
    nlist = npos // cmax
    if cmax % LANES or npos != nlist * cmax:
        raise ValueError(
            f"grouped scan shapes: vectors {npos} rows for cmax {cmax} (a multiple of {LANES})"
        )
    for name, t in (("starts", starts), ("counts", counts)):
        if t.shape != (nlist,) or t.dtype != torch.int32 or t.device != vectors.device:
            raise ValueError(f"{name} must be [{nlist}] int32 on {vectors.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if vectors.device.type == "cpu":
        return grouped_scan_pairs_plain(queries, vectors, a, b, starts, counts, cmax)
    require_cuda(vectors)
    n_pairs = queries.shape[0]
    rank = torch.empty((n_pairs, LANES), dtype=torch.float32, device=vectors.device)
    row = torch.empty((n_pairs, LANES), dtype=torch.int32, device=vectors.device)
    if nlist and n_pairs:
        # the kernel's scratch: each cluster's first query tile and the total,
        # then the cluster of every tile (at most ceil(P / 16) + nlist tiles)
        tiles = torch.empty((2 * nlist + 1 + -(-n_pairs // 16),), dtype=torch.int32, device=vectors.device)
        kernels.launch(
            "vst_grouped_scan_pairs",
            [queries, vectors, a, b, starts, counts, tiles, rank, row],
            [nlist, cmax, dp, kernels.DTYPE_CODES[vectors.dtype], n_pairs],
        )
        with kernels.count_lock:
            grouped_scan_pairs.launches += 1
            grouped_scan.launches_by[str(vectors.dtype).removeprefix("torch."), PAIRS] += 1
    return rank, row


grouped_scan_pairs.launches = 0


# -- search ------------------------------------------------------------------------


def ivf_probe(
    centroids: torch.Tensor,  # [nlist, Dp] f32
    queries: torch.Tensor,  # [B, Dp] storage dtype
    q_live: torch.Tensor,  # [B] bool
    *,
    nprobe: int,
    spherical: bool,
) -> torch.Tensor:
    """Clusters per query by centroid affinity -> [B, nprobe] i64 cluster
    ids (exact top-k; padding rows parked at the sentinel id nlist)."""
    probes = torch.topk(_affinity(queries, centroids, spherical), nprobe, dim=-1)
    return torch.where(q_live[:, None], probes.indices, centroids.shape[0])


def regroup_pairs(
    probes: torch.Tensor,  # [B, nprobe] cluster ids (sentinel >= nlist)
    *,
    nlist: int,
    s: int,
):
    """Regroup (query, cluster) pairs into the dense slot plane of the
    JAX package's kernel (``grouped_scan``): s query slots a cluster.

    Returns (qtab [nlist*s] query index per slot, filled [nlist*s] bool,
    row_of_pair [B, nprobe] slot row or -1 for dropped/sentinel pairs).
    Pairs rank within their cluster first-come by pair index (b-major), a
    stable sort; the first ``s`` win the cluster's slots. The search path
    takes ``compact_pairs``, which drops the same pairs."""
    b, nprobe = probes.shape
    dev = probes.device
    sidx, sc, rank = _rank_in_run(probes.reshape(-1))
    ok = (rank < s) & (sc < nlist)
    row = sc * s + torch.clamp(rank, max=s - 1)
    plane = torch.zeros((nlist * s + 1,), dtype=torch.long, device=dev)
    plane[torch.where(ok, row, nlist * s)] = sidx // nprobe + 1  # extra row: drops
    plane = plane[:-1]
    row_of_pair = torch.full((b * nprobe,), -1, dtype=torch.long, device=dev)
    row_of_pair[sidx] = torch.where(ok, row, -1)
    return torch.clamp(plane - 1, min=0), plane > 0, row_of_pair.view(b, nprobe)


def compact_pairs(
    probes: torch.Tensor,  # [B, nprobe] cluster ids (sentinel >= nlist)
    *,
    nlist: int,
    s: int,
):
    """The (query, cluster) pairs in (cluster, arrival) order, for
    ``grouped_scan_pairs``: the stable sort of ``regroup_pairs``, without
    its slot plane.

    Returns (qidx [B*nprobe] i64 the query of each sorted pair, starts
    [nlist] i32 the sorted position of each cluster's first pair, counts
    [nlist] i32 the pairs a cluster scans, min(its pairs, s), row_of_pair
    [B, nprobe] i64 the pair's sorted position if it won one of its
    cluster's first ``s`` places, else -1). A kept pair's dense slot is
    c * s + (its position - starts[c]), so the same pairs drop as in
    ``regroup_pairs`` and the JAX engine. Shapes depend on B and nprobe
    only: no host synchronisation."""
    b, nprobe = probes.shape
    dev = probes.device
    sidx, sc, rank = _rank_in_run(probes.reshape(-1))
    ok = (rank < s) & (sc < nlist)
    # sentinel pairs (>= nlist) sort last, past every cluster's run
    bounds = torch.searchsorted(
        sc, torch.arange(nlist + 1, dtype=sc.dtype, device=dev), out_int32=True
    )
    starts = bounds[:-1]
    counts = torch.clamp(bounds[1:] - starts, max=s)
    pos = torch.arange(sc.shape[0], device=dev)
    row_of_pair = torch.full((b * nprobe,), -1, dtype=torch.long, device=dev)
    row_of_pair[sidx] = torch.where(ok, pos, -1)
    return sidx // nprobe, starts, counts, row_of_pair.view(b, nprobe)


def ivf_candidates(
    vectors: torch.Tensor,  # [nlist*cmax, Dp] storage dtype (cluster-major)
    a: torch.Tensor,  # [nlist*cmax] f32
    b: torch.Tensor,  # [nlist*cmax] f32
    centroids: torch.Tensor,  # [nlist, Dp] f32
    queries: torch.Tensor,  # [B, Dp] storage dtype
    q_live: torch.Tensor,  # [B] bool
    *,
    k: int,
    nprobe: int,
    s: int,
    cmax: int,
    spherical: bool,
    probes: torch.Tensor | None = None,  # [B, nprobe] precomputed (sharded path)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe -> compact pairs -> grouped scan of the pairs -> merge.
    Returns (rank [B, k] f32 ascending, pos [B, k] i32 cluster-major
    positions or -1, dropped [B] i32: live (query, cluster) pairs that
    lost their cluster's race for its first ``s`` places and were not
    scanned; the engine re-dispatches those queries). The answers are
    the JAX package's, whose kernel scanned the dense slot plane.

    Given ``probes`` (cluster ids local to ``vectors``, the sentinel >=
    nlist for a pair another shard owns), the probe is skipped and
    ``centroids`` and ``nprobe`` are not read."""
    nlist = vectors.shape[0] // cmax
    if probes is None:
        nprobe = min(nprobe, nlist)
        probes = ivf_probe(centroids, queries, q_live, nprobe=nprobe, spherical=spherical)
    qidx, starts, counts, row_of_pair = compact_pairs(probes, nlist=nlist, s=s)
    dropped = ((row_of_pair < 0) & (probes < nlist)).sum(dim=1, dtype=torch.int32)
    dropped = torch.where(q_live, dropped, 0)

    rank_out, row_out = grouped_scan_pairs(queries[qidx], vectors, a, b, starts, counts, cmax=cmax)
    best_rank, best_pos = merge_candidates(rank_out, row_out, row_of_pair, k=k)
    return best_rank, best_pos, dropped


def merge_candidates(
    rank_out: torch.Tensor,  # [rows, 128] f32 candidates of each scanned slot or pair
    row_out: torch.Tensor,  # [rows, 128] i32 their cluster-major rows
    row_of_pair: torch.Tensor,  # [B, nprobe] the pair's row of rank_out, or -1
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each query's nprobe * 128 candidates -> exact top-k (rank [B, k] f32
    ascending, pos [B, k] i32 or -1). Only rows that ``row_of_pair``
    names are read (a scan writes no other), and only the winners' rows
    are gathered from ``row_out``."""
    nq, nprobe = row_of_pair.shape
    safe_row = torch.clamp(row_of_pair, min=0)  # [B, nprobe]
    cand = torch.where(
        (row_of_pair >= 0)[:, :, None], rank_out[safe_row], INVALID_BIAS
    ).view(nq, nprobe * LANES)
    kk = min(k, cand.shape[1])
    best_rank, sel = torch.topk(cand, kk, dim=1, largest=False, sorted=True)
    slot_row = torch.gather(safe_row, 1, sel // LANES)
    best_pos = row_out[slot_row, sel % LANES]
    if kk < k:
        best_rank = torch.nn.functional.pad(best_rank, (0, k - kk), value=INVALID_BIAS)
        best_pos = torch.nn.functional.pad(best_pos, (0, k - kk), value=-1)
    best_pos = torch.where(best_rank < INVALID_CUTOFF, best_pos, -1)
    return best_rank, best_pos
