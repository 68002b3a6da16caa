"""Partition rank scan (kernel 3) and the local-index search built on it.

Counterpart of vector_store_tpu/ops/partition_scan.py. A local
(per-partition) index keeps a partition-major mirror of its rows: bucket
p owns positions [p * pmax, (p + 1) * pmax) of ``part_vecs``, with the
same rank coefficients (a, b) as the flat scan (empty positions carry
b = INVALID_BIAS). Query i reads only its own bucket ``bsel[i]``, so a
search costs O(B * pmax * Dp) whatever the table's row count (the
reference's per-partition sub-indexes, usearch.rs:626-670). For each
query and lane l in [0, 128) the scan keeps the position with the
smallest rank among the bucket's positions at offsets == l (mod 128),
ties going to the smaller position.

``partition_scan`` takes its plain PyTorch version for tensors on the
CPU and launches csrc/partition_scan.cu for tensors on a CUDA device;
there is no other fallback. The kernel sorts the batch by bucket on the
card (as ``bucket_order`` does), so that it reads each bucket once for
every tile of up to ``TILE_QUERIES`` of its queries (``tiles``); the
wrapper cuts each bucket's rows into chunks when the batch is too small
to fill the card (``chunk_rows_for``), and the kernel merges the chunks
as ``merge_chunks_plain`` does. Unlike the Pallas kernel, queries are not
replicated 8 times (a Mosaic sublane rule), winners come back as int32
absolute positions instead of f32 offsets, and (a, b) are two f32
vectors instead of an [8, P_cap * pmax] side array.

Group-min is approximate: two true neighbours at the same lane of one
bucket collide and only one survives (the JAX kernel has the same rule).
"""

from __future__ import annotations

import functools

import torch

from vector_store_tpu_torch.ops import kernels
from vector_store_tpu_torch.ops.fused_scan import (
    INVALID_BIAS,
    INVALID_CUTOFF,
    LANES,
    check_scan_inputs,
    require_cuda,
)

# elements of one gathered [queries, pmax, Dp] chunk of the plain version
# (64 MB in f32): a whole batch at B 2048, pmax 1024, Dp 128 would be 1 GB
PLAIN_CHUNK_ELEMS = 1 << 24
# queries a CUDA block: TILE of csrc/partition_scan.cu (the query tile of
# its cores, TensorScan<T, T, 16> and F32Scan<1, 2>)
TILE_QUERIES = 16


def partition_scan_plain(
    part_vecs: torch.Tensor,  # [P_cap * pmax, Dp] storage dtype
    a: torch.Tensor,  # [P_cap * pmax] f32
    b: torch.Tensor,  # [P_cap * pmax] f32
    queries: torch.Tensor,  # [B, Dp] storage dtype
    bsel: torch.Tensor,  # [B] i32 bucket per query, 0 <= bsel < P_cap
    pmax: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (rank [B, 128] f32, pos [B, 128]
    i32 absolute positions in the partition-major arrays). Gathers the
    queries' buckets a chunk of queries at a time."""
    nq, dp = queries.shape
    dev = part_vecs.device
    vb = part_vecs.view(-1, pmax, dp)
    ab, bb = a.view(-1, pmax), b.view(-1, pmax)
    rank = torch.empty((nq, LANES), dtype=torch.float32, device=dev)
    pos = torch.empty((nq, LANES), dtype=torch.int32, device=dev)
    step = max(1, PLAIN_CHUNK_ELEMS // (pmax * dp))
    lane = torch.arange(LANES, device=dev)
    for lo in range(0, nq, step):
        sel = bsel[lo : lo + step].long()
        dot = torch.einsum("bd,bmd->bm", queries[lo : lo + step].float(), vb[sel].float())
        r = ab[sel] * dot + bb[sel]
        r, j = r.view(-1, pmax // LANES, LANES).min(dim=1)
        rank[lo : lo + step] = r
        pos[lo : lo + step] = (sel[:, None] * pmax + j * LANES + lane).to(torch.int32)
    return rank, pos


def bucket_order(bsel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The batch sorted by bucket: (perm [B] i64, the permutation of a
    stable sort; sorted_bsel [B] i32 = bsel[perm]; run_start [B] i32, the
    first sorted position of each sorted query's bucket). Plain version of
    the kernel's first step (order_queries in csrc/partition_scan.cu), which
    also gathers the queries in this order."""
    sorted_bsel, perm = torch.sort(bsel, stable=True)
    run_start = torch.searchsorted(sorted_bsel, sorted_bsel, out_int32=True)
    return perm, sorted_bsel, run_start


def tiles(sorted_bsel: torch.Tensor, run_start: torch.Tensor, tile: int = TILE_QUERIES) -> torch.Tensor:
    """The kernel's query tiles, [n_tiles, 2] (first sorted position, query
    count), in its rule: block i works where (i - run_start[i]) % tile == 0
    and takes the next queries of its bucket, at most ``tile``. Plain
    version of the kernel's tiling (the CPU path does not tile)."""
    i = torch.arange(sorted_bsel.shape[0], device=sorted_bsel.device)
    first = i[(i - run_start.long()) % tile == 0]
    run_end = torch.searchsorted(sorted_bsel, sorted_bsel, right=True)
    return torch.stack([first, torch.clamp(run_end[first] - first, max=tile)], dim=1)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunk_rows_for(nq: int, pmax: int, sms: int) -> int:
    """Rows of a bucket that one block scans. A batch of nq queries has at
    most nq tiles; while those give the card's ``sms`` multiprocessors two
    blocks each, a block takes the whole bucket. Below that, each bucket's
    rows are cut into at least 2 * sms / nq chunks of whole 128-row lane
    groups (at most one chunk a lane group), chunk c of every tile in a
    block of its own."""
    groups = pmax // LANES
    splits = min(groups, max(1, -(-2 * sms // max(nq, 1))))
    return LANES * (groups // splits)


def merge_chunks_plain(
    chunk_rank: torch.Tensor,  # [splits, B, 128] f32, chunks in row order
    chunk_pos: torch.Tensor,  # [splits, B, 128] i32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel's chunk merge: a later chunk's candidate
    replaces the earlier one only at a strictly lower rank, so the result
    is the unsplit fold's (equal ranks go to the smaller position)."""
    rank, pos = chunk_rank[0], chunk_pos[0]
    for c in range(1, chunk_rank.shape[0]):
        lower = chunk_rank[c] < rank
        rank = torch.where(lower, chunk_rank[c], rank)
        pos = torch.where(lower, chunk_pos[c], pos)
    return rank, pos


def partition_scan(
    part_vecs: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    queries: torch.Tensor,
    bsel: torch.Tensor,
    pmax: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(query, lane) minimum rank over the query's bucket; see the
    module docstring. CPU tensors take the plain version, CUDA tensors the
    kernel."""
    check_scan_inputs(queries, part_vecs, a, b)
    npos, dp = part_vecs.shape
    if pmax <= 0 or pmax % LANES or npos % pmax or npos >= 2**31:
        raise ValueError(
            f"partition scan shapes: {npos} positions for pmax {pmax} (a "
            f"multiple of {LANES}), under 2**31 positions"
        )
    nq = queries.shape[0]
    if bsel.dtype != torch.int32 or bsel.shape != (nq,) or not bsel.is_contiguous():
        raise ValueError(f"bsel must be a contiguous int32 [{nq}] tensor")
    if bsel.device != queries.device:
        raise ValueError(f"bsel on {bsel.device}, queries on {queries.device}")
    if queries.device.type == "cpu":
        return partition_scan_plain(part_vecs, a, b, queries, bsel, pmax)
    require_cuda(queries)
    if queries.data_ptr() % 16:
        raise ValueError("queries must start on a 16-byte boundary (the kernel copies rows 16 bytes at a time)")
    dev = queries.device
    rank = torch.empty((nq, LANES), dtype=torch.float32, device=dev)
    pos = torch.empty((nq, LANES), dtype=torch.int32, device=dev)
    if nq:
        chunk = chunk_rows_for(nq, pmax, _sm_count(dev.index or 0))
        # one scratch buffer (one allocation: the host time of a launch is
        # the time of a small batch): the sorted queries [nq, dp], the
        # chunks' candidates (rank f32, pos i32) [splits, nq, 128] each, and
        # (perm, sorted bsel, run starts) [3, nq] i32
        q_bytes = queries.numel() * queries.element_size()
        chunk_bytes = -(-pmax // chunk) * nq * LANES * 4
        work = torch.empty((q_bytes + 2 * chunk_bytes + 3 * nq * 4,), dtype=torch.uint8, device=dev)
        base = work.data_ptr()
        kernels.launch(
            "vst_partition_scan",
            [queries, part_vecs, a, b, bsel, base, base + q_bytes + 2 * chunk_bytes, base + q_bytes,
             base + q_bytes + chunk_bytes, rank, pos],
            [nq, npos // pmax, pmax, dp, kernels.DTYPE_CODES[queries.dtype], chunk],
        )
        with kernels.count_lock:
            partition_scan.launches += 1
    return rank, pos


partition_scan.launches = 0


def partition_candidates(
    part_vecs: torch.Tensor,  # [P_cap * pmax, Dp]
    a: torch.Tensor,  # [P_cap * pmax] f32
    b: torch.Tensor,  # [P_cap * pmax] f32
    part_rows: torch.Tensor,  # [P_cap, pmax] i32 position -> engine slot (-1)
    queries: torch.Tensor,  # [B, Dp]
    bsel: torch.Tensor,  # [B] i32 bucket (-1 = unknown partition)
    *,
    k: int,
    pmax: int,
) -> torch.Tensor:
    """Partitioned search -> [B, k] i32 engine slots sorted by rank (-1
    empty). Exact distances and epochs are resolved host-side
    (ids_postprocess)."""
    rank, pos = partition_scan(
        part_vecs, a, b, queries, torch.clamp(bsel, min=0), pmax
    )
    slot = part_rows.view(-1)[pos.long()]
    rank = torch.where((bsel[:, None] >= 0) & (slot >= 0), rank, INVALID_BIAS)
    kk = min(k, LANES)
    best, sel = torch.topk(rank, kk, dim=1, largest=False, sorted=True)
    ids = torch.where(best < INVALID_CUTOFF, torch.gather(slot, 1, sel), -1)
    if kk < k:
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
    return ids
