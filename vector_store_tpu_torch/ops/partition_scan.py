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
there is no other fallback. Unlike the Pallas kernel, queries are not
replicated 8 times (a Mosaic sublane rule), winners come back as int32
absolute positions instead of f32 offsets, and (a, b) are two f32
vectors instead of an [8, P_cap * pmax] side array.

Group-min is approximate: two true neighbours at the same lane of one
bucket collide and only one survives (the JAX kernel has the same rule).
"""

from __future__ import annotations

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
    rank = torch.empty((nq, LANES), dtype=torch.float32, device=queries.device)
    pos = torch.empty((nq, LANES), dtype=torch.int32, device=queries.device)
    if nq:
        kernels.launch(
            "vst_partition_scan",
            [queries, part_vecs, a, b, bsel, rank, pos],
            [nq, npos // pmax, pmax, dp, kernels.DTYPE_CODES[queries.dtype]],
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
