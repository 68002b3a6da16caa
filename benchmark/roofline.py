"""The least time a scan kernel could take, from the inputs of its call.

Peaks are NVIDIA's published figures for one H100 SXM (dense, at its
700 W power limit): 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the
tensor cores, 989 TFLOP/s in bf16 and fp16. An int8 row scanned by bf16
queries runs at the bf16 rate (its values are bf16-exact). A card set
below 700 W runs slower; the run prints the card's power limit beside
every share.

A call's work is what its inputs need: every live row (one whose ``b``
is not the dead rows' bias), query and (a, b) pair read once, every
candidate written once, and ``2 (Dp + 1)`` operations for each (query,
live row) pair. Rows the kernel reads but no answer needs (a cluster's
padding up to ``cmax``, the delta's free capacity, deleted rows) are not
counted, so a kernel that learns to skip them moves its share up. For
the compact IVF scan that is the live rows of the clusters that hold a
scanned pair, each scanned by that cluster's pairs only; for the fused
scan over the delta, its live rows, with a candidate per lane of each
block they fill.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float16": 989e12, "bfloat16": 989e12}
ELEMENT_BYTES = {"float32": 4, "float16": 2, "bfloat16": 2, "int8": 1}
LANES = 128  # candidates a (query, block or cluster) writes: (rank f32, row i32) each


def bound_s(nbytes: float, ops: float, op_dtype: str) -> tuple[float, str]:
    """(seconds, "bytes" or "ops"): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[op_dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")


def scan_work(n_rows: int, n_queries: int, pairs: int, dp: int, row_dtype: str, q_dtype: str,
              n_out: int) -> tuple[float, float]:
    """(bytes, operations) of a rank scan: ``n_rows`` rows with their (a, b),
    ``n_queries`` queries, ``n_out`` candidates written, ``pairs`` (query,
    row) pairs."""
    nbytes = (n_rows * (dp * ELEMENT_BYTES[row_dtype] + 8) + n_queries * dp * ELEMENT_BYTES[q_dtype]
              + n_out * 8)
    return nbytes, 2.0 * pairs * (dp + 1)


def fused_scan_bound(nq: int, rows: int, dp: int, dtype: str, block_rows: int) -> float:
    """Seconds: the fused scan of nq queries over ``rows`` live rows (the
    IVF delta's), writing one candidate per lane of each block of
    ``block_rows`` they fill."""
    blocks = math.ceil(rows / block_rows)
    nbytes, ops = scan_work(rows, nq, nq * rows, dp, dtype, dtype, nq * blocks * LANES)
    return bound_s(nbytes, ops, dtype)[0]


def pairs_scan_bound(pairs: list[int], rows: list[int], dp: int, row_dtype: str, q_dtype: str) -> float:
    """Seconds: the compact grouped scan of ``pairs[c]`` (query, cluster)
    pairs over the ``rows[c]`` live rows of each cluster c."""
    scanned = sum(pairs)
    read = sum(r for p, r in zip(pairs, rows) if p)
    nbytes, ops = scan_work(read, scanned, sum(p * r for p, r in zip(pairs, rows)), dp, row_dtype, q_dtype,
                            scanned * LANES)
    return bound_s(nbytes, ops, q_dtype)[0]
