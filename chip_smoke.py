#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vector_store_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU, nvcc and the repository checkout; it exits
non-zero (and prints no result) without them. Phases, each fatal on
failure:

1. device: CUDA present; the card's name and power limit (nvidia-smi).
2. build: the scan kernels of csrc/ compiled with nvcc for sm_90a.
3. kernels: each kernel against its plain PyTorch version on the card at
   its path's shapes: the fused scan over 1,000,000 x 128 rows (capacity
   rounded up to the scan block) with 1024 queries, F32 (CUDA cores) and
   BF16 (tensor cores), an entry each; the
   grouped scan over nlist 2048 x cmax 768 with the slot budget of a
   1024-query batch at nprobe 32, F32 and BF16; the partition scan over
   the partition-1000k mirror (P_cap 2048 x pmax 1024 positions, ~5%
   empty, 1025 live buckets; bench/partition_times.py's data) at B 2048
   with uniform and with Zipf-drawn buckets, B 64 and B 8, F32 and BF16,
   and small at its edge cases (pmax 128 and 16384, Dp 3072, a bucket of
   three tiles and one query, every query in one bucket, the largest
   bucket id, an all-dead bucket); the
   grouped scan at g = 1, 2, 4 and 8 clusters per block (kernel 4) at the
   stage ablation's shape (BF16, nlist 2048 x cmax 1024, s 128) and at the
   global smoke's (F32, nlist 2048 x cmax 768, s 32); and the I8 grouped
   scan (int8 rows, bf16 queries) at the dbpedia-i8 main region's shape
   (nlist 2048 x cmax 640, Dp 1536, s 32: what the engine picks for 1M
   rows and a 1024-query batch at nprobe 32); and both scans, small, at
   Dp 3072 and at their tail shapes (row lengths 8 mod 16, query tiles cut
   short, cmax 384 and 640, a group with no live row). Ranks agree within
   1e-4 * (1 + |r|); positions are equal except where the kernel's row
   ties the plain winner within that tolerance in the same group. Median
   times over CUDA events after warm-up, beside each kernel's bound (the
   larger of its bytes over 3.35 TB/s and its operations over the peak of
   its type) and the time of the same product alone in torch (no single
   PyTorch call computes the folded minimum). At the same two batch
   sizes, the local index's directory search (partition_candidates) is
   timed against the masked full scan over 1,000,000 rows: the crossover
   the flat engine routes on (PART_CROSSOVER).
4. stage: the stage ablation of the IVF candidate pipeline
   (vector_store_tpu_torch/bench/ivf_stage.py) and its table; its
   equivalence check (combo g8 + merge_v3 against the base) must hold.
   The grouped scan's launches at g > 1 are counted over this phase.
5. service: the port's HTTP service (run.serve) over FakeDb with one
   default vector index (COSINE, F32, global) of SERVICE_ROWS clustered
   128-d rows; ANN requests with 64 in flight, recall@10 against exact f32
   ground truth computed on the card (>= 0.90), self-queries and one CDC
   upsert found first at distance 0. The fused and grouped scans' launch
   counts are reset before and read after the requests, and must be > 0.
   Then the same phase again as a new service over the same rows stored
   as BF16: its searches launch the scans' tensor-core instantiations,
   the fused one over the IVF delta's whole capacity, which is the shape
   phase 3 holds it against its plain version at.
6. local service: a new service over one local (per-partition) index, the
   partition-1000k configuration of vector_store_tpu/benchkit/scale.py
   (COSINE, BF16, SERVICE_ROWS clustered rows in 1025 partitions, row i in
   partition i % 1025), started after phase 5's service stopped. ANN
   requests restricted to one partition with 64 in flight: every key in its
   partition, recall@10 against the exact top-10 of the partition
   (>= 0.90), self-queries, one CDC insert and one CDC update of a row's
   vector in its own partition found first at distance 0. The partition
   scan's launch count is reset before and read after the requests, and
   must be > 0.
7. I8 service: a new service over one global index at the dbpedia-i8
   shape of vector_store_tpu/benchkit/scale.py (1,000,000 x 1536 clustered
   rows around 1024 centers, COSINE, I8, rescoring on, default search
   width: nprobe 32, oversample 4). Recall@10 against exact f32 ground
   truth on the card (>= 0.90, printed beside the reference's 0.9594),
   self-queries and one CDC upsert found first at distance 0, and the
   int8 grouped scan launched during the requests.
8. filtered service: a new service over filtered-1000k of
   vector_store_tpu/benchkit/scale.py (SERVICE_ROWS clustered 128-d rows,
   COSINE, F32, global, nprobe 32, one int filtering column ``bucket``
   labelled as benchkit/suite.py's selectivity(): bucket b matches 50%,
   10%, 1% or 0.1% of the rows; ingested row by row, since filtering
   columns take the table's per-row path). For each bucket a cold and a
   warm pass of 128 requests ``bucket == b`` at 128 in flight, limit 10:
   QPS, p50, recall@10 against the exact filtered top-10 computed on the
   card, the deltas of the actor's three filtered-path counters and the
   scans' launches. 50% must stay on the post-filter ladder (recall >=
   0.90); 10% must be device-masked with both scans launched (>= 0.90);
   1% and 0.1% must take the grouped subset-exact terminal, the warm pass
   with no scan at all (>= 0.99). Then a CDC insert into the 10% bucket and
   one into the 0.1% bucket, each found first at distance 0.
9. B1 service: phase 7's rows (the dbpedia-i8 shape) as a global B1 index
   (COSINE, rescoring on, oversample 4), served by the flat engine's
   Hamming scan and bf16 rescore tier. 128 requests at 64 in flight:
   recall@10 against exact f32 (printed); for 32 of them the scan's
   Hamming top-64 (the JAX engine's fetch at k 10: k's bucket 16 x the
   oversample 4) against an oracle built on the card from the rows' signs
   (the distances equal as multisets) and their recall no lower than the
   oracle's (the same candidates re-ranked in exact f32) minus 0.01;
   self-queries and one CDC insert found first at distance 0 (a rounded
   Hamming distance); one search batch timed at B 64 and B 1024.
10. local I8 service: partition-1000k stored as I8 (the directory's exact
   gather and the bf16 tier): every key in its partition, recall@10
   against the partition's exact top-10 (>= 0.90), self-queries and a CDC
   insert found first within 1e-6 of distance 0, no partition scan launch
   (its kernel takes float rows only, as the JAX package's), and the
   gather against the masked scan at B 64 and B 2048 beside the engine's
   crossover constant, and the f64 block distance against an f32 sum.
11. graph service: graph-1000k of vector_store_tpu/benchkit/scale.py
   (1,000,000 x 128 clustered rows in 512 clusters, EUCLIDEAN, BF16, the
   index's default connectivity 16 and expansion 128 / 64) served under
   ``engine_kind="graph"``: the build path the actor's first merge took,
   the seconds until the delta is merged and the refinement pass is done,
   graph_nodes (== 1,000,000) and device_bytes; recall@10 against exact
   f32 over 512 held queries (>= 0.90), QPS and p50 at 64 in flight; one
   beam-search batch at B 64 and B 2048 (CUDA events); one kNN chunk of
   the bulk build (B 2048 stored rows) against fused_scan_plain; 256
   self-queries and 256 CDC inserts (all found first at distance 0 while
   in the delta, with the merges held back; each stored or merged row
   found first at distance 0.0 exactly, at least GRAPH_FOUND_MIN of them)
   and a delete; kernel 1's launches by purpose (build, merge, search).
12. scaled service: phase 5's index (the same rows and requests) served by
   run.serve_scaled: this process owns the card, the engines and the
   ingestion, and W = min(4, cores - 2) spawned frontend processes serve
   HTTP over the owner IPC. Each frontend's start-up (until it listens)
   and RSS; the in-process ceiling (actor.ann_many, 4 tasks x 1024
   queries, ~5 s); HTTP load from 2 spawned client processes of the
   port's client.py at 64 and then 256 requests in flight (2 s warm-up,
   10 s measured): QPS, p50, p99, the CPU seconds of the owner, the
   frontends and the clients, the owner loop's lag and its threads' host
   time, beside phase 5's QPS; recall@10 (>= 0.90), 16 self-queries and a
   CDC insert found first at distance 0 through the frontends, a 404 and a
   400 through the IPC; the fused and grouped scans' launches in the
   owner during the HTTP requests (> 0); and nvidia-smi listing one
   compute process, holding at least the owner's reserved memory.
13. bench twin: ``python -m vector_store_tpu_torch.benchkit.headline`` (the
   twin of the root bench.py) in a process of its own at full width:
   1,000,000 x 128 rows in 256 clusters, EUCLIDEAN, BF16, IVF, batch 4096.
   Its JSON line must hold recall_gate_passed (recall@10 >= 0.95); its QPS
   at the gate, p50, bounded point, build rate, compute-side rate, nlist
   and nprobe are printed beside the card's name and power limit. Then
   every other runner of ``python -m vector_store_tpu_torch.benchkit.scale``
   (dbpedia-bf16, dbpedia-i8, deep10m, glove, graph, partition, filtered,
   filtered-diverse, filtered-engine, streaming, streaming-actor, http) in
   a process of its own at SCALE_N = 131,072 rows (above the IVF engine's
   min_build), SCALE_STREAM_SECONDS = 10, HTTP_BENCH_SECONDS = 3, three
   processes at a time (runners that share a dataset file in one lane):
   each must exit 0 and print its JSON line with every recall in [0, 1];
   its wall time is printed. Each process prints its scan kernels' launch
   counts on the line before its JSON; they are added to the kernels line,
   and the headline's launches of kernels 1 and 2 must be > 0.
   The smoke's total wall time is printed last of all phases.

Phase 3 also holds both scans under a slot filter against their plain
versions (``b`` biased as the engines bias it; 10% and 0.1% of the rows
allowed; a lane group, and a cluster, with no allowed row), F32 and BF16,
each timed beside its unmasked reading.

The last three lines of standard output are: one JSON object describing
the kernels (the F32 fused and grouped scans' launches are phase 5's and
phase 12's together, and every kernel's count includes phase 13's
processes), the nvidia-smi name/power-limit line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import socket
import statistics
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SEED = 20261016
DIMS = 128
SERVICE_ROWS = 1_000_000
LOCAL_PARTS = 1025  # partition-1000k: ~976 rows a partition
PART_PCAP, PART_PMAX = 2048, 1024  # its directory geometry after ingest
N_CLUSTERS = 256
N_REQUESTS = 1024
IN_FLIGHT = 64
K = 10
RECALL_MIN = 0.90
RTOL = 1e-4
I8_ROWS, I8_DIMS, I8_CENTERS = 1_000_000, 1536, 1024  # dbpedia-i8
I8_RECALL_REFERENCE = 0.9594  # the JAX package's run of dbpedia-i8 (SCALE_RUNS.jsonl:21)
G_SWEEP = (1, 2, 4, 8)
MASK_FRACS = (0.1, 0.001)  # allowed shares of phase 3's masked scans
SELECTIVITY = (0.5, 0.1, 0.01, 0.001)  # vector_store_tpu/benchkit/harness.py:25
FILTERED_REQUESTS = FILTERED_IN_FLIGHT = 128  # filtered-1000k (benchkit/scale.py:416-449)
B1_ROWS = I8_ROWS  # the dbpedia-i8 shape, stored as B1
B1_REQUESTS = 128
B1_OVERSAMPLE = 4  # the flat engine's default
B1_ORACLE = 32  # queries held to the Hamming oracle
# graph-1000k (vector_store_tpu/benchkit/scale.py:41-130): 1M x 128 rows in
# 512 clusters, EUCLIDEAN, BF16, the index's default graph options
GRAPH_ROWS, GRAPH_CLUSTERS, GRAPH_HELD = 1_000_000, 512, 512
GRAPH_SELF, GRAPH_CDC = 256, 256  # self-queries; CDC inserts, checked in the delta and merged
# the share of stored (or merged) rows a graph self-query must find first:
# at graph-1000k after the refinement pass the beam (ef 64) found 0.877 of
# 1024 stored rows and 0.875 of 256 rows merged in one slice
# (vector_store_tpu_torch/bench/graph_reach.py on an H100; PERF.md section 6)
GRAPH_FOUND_MIN = 0.75
# the scaled service (phase 12): HTTP clients in processes of their own, the
# requests they keep in flight in total, and each load's windows
SCALED_CLIENTS = 2
SCALED_IN_FLIGHT = (64, 256)
SCALED_WARM_S, SCALED_RUN_S = 2.0, 10.0
CEILING_BATCH, CEILING_TASKS, CEILING_S = 1024, 4, 5.0  # the in-process ceiling (actor.ann_many)
# the bench twin (phase 13): the headline at full width, then every scale
# runner at reduced depth, in lanes of runners that share a dataset file
# (benchkit/synth.py's rows_file_np writes one file a seed and shape)
HEADLINE_ENV = {"BENCH_N": "1000000", "BENCH_BATCH": "4096"}
SCALE_ENV = {"SCALE_N": "131072", "SCALE_STREAM_SECONDS": "10", "HTTP_BENCH_SECONDS": "3"}
SCALE_LANES = (
    ("dbpedia-bf16", "dbpedia-i8", "glove", "filtered-1000k"),
    ("streaming-1000k", "streaming-actor-1000k", "deep10m", "partition-1000k"),
    ("filtered-engine-1000k", "http-1000k", "graph-1000k", "filtered-diverse-1000k"),
)
BENCH_TIMEOUT_S = 420
# each kernel's time under the port's first scan core, before its redesign
# for Hopper: ms at the same shapes on an NVIDIA H100 80GB HBM3 at 700 W,
# copied from PERF.md section 5 (that core's last full smoke run), not
# measured by this script. Printed beside this run's times in a [kernels]
# log line, never in the result
PREV_MS = {"fused_scan": 11.236, "grouped_scan": 0.664, "partition_scan": 0.357, "grouped_scan_g": 3.173,
           "grouped_scan_i8": 17.042}

# the H100 SXM's published peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float16: 989e12, torch.bfloat16: 989e12}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"smoke check failed: {msg}")


def host_line(before: str) -> None:
    """What the process carries into a phase: the service phases are bound
    by this one Python process, so their readings depend on it."""
    cpu = os.times()
    print(f"[host] before {before}: {len(gc.get_objects()):,} gc-tracked objects, {threading.active_count()} threads, "
          f"process CPU {cpu.user + cpu.system:.1f} s, {os.cpu_count()} cores", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float, dtype: torch.dtype) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak of their type (int8 x
    bf16 products count at the bf16 rate: the values are bf16-exact, as in
    the TPU kernel's cast)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def scan_bound(n_rows: int, n_queries: int, pairs: int, dp: int, row_dtype, q_dtype, n_out: int) -> dict:
    """Bound of a rank scan: every row, query and (a, b) pair read once,
    ``n_out`` (rank, row) candidates written once, 2 (dp + 1) operations
    for each of ``pairs`` (query, row) pairs."""
    nbytes = (
        n_rows * (dp * torch.empty((), dtype=row_dtype).element_size() + 8)
        + n_queries * dp * torch.empty((), dtype=q_dtype).element_size()
        + n_out * 8
    )
    return bound(nbytes, 2.0 * pairs * (dp + 1), q_dtype)


def compare(name, rank, pos, plain_rank, plain_pos, exact_rank_at, group_of) -> float:
    """Check a kernel's (rank, pos) against its plain version; return the
    max abs rank error. exact_rank_at(qi, rows) recomputes ranks of given
    rows; group_of(qi, col) is the group id a (query, column) must hold."""
    err = (rank - plain_rank).abs()
    check(bool((err <= RTOL * (1 + plain_rank.abs())).all()), f"{name}: ranks differ beyond tolerance")
    mism = (pos != plain_pos).nonzero()
    if mism.numel():
        qi, col = mism[:, 0], mism[:, 1]
        rows = pos[qi, col].long()
        check(bool((group_of(qi, col) == group_of(qi, col, rows)).all()), f"{name}: row outside its group")
        tie = (exact_rank_at(qi, rows) - plain_rank[qi, col]).abs()
        check(
            bool((tie <= RTOL * (1 + plain_rank[qi, col].abs())).all()),
            f"{name}: {mism.shape[0]} positions differ beyond near ties",
        )
    return float(err.max())


def kernel_phase(device) -> list[dict]:
    from vector_store_tpu_torch.ops import fused_scan as fs
    from vector_store_tpu_torch.ops import ivf

    rng = np.random.default_rng(SEED)
    out = []

    # -- kernel 1: fused scan at the flat-scan shape --------------------------
    block = fs.block_rows_for(DIMS)
    cap = -(-SERVICE_ROWS // block) * block
    nq = 1024
    v32 = torch.from_numpy(rng.standard_normal((cap, DIMS), dtype=np.float32)).to(device)
    v32 /= v32.norm(dim=1, keepdim=True)
    q32 = torch.from_numpy(rng.standard_normal((nq, DIMS), dtype=np.float32)).to(device)
    q32 /= q32.norm(dim=1, keepdim=True)
    a = torch.full((cap,), -1.0, device=device)  # cosine coefficients
    b = torch.zeros((cap,), device=device)
    b[SERVICE_ROWS:] = fs.INVALID_BIAS  # rows past the index: empty slots
    b[torch.from_numpy(rng.random(cap) < 0.01).to(device)] = fs.INVALID_BIAS  # removed rows
    for dt, name in ((torch.float32, "fused_scan"), (torch.bfloat16, "fused_scan_bf16")):
        q, v = q32.to(dt), v32.to(dt)
        rank, pos = fs.fused_scan(q, v, a, b, block)
        prank, ppos = fs.fused_scan_plain(q, v, a, b, block)

        def exact(qi, rows, q=q, v=v):
            return a[rows] * (q[qi].float() * v[rows].float()).sum(-1) + b[rows]

        def group(qi, col, rows=None):
            if rows is None:
                return (col // fs.LANES) * block + col % fs.LANES
            return (rows // block) * block + rows % fs.LANES

        err = compare(f"fused_scan/{dt}", rank, pos, prank, ppos, exact, group)
        del rank, pos, prank, ppos
        entry = {"name": name, "route": "cuda", "source": "vector_store_tpu_torch/csrc/fused_scan.cu",
                 "replaces": "vector_store_tpu/ops/pallas_scan.py:136", "max_abs_err": err,
                 "ms": median_ms(lambda: fs.fused_scan(q, v, a, b, block)),
                 "plain_ms": median_ms(lambda: fs.fused_scan_plain(q, v, a, b, block), reps=5),
                 "library_ms": None, "product_only_ms": median_ms(lambda: torch.matmul(q, v.T), reps=5),
                 **scan_bound(cap, nq, nq * cap, DIMS, dt, dt, nq * (cap // block) * fs.LANES)}
        print(f"[kernels] fused_scan {dt} {cap}x{DIMS} B={nq}: kernel {entry['ms']:.3f} ms, plain "
              f"{entry['plain_ms']:.3f} ms, product only {entry['product_only_ms']:.3f} ms, bound "
              f"{entry['bound_ms']:.3f} ms ({entry['bound_by']}), max |rank err| {err:.3g} "
              f"(tolerance {RTOL:g} * (1 + |r|))", flush=True)
        entry["max_abs_err"] = max(err, masked_fused(q, v, a, b, block, entry["ms"], rng))
        out.append(entry)
    del v32, v, q

    # -- kernel 2: grouped scan at the IVF shape ------------------------------
    nlist, cmax = 2048, 768
    s = ivf.choose_budget(nq, 32, nlist)
    v32 = torch.from_numpy(rng.standard_normal((nlist * cmax, DIMS), dtype=np.float32)).to(device)
    v32 /= v32.norm(dim=1, keepdim=True)
    qg32 = torch.from_numpy(rng.standard_normal((nlist * s, DIMS), dtype=np.float32)).to(device)
    qg32 /= qg32.norm(dim=1, keepdim=True)
    a = torch.full((nlist * cmax,), -1.0, device=device)
    b = torch.where(  # clusters are ~80% full
        torch.from_numpy(rng.random(nlist * cmax) < 0.8).to(device), 0.0, fs.INVALID_BIAS
    )
    entry = {"name": "grouped_scan", "route": "cuda", "source": "vector_store_tpu_torch/csrc/grouped_scan.cu",
             "replaces": "vector_store_tpu/ops/ivf.py:467"}
    errs, times = [], {}
    for dt in (torch.float32, torch.bfloat16):
        q, v = qg32.to(dt), v32.to(dt)
        rank, pos = ivf.grouped_scan(q, v, a, b, s, cmax)
        prank, ppos = ivf.grouped_scan_plain(q, v, a, b, s, cmax)
        errs.append(compare(f"grouped_scan/{dt}", rank, pos, prank, ppos, *grouped_oracle(q, v, a, b, s, cmax)))
        times[dt] = (
            median_ms(lambda: ivf.grouped_scan(q, v, a, b, s, cmax)),
            median_ms(lambda: ivf.grouped_scan_plain(q, v, a, b, s, cmax), reps=5),
            median_ms(lambda: grouped_product(q, v, s, cmax), reps=5),
        )
        bnd = scan_bound(nlist * cmax, nlist * s, nlist * s * cmax, DIMS, dt, dt, nlist * s * fs.LANES)
        print(f"[kernels] grouped_scan {dt} nlist={nlist} cmax={cmax} s={s}: kernel "
              f"{times[dt][0]:.3f} ms, plain {times[dt][1]:.3f} ms, product only {times[dt][2]:.3f} ms, bound "
              f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']}), max |rank err| {errs[-1]:.3g} (tolerance {RTOL:g} * "
              "(1 + |r|))", flush=True)
        errs.append(masked_grouped(q, v, a, b, s, cmax, times[dt][0], rng))
    entry.update(max_abs_err=max(errs), ms=times[torch.float32][0], plain_ms=times[torch.float32][1],
                 library_ms=None, product_only_ms=times[torch.float32][2],
                 **scan_bound(nlist * cmax, nlist * s, nlist * s * cmax, DIMS, torch.float32, torch.float32,
                              nlist * s * fs.LANES))
    out.append(entry)
    del v32, qg32, v, q, prank, ppos
    torch.cuda.empty_cache()
    out.append(partition_kernel(device, rng))
    out.append(grouped_g_sweep(device))
    out.append(grouped_i8_kernel(device))
    edge_shapes(device)
    return out


def random_allow(rng, n: int, frac: float, device) -> torch.Tensor:
    """[n] bool: each slot allowed with probability ``frac``."""
    return torch.from_numpy(rng.random(n) < frac).to(device)


def masked_fused(q, v, a, b, block, unmasked_ms, rng) -> float:
    """The fused scan under a slot filter, as the flat engine and the IVF
    delta run it (``b`` biased by apply_allow_to_paux), against its plain
    version: 10% and 0.1% of the rows allowed, and one lane group (block 3,
    lane 5) with no allowed row, which must return its first row at
    INVALID_BIAS. The same kernel reads the same bytes as unmasked, so its
    time should match the unmasked one. Returns the max |rank err|."""
    from vector_store_tpu_torch.ops import fused_scan as fs

    cap, worst = v.shape[0], 0.0
    dead = 3 * block + 5 + fs.LANES * torch.arange(block // fs.LANES, device=v.device)
    col = 3 * fs.LANES + 5
    for frac in MASK_FRACS:
        allow = random_allow(rng, cap, frac, v.device)
        allow[dead] = False
        bm = fs.apply_allow_to_paux(b, allow)
        rank, pos = fs.fused_scan(q, v, a, bm, block)
        prank, ppos = fs.fused_scan_plain(q, v, a, bm, block)

        def exact(qi, rows):
            return a[rows] * (q[qi].float() * v[rows].float()).sum(-1) + bm[rows]

        def group(qi, col, rows=None):
            if rows is None:
                return (col // fs.LANES) * block + col % fs.LANES
            return (rows // block) * block + rows % fs.LANES

        err = compare(f"fused_scan/masked {frac:g}/{q.dtype}", rank, pos, prank, ppos, exact, group)
        check(bool((rank[:, col] == fs.INVALID_BIAS).all()) and torch.equal(pos[:, col], ppos[:, col]),
              f"fused_scan/masked {frac:g}/{q.dtype}: the lane group with no allowed row did not return its "
              "first row at INVALID_BIAS")
        live = int((bm < fs.INVALID_CUTOFF).sum())
        del rank, pos, prank, ppos
        ms = median_ms(lambda: fs.fused_scan(q, v, a, bm, block))
        print(f"[kernels] fused_scan {q.dtype} masked, {frac:.1%} allowed ({live:,} live rows): kernel {ms:.3f} ms "
              f"(unmasked {unmasked_ms:.3f} ms), max |rank err| {err:.3g}; a lane group with no allowed row held",
              flush=True)
        worst = max(worst, err)
    return worst


def masked_grouped(q, v, a, b, s, cmax, unmasked_ms, rng) -> float:
    """The grouped scan under a slot filter, as the IVF main region runs it
    (``b`` biased through the position -> slot map by the engine's
    _apply_allow_main), against its plain version: 10% and 0.1% of the
    slots allowed, and one cluster (7) with no allowed row, whose queries
    must get their first rows at INVALID_BIAS. Returns the max |rank
    err|."""
    from vector_store_tpu_torch.engine.ivf import _apply_allow_main
    from vector_store_tpu_torch.ops import fused_scan as fs
    from vector_store_tpu_torch.ops import ivf

    npos = v.shape[0]
    pos2slot = torch.where(b < fs.INVALID_CUTOFF, torch.arange(npos, device=v.device, dtype=torch.int32), -1)
    worst = 0.0
    for frac in MASK_FRACS:
        allow = random_allow(rng, npos, frac, v.device)
        allow[7 * cmax : 8 * cmax] = False
        bm = _apply_allow_main(b, pos2slot, allow)
        exact, group = grouped_oracle(q, v, a, bm, s, cmax)
        rank, pos = ivf.grouped_scan(q, v, a, bm, s, cmax)
        prank, ppos = ivf.grouped_scan_plain(q, v, a, bm, s, cmax)
        err = compare(f"grouped_scan/masked {frac:g}/{q.dtype}", rank, pos, prank, ppos, exact, group)
        dead = slice(7 * s, 8 * s)
        check(bool((rank[dead] == fs.INVALID_BIAS).all()) and torch.equal(pos[dead], ppos[dead]),
              f"grouped_scan/masked {frac:g}/{q.dtype}: the cluster with no allowed row did not return its first "
              "rows at INVALID_BIAS")
        del rank, pos, prank, ppos
        ms = median_ms(lambda: ivf.grouped_scan(q, v, a, bm, s, cmax))
        print(f"[kernels] grouped_scan {q.dtype} masked, {frac:.1%} allowed: kernel {ms:.3f} ms (unmasked "
              f"{unmasked_ms:.3f} ms), max |rank err| {err:.3g}; a cluster with no allowed row held", flush=True)
        worst = max(worst, err)
    return worst


def edge_shapes(device) -> None:
    """Both redesigned scans, small, against their plain versions where
    their cores could go wrong: Dp 3072 (a block's shared memory must not
    grow with the row length), row lengths that are 8 mod 16 or shorter
    than a K-slice, query tiles cut short (nq 1 and 17, s 24 and 20), cmax
    384 and 640, and a group with no live row, which must return its
    first rows at INVALID_BIAS."""
    from vector_store_tpu_torch.ops import fused_scan as fs
    from vector_store_tpu_torch.ops import ivf

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 6)
    floats = (torch.float32, torch.float16, torch.bfloat16)
    worst = 0.0
    # (row length, queries, rows a block, blocks)
    for dp, nq, block, nblk in ((3072, 40, 1024, 2), (136, 1, 384, 3), (72, 17, 640, 3), (48, 70, 128, 4)):
        for dt in floats:
            v, q = unit_rows_on(device, gen, nblk * block, dp, dt), unit_rows_on(device, gen, nq, dp, dt)
            a, b = cosine_coeffs(v, gen)
            b[block : 2 * block] = fs.INVALID_BIAS  # block 1 has no live row
            rank, pos = fs.fused_scan(q, v, a, b, block)
            prank, ppos = fs.fused_scan_plain(q, v, a, b, block)

            def exact(qi, rows, q=q, v=v, a=a, b=b):
                return a[rows] * (q[qi].float() * v[rows].float()).sum(-1) + b[rows]

            def group(qi, col, rows=None, block=block):
                if rows is None:
                    return (col // fs.LANES) * block + col % fs.LANES
                return (rows // block) * block + rows % fs.LANES

            worst = max(worst, compare(f"fused_scan/edge/{dt}/Dp={dp}/B={nq}", rank, pos, prank, ppos, exact, group))
            dead = slice(fs.LANES, 2 * fs.LANES)
            check(torch.equal(pos[:, dead], ppos[:, dead]) and bool((rank[:, dead] == fs.INVALID_BIAS).all()),
                  f"fused_scan/edge/{dt}/Dp={dp}: a dead block did not return its first rows at INVALID_BIAS")
    # (row length, slots a cluster, cmax, clusters, g); int8 rows pad to 16
    for dp, s, cmax, nlist, g in ((3072, 32, 640, 4, 1), (136, 24, 384, 6, 2), (72, 20, 640, 6, 3), (48, 100, 128, 8, 4)):
        for dt in floats + (torch.int8,):
            dpp = -(-dp // 16) * 16 if dt is torch.int8 else dp
            v = unit_rows_on(device, gen, nlist * cmax, dpp, dt)
            q = unit_rows_on(device, gen, nlist * s, dpp, torch.bfloat16 if dt is torch.int8 else dt)
            a, b = cosine_coeffs(v, gen)
            b[cmax : 2 * cmax] = fs.INVALID_BIAS  # cluster 1 has no live row
            rank, pos = ivf.grouped_scan(q, v, a, b, s, cmax, g=g)
            prank, ppos = ivf.grouped_scan_plain(q, v, a, b, s, cmax)
            worst = max(worst, compare(f"grouped_scan/edge/{dt}/Dp={dpp}/s={s}", rank, pos, prank, ppos,
                                       *grouped_oracle(q, v, a, b, s, cmax)))
            dead = slice(s, 2 * s)
            check(torch.equal(pos[dead], ppos[dead]) and bool((rank[dead] == fs.INVALID_BIAS).all()),
                  f"grouped_scan/edge/{dt}/Dp={dpp}: a dead cluster did not return its first rows at INVALID_BIAS")
    print(f"[kernels] edge shapes (Dp 3072; Dp 136, 72, 48; nq 1, 17, 70; s 24, 20, 100; cmax 384, 640, 128; a dead "
          f"group), F32/F16/BF16 and int8 rows: all within tolerance, max |rank err| {worst:.3g}", flush=True)


def grouped_oracle(q, v, a, b, s, cmax):
    """compare()'s two callbacks for a grouped scan: the exact rank of
    given rows, and the (cluster, lane) group of a column or a row."""
    from vector_store_tpu_torch.ops.fused_scan import LANES

    def exact(qi, rows):
        return a[rows] * (q[qi].float() * v[rows].float()).sum(-1) + b[rows]

    def group(qi, col, rows=None):
        if rows is None:
            return (qi // s) * cmax + col
        return (rows // cmax) * cmax + rows % LANES

    return exact, group


def grouped_product(q, v, s, cmax):
    """The grouped scan's product alone, one torch.bmm (no rank fold)."""
    dp = v.shape[1]
    return torch.bmm(q.view(-1, s, dp), v.view(-1, cmax, dp).transpose(1, 2))


def unit_rows_on(device, gen, n: int, dims: int, dtype, chunk: int = 131_072) -> torch.Tensor:
    """n random unit rows drawn on the card, cast to dtype a chunk at a
    time (int8: the I8 codes round(127 v))."""
    out = torch.empty((n, dims), dtype=dtype, device=device)
    for lo in range(0, n, chunk):
        x = torch.randn((min(chunk, n - lo), dims), generator=gen, device=device)
        x /= x.norm(dim=1, keepdim=True)
        out[lo : lo + x.shape[0]] = torch.round(x * 127).to(dtype) if dtype is torch.int8 else x.to(dtype)
    return out


def cosine_coeffs(v: torch.Tensor, gen, fill: float = 0.8):
    """(a, b) of stored rows for cosine, ~``fill`` of the positions live:
    a = -1/|v| (for I8 codes the 127x scale folds in; -1 for unit floats),
    b = 0 for live rows and INVALID_BIAS for empty ones."""
    from vector_store_tpu_torch.ops.fused_scan import INVALID_BIAS

    a = -1.0 / v.float().norm(dim=1) if v.dtype is torch.int8 else torch.full((v.shape[0],), -1.0, device=v.device)
    live = torch.rand((v.shape[0],), generator=gen, device=v.device) < fill
    return a, torch.where(live, 0.0, INVALID_BIAS)


def grouped_g_sweep(device) -> dict:
    """Kernel 4: the grouped scan at g clusters per block (G_SWEEP) against
    its plain version, at the stage ablation's shape (BF16) and at the
    global smoke's (F32). Its entry carries the ablation shape at g = 8,
    the script's choice."""
    from vector_store_tpu_torch.bench.ivf_stage import SHAPE
    from vector_store_tpu_torch.ops import ivf
    from vector_store_tpu_torch.ops.fused_scan import LANES

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    entry = {"name": "grouped_scan_g", "route": "cuda", "source": "vector_store_tpu_torch/csrc/grouped_scan.cu",
             "replaces": "scripts/ivf_stage_opt2.py:116"}
    shapes = (
        ("ablation", torch.bfloat16, SHAPE["nlist"], SHAPE["cmax"],
         ivf.choose_budget(SHAPE["b"], SHAPE["nprobe"], SHAPE["nlist"]), SHAPE["d"]),
        ("global", torch.float32, 2048, 768, ivf.choose_budget(1024, 32, 2048), DIMS),
    )
    errs, sweep, plain, product = [], {}, {}, {}
    for label, dt, nlist, cmax, s, dp in shapes:
        v = unit_rows_on(device, gen, nlist * cmax, dp, dt)
        q = unit_rows_on(device, gen, nlist * s, dp, dt)
        a, b = cosine_coeffs(v, gen)
        prank, ppos = ivf.grouped_scan_plain(q, v, a, b, s, cmax)
        for g in G_SWEEP:
            rank, pos = ivf.grouped_scan(q, v, a, b, s, cmax, g=g)
            errs.append(compare(f"grouped_scan/{label}/g={g}", rank, pos, prank, ppos,
                                *grouped_oracle(q, v, a, b, s, cmax)))
            sweep[label, g] = median_ms(lambda g=g: ivf.grouped_scan(q, v, a, b, s, cmax, g=g))
        plain[label] = median_ms(lambda: ivf.grouped_scan_plain(q, v, a, b, s, cmax), reps=3)
        product[label] = median_ms(lambda: grouped_product(q, v, s, cmax), reps=5)
        readings = ", ".join(f"g={g} {sweep[label, g]:.3f} ms" for g in G_SWEEP)
        print(f"[kernels] grouped_scan g sweep, {label} shape {dt} nlist={nlist} cmax={cmax} s={s} Dp={dp}: "
              f"{readings}; plain {plain[label]:.3f} ms, product only {product[label]:.3f} ms; choose_g -> "
              f"{ivf.choose_g()}", flush=True)
        if label == "ablation":
            entry.update(**scan_bound(nlist * cmax, nlist * s, nlist * s * cmax, dp, dt, dt, nlist * s * LANES))
        del v, q, a, b, prank, ppos
        torch.cuda.empty_cache()
    entry.update(max_abs_err=max(errs), ms=sweep["ablation", 8], plain_ms=plain["ablation"], library_ms=None,
                 product_only_ms=product["ablation"],
                 g_ms={f"{label}/g{g}": ms for (label, g), ms in sweep.items()})
    return entry


def grouped_i8_kernel(device) -> dict:
    """The I8 grouped scan (int8 rows, true-scale bf16 queries, the 127x
    scale folded into a) at the dbpedia-i8 main region's shape."""
    from vector_store_tpu_torch.ops import ivf
    from vector_store_tpu_torch.ops.fused_scan import LANES

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    nlist = ivf.choose_nlist(I8_ROWS)
    cmax = ivf.choose_cmax(I8_ROWS, nlist, headroom=1.25)  # the IVF engine's default headroom
    s = ivf.choose_budget(1024, 32, nlist)
    v = unit_rows_on(device, gen, nlist * cmax, I8_DIMS, torch.int8)
    q = unit_rows_on(device, gen, nlist * s, I8_DIMS, torch.bfloat16)
    a, b = cosine_coeffs(v, gen)
    rank, pos = ivf.grouped_scan(q, v, a, b, s, cmax)
    prank, ppos = ivf.grouped_scan_plain(q, v, a, b, s, cmax)
    err = compare("grouped_scan/i8", rank, pos, prank, ppos, *grouped_oracle(q, v, a, b, s, cmax))
    ms = median_ms(lambda: ivf.grouped_scan(q, v, a, b, s, cmax))
    plain_ms = median_ms(lambda: ivf.grouped_scan_plain(q, v, a, b, s, cmax), reps=3)
    del prank, ppos
    vb = v.to(torch.bfloat16)
    product_ms = median_ms(lambda: grouped_product(q, vb, s, cmax), reps=5)
    del vb
    entry = {"name": "grouped_scan_i8", "route": "cuda", "source": "vector_store_tpu_torch/csrc/grouped_scan.cu",
             "replaces": "vector_store_tpu/ops/ivf.py:467", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "library_ms": None, "product_only_ms": product_ms,
             **scan_bound(nlist * cmax, nlist * s, nlist * s * cmax, I8_DIMS, torch.int8, torch.bfloat16,
                          nlist * s * LANES)}
    print(f"[kernels] grouped_scan I8 (int8 rows, bf16 queries) nlist={nlist} cmax={cmax} s={s} Dp={I8_DIMS}: "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, product only (bf16 bmm) {product_ms:.3f} ms, bound "
          f"{entry['bound_ms']:.3f} ms ({entry['bound_by']}), max |rank err| {err:.3g} (tolerance {RTOL:g} * (1 + |r|))",
          flush=True)
    del v, q, a, b
    torch.cuda.empty_cache()
    return entry


def partition_kernel(device, rng) -> dict:
    """Kernel 3 on the partition-1000k mirror (the data of
    bench/partition_times.py): F32 and BF16, B 2048 with uniform and with
    Zipf-drawn buckets, B 64 and B 8; its edge cases; then the directory
    against the masked scan at two batch sizes."""
    from vector_store_tpu_torch.bench import partition_times as pt
    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.engine.flat import PART_CROSSOVER, FlatDeviceIndex
    from vector_store_tpu_torch.ops import fused_scan as fs
    from vector_store_tpu_torch.ops import partition_scan as ps

    pmax, npos = pt.PMAX, pt.PCAP * pt.PMAX
    v32, a, b = pt.mirror(device, SEED)
    entry = {"name": "partition_scan", "route": "cuda",
             "source": "vector_store_tpu_torch/csrc/partition_scan.cu + vector_store_tpu_torch/csrc/hopper_scan.cuh",
             "replaces": "vector_store_tpu/ops/partition_scan.py:55"}
    errs = []
    for dname, dt in pt.DTYPES.items():
        v = v32.to(dt)
        for label in pt.BATCHES:
            q32, bsel = pt.batch(label, device, SEED)
            q, nq = q32.to(dt), q32.shape[0]
            rank, pos = ps.partition_scan(v, a, b, q, bsel, pmax)
            prank, ppos = ps.partition_scan_plain(v, a, b, q, bsel, pmax)
            errs.append(compare(f"partition_scan/{dname}/{label}", rank, pos, prank, ppos,
                                *partition_oracle(q, v, a, b, bsel, pmax)))
            del rank, pos, prank, ppos
            n_buckets = int(torch.unique(bsel).numel())  # the buckets this batch reads
            ms = median_ms(lambda: ps.partition_scan(v, a, b, q, bsel, pmax), reps=20)
            plain_ms = median_ms(lambda: ps.partition_scan_plain(v, a, b, q, bsel, pmax), reps=5)
            bnd = scan_bound(n_buckets * pmax, nq, nq * pmax, DIMS, dt, dt, nq * fs.LANES)
            hot = int(torch.bincount(bsel).max())
            print(f"[kernels] partition_scan {dname} P_cap={pt.PCAP} pmax={pmax} {label} ({n_buckets} buckets, the "
                  f"hottest {hot} queries): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} "
                  f"ms ({bnd['bound_by']}), max |rank err| {errs[-1]:.3g} (tolerance {RTOL:g} * (1 + |r|))",
                  flush=True)
            if dname == "F32" and label == "B 2048 uniform":
                vb_sel = v.view(-1, pmax, DIMS)[bsel.long()]  # the product's operand, gathered beforehand
                product_ms = median_ms(lambda: torch.bmm(q[:, None, :], vb_sel.transpose(1, 2)), reps=5)
                del vb_sel
                entry.update(ms=ms, plain_ms=plain_ms, library_ms=None, product_only_ms=product_ms, **bnd)
        del v
    entry["max_abs_err"] = max(errs + [partition_edges(device)])

    # directory (kernel path, as the engine runs it) against the masked scan
    # of a 1M-row BF16 flat array, both at k = 10
    flat = FlatDeviceIndex(DIMS, SpaceType.COSINE, Quantization.BF16, device=device, initial_capacity=SERVICE_ROWS)
    cap = flat.capacity
    flat.vectors[:SERVICE_ROWS] = v32[:SERVICE_ROWS].to(torch.bfloat16)
    flat.a.fill_(-1.0)
    flat.b[:SERVICE_ROWS] = 0.0
    flat.parts[:SERVICE_ROWS] = torch.arange(SERVICE_ROWS, device=device, dtype=torch.int32) % LOCAL_PARTS
    vb, rows = v32.to(torch.bfloat16), torch.arange(npos, dtype=torch.int32, device=device).view(pt.PCAP, pmax)
    crossing = {}
    for nq in (8, 2048):
        q = torch.from_numpy(rng.standard_normal((nq, DIMS), dtype=np.float32)).to(device).to(torch.bfloat16)
        bsel = torch.from_numpy(rng.integers(0, LOCAL_PARTS, size=nq).astype(np.int32)).to(device)
        t_dir = median_ms(lambda: ps.partition_candidates(vb, a, b, rows, q, bsel, k=K, pmax=pmax))
        t_mask = median_ms(lambda: flat._masked_scan(q, bsel, K), reps=3, warmup=1)
        crossing[nq] = (t_dir, t_mask)
        print(f"[kernels] crossover B={nq}: directory {t_dir:.3f} ms (B*pmax = {nq * pmax:,} rows), masked scan "
              f"{t_mask:.3f} ms ({cap:,} rows), BF16 k={K}", flush=True)
    # per (query, row) cost of each path at the larger batch, where both are
    # dominated by their per-row work; the directory wins while
    # pmax <= (masked / directory) * capacity
    t_dir, t_mask = crossing[2048]
    per_row_dir, per_row_mask = t_dir / (2048 * pmax), t_mask / (2048 * cap)
    print(f"[kernels] per query-row at B=2048: directory {1e6 * per_row_dir:.4f} ns, masked scan "
          f"{1e6 * per_row_mask:.4f} ns: the directory wins while pmax <= {per_row_mask / per_row_dir:.3f} "
          f"x capacity (the engine routes on PART_CROSSOVER = {PART_CROSSOVER})", flush=True)
    del v32, vb, flat
    torch.cuda.empty_cache()
    return entry


def partition_oracle(q, v, a, b, bsel, pmax):
    """compare()'s two callbacks for a partition scan: the exact rank of
    given positions, and the (bucket, lane) group of a column or a
    position."""
    from vector_store_tpu_torch.ops.fused_scan import LANES

    def exact(qi, rows):
        return a[rows] * (q[qi].float() * v[rows].float()).sum(-1) + b[rows]

    def group(qi, col, rows=None):
        if rows is None:
            return bsel[qi].long() * pmax + col
        return (rows // pmax) * pmax + rows % LANES

    return exact, group


def partition_edges(device) -> float:
    """The partition scan, small, against its plain version where its tiles,
    its chunks and its cores could go wrong: pmax 128 and 16384 (the ends of
    the directory's ladder; at B 64 and B 8 a 16384-row bucket is cut into
    chunks, the last one short), Dp 3072, a bucket holding 3 tiles + 1
    query, every query in one bucket, the largest bucket id, and an
    all-dead bucket (bucket 3, which all cases but one read: its lanes
    return their first positions at INVALID_BIAS). F32 and BF16. Returns the max
    |rank err|."""
    from vector_store_tpu_torch.ops import fused_scan as fs
    from vector_store_tpu_torch.ops import partition_scan as ps

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 7)
    rng = np.random.default_rng(SEED + 7)
    tile = ps.TILE_QUERIES
    cases = (  # (label, buckets, pmax, Dp, bsel); bucket 3 is dead
        ("pmax 128", 64, 128, DIMS, np.r_[rng.integers(0, 64, 63), 3]),
        ("pmax 16384 B 64", 6, 16384, DIMS, np.r_[rng.integers(0, 6, 63), 3]),
        ("pmax 16384 B 8", 6, 16384, DIMS, np.r_[rng.integers(0, 6, 7), 3]),
        ("Dp 3072", 16, 1024, 3072, np.r_[rng.integers(0, 16, 39), 3]),
        ("3 tiles + 1 in one bucket", 16, 1024, DIMS, np.r_[np.full(3 * tile + 1, 5), rng.integers(0, 16, 14), 3]),
        ("every query in one bucket", 16, 1024, DIMS, np.full(100, 2)),
        ("every query in the dead bucket", 16, 1024, DIMS, np.full(20, 3)),
        ("the largest bucket id", 16, 1024, DIMS, np.r_[np.full(tile + 3, 15), rng.integers(0, 16, 8), 3]),
    )
    worst = 0.0
    for label, nparts, pmax, dp, bsel_np in cases:
        bsel = torch.from_numpy(rng.permutation(bsel_np.astype(np.int32))).to(device)
        v32 = unit_rows_on(device, gen, nparts * pmax, dp, torch.float32)
        q32 = unit_rows_on(device, gen, bsel.shape[0], dp, torch.float32)
        a, b = cosine_coeffs(v32, gen, fill=0.95)
        b[3 * pmax : 4 * pmax] = fs.INVALID_BIAS
        for dname, dt in (("F32", torch.float32), ("BF16", torch.bfloat16)):
            v, q = v32.to(dt), q32.to(dt)
            rank, pos = ps.partition_scan(v, a, b, q, bsel, pmax)
            prank, ppos = ps.partition_scan_plain(v, a, b, q, bsel, pmax)
            worst = max(worst, compare(f"partition_scan/edge/{label}/{dname}", rank, pos, prank, ppos,
                                       *partition_oracle(q, v, a, b, bsel, pmax)))
            dead = bsel == 3
            check(torch.equal(pos[dead], ppos[dead]) and bool((rank[dead] == fs.INVALID_BIAS).all()),
                  f"partition_scan/edge/{label}/{dname}: the dead bucket did not return its first positions")
        del v32, q32, v, q
    print(f"[kernels] partition_scan edge cases ({'; '.join(c[0] for c in cases)}), F32 and "
          f"BF16: all within tolerance, max |rank err| {worst:.3g}", flush=True)
    return worst


def clustered_rows(rng, n: int, dims: int = DIMS, n_clusters: int = N_CLUSTERS) -> np.ndarray:
    """Synthetic data: n_clusters Gaussian clusters (unit-norm centers,
    per-component sigma 0.4/sqrt(d), as bench.py), by default the SIFT-1M
    shape (128-d, 256 clusters). One f32 copy: the centers are added in
    place, a chunk of rows at a time."""
    centers = rng.standard_normal((n_clusters, dims), dtype=np.float32) / np.sqrt(dims)
    rows = rng.standard_normal((n, dims), dtype=np.float32)
    rows *= np.float32(0.4 / np.sqrt(dims))
    label = rng.integers(0, n_clusters, size=n)
    for lo in range(0, n, 65_536):
        rows[lo : lo + 65_536] += centers[label[lo : lo + 65_536]]
    return rows


def exact_top_k(data: torch.Tensor, queries: torch.Tensor, k: int, space: str = "COSINE") -> np.ndarray:
    """Exact f32 top-k ids on the card (cosine, or the named space), in
    chunks of rows."""
    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.ops.distance import pairwise_distance
    from vector_store_tpu_torch.ops.topk import merge_min_k

    qn = queries.norm(dim=1)
    best_d = torch.full((queries.shape[0], k), float("inf"), device=queries.device)
    best_i = torch.full((queries.shape[0], k), -1, dtype=torch.int64, device=queries.device)
    for lo in range(0, data.shape[0], 262_144):
        block = data[lo : lo + 262_144]
        d = pairwise_distance(queries, block, SpaceType[space], Quantization.F32, qn, block.norm(dim=1))
        bd, bi = torch.topk(d, k, dim=1, largest=False)
        best_d, best_i = merge_min_k(best_d, best_i, bd, bi + lo)
    return best_i.cpu().numpy()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class Http:
    """The smoke's HTTP client for one index of a running service."""

    def __init__(self, session, base: str) -> None:
        self.session, self.base = session, base

    async def status(self) -> dict:
        async with self.session.get(f"{self.base}/status") as resp:
            return await resp.json() if resp.status == 200 else {}

    async def counted(self, want: int) -> bool:
        st = await self.status()
        return st.get("count") == want and st.get("status") == "SERVING"

    async def ann(self, vector, limit=K, **extra) -> dict:
        body = {"vector": [float(x) for x in vector], "limit": limit, **extra}
        async with self.session.post(f"{self.base}/ann", json=body) as resp:
            text = await resp.text()
            check(resp.status == 200, f"ann answered {resp.status}: {text}")
            return json.loads(text)

    @staticmethod
    async def wait_for(cond, what: str, timeout: float = 600.0):
        deadline = time.perf_counter() + timeout
        while not await cond():
            check(time.perf_counter() < deadline, f"timed out waiting for {what}")
            await asyncio.sleep(0.2)


async def service_phase(device, card: str, storage: str = "F32") -> dict:
    """Phase 5: one global index (COSINE, ``storage`` rows) served over
    HTTP; returns the scans' launches during the requests."""
    import aiohttp

    from vector_store_tpu_torch.core.types import Quantization
    from vector_store_tpu_torch.db.fake import FakeDb, FakeIndex, FakeTable, make_vs_metadata, vector_row
    from vector_store_tpu_torch.service.config import Config
    from vector_store_tpu_torch.ops import fused_scan as fs
    from vector_store_tpu_torch.ops import ivf
    from vector_store_tpu_torch.run import serve

    rng = np.random.default_rng(SEED + 1)
    n = SERVICE_ROWS
    data = clustered_rows(rng, n)
    pick = rng.integers(0, n, size=N_REQUESTS)
    queries = data[pick] + rng.standard_normal((N_REQUESTS, DIMS), dtype=np.float32) * np.float32(
        0.1 / np.sqrt(DIMS)
    )
    gt = exact_top_k(torch.from_numpy(data).to(device), torch.from_numpy(queries).to(device), K)

    db = FakeDb()
    db.add_table(FakeTable("ks", "tbl", ("pk",)))
    metadata = make_vs_metadata(dimensions=DIMS, quantization=Quantization[storage])  # COSINE, global
    db.add_index(FakeIndex(metadata=metadata, scan=lambda: (vector_row((i,), data[i], 100) for i in range(n))))
    port = free_port()
    tag = "[service]" if storage == "F32" else f"[service {storage}]"
    scan_dtype = {"F32": "float32", "BF16": "bfloat16"}[storage]

    t0 = time.perf_counter()
    service = await serve(db, Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.1), device=device)
    try:
        async with aiohttp.ClientSession() as http:
            client = Http(http, f"http://127.0.0.1:{port}/api/v1/indexes/ks/idx")
            ann, wait_for, counted = client.ann, client.wait_for, client.counted
            await wait_for(lambda: counted(n), f"{n} rows")
            ingest_s = time.perf_counter() - t0
            engine = service.indexes.get_vs(metadata.key).actor.engine

            async def built() -> bool:
                return engine.nlist > 0 and engine.maintain_pending() is None

            await wait_for(built, "the IVF build to swap in and settle")
            settle_s = time.perf_counter() - t0 - ingest_s
            build_s = sum(sec for phase, sec in engine.maintain_log)
            rebuilds = sum(1 for phase, _ in engine.maintain_log if phase == "swap")
            print(f"{tag} {n} rows ingested in {ingest_s:.1f} s; IVF nlist={engine.nlist} "
                  f"cmax={engine.cmax} main={engine._main_rows} delta={engine._delta.size}; "
                  f"settled {settle_s:.1f} s later", flush=True)
            check(engine._main_rows >= 0.8 * n, "the IVF main region holds under 80% of the rows")

            # -- the main path, counted ------------------------------------
            fs.fused_scan.launches = 0
            fs.fused_scan.launches_by.clear()
            ivf.grouped_scan.launches = 0
            ivf.grouped_scan.launches_by.clear()
            sem = asyncio.Semaphore(IN_FLIGHT)
            lat: list[float] = []

            async def one(q):
                async with sem:
                    t = time.perf_counter()
                    res = await ann(q)
                    lat.append(time.perf_counter() - t)
                    return res["primary_keys"]["pk"]

            t1 = time.perf_counter()
            got = await asyncio.gather(*(one(q) for q in queries))
            wall = time.perf_counter() - t1
            recall = float(np.mean([len(set(g) & set(t.tolist())) / K for g, t in zip(got, gt)]))
            print(f"{tag} recall@{K} {recall:.4f} over {N_REQUESTS} requests", flush=True)
            check(recall >= RECALL_MIN, f"recall@{K} {recall:.4f} < {RECALL_MIN}")

            for i in rng.choice(n, size=16, replace=False):
                res = await ann(data[i], 3)
                check(res["primary_keys"]["pk"][0] == int(i) and abs(res["distances"][0]) <= 1e-6,
                      f"self-query of row {i} returned {res}")
            new = clustered_rows(rng, 1)[0]
            await db.db_indexes[metadata.key].push_cdc(vector_row((n,), new, 200))
            await wait_for(lambda: counted(n + 1), "the CDC row", timeout=60)
            res = await ann(new, 3)
            check(res["primary_keys"]["pk"][0] == n and abs(res["distances"][0]) <= 1e-6,
                  f"CDC row query returned {res}")
            launches = {"fused_scan": fs.fused_scan.launches_by[scan_dtype],
                        "grouped_scan": sum(c for (dt, _), c in ivf.grouped_scan.launches_by.items()
                                            if dt == scan_dtype)}
            print(f"{tag} launches during the main path ({scan_dtype} rows): {launches}", flush=True)
            check(all(v > 0 for v in launches.values()), f"a kernel of the path never launched: {launches}")
            print(
                f"{tag} smoke readings on {card}: ingest {ingest_s:.1f} s for {n} rows, "
                f"device build slices {build_s:.1f} s over {rebuilds} builds, "
                f"{N_REQUESTS / wall:.0f} QPS and p50 {1e3 * statistics.median(lat):.1f} ms "
                f"at {IN_FLIGHT} in flight (client in the same process)",
                flush=True,
            )
            return launches, N_REQUESTS / wall
    finally:
        await service.stop()


def partition_top_k(data: torch.Tensor, queries: torch.Tensor, qpart: np.ndarray, k: int) -> np.ndarray:
    """Exact cosine top-k within each query's partition (row i lies in
    partition i % LOCAL_PARTS), on the card; as rows."""
    n = data.shape[0]
    m = -(-n // LOCAL_PARTS)
    rows = torch.arange(LOCAL_PARTS, device=data.device)[:, None] + LOCAL_PARTS * torch.arange(m, device=data.device)
    rows = torch.where(rows < n, rows, -1)
    out = []
    for lo in range(0, queries.shape[0], 128):
        r = rows[torch.from_numpy(qpart[lo : lo + 128]).to(data.device)]
        v = data[torch.clamp(r, min=0)]  # [c, m, D]
        q = queries[lo : lo + 128]
        cos = torch.einsum("bd,bmd->bm", q, v) / (q.norm(dim=1)[:, None] * v.norm(dim=2))
        d = torch.where(r >= 0, 1.0 - cos, float("inf"))
        out.append(torch.gather(r, 1, torch.topk(d, k, dim=1, largest=False).indices))
    return torch.cat(out).cpu().numpy()


def stage_phase(device) -> int:
    """Phase 4: the stage ablation of the IVF candidate pipeline; returns
    the grouped scan's launches at g > 1 over it (kernel 4's path)."""
    from vector_store_tpu_torch.bench import ivf_stage
    from vector_store_tpu_torch.ops import ivf

    ivf.grouped_scan.launches_by.clear()
    result = ivf_stage.run(device)
    launches = sum(n for (_, g), n in ivf.grouped_scan.launches_by.items() if g > 1)
    for line in ivf_stage.table(result):
        print(f"[stage] {line}", flush=True)
    print(f"[stage] grouped_scan launches at g > 1 during the ablation: {launches}", flush=True)
    check(result["equivalence"]["ok"], f"stage ablation: combo differs from base: {result['equivalence']}")
    check(launches > 0, "the grouped scan never launched with g > 1 in the ablation")
    del result
    torch.cuda.empty_cache()
    return launches


async def local_phase(device, card: str) -> int:
    """Phase 5: one local index (partition-1000k) served over HTTP."""
    import aiohttp

    from vector_store_tpu_torch.core.types import DbIndexPartitioning, Quantization
    from vector_store_tpu_torch.db.fake import FakeDb, FakeIndex, FakeTable, make_vs_metadata, vector_row
    from vector_store_tpu_torch.service.config import Config
    from vector_store_tpu_torch.ops import partition_scan as ps
    from vector_store_tpu_torch.run import serve

    rng = np.random.default_rng(SEED + 2)
    n = SERVICE_ROWS
    data = clustered_rows(rng, n)
    pick = rng.integers(0, n, size=N_REQUESTS)
    qpart = pick % LOCAL_PARTS
    queries = data[pick] + rng.standard_normal((N_REQUESTS, DIMS), dtype=np.float32) * np.float32(
        0.1 / np.sqrt(DIMS)
    )
    gt = partition_top_k(torch.from_numpy(data).to(device), torch.from_numpy(queries).to(device), qpart, K)

    def key(i: int) -> tuple[int, int]:
        return int(i % LOCAL_PARTS), int(i // LOCAL_PARTS)

    def in_partition(p: int) -> dict:
        return {"filter": {"restrictions": [{"type": "==", "lhs": "p", "rhs": int(p)}], "allow_filtering": True}}

    db = FakeDb()
    db.add_table(FakeTable("ks", "tbl2", ("p", "c")))
    metadata = make_vs_metadata(
        index="lidx", table="tbl2", dimensions=DIMS, primary_key_columns=("p", "c"), partition_key_count=1,
        partitioning=DbIndexPartitioning.local(("p",)), quantization=Quantization.BF16,
    )  # COSINE
    db.add_index(FakeIndex(metadata=metadata, scan=lambda: (vector_row(key(i), data[i], 100) for i in range(n))))
    port = free_port()

    t0 = time.perf_counter()
    service = await serve(db, Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.1), device=device)
    try:
        async with aiohttp.ClientSession() as http:
            client = Http(http, f"http://127.0.0.1:{port}/api/v1/indexes/ks/lidx")
            await client.wait_for(lambda: client.counted(n), f"{n} rows")
            ingest_s = time.perf_counter() - t0
            engine = service.indexes.get_vs(metadata.key).actor.engine
            print(f"[local] {n} rows in {LOCAL_PARTS} partitions ingested in {ingest_s:.1f} s; directory "
                  f"P_cap x pmax = {engine._part_rows_host.shape}, capacity {engine.capacity}, "
                  f"device bytes {engine.device_bytes:,}", flush=True)
            check(engine._part_rows_host.shape == (PART_PCAP, PART_PMAX), "unexpected directory geometry")

            async def first_is(vector, p: int, want: tuple[int, int]) -> bool:
                res = await client.ann(vector, 3, **in_partition(p))
                keys = res["primary_keys"]
                return (keys["p"][:1], keys["c"][:1]) == ([want[0]], [want[1]]) and abs(res["distances"][0]) <= 1e-6

            # -- the local path, counted ------------------------------------
            ps.partition_scan.launches = 0
            sem = asyncio.Semaphore(IN_FLIGHT)
            lat: list[float] = []

            async def one(q, p):
                async with sem:
                    t = time.perf_counter()
                    res = await client.ann(q, K, **in_partition(p))
                    lat.append(time.perf_counter() - t)
                    return res["primary_keys"]

            t1 = time.perf_counter()
            got = await asyncio.gather(*(one(q, p) for q, p in zip(queries, qpart)))
            wall = time.perf_counter() - t1
            for keys, p in zip(got, qpart):
                check(set(keys["p"]) == {int(p)}, f"a result left partition {p}: {keys}")
            recall = float(np.mean([
                len(set(keys["c"]) & set((t // LOCAL_PARTS).tolist())) / K for keys, t in zip(got, gt)
            ]))
            print(f"[local] recall@{K} {recall:.4f} over {N_REQUESTS} partition-restricted requests; "
                  f"every key in its partition", flush=True)
            check(recall >= RECALL_MIN, f"local recall@{K} {recall:.4f} < {RECALL_MIN}")

            for i in rng.choice(n, size=8, replace=False):
                check(await first_is(data[i], key(i)[0], key(i)), f"self-query of row {key(i)} failed")
            p = key(pick[0])[0]
            new = clustered_rows(rng, 1)[0]
            await db.db_indexes[metadata.key].push_cdc(vector_row((p, n), new, 200))
            await client.wait_for(lambda: client.counted(n + 1), "the CDC insert", timeout=60)
            check(await first_is(new, p, (p, n)), "the CDC insert was not found first at distance 0")
            upd_key = key(pick[1])
            upd = clustered_rows(rng, 1)[0]
            await db.db_indexes[metadata.key].push_cdc(vector_row(upd_key, upd, 300))
            await client.wait_for(lambda: first_is(upd, upd_key[0], upd_key), "the CDC update of a row's vector",
                                  timeout=60)
            launches = ps.partition_scan.launches
            print(f"[local] partition_scan launches during the local path: {launches}", flush=True)
            check(launches > 0, "partition_scan never launched on the local path")
            print(
                f"[local] smoke readings on {card}: ingest {ingest_s:.1f} s for {n} rows, "
                f"{N_REQUESTS / wall:.0f} QPS and p50 {1e3 * statistics.median(lat):.1f} ms "
                f"at {IN_FLIGHT} in flight (client in the same process)",
                flush=True,
            )
            return launches
    finally:
        await service.stop()


async def i8_phase(device, card: str) -> int:
    """Phase 7: one global I8 index at the dbpedia-i8 shape served over
    HTTP; returns the int8 grouped scan's launches during the requests."""
    import aiohttp

    from vector_store_tpu_torch.core.types import Quantization
    from vector_store_tpu_torch.db.fake import FakeDb, FakeIndex, FakeTable, make_vs_metadata, vector_row
    from vector_store_tpu_torch.ops import ivf
    from vector_store_tpu_torch.run import serve
    from vector_store_tpu_torch.service.config import Config

    rng = np.random.default_rng(SEED + 5)
    n, dims = I8_ROWS, I8_DIMS
    t_gen = time.perf_counter()
    data = clustered_rows(rng, n, dims, I8_CENTERS)
    pick = rng.integers(0, n, size=N_REQUESTS)
    queries = data[pick] + rng.standard_normal((N_REQUESTS, dims), dtype=np.float32) * np.float32(
        0.1 / np.sqrt(dims)
    )
    data_dev = torch.from_numpy(data).to(device)
    gt = exact_top_k(data_dev, torch.from_numpy(queries).to(device), K)
    del data_dev
    torch.cuda.empty_cache()
    print(f"[i8] {n} x {dims} rows around {I8_CENTERS} centers and exact ground truth in "
          f"{time.perf_counter() - t_gen:.1f} s", flush=True)

    db = FakeDb()
    db.add_table(FakeTable("ks", "tbl3", ("pk",)))
    metadata = make_vs_metadata(index="i8idx", table="tbl3", dimensions=dims,
                                quantization=Quantization.I8)  # COSINE, rescoring on, global
    db.add_index(FakeIndex(metadata=metadata, scan=lambda: (vector_row((i,), data[i], 100) for i in range(n))))
    port = free_port()

    t0 = time.perf_counter()
    service = await serve(db, Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.1), device=device)
    try:
        async with aiohttp.ClientSession() as http:
            client = Http(http, f"http://127.0.0.1:{port}/api/v1/indexes/ks/i8idx")
            await client.wait_for(lambda: client.counted(n), f"{n} rows")
            ingest_s = time.perf_counter() - t0
            engine = service.indexes.get_vs(metadata.key).actor.engine

            async def built() -> bool:
                return engine.nlist > 0 and engine.maintain_pending() is None

            await client.wait_for(built, "the I8 IVF build to swap in and settle")
            settle_s = time.perf_counter() - t0 - ingest_s
            build_s = sum(sec for phase, sec in engine.maintain_log)
            print(f"[i8] {n} rows ingested in {ingest_s:.1f} s; IVF nlist={engine.nlist} cmax={engine.cmax} "
                  f"main={engine._main_rows} delta={engine._delta.size} ({engine.main_vecs.dtype} rows, "
                  f"oversample {engine.oversample}, nprobe {engine.nprobe}); settled {settle_s:.1f} s later, "
                  f"device build slices {build_s:.1f} s", flush=True)
            check(engine.main_vecs.dtype is torch.int8, "the I8 index's main region is not int8")
            check(engine._main_rows >= 0.8 * n, "the I8 main region holds under 80% of the rows")

            # -- the I8 path, counted ----------------------------------------
            ivf.grouped_scan.launches_by.clear()
            sem = asyncio.Semaphore(IN_FLIGHT)
            lat: list[float] = []

            async def one(q):
                async with sem:
                    t = time.perf_counter()
                    res = await client.ann(q)
                    lat.append(time.perf_counter() - t)
                    return res["primary_keys"]["pk"]

            t1 = time.perf_counter()
            got = await asyncio.gather(*(one(q) for q in queries))
            wall = time.perf_counter() - t1
            recall = float(np.mean([len(set(g) & set(t.tolist())) / K for g, t in zip(got, gt)]))
            print(f"[i8] recall@{K} {recall:.4f} over {N_REQUESTS} requests (the JAX package's dbpedia-i8 run: "
                  f"{I8_RECALL_REFERENCE})", flush=True)
            check(recall >= RECALL_MIN, f"I8 recall@{K} {recall:.4f} < {RECALL_MIN}")

            for i in rng.choice(n, size=16, replace=False):
                res = await client.ann(data[i], 3)
                check(res["primary_keys"]["pk"][0] == int(i) and abs(res["distances"][0]) <= 1e-6,
                      f"I8 self-query of row {i} returned {res}")
            new = clustered_rows(rng, 1, dims, I8_CENTERS)[0]
            await db.db_indexes[metadata.key].push_cdc(vector_row((n,), new, 200))
            await client.wait_for(lambda: client.counted(n + 1), "the CDC row", timeout=60)
            res = await client.ann(new, 3)
            check(res["primary_keys"]["pk"][0] == n and abs(res["distances"][0]) <= 1e-6,
                  f"I8 CDC row query returned {res}")
            launches = sum(c for (dt, _), c in ivf.grouped_scan.launches_by.items() if dt == "int8")
            print(f"[i8] int8 grouped_scan launches during the I8 path: {launches}", flush=True)
            check(launches > 0, "the int8 grouped scan never launched on the I8 path")
            print(
                f"[i8] smoke readings on {card}: ingest {ingest_s:.1f} s for {n} x {dims} rows, "
                f"device build slices {build_s:.1f} s, {N_REQUESTS / wall:.0f} QPS and p50 "
                f"{1e3 * statistics.median(lat):.1f} ms at {IN_FLIGHT} in flight (client in the same process)",
                flush=True,
            )
            return launches
    finally:
        await service.stop()


def bucket_labels(rng, n: int) -> np.ndarray:
    """suite.selectivity's labelling: each row draws u in [0, 1) and takes
    the bucket whose cumulative band holds it, so bucket b matches
    SELECTIVITY[b] of the rows (-1: none of them)."""
    labels = np.full(n, -1, dtype=np.int64)
    u = rng.random(n)
    acc = 0.0
    for bi, frac in enumerate(SELECTIVITY):
        labels[(u >= acc) & (u < acc + frac)] = bi
        acc += frac
    return labels


async def filtered_phase(device, card: str) -> dict:
    """Phase 8: filtered-1000k of vector_store_tpu/benchkit/scale.py served
    over HTTP; returns the scans' launches of the 10% bucket's warm pass
    (the device-masked regime)."""
    import aiohttp

    from vector_store_tpu_torch.db.fake import FakeDb, FakeIndex, FakeTable, make_vs_metadata, vector_row
    from vector_store_tpu_torch.ops import fused_scan as fs
    from vector_store_tpu_torch.ops import ivf
    from vector_store_tpu_torch.run import serve
    from vector_store_tpu_torch.service.config import Config

    rng = np.random.default_rng(SEED + 8)
    n = SERVICE_ROWS
    data = clustered_rows(rng, n)
    labels = bucket_labels(rng, n)
    pick = rng.integers(0, n, size=FILTERED_REQUESTS)
    queries = data[pick] + rng.standard_normal((FILTERED_REQUESTS, DIMS), dtype=np.float32) * np.float32(
        0.1 / np.sqrt(DIMS)
    )
    data_dev, q_dev = torch.from_numpy(data).to(device), torch.from_numpy(queries).to(device)
    gt = {}
    for bi in range(len(SELECTIVITY)):
        allowed = np.flatnonzero(labels == bi)
        gt[bi] = allowed[exact_top_k(data_dev[torch.from_numpy(allowed).to(device)], q_dev, K)]
    del data_dev, q_dev
    torch.cuda.empty_cache()

    db = FakeDb()
    db.add_table(FakeTable("ks", "tbl4", ("pk",), columns={"bucket": "int"}))
    metadata = make_vs_metadata(index="fidx", table="tbl4", dimensions=DIMS,
                                filtering_columns=("bucket",))  # COSINE, F32, global
    db.add_index(FakeIndex(metadata=metadata, scan=lambda: (
        vector_row((i,), data[i], 100, filtering=[(100, int(labels[i]))]) for i in range(n))))
    port = free_port()

    t0 = time.perf_counter()
    service = await serve(db, Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.1), device=device)
    try:
        async with aiohttp.ClientSession() as http:
            client = Http(http, f"http://127.0.0.1:{port}/api/v1/indexes/ks/fidx")
            await client.wait_for(lambda: client.counted(n), f"{n} rows", timeout=900)
            ingest_s = time.perf_counter() - t0
            actor = service.indexes.get_vs(metadata.key).actor
            engine = actor.engine

            async def built() -> bool:
                return engine.nlist > 0 and engine.maintain_pending() is None

            await client.wait_for(built, "the IVF build to swap in and settle")
            print(f"[filtered] {n} rows (buckets of {', '.join(f'{f:.1%}' for f in SELECTIVITY)}: "
                  f"{', '.join(str(int((labels == b).sum())) for b in range(len(SELECTIVITY)))} rows) ingested "
                  f"row by row in {ingest_s:.1f} s; IVF nlist={engine.nlist} cmax={engine.cmax} "
                  f"main={engine._main_rows} delta={engine._delta.size}; settled "
                  f"{time.perf_counter() - t0 - ingest_s:.1f} s later", flush=True)

            async def counters() -> dict:
                async with http.get(f"http://127.0.0.1:{port}/api/internals/counters") as resp:
                    return await resp.json()

            def only(value: int) -> dict:
                return {"filter": {"restrictions": [{"type": "==", "lhs": "bucket", "rhs": value}],
                                   "allow_filtering": True}}

            names = ("masked_dispatches", "exact_host_fallbacks", "oversample_escalations")
            masked_launches = {}
            for bi, frac in enumerate(SELECTIVITY):
                for label in ("cold", "warm"):
                    before = await counters()
                    # -- this pass of the filtered path, counted ---------------
                    fs.fused_scan.launches = 0
                    ivf.grouped_scan.launches = 0
                    sem = asyncio.Semaphore(FILTERED_IN_FLIGHT)
                    lat: list[float] = []

                    async def one(q, bi=bi):
                        async with sem:
                            t = time.perf_counter()
                            res = await client.ann(q, K, **only(bi))
                            lat.append(time.perf_counter() - t)
                            return res["primary_keys"]["pk"]

                    t1 = time.perf_counter()
                    got = await asyncio.gather(*(one(q) for q in queries))
                    wall = time.perf_counter() - t1
                    launches = {"fused_scan": fs.fused_scan.launches, "grouped_scan": ivf.grouped_scan.launches}
                    after = await counters()
                    delta = {k: after.get(f"vs_index_{k}", 0) - before.get(f"vs_index_{k}", 0) for k in names}
                    check(all((labels[g] == bi).all() for g in got), f"bucket {frac:.1%}: a key outside the bucket")
                    recall = float(np.mean([len(set(g) & set(t.tolist())) / K for g, t in zip(got, gt[bi])]))
                    print(f"[filtered] bucket {frac:.1%} {label}: {FILTERED_REQUESTS / wall:.0f} QPS, p50 "
                          f"{1e3 * statistics.median(lat):.1f} ms at {FILTERED_IN_FLIGHT} in flight, recall@{K} "
                          f"{recall:.4f}; counters {delta}; launches {launches}", flush=True)
                    if frac >= 0.5:  # the ladder
                        check(delta["masked_dispatches"] == 0 and delta["exact_host_fallbacks"] == 0,
                              f"bucket {frac:.1%} {label} left the ladder: {delta}")
                        check(recall >= RECALL_MIN, f"bucket {frac:.1%} recall@{K} {recall:.4f} < {RECALL_MIN}")
                    elif frac >= 1 / 32:  # the device-masked scan
                        check(delta["masked_dispatches"] > 0, f"bucket {frac:.1%} {label} was never masked: {delta}")
                        check(all(v > 0 for v in launches.values()),
                              f"bucket {frac:.1%} {label}: a scan of the masked path never launched: {launches}")
                        check(recall >= RECALL_MIN, f"bucket {frac:.1%} recall@{K} {recall:.4f} < {RECALL_MIN}")
                        if label == "warm":
                            masked_launches = launches
                    else:  # the grouped subset-exact terminal
                        check(delta["exact_host_fallbacks"] > 0, f"bucket {frac:.1%} {label} never took the "
                              f"terminal: {delta}")
                        if label == "warm":
                            check(delta["exact_host_fallbacks"] == FILTERED_REQUESTS and not any(launches.values()),
                                  f"bucket {frac:.1%} warm: {delta}, launches {launches}")
                        check(recall >= 0.99, f"bucket {frac:.1%} recall@{K} {recall:.4f} < 0.99")

            # the masked regime's device state, made anew from the same mask
            check(len(actor._allow_cache) == 1, f"{len(actor._allow_cache)} filters promoted to the mask, not 1")
            sig, (_, handle) = next(iter(actor._allow_cache.items()))
            fresh = engine.upload_allow_mask(handle.host)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            fresh.masked_b(engine)
            torch.cuda.synchronize()
            print(f"[filtered] the 10% bucket's handle ({int(handle.host.sum()):,} allowed slots) made its device "
                  f"mask and masked bias in {1e3 * (time.perf_counter() - t2):.2f} ms (host clock around "
                  f"synchronize)", flush=True)
            del fresh

            # two CDC inserts at a query point, each found first at distance 0:
            # a 10% row through a rebuilt mask, a 0.1% row through a refreshed
            # match set
            for i, bi in enumerate((1, len(SELECTIVITY) - 1)):
                new = clustered_rows(rng, 1)[0]
                before = await counters()
                await db.db_indexes[metadata.key].push_cdc(
                    vector_row((n + i,), new, 200, filtering=[(200, bi)]))
                await client.wait_for(lambda i=i: client.counted(n + 1 + i), "the CDC row", timeout=60)
                res = await client.ann(new, 3, **only(bi))
                check(res["primary_keys"]["pk"][0] == n + i and abs(res["distances"][0]) <= 1e-6,
                      f"the CDC row of bucket {SELECTIVITY[bi]:.1%} was not found first at distance 0: {res}")
                after = await counters()
                regime = "masked_dispatches" if bi == 1 else "exact_host_fallbacks"
                check(after.get(f"vs_index_{regime}", 0) > before.get(f"vs_index_{regime}", 0),
                      f"the CDC row of bucket {SELECTIVITY[bi]:.1%} was not served by {regime}")
            check(actor._allow_cache[sig][1] is not handle, "the 10% bucket's mask was not rebuilt after a write")
            print(f"[filtered] CDC inserts into the 10% and the 0.1% buckets found first at distance 0 (a rebuilt "
                  f"mask, a refreshed match set); smoke readings on {card}", flush=True)
            return masked_launches
    finally:
        await service.stop()


def hamming_oracle(bits_dev: torch.Tensor, q_bits: torch.Tensor, kc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact Hamming top-kc of {0, 1} queries [B, D] over {0, 1} rows [N, D]
    (both f32 on the card; the products are exact integers, TF32 is off),
    from the rows' own signs: popcnt(q) + popcnt(v) - 2 q.v, in chunks of
    rows. Returns (distances [B, kc] ascending, rows [B, kc])."""
    qc = q_bits.sum(1)
    cand_d, cand_i = [], []
    for lo in range(0, bits_dev.shape[0], 131_072):
        block = bits_dev[lo : lo + 131_072].float()
        d = qc[:, None] + block.sum(1)[None, :] - 2.0 * (q_bits @ block.T)
        bd, bi = torch.topk(d, kc, dim=1, largest=False)
        cand_d.append(bd)
        cand_i.append(bi + lo)
    best_d, sel = torch.topk(torch.cat(cand_d, 1), kc, dim=1, largest=False)
    return best_d, torch.gather(torch.cat(cand_i, 1), 1, sel)


async def b1_phase(device, card: str) -> None:
    """Phase 9: one global B1 index at the dbpedia-i8 shape served over
    HTTP (the flat engine's Hamming scan and bf16 rescore tier)."""
    import aiohttp

    from vector_store_tpu_torch.core.types import Quantization
    from vector_store_tpu_torch.db.fake import FakeDb, FakeIndex, FakeTable, make_vs_metadata, vector_row
    from vector_store_tpu_torch.engine.flat import FlatDeviceIndex, k_bucket
    from vector_store_tpu_torch.run import serve
    from vector_store_tpu_torch.service.config import Config

    rng = np.random.default_rng(SEED + 9)
    n, dims = B1_ROWS, I8_DIMS
    t_gen = time.perf_counter()
    data = clustered_rows(rng, n, dims, I8_CENTERS)
    pick = rng.integers(0, n, size=B1_REQUESTS)
    queries = data[pick] + rng.standard_normal((B1_REQUESTS, dims), dtype=np.float32) * np.float32(
        0.1 / np.sqrt(dims)
    )
    data_dev = torch.from_numpy(data).to(device)
    q_dev = torch.from_numpy(queries).to(device)
    gt = exact_top_k(data_dev, q_dev, K)
    # the oracle of the first B1_ORACLE queries: the Hamming top-kc from the
    # rows' signs (kc: the JAX engine's fetch, k's bucket times the
    # oversample), re-ranked by exact f32 cosine
    kc = k_bucket(k_bucket(K) * B1_OVERSAMPLE)
    bits = data_dev > 0
    del data_dev
    torch.cuda.empty_cache()
    q_or = q_dev[:B1_ORACLE]
    oracle_d, oracle_rows = hamming_oracle(bits, (q_or > 0).float(), kc)
    del bits
    torch.cuda.empty_cache()
    cand = torch.stack([torch.from_numpy(data[r]).to(device) for r in oracle_rows.cpu().numpy()])  # [B, kc, D]
    cos = torch.einsum("bd,bmd->bm", q_or, cand) / (q_or.norm(dim=1)[:, None] * cand.norm(dim=2))
    oracle_top = torch.gather(oracle_rows, 1, torch.topk(1.0 - cos, K, dim=1, largest=False).indices).cpu().numpy()
    del cand, cos
    print(f"[b1] {n} x {dims} rows around {I8_CENTERS} centers, exact ground truth and the Hamming oracle of "
          f"{B1_ORACLE} queries in {time.perf_counter() - t_gen:.1f} s", flush=True)

    db = FakeDb()
    db.add_table(FakeTable("ks", "tbl5", ("pk",)))
    metadata = make_vs_metadata(index="b1idx", table="tbl5", dimensions=dims,
                                quantization=Quantization.B1)  # COSINE, rescoring on, global
    db.add_index(FakeIndex(metadata=metadata, scan=lambda: (vector_row((i,), data[i], 100) for i in range(n))))
    port = free_port()

    t0 = time.perf_counter()
    service = await serve(db, Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.1), device=device)
    try:
        async with aiohttp.ClientSession() as http:
            client = Http(http, f"http://127.0.0.1:{port}/api/v1/indexes/ks/b1idx")
            await client.wait_for(lambda: client.counted(n), f"{n} rows")
            ingest_s = time.perf_counter() - t0
            engine = service.indexes.get_vs(metadata.key).actor.engine
            check(isinstance(engine, FlatDeviceIndex) and engine.vectors.dtype is torch.uint8,
                  "the B1 index is not on the flat engine's packed rows")
            check(engine.rescore and engine.oversample == B1_OVERSAMPLE, "the B1 index has no rescore tier")
            check(engine.lossy_fetch(K) == kc, f"the B1 scan fetches {engine.lossy_fetch(K)} candidates, not {kc}")
            print(f"[b1] {n} rows ingested in {ingest_s:.1f} s; flat engine, {engine.dp}-byte packed rows, "
                  f"capacity {engine.capacity}, bf16 rescore tier, oversample {engine.oversample}, "
                  f"device bytes {engine.device_bytes:,}", flush=True)

            # -- the B1 path --------------------------------------------------
            sem = asyncio.Semaphore(IN_FLIGHT)
            lat: list[float] = []

            async def one(q):
                async with sem:
                    t = time.perf_counter()
                    res = await client.ann(q)
                    lat.append(time.perf_counter() - t)
                    return res["primary_keys"]["pk"]

            t1 = time.perf_counter()
            got = await asyncio.gather(*(one(q) for q in queries))
            wall = time.perf_counter() - t1
            recall = float(np.mean([len(set(g) & set(t.tolist())) / K for g, t in zip(got, gt)]))
            print(f"[b1] recall@{K} {recall:.4f} over {B1_REQUESTS} requests against exact f32 cosine", flush=True)

            # the scan's candidates against the oracle's, as multisets of
            # Hamming distances (rows may differ only among ties)
            qs = engine.query_tensor(queries[:B1_ORACLE])
            dist, rows = engine._flat_search(qs, kc)
            check(torch.equal(dist, oracle_d), "the B1 scan's Hamming candidates differ from the oracle's")
            held = float((dist[:, -1:] > dist).float().mean())  # share of candidates strictly inside the cut
            port_recall = float(np.mean([len(set(g) & set(t.tolist())) / K for g, t in zip(got[:B1_ORACLE], gt)]))
            oracle_recall = float(np.mean([len(set(o.tolist()) & set(t.tolist())) / K
                                           for o, t in zip(oracle_top, gt)]))
            print(f"[b1] {B1_ORACLE} queries: Hamming top-{kc} distances equal to the oracle's "
                  f"({held:.3f} of them strictly inside the cut-off); recall@{K} {port_recall:.4f} against the "
                  f"oracle's (the same candidates re-ranked in exact f32) {oracle_recall:.4f}", flush=True)
            check(port_recall >= oracle_recall - 0.01,
                  f"B1 recall {port_recall:.4f} under the oracle's {oracle_recall:.4f} - 0.01")

            for i in rng.choice(n, size=16, replace=False):
                res = await client.ann(data[i], 3)
                check(res["primary_keys"]["pk"][0] == int(i) and res["distances"][0] == 0.0,
                      f"B1 self-query of row {i} returned {res}")
            new = clustered_rows(rng, 1, dims, I8_CENTERS)[0]
            await db.db_indexes[metadata.key].push_cdc(vector_row((n,), new, 200))
            await client.wait_for(lambda: client.counted(n + 1), "the CDC row", timeout=60)
            res = await client.ann(new, 3)
            check(res["primary_keys"]["pk"][0] == n and res["distances"][0] == 0.0, f"B1 CDC row query returned {res}")

            times = {}
            for b in (64, 1024):
                qb = np.resize(queries, (b, dims))
                times[b] = median_ms(lambda: engine.search(qb, K), reps=5, warmup=1)
            print(f"[b1] one flat B1 search batch (Hamming scan of {engine.capacity:,} rows, bf16 tier, host "
                  f"collect; CUDA events around the call) on {card}: B 64 {times[64]:.2f} ms, B 1024 "
                  f"{times[1024]:.2f} ms", flush=True)
            print(
                f"[b1] smoke readings on {card}: ingest {ingest_s:.1f} s for {n} x {dims} rows, "
                f"{B1_REQUESTS / wall:.0f} QPS and p50 {1e3 * statistics.median(lat):.1f} ms at {IN_FLIGHT} in "
                f"flight (client in the same process)",
                flush=True,
            )
    finally:
        await service.stop()


async def local_i8_phase(device, card: str) -> None:
    """Phase 10: partition-1000k stored as I8, served over HTTP (the
    directory's exact gather and the bf16 rescore tier; no partition
    scan: the JAX package's partition kernel takes float rows only)."""
    import aiohttp

    from vector_store_tpu_torch.core.types import DbIndexPartitioning, Quantization
    from vector_store_tpu_torch.db.fake import FakeDb, FakeIndex, FakeTable, make_vs_metadata, vector_row
    from vector_store_tpu_torch.engine.flat import PART_CROSSOVER_LOSSY, normalize_rows
    from vector_store_tpu_torch.ops import partition_scan as ps
    from vector_store_tpu_torch.ops.distance import query_block_distance
    from vector_store_tpu_torch.run import serve
    from vector_store_tpu_torch.service.config import Config

    rng = np.random.default_rng(SEED + 10)
    n = SERVICE_ROWS
    data = clustered_rows(rng, n)
    pick = rng.integers(0, n, size=N_REQUESTS)
    qpart = pick % LOCAL_PARTS
    queries = data[pick] + rng.standard_normal((N_REQUESTS, DIMS), dtype=np.float32) * np.float32(
        0.1 / np.sqrt(DIMS)
    )
    gt = partition_top_k(torch.from_numpy(data).to(device), torch.from_numpy(queries).to(device), qpart, K)

    def key(i: int) -> tuple[int, int]:
        return int(i % LOCAL_PARTS), int(i // LOCAL_PARTS)

    def in_partition(p: int) -> dict:
        return {"filter": {"restrictions": [{"type": "==", "lhs": "p", "rhs": int(p)}], "allow_filtering": True}}

    db = FakeDb()
    db.add_table(FakeTable("ks", "tbl6", ("p", "c")))
    metadata = make_vs_metadata(
        index="li8idx", table="tbl6", dimensions=DIMS, primary_key_columns=("p", "c"), partition_key_count=1,
        partitioning=DbIndexPartitioning.local(("p",)), quantization=Quantization.I8,
    )  # COSINE, rescoring on
    db.add_index(FakeIndex(metadata=metadata, scan=lambda: (vector_row(key(i), data[i], 100) for i in range(n))))
    port = free_port()

    t0 = time.perf_counter()
    service = await serve(db, Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.1), device=device)
    try:
        async with aiohttp.ClientSession() as http:
            client = Http(http, f"http://127.0.0.1:{port}/api/v1/indexes/ks/li8idx")
            await client.wait_for(lambda: client.counted(n), f"{n} rows")
            ingest_s = time.perf_counter() - t0
            engine = service.indexes.get_vs(metadata.key).actor.engine
            pmax = engine._part_rows_host.shape[1]
            print(f"[local-i8] {n} rows in {LOCAL_PARTS} partitions ingested in {ingest_s:.1f} s; directory "
                  f"P_cap x pmax = {engine._part_rows_host.shape}, capacity {engine.capacity}, mirror "
                  f"{engine.part_vecs is not None}, device bytes {engine.device_bytes:,}", flush=True)
            check(engine.vectors.dtype is torch.int8 and engine.part_vecs is None and engine.rescore,
                  "the local I8 index is not int8 rows with a rescore tier and no mirror")
            check(engine._part_directory_wins(), "the local I8 index does not route to its directory")

            async def first_is(vector, p: int, want: tuple[int, int]) -> bool:
                res = await client.ann(vector, 3, **in_partition(p))
                keys = res["primary_keys"]
                return (keys["p"][:1], keys["c"][:1]) == ([want[0]], [want[1]]) and abs(res["distances"][0]) <= 1e-6

            # -- the local I8 path ------------------------------------------
            ps.partition_scan.launches = 0
            sem = asyncio.Semaphore(IN_FLIGHT)
            lat: list[float] = []

            async def one(q, p):
                async with sem:
                    t = time.perf_counter()
                    res = await client.ann(q, K, **in_partition(p))
                    lat.append(time.perf_counter() - t)
                    return res["primary_keys"]

            t1 = time.perf_counter()
            got = await asyncio.gather(*(one(q, p) for q, p in zip(queries, qpart)))
            wall = time.perf_counter() - t1
            for keys, p in zip(got, qpart):
                check(set(keys["p"]) == {int(p)}, f"a result left partition {p}: {keys}")
            recall = float(np.mean([
                len(set(keys["c"]) & set((t // LOCAL_PARTS).tolist())) / K for keys, t in zip(got, gt)
            ]))
            print(f"[local-i8] recall@{K} {recall:.4f} over {N_REQUESTS} partition-restricted requests; every "
                  f"key in its partition", flush=True)
            check(recall >= RECALL_MIN, f"local I8 recall@{K} {recall:.4f} < {RECALL_MIN}")

            for i in rng.choice(n, size=8, replace=False):
                check(await first_is(data[i], key(i)[0], key(i)), f"I8 self-query of row {key(i)} failed")
            p = key(pick[0])[0]
            new = clustered_rows(rng, 1)[0]
            await db.db_indexes[metadata.key].push_cdc(vector_row((p, n), new, 200))
            await client.wait_for(lambda: client.counted(n + 1), "the CDC insert", timeout=60)
            check(await first_is(new, p, (p, n)), "the local I8 CDC insert was not found first")
            launches = ps.partition_scan.launches
            print(f"[local-i8] partition_scan launches during the local I8 path: {launches}", flush=True)
            check(launches == 0, "the partition scan launched for I8 rows")

            # the directory's gather against the masked scan, both fetching
            # the tier's candidates (the engine's lossy_fetch at k 10), and
            # the f64 sum of the gather's I8 block distances against an f32 one
            kc = engine.lossy_fetch(K)
            crossing = {}
            for nq in (64, 2048):
                sel = rng.integers(0, n, size=nq)
                q = engine.query_tensor(normalize_rows(data[sel]))
                psel = (sel % LOCAL_PARTS).astype(np.int64)
                bsel = engine._directory_buckets(psel)
                psel_t = torch.from_numpy(psel.astype(np.int32)).to(device)
                t_dir = median_ms(lambda: engine._part_gather(q, bsel, kc), reps=5, warmup=1)
                t_mask = median_ms(lambda: engine._flat_search(q, kc, psel_t), reps=3, warmup=1)
                crossing[nq] = (t_dir, t_mask)
                print(f"[local-i8] B={nq}: directory gather {t_dir:.3f} ms (B*pmax = {nq * pmax:,} rows), masked "
                      f"scan {t_mask:.3f} ms ({engine.capacity:,} rows), I8 k={kc}, on {card}", flush=True)
            t_dir, t_mask = crossing[2048]
            ratio = (t_mask / (2048 * engine.capacity)) / (t_dir / (2048 * pmax))
            print(f"[local-i8] per query-row at B=2048: the directory wins while pmax <= {ratio:.3f} x capacity "
                  f"(the engine routes lossy storage on PART_CROSSOVER_LOSSY = {PART_CROSSOVER_LOSSY})", flush=True)
            step = max(1, ps.PLAIN_CHUNK_ELEMS // (pmax * engine.dp))  # the gather's chunk of queries
            rows = engine.part_rows[bsel[:step].long()]
            vb = engine.vectors[torch.clamp(rows, min=0).long()]  # [step, pmax, Dp] int8
            qa = torch.zeros(step, device=device)
            va = torch.ones(vb.shape[:2], device=device)
            t64 = median_ms(lambda: query_block_distance(q[:step], vb, engine.space_type, engine.quantization,
                                                         qa, va), reps=5, warmup=1)
            t32 = median_ms(lambda: torch.einsum("bd,bmd->bm", q[:step].float(), vb.float()), reps=5, warmup=1)
            print(f"[local-i8] one gather chunk [{step}, {pmax}, {engine.dp}] int8: I8 block distance (f64 sum) "
                  f"{t64:.3f} ms, the same product summed in f32 {t32:.3f} ms; {-(-2048 // step)} chunks at "
                  f"B 2048, on {card}", flush=True)
            del vb
            print(
                f"[local-i8] smoke readings on {card}: ingest {ingest_s:.1f} s for {n} rows, "
                f"{N_REQUESTS / wall:.0f} QPS and p50 {1e3 * statistics.median(lat):.1f} ms "
                f"at {IN_FLIGHT} in flight (client in the same process)",
                flush=True,
            )
    finally:
        await service.stop()


async def graph_phase(device, card: str) -> dict:
    """Phase 11: graph-1000k served over HTTP under ``engine_kind="graph"``;
    returns kernel 1's launches of the phase by purpose."""
    import aiohttp

    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.db.fake import FakeDb, FakeIndex, FakeTable, delete_row, make_vs_metadata, vector_row
    from vector_store_tpu_torch.engine.graph import graph_beam_search
    from vector_store_tpu_torch.ops import fused_scan as fs
    from vector_store_tpu_torch.ops.distance import prepare_queries
    from vector_store_tpu_torch.run import serve
    from vector_store_tpu_torch.service.config import Config

    rng = np.random.default_rng(SEED + 9)
    n = GRAPH_ROWS
    t_gen = time.perf_counter()
    data = clustered_rows(rng, n, DIMS, GRAPH_CLUSTERS)
    held = data[rng.integers(0, n, size=GRAPH_HELD)] + rng.standard_normal((GRAPH_HELD, DIMS), dtype=np.float32) * (
        np.float32(0.1 / np.sqrt(DIMS))
    )
    gt = exact_top_k(torch.from_numpy(data).to(device), torch.from_numpy(held).to(device), K, "EUCLIDEAN")
    torch.cuda.empty_cache()
    print(f"[graph] {n} x {DIMS} rows in {GRAPH_CLUSTERS} clusters and exact ground truth in "
          f"{time.perf_counter() - t_gen:.1f} s", flush=True)

    db = FakeDb()
    db.add_table(FakeTable("ks", "tbl5", ("pk",)))
    metadata = make_vs_metadata(index="gidx", table="tbl5", dimensions=DIMS, space_type=SpaceType.EUCLIDEAN,
                                quantization=Quantization.BF16)  # connectivity 16, expansion 128 / 64
    db.add_index(FakeIndex(metadata=metadata, scan=lambda: (vector_row((i,), data[i], 100) for i in range(n))))
    port = free_port()
    by = {"build": 0, "merge": 0, "search": 0}

    def counted(fn, purpose):
        def wrapper(*args, **kwargs):
            before = fs.fused_scan.launches
            try:
                return fn(*args, **kwargs)
            finally:
                by[purpose] += fs.fused_scan.launches - before
        return wrapper

    t0 = time.perf_counter()
    config = Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.1, engine_kind="graph")
    service = await serve(db, config, device=device)
    try:
        async with aiohttp.ClientSession() as http:
            client = Http(http, f"http://127.0.0.1:{port}/api/v1/indexes/ks/gidx")
            engine = None
            while engine is None:  # the actor exists once the index is registered
                entry = service.indexes.get_vs(metadata.key)
                engine = entry.actor.engine if entry is not None else None
                await asyncio.sleep(0.05)
            # the bulk builds (device, or host through it) and every merge
            # or refinement slice
            for name, purpose in (("bulk_build_device", "build"), ("_insert_into_graph", "merge")):
                setattr(engine, name, counted(getattr(engine, name), purpose))
            await client.wait_for(lambda: client.counted(n), f"{n} rows")
            ingest_s = time.perf_counter() - t0
            marks = {}

            async def idle() -> bool:
                if engine.delta_count == 0 and "merged" not in marks:
                    marks["merged"] = time.perf_counter()
                return not engine.maintenance_due

            await client.wait_for(idle, "the graph's merges and refinement to fall idle", timeout=900)
            t_idle = time.perf_counter()
            path = {"device": "device bulk build", "host": "host bulk build"}.get(
                engine.last_build, "bootstrap + incremental merges of 4096")
            print(f"[graph] {n} rows ingested in {ingest_s:.1f} s; build path: {path}; delta drained "
                  f"{marks['merged'] - t0 - ingest_s:.1f} s after ingest, maintenance idle "
                  f"{t_idle - t0 - ingest_s:.1f} s after ingest (refinement {t_idle - marks['merged']:.1f} s); "
                  f"graph_nodes {engine.graph_nodes}, device_bytes {engine.device_bytes}, entries "
                  f"{len(engine._entries)}", flush=True)
            check(engine.graph_nodes == n, f"graph_nodes {engine.graph_nodes} != {n}")

            # -- the search path, counted ------------------------------------
            fs.fused_scan.launches = 0
            sem = asyncio.Semaphore(IN_FLIGHT)
            lat: list[float] = []

            async def one(q):
                async with sem:
                    t = time.perf_counter()
                    res = await client.ann(q)
                    lat.append(time.perf_counter() - t)
                    return res["primary_keys"]["pk"]

            requests = np.concatenate([held, held])
            t1 = time.perf_counter()
            got = await asyncio.gather(*(one(q) for q in requests))
            wall = time.perf_counter() - t1
            by["search"] = fs.fused_scan.launches
            recall = float(np.mean([len(set(g) & set(t.tolist())) / K for g, t in zip(got[:GRAPH_HELD], gt)]))
            print(f"[graph] recall@{K} {recall:.4f} over {GRAPH_HELD} held queries (exact f32 ground truth); "
                  f"{len(requests) / wall:.0f} QPS and p50 {1e3 * statistics.median(lat):.1f} ms at {IN_FLIGHT} "
                  "in flight (client in the same process)", flush=True)
            check(recall >= RECALL_MIN, f"graph recall@{K} {recall:.4f} < {RECALL_MIN}")

            # -- one beam-search batch, CUDA events ----------------------------
            store = engine.store
            beam_ms = {}
            for b in (64, 2048):
                qs, qa = prepare_queries(np.resize(held, (b, DIMS)), SpaceType.EUCLIDEAN, Quantization.BF16)
                qs, qa = qs.to(device), qa.to(device)
                allow = torch.ones((store.capacity,), dtype=torch.bool, device=device)
                entries, valid = engine._entries_tensor(), engine._valid()

                def beam(qs=qs, qa=qa, allow=allow, entries=entries, valid=valid):
                    return graph_beam_search(
                        store.vectors, store.aux, valid, allow, engine.adjacency, entries, qs, qa,
                        space=SpaceType.EUCLIDEAN, quant=Quantization.BF16, k=16,
                        beam_width=engine.expansion_search, iters=engine.expansion_search, filtered=False,
                        expand=engine.beam_expand,
                    )

                beam_ms[b] = median_ms(beam, reps=5)
                t = time.perf_counter()
                engine.search(np.resize(held, (b, DIMS)), K)
                beam_ms[f"search {b}"] = 1e3 * (time.perf_counter() - t)
            print(f"[graph] one beam-search batch (k 16, ef {engine.expansion_search}, expand "
                  f"{engine.beam_expand}; CUDA events): B 64 {beam_ms[64]:.3f} ms, B 2048 {beam_ms[2048]:.3f} ms; "
                  f"engine.search with its host collect: B 64 {beam_ms['search 64']:.1f} ms, B 2048 "
                  f"{beam_ms['search 2048']:.1f} ms", flush=True)

            # -- one kNN chunk of the bulk build against the plain scan -------
            qd = store.vectors[:2048]
            rank, pos = fs.fused_scan(qd, store.vectors, store.a, store.b, store.block_rows)
            prank, ppos = fs.fused_scan_plain(qd, store.vectors, store.a, store.b, store.block_rows)
            a, bb, block = store.a, store.b, store.block_rows

            def exact(qi, rows):
                return a[rows] * (qd[qi].float() * store.vectors[rows].float()).sum(-1) + bb[rows]

            def group(qi, col, rows=None):
                if rows is None:
                    return (col // fs.LANES) * block + col % fs.LANES
                return (rows // block) * block + rows % fs.LANES

            err = compare("graph kNN chunk", rank, pos, prank, ppos, exact, group)
            del rank, pos, prank, ppos
            print(f"[graph] one kNN chunk of the bulk build (B 2048 stored BF16 rows over {store.capacity} rows): "
                  f"kernel against fused_scan_plain, max |rank err| {err:.3g} (tolerance {RTOL:g} * (1 + |r|))",
                  flush=True)

            # -- self-queries; CDC inserts in the delta, then in the graph; a delete.
            # A stored row is not always reached by the beam (the held
            # queries' recall counts those misses too), so the graph's
            # answers are held to a share: every row found must come first
            # at distance 0.0 exactly (the f32 host mirror's distance), and
            # at least GRAPH_FOUND_MIN of the rows must be found; rows in
            # the delta are scanned exactly and must all be found
            async def found_first(rows, pks) -> int:
                async def one(v, pk):
                    async with sem:
                        res = await client.ann(v)
                    first = res["primary_keys"]["pk"][0] == pk
                    check(not first or res["distances"][0] == 0.0, f"row {pk} answered at {res['distances'][0]}")
                    return first

                return sum(await asyncio.gather(*(one(v, int(pk)) for v, pk in zip(rows, pks))))

            picked = rng.choice(n, size=GRAPH_SELF, replace=False)
            self_hits = await found_first(data[picked], picked)
            dbi = db.db_indexes[metadata.key]
            real = engine.maintain
            engine.maintain = lambda max_batch=4096: False  # the smoke holds the merges back
            # new rows inside the data's clusters (stored rows moved by noise)
            new = data[rng.integers(0, n, size=GRAPH_CDC)] + rng.standard_normal((GRAPH_CDC, DIMS), dtype=np.float32) * (
                np.float32(0.1 / np.sqrt(DIMS))
            )
            for j in range(GRAPH_CDC):
                await dbi.push_cdc(vector_row((n + j,), new[j], 200))
            await client.wait_for(lambda: client.counted(n + GRAPH_CDC), "the CDC rows", timeout=60)
            check(engine.delta_count == GRAPH_CDC, f"{engine.delta_count} CDC rows in the delta")
            delta_hits = await found_first(new, range(n, n + GRAPH_CDC))
            check(delta_hits == GRAPH_CDC, f"{delta_hits} of {GRAPH_CDC} CDC rows found in the delta")
            engine.maintain = real  # the next modify batch makes a merge due
            await dbi.push_cdc(vector_row((n + GRAPH_CDC,), new[0] + 1.0, 201))

            async def merged() -> bool:
                return engine.delta_count == 0 and engine.graph_nodes == n + GRAPH_CDC + 1

            await client.wait_for(merged, "the CDC rows' merge", timeout=120)
            graph_hits = await found_first(new, range(n, n + GRAPH_CDC))
            await dbi.push_cdc(delete_row((n,), 300))
            await client.wait_for(lambda: client.counted(n + GRAPH_CDC), "the delete", timeout=60)
            res = await client.ann(new[0], 100)
            check(n not in res["primary_keys"]["pk"], f"a deleted row still answers: {res['primary_keys']['pk'][:5]}")
            print(f"[graph] found first at distance 0 (limit {K}): {self_hits} of {GRAPH_SELF} stored rows; "
                  f"{delta_hits} of {GRAPH_CDC} CDC inserts in the delta, {graph_hits} of them after their merge; "
                  f"a deleted row no longer answers. Kernel 1 launches of the phase (BF16 rows): {by}", flush=True)
            check(self_hits >= GRAPH_FOUND_MIN * GRAPH_SELF, f"{self_hits} of {GRAPH_SELF} stored rows found")
            check(graph_hits >= GRAPH_FOUND_MIN * GRAPH_CDC, f"{graph_hits} of {GRAPH_CDC} merged CDC rows found")
            check(by["build"] + by["merge"] > 0, f"kernel 1 never launched while the graph was built: {by}")
            print(f"[graph] smoke readings on {card}: ingest {ingest_s:.1f} s, maintenance idle "
                  f"{t_idle - t0 - ingest_s:.1f} s after ingest ({path}), recall@{K} {recall:.4f}, "
                  f"{len(requests) / wall:.0f} QPS, p50 {1e3 * statistics.median(lat):.1f} ms", flush=True)
            return by
    finally:
        await service.stop()


def cpu_seconds(pid: int) -> float:
    """utime + stime of one process (/proc/<pid>/stat), seconds."""
    with open(f"/proc/{pid}/stat", "rb") as f:
        fields = f.read().split(b") ", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def proc_rss(pid: int) -> str:
    """A process's resident memory (VmRSS), split into private (RssAnon)
    and file-backed (RssFile: shared libraries, in the page cache once for
    all) where the kernel reports the split."""
    with open(f"/proc/{pid}/status") as f:
        kb = {line.split(":")[0]: int(line.split()[1]) for line in f if line.startswith(("VmRSS", "Rss"))}
    if "RssAnon" not in kb:
        return f"{kb['VmRSS'] / 1024:.0f} MB resident"
    return f"{kb['RssAnon'] / 1024:.0f} MB private + {kb['RssFile'] / 1024:.0f} MB file-backed"


def proc_maps(pid: int, name: str) -> bool:
    """Does the process map a library whose path holds ``name``?"""
    with open(f"/proc/{pid}/maps") as f:
        return any(name in line for line in f)


def listening(pids: list[int], port: int) -> set[int]:
    """The processes among ``pids`` that hold a socket listening on TCP
    ``port`` (/proc/net/tcp's LISTEN inodes against each one's fds)."""
    inodes = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        with open(table) as f:
            for line in list(f)[1:]:
                fields = line.split()
                if fields[3] == "0A" and int(fields[1].rsplit(":", 1)[1], 16) == port:
                    inodes.add(f"socket:[{fields[9]}]")
    out = set()
    for pid in pids:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                if os.readlink(f"/proc/{pid}/fd/{fd}") in inodes:
                    out.add(pid)
                    break
            except OSError:
                continue
    return out


def frontends_up(pids: list[int], port: int, t0: float, timeout: float = 120.0) -> dict[int, float]:
    """Seconds from ``t0`` until each process listens on ``port``."""
    up: dict[int, float] = {}
    deadline = time.perf_counter() + timeout
    while len(up) < len(pids) and time.perf_counter() < deadline:
        for pid in listening([p for p in pids if p not in up], port):
            up[pid] = time.perf_counter() - t0
        time.sleep(0.01)
    return up


class LoopLag:
    """How late a 10 ms sleep of the owner's event loop wakes: the loop's
    saturation during a load window."""

    def __init__(self) -> None:
        self.lags: list[float] = []
        self.task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        while True:
            t = time.perf_counter()
            await asyncio.sleep(0.01)
            self.lags.append(time.perf_counter() - t - 0.01)

    def stop(self) -> str:
        self.task.cancel()
        return (f"loop lag p50 {1e3 * statistics.median(self.lags):.1f} ms, max {1e3 * max(self.lags):.1f} ms"
                if self.lags else "loop lag not sampled")


def owner_host_ms() -> str:
    """The actor's and the IVF engine's host time in worker threads since
    the last hotpath reset (utils/hotpath.py)."""
    from vector_store_tpu_torch.utils import hotpath

    names = ("vs_index.VsIndexActor._begin_window", "vs_index.VsIndexActor._collect_batches",
             "ivf.IvfDeviceIndex.search_begin", "ivf.IvfDeviceIndex.search_collect")
    st = hotpath.stats()
    return ", ".join(f"{name.split('.')[-1]} {st[name]['calls']} calls {st[name]['total_ms']:.0f} ms"
                     for name in names if name in st)


def scaled_client_main(base: str, queries: np.ndarray, in_flight: int, ready, go, out) -> None:
    """One HTTP load process of phase 12: ``in_flight`` closed loops of ANN
    requests through the port's REST client (client.py). It reports ready,
    starts on ``go``, and after SCALED_WARM_S reports the latencies of the
    requests it sent and finished within the next SCALED_RUN_S."""
    asyncio.run(_client_load(base, queries, in_flight, ready, go, out))


async def _client_load(base, queries, in_flight, ready, go, out) -> None:
    import aiohttp

    from vector_store_tpu_torch.client import ApiError, VectorStoreClient

    vectors = [q.tolist() for q in queries]
    lat: list[float] = []
    errors = 0
    connector = aiohttp.TCPConnector(limit=0)  # one connection a loop
    timeout = aiohttp.ClientTimeout(total=None, sock_read=120)
    async with aiohttp.ClientSession(connector=connector, timeout=timeout) as session:
        client = VectorStoreClient(base, session=session)
        ready.put(os.getpid())
        await asyncio.to_thread(go.wait, 300)
        t_measure = time.perf_counter() + SCALED_WARM_S
        t_end = t_measure + SCALED_RUN_S

        async def closed_loop(i: int) -> None:
            nonlocal errors
            while (t := time.perf_counter()) < t_end:
                try:
                    await client.ann("ks", "idx", vectors[i % len(vectors)], K)
                except ApiError:
                    errors += 1
                    continue
                done = time.perf_counter()
                if t >= t_measure and done <= t_end:
                    lat.append(done - t)
                i += in_flight

        await asyncio.gather(*(closed_loop(i) for i in range(in_flight)))
    out.put({"pid": os.getpid(), "lat": lat, "errors": errors})


async def scaled_phase(device, card: str, phase5_qps: float) -> dict:
    """Phase 12: phase 5's index (global F32 COSINE, SERVICE_ROWS x 128)
    served by run.serve_scaled: the owner keeps the card and the engines,
    W frontend processes do the HTTP work; returns the scans' launches
    during the HTTP requests (counted in the owner)."""
    import multiprocessing

    import aiohttp

    from vector_store_tpu_torch.core.types import Quantization
    from vector_store_tpu_torch.db.fake import FakeDb, FakeIndex, FakeTable, make_vs_metadata, vector_row
    from vector_store_tpu_torch.ops import fused_scan as fs
    from vector_store_tpu_torch.ops import ivf
    from vector_store_tpu_torch.run import gpus_hidden, serve_scaled
    from vector_store_tpu_torch.service.config import Config
    from vector_store_tpu_torch.utils import hotpath

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 1)  # phase 5's rows and requests
    n = SERVICE_ROWS
    data = clustered_rows(rng, n)
    pick = rng.integers(0, n, size=N_REQUESTS)
    queries = data[pick] + rng.standard_normal((N_REQUESTS, DIMS), dtype=np.float32) * np.float32(
        0.1 / np.sqrt(DIMS)
    )
    gt = exact_top_k(torch.from_numpy(data).to(device), torch.from_numpy(queries).to(device), K)

    db = FakeDb()
    db.add_table(FakeTable("ks", "tbl", ("pk",)))
    metadata = make_vs_metadata(dimensions=DIMS, quantization=Quantization.F32)  # COSINE, global
    port = free_port()
    workers = max(1, min(4, (os.cpu_count() or 1) - 2))
    owner = os.getpid()
    print(f"[scaled] {workers} frontend workers on {os.cpu_count()} cores; owner pid {owner}", flush=True)

    t0 = time.perf_counter()
    service = await serve_scaled(
        db, Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.1), workers=workers, device=device
    )
    frontends = [p.pid for p in service.frontends]
    # the frontends' start-up, timed while the owner is idle (an ingesting
    # owner holds the interpreter lock for long stretches); then the index
    up_s = await asyncio.to_thread(frontends_up, frontends, port, t0)
    check(len(up_s) == workers, f"frontends {sorted(set(frontends) - set(up_s))} never listened")
    t0 = time.perf_counter()
    db.add_index(FakeIndex(metadata=metadata, scan=lambda: (vector_row((i,), data[i], 100) for i in range(n))))
    ctx = multiprocessing.get_context("spawn")
    try:
        async with aiohttp.ClientSession() as http:
            base = f"http://127.0.0.1:{port}"
            client = Http(http, f"{base}/api/v1/indexes/ks/idx")
            ann, wait_for, counted = client.ann, client.wait_for, client.counted

            async def frontend_up() -> bool:
                try:
                    async with http.get(f"{base}/api/v1/status") as resp:
                        return resp.status == 200
                except aiohttp.ClientError:
                    return False

            await wait_for(frontend_up, "a frontend to answer", timeout=120)
            await wait_for(lambda: counted(n), f"{n} rows")
            ingest_s = time.perf_counter() - t0
            actor = service.indexes.get_vs(metadata.key).actor
            engine = actor.engine

            async def built() -> bool:
                return engine.nlist > 0 and engine.maintain_pending() is None

            await wait_for(built, "the IVF build to swap in and settle")
            settle_s = time.perf_counter() - t0 - ingest_s
            print(f"[scaled] {n} rows ingested (through the owner, polled through the frontends) in {ingest_s:.1f} s; "
                  f"IVF nlist={engine.nlist} main={engine._main_rows} delta={engine._delta.size}; settled "
                  f"{settle_s:.1f} s later", flush=True)
            print("[scaled] frontends (listening s after serve_scaled was called; resident memory now): " + "; ".join(
                f"pid {pid} {up_s[pid]:.2f} s, {proc_rss(pid)}, torch "
                f"{'loaded' if proc_maps(pid, 'libtorch') else 'not loaded'}" for pid in frontends)
                + f"; owner {proc_rss(owner)}", flush=True)

            # -- the in-process ceiling: actor.ann_many, no IPC, no HTTP ----
            lat: list[float] = []
            served = 0

            async def ceiling_task(w: int, stop_at: float) -> None:
                nonlocal served
                lo = (w * CEILING_BATCH) % N_REQUESTS
                while time.perf_counter() < stop_at:
                    t = time.perf_counter()
                    res = await actor.ann_many(queries[lo : lo + CEILING_BATCH], K)
                    lat.append(time.perf_counter() - t)
                    served += len(res)

            # warm-up at the same concurrency (the batch shapes of the window)
            await asyncio.gather(*(ceiling_task(w, time.perf_counter() + 1.0) for w in range(CEILING_TASKS)))
            lat.clear()
            served = 0
            hotpath.enable()
            hotpath.reset()
            lag = LoopLag()
            launches0 = fs.fused_scan.launches
            t1 = time.perf_counter()
            stop_at = t1 + CEILING_S
            await asyncio.gather(*(ceiling_task(w, stop_at) for w in range(CEILING_TASKS)))
            ceiling_qps = served / (time.perf_counter() - t1)
            batches = fs.fused_scan.launches - launches0
            print(f"[scaled] in-process ceiling on {card}: actor.ann_many, {CEILING_TASKS} tasks x {CEILING_BATCH} "
                  f"queries: {ceiling_qps:.0f} QPS, p50 {1e3 * statistics.median(lat):.1f} ms a call, "
                  f"{served / max(batches, 1):.0f} requests a device batch; {lag.stop()}; owner threads: "
                  f"{owner_host_ms()}", flush=True)

            # -- the main path, counted: HTTP through the frontends ---------
            fs.fused_scan.launches = 0
            fs.fused_scan.launches_by.clear()
            ivf.grouped_scan.launches = 0
            ivf.grouped_scan.launches_by.clear()
            readings = {}
            apps = None
            for in_flight in SCALED_IN_FLIGHT:
                ready, go, out = ctx.Queue(), ctx.Event(), ctx.Queue()
                clients = [ctx.Process(target=scaled_client_main, daemon=True, args=(
                    base, queries[c::SCALED_CLIENTS], in_flight // SCALED_CLIENTS, ready, go, out))
                    for c in range(SCALED_CLIENTS)]
                with gpus_hidden():  # the clients see no GPU either
                    for p in clients:
                        p.start()
                pids = [await asyncio.to_thread(ready.get, True, 300) for _ in clients]
                go.set()
                await asyncio.sleep(SCALED_WARM_S)
                cpu0 = {"owner": cpu_seconds(owner), "frontends": sum(map(cpu_seconds, frontends)),
                        "clients": sum(map(cpu_seconds, pids))}
                hotpath.reset()
                lag = LoopLag()
                launches0 = fs.fused_scan.launches
                if apps is None:  # every process of the phase is up: who holds a CUDA context?
                    apps = subprocess.run(
                        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                        capture_output=True, text=True, check=True,
                    ).stdout.strip().splitlines()
                    reserved_mib = torch.cuda.memory_reserved(device) / 2**20
                    cuda_mapped = [pid for pid in frontends + pids if proc_maps(pid, "libcuda")]
                await asyncio.sleep(SCALED_RUN_S)
                cpu1 = {"owner": cpu_seconds(owner), "frontends": sum(map(cpu_seconds, frontends)),
                        "clients": sum(map(cpu_seconds, pids))}
                batches = fs.fused_scan.launches - launches0
                window = f"{lag.stop()}; owner threads: {owner_host_ms()}"
                results = [await asyncio.to_thread(out.get, True, 120) for _ in clients]
                for p in clients:
                    p.join(timeout=30)
                    check(not p.is_alive() and p.exitcode == 0, f"HTTP client {p.pid} exited {p.exitcode}")
                lat = [x for r in results for x in r["lat"]]
                errors = sum(r["errors"] for r in results)
                check(errors == 0 and len(lat) > 0, f"{errors} failed requests, {len(lat)} answered at {in_flight} in flight")
                cpu = {k: cpu1[k] - cpu0[k] for k in cpu0}
                readings[in_flight] = len(lat) / SCALED_RUN_S
                print(f"[scaled] HTTP on {card}, {SCALED_CLIENTS} client processes (client.py), {in_flight} in flight: "
                      f"{len(lat) / SCALED_RUN_S:.0f} QPS, p50 {1e3 * np.percentile(lat, 50):.1f} ms, "
                      f"p99 {1e3 * np.percentile(lat, 99):.1f} ms over {SCALED_RUN_S:.0f} s; CPU seconds in the window: "
                      f"owner {cpu['owner']:.2f}, {workers} frontends {cpu['frontends']:.2f}, "
                      f"clients {cpu['clients']:.2f}; ~{len(lat) / max(batches, 1):.0f} requests a device batch; "
                      f"{window}", flush=True)
            print(f"[scaled] QPS on {card}: in-process ceiling {ceiling_qps:.0f}; HTTP through {workers} frontends "
                  + ", ".join(f"{v:.0f} at {k} in flight" for k, v in readings.items())
                  + f"; phase 5 (one process, {IN_FLIGHT} in flight) {phase5_qps:.0f}", flush=True)

            # -- correctness through the frontends --------------------------
            sem = asyncio.Semaphore(IN_FLIGHT)

            async def one(q):
                async with sem:
                    return (await ann(q))["primary_keys"]["pk"]

            got = await asyncio.gather(*(one(q) for q in queries))
            recall = float(np.mean([len(set(g) & set(t.tolist())) / K for g, t in zip(got, gt)]))
            print(f"[scaled] recall@{K} {recall:.4f} over {N_REQUESTS} requests through the frontends", flush=True)
            check(recall >= RECALL_MIN, f"scaled recall@{K} {recall:.4f} < {RECALL_MIN}")
            for i in rng.choice(n, size=16, replace=False):
                res = await ann(data[i], 3)
                check(res["primary_keys"]["pk"][0] == int(i) and abs(res["distances"][0]) <= 1e-6,
                      f"scaled self-query of row {i} returned {res}")
            async with http.post(f"{base}/api/v1/indexes/ks/nope/ann", json={"vector": [0.0] * DIMS}) as resp:
                check(resp.status == 404, f"an unknown index answered {resp.status}")
            async with http.post(f"{client.base}/ann", json={"vector": [0.0] * 3, "limit": K}) as resp:
                check(resp.status == 400, f"a wrong dimension answered {resp.status}")
            new = clustered_rows(rng, 1)[0]
            await db.db_indexes[metadata.key].push_cdc(vector_row((n,), new, 200))
            await wait_for(lambda: counted(n + 1), "the CDC row", timeout=60)
            res = await ann(new, 3)
            check(res["primary_keys"]["pk"][0] == n and abs(res["distances"][0]) <= 1e-6,
                  f"scaled CDC row query returned {res}")
            print("[scaled] 16 self-queries and the CDC row first at distance 0 through the frontends; "
                  "404 and 400 through the IPC", flush=True)
            launches = {"fused_scan": fs.fused_scan.launches_by["float32"],
                        "grouped_scan": sum(c for (dt, _), c in ivf.grouped_scan.launches_by.items() if dt == "float32")}
            print(f"[scaled] launches during the HTTP requests (float32 rows, counted in the owner): {launches}", flush=True)
            check(all(v > 0 for v in launches.values()), f"a kernel of the scaled path never launched: {launches}")

            # nvidia-smi names processes by the PIDs of another namespace
            # here: the one process it lists must hold at least the owner's
            # reserved memory
            listed = [line.split(",") for line in apps]
            print(f"[scaled] nvidia-smi compute apps during the load: {apps}; owner pid {owner} "
                  f"(torch reserved {reserved_mib:.0f} MiB), frontends {frontends}", flush=True)
            check(len(listed) == 1, f"{len(listed)} compute processes on the card, not the owner alone")
            check(int(listed[0][0]) not in frontends, "a frontend process holds a CUDA context")
            check(float(listed[0][1].split()[0]) >= reserved_mib, "the listed process holds less than the owner's memory")
            print(f"[scaled] frontend and client processes that map libcuda (loaded by torch's import, "
                  f"no context without a visible device): {cuda_mapped}", flush=True)
            print(f"[scaled] phase wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
            return launches
    finally:
        hotpath.disable()
        await service.stop()


def bench_process(module: str, args: list[str], env: dict, timeout: float = BENCH_TIMEOUT_S) -> tuple[dict, dict, float]:
    """Phase 13: one bench program (``python -m module args``) in a process
    of its own, from the checkout's root, leading a process group of its
    own (the HTTP runner spawns frontends and clients: a timeout ends them
    all). Returns
    (its JSON line, its launch counts, its wall seconds); fails the smoke if
    it exits non-zero, times out or prints no JSON line."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", module, *args], cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, **env}, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        print(err[-4000:], flush=True)
        check(False, f"{module} {args} ran past {timeout} s")
    wall = time.perf_counter() - t0
    lines = out.strip().splitlines()
    if proc.returncode != 0 or not lines:
        print(err[-4000:], flush=True)
        check(False, f"{module} {args} exited {proc.returncode}")
    launch_lines = [line for line in lines if line.startswith("[launches] ")]
    check(len(launch_lines) == 1, f"{module} {args} printed no launch counts")
    return json.loads(lines[-1]), json.loads(launch_lines[0].removeprefix("[launches] ")), wall


def recalls(result, prefix: str = "") -> dict[str, float]:
    """Every number under a key that names a recall, anywhere in a JSON
    line (the buckets' and bands' too), by its path."""
    found = {}
    for key, value in result.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            if "recall" in key:
                found.update({f"{path}.{k}": v for k, v in value.items() if isinstance(v, (int, float))})
            found.update(recalls(value, path + "."))
        elif "recall" in key and isinstance(value, (int, float)) and not isinstance(value, bool):
            found[path] = float(value)
    return found


def bench_phase(card: str) -> dict[str, int]:
    """Phase 13: the headline at full width, then every scale runner at
    reduced depth. Returns the launch counts of all its processes, by
    kernel name."""
    t_phase = time.perf_counter()
    res, launches, wall = bench_process("vector_store_tpu_torch.benchkit.headline", [], HEADLINE_ENV)
    print(f"[bench] headline (the bench.py twin) on {card}: {res['value']} QPS at recall@10 {res['recall_at_10']} "
          f"(gate passed: {res['recall_gate_passed']}), p50 {res['p50_query_latency_ms']} ms at "
          f"{res['in_flight_batches']} batches of {res['batch']} in flight, qps_at_p50_500ms "
          f"{res['qps_at_p50_500ms']} (p50 {res['p50_at_bounded_ms']} ms, {res['bounded_in_flight']} in flight), "
          f"burst {res['burst_qps_agg24']} QPS, single batch {res['single_batch_rtt_ms']} ms, build "
          f"{res['build_vectors_per_sec']} vectors/s (ingest {res['ingest_seconds']} s + cluster "
          f"{res['cluster_seconds']} s; dataset file {res['dataset_gen_seconds']} s), compute-side "
          f"{res['compute_side_qps']} QPS, nlist {res['nlist']}, nprobe {res['nprobe']}, vs_baseline "
          f"{res['vs_baseline']}; launches {launches}; process wall {wall:.1f} s", flush=True)
    check(res["recall_gate_passed"] and res["recall_at_10"] >= 0.95,
          f"the headline's recall@10 {res['recall_at_10']} is under 0.95")
    check(launches["fused_scan"] + launches["fused_scan_bf16"] > 0 and launches["grouped_scan"] > 0,
          f"the headline did not launch kernels 1 and 2: {launches}")
    total = dict(launches)

    def lane(names, done: list) -> None:
        for name in names:
            done.append((name, *bench_process("vector_store_tpu_torch.benchkit.scale", [name], SCALE_ENV)))

    t_runs = time.perf_counter()
    done: list = []
    threads = [threading.Thread(target=lane, args=(names, done)) for names in SCALE_LANES]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    check(len(done) == sum(len(names) for names in SCALE_LANES), "a scale runner failed (see above)")
    for name, res, counts, wall in done:
        rec = recalls(res)
        check(all(0.0 <= v <= 1.0 for v in rec.values()), f"{name}: a recall outside [0, 1]: {rec}")
        shown = {k: res[k] for k in ("e2e_qps", "e2e_qps_burst", "compute_side_qps", "query_qps_under_churn",
                                     "http_qps", "actor_qps", "unfiltered_qps", "device_bytes") if k in res}
        print(f"[bench] {name} ({res['config']}): exit 0 in {wall:.1f} s; recalls "
              f"{ {k: round(v, 4) for k, v in rec.items()} }; {shown}; launches {counts}", flush=True)
        for k, v in counts.items():
            total[k] += v
    print(f"[bench] {len(done)} scale runners at SCALE_N {SCALE_ENV['SCALE_N']} in {time.perf_counter() - t_runs:.1f} s "
          f"({len(SCALE_LANES)} at a time); phase 13 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def main() -> None:
    t_start = time.perf_counter()
    check(torch.cuda.is_available(), "no CUDA device")
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)

    from vector_store_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.library()
    built = "a cached library" if kernels.build_seconds is None else f"nvcc {kernels.build_seconds:.1f} s"
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s ({built})", flush=True)
    for line in kernels.ptxas_report.splitlines():
        if "Used " in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)
    spills = [line for line in kernels.ptxas_report.splitlines() if "spill" in line and " 0 bytes spill stores" not in line]
    check(not spills, f"ptxas reports spills: {spills}")

    results = kernel_phase(device)
    print("[kernels] before the redesign for Hopper (PERF.md section 5: the first scan core's last smoke run, same "
          "shapes, NVIDIA H100 80GB HBM3, 700 W) -> this run: "
          + ", ".join(f"{e['name']} {PREV_MS[e['name']]:.3f} -> {e['ms']:.3f} ms" for e in results
                      if e["name"] in PREV_MS), flush=True)
    g_launches = stage_phase(device)
    host_line("the F32 service")
    launches, phase5_qps = asyncio.run(service_phase(device, card))
    launches["grouped_scan_g"] = g_launches
    gc.collect()
    torch.cuda.empty_cache()
    host_line("the BF16 service")
    launches["fused_scan_bf16"] = asyncio.run(service_phase(device, card, "BF16"))[0]["fused_scan"]
    gc.collect()  # each index leaves the card before the next one arrives
    torch.cuda.empty_cache()
    host_line("the local service")
    launches["partition_scan"] = asyncio.run(local_phase(device, card))
    gc.collect()
    torch.cuda.empty_cache()
    host_line("the I8 service")
    launches["grouped_scan_i8"] = asyncio.run(i8_phase(device, card))
    gc.collect()
    torch.cuda.empty_cache()
    host_line("the filtered service")
    masked = asyncio.run(filtered_phase(device, card))
    print(f"[filtered] launches during the 10% bucket's warm pass (the device-masked path): {masked}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    host_line("the B1 service")
    asyncio.run(b1_phase(device, card))
    gc.collect()
    torch.cuda.empty_cache()
    host_line("the local I8 service")
    asyncio.run(local_i8_phase(device, card))
    gc.collect()
    torch.cuda.empty_cache()
    host_line("the graph service")
    asyncio.run(graph_phase(device, card))
    gc.collect()
    torch.cuda.empty_cache()
    host_line("the scaled service")
    scaled = asyncio.run(scaled_phase(device, card, phase5_qps))
    print(f"[scaled] launches of the F32 scans: phase 5 {({k: launches[k] for k in scaled})}, phase 12 {scaled}; "
          "the kernels line gives their sums", flush=True)
    for name, count in scaled.items():
        launches[name] += count
    gc.collect()
    torch.cuda.empty_cache()
    host_line("the bench twin")
    bench = bench_phase(card)
    print(f"[bench] phase 13 launches (added to the kernels line): {bench}", flush=True)
    for name, count in bench.items():
        launches[name] = launches.get(name, 0) + count
    print(f"[smoke] total wall time {time.perf_counter() - t_start:.1f} s", flush=True)
    for entry in results:
        entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": [{k: e[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "product_only_ms")} for e in results]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
