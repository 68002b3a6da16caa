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

The last three lines of standard output are: one JSON object describing
the kernels, the nvidia-smi name/power-limit line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import socket
import statistics
import subprocess
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
        print(f"[kernels] grouped_scan {dt} nlist={nlist} cmax={cmax} s={s}: kernel "
              f"{times[dt][0]:.3f} ms, plain {times[dt][1]:.3f} ms, max |rank err| {errs[-1]:.3g} (tolerance {RTOL:g} * (1 + |r|))",
              flush=True)
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


def exact_top_k(data: torch.Tensor, queries: torch.Tensor, k: int) -> np.ndarray:
    """Exact cosine top-k ids on the card, in chunks of rows."""
    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.ops.distance import pairwise_distance
    from vector_store_tpu_torch.ops.topk import merge_min_k

    qn = queries.norm(dim=1)
    best_d = torch.full((queries.shape[0], k), float("inf"), device=queries.device)
    best_i = torch.full((queries.shape[0], k), -1, dtype=torch.int64, device=queries.device)
    for lo in range(0, data.shape[0], 262_144):
        block = data[lo : lo + 262_144]
        d = pairwise_distance(queries, block, SpaceType.COSINE, Quantization.F32, qn, block.norm(dim=1))
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
            return launches
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


def main() -> None:
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
    launches = asyncio.run(service_phase(device, card))
    launches["grouped_scan_g"] = g_launches
    gc.collect()
    torch.cuda.empty_cache()
    host_line("the BF16 service")
    launches["fused_scan_bf16"] = asyncio.run(service_phase(device, card, "BF16"))["fused_scan"]
    gc.collect()  # each index leaves the card before the next one arrives
    torch.cuda.empty_cache()
    host_line("the local service")
    launches["partition_scan"] = asyncio.run(local_phase(device, card))
    gc.collect()
    torch.cuda.empty_cache()
    host_line("the I8 service")
    launches["grouped_scan_i8"] = asyncio.run(i8_phase(device, card))
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
