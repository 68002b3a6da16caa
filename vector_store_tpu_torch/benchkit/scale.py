"""The JAX package's scale configurations (benchkit/scale.py) on the port's
engines, one process a run.

  dbpedia-bf16 / dbpedia-i8  1M x 1536-d, cosine, BF16 or I8, IVF engine
  deep10m                    10M x 96-d, cosine, BF16, IVF engine
  glove                      1.2M x 100-d, cosine, BF16, IVF engine, nprobe sweep
  graph-1000k                1M x 128-d, euclidean, graph engine (device bulk build)
  partition-1000k            1M x 128-d local index: partition scan vs masked full scan
  filtered-1000k             selectivity buckets through HTTP and the actor (suite.py)
  filtered-diverse-1000k     128 distinct range filters a band (suite.py)
  filtered-engine-1000k      device-masked IVF scan and the subset-exact terminal
  streaming-1000k            queries under churn with a sliced rebuild (engine)
  streaming-actor-1000k      the same through the serving actor
  http-1000k                 serve_scaled: in-process, IPC and HTTP points (http_bench.py)

Usage:
  python -m vector_store_tpu_torch.benchkit.scale <name>

Each run prints one ``[launches] {...}`` line (benchkit/common.py), then
one JSON line, which it also appends to ``scale_logs/SCALE_RUNS_torch.jsonl``
of the working directory; the dataset files go under ``scale_logs/`` too.
Knobs: SCALE_N (rows), SCALE_BATCH, SCALE_NPROBE, SCALE_STREAM_SECONDS,
SCALE_CHURN_BATCH, SCALE_COMPUTE_CHAIN, SCALE_NPARTS, SCALE_QUANT (graph),
BENCH_DEVICE (cuda unless set; ``cpu`` runs the kernels' plain versions).

The rows are synthetic clustered Gaussians at each configuration's shape
(benchkit/synth.py, the same numpy generator and seeds as the JAX runners,
so a dataset file under scale_logs/ serves both); ground truth is exact
f32 on the device (benchkit/common.py::exact_top_k), never the JAX
package's cached ``scale_logs/gt-*.npz``. The device rows are the host rows
copied from pinned memory (the JAX runners generated theirs on the TPU).

What changed from the JAX runners:
- their jitted ``fori_loop`` chains (compute-side rates, the partition
  kernel against the masked scan) are loops of the port's counterparts
  (``ivf_candidates``, ``rank_search`` over ``fused_scan``,
  ``partition_candidates``, ``graph_beam_search``) between CUDA events;
  ``jax.block_until_ready`` is ``torch.cuda.synchronize`` before a timer
  stops; the compile cache and ``_warm_queue.clear()`` are gone;
- the aggregated query upload (``upload_queries``, ``split_query_windows``)
  is gone: a window begins its batches, then collects them;
- relay-only keys are not written: ``ingest_uplink``, the weather stamps
  (``weather_before``, ``weather_after``), ``gt_cached``, the compile
  counts (``max_bucket_compiles`` and the buckets' ``*_compiles``),
  ``preview_dims`` (the preview traversal is not ported) and the caught
  errors ``compute_side_error`` and ``kernel_error`` (a failure raises).

The engine internals the JAX runners read, and what they read here:
``_build``, ``maintain_log``, ``_rebuild_floor``, ``kmeans_block``,
``_region``, ``_valid_host``, ``_live`` (the port's IVF engine has each);
``main_paux`` -> ``main_a``/``main_b``; ``_prep_queries`` ->
``_main_queries``; ``part_paux`` -> ``part_a``/``part_b``;
``pallas_block`` -> ``block_rows``; ``_entries_array`` ->
``_entries_tensor``; the graph engine's ``search_iters`` has no
counterpart (the port's beam runs ef rounds), so ``search_iters`` is None;
``ingest_i8`` (an int8 uplink) has none and is dropped.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

CONFIGS = {
    # name: (n, d, quantization)
    "dbpedia-bf16": (1_000_000, 1536, "BF16"),
    "dbpedia-i8": (1_000_000, 1536, "I8"),
    "deep10m": (10_000_000, 96, "BF16"),
    # BASELINE config 2 at spec scale: GloVe-100 angular, 1.2M vectors,
    # recall@10 sweep over nprobe (the ef_search analog)
    "glove": (1_200_000, 100, "BF16"),
}
RUNS_FILE = os.path.join("scale_logs", "SCALE_RUNS_torch.jsonl")
CHUNK = 131_072


def _log(msg: str) -> None:
    print(f"[scale] {msg}", file=sys.stderr, flush=True)


def _ingest(index, dataset, n: int, d: int, device, held_rng, nq: int, normalize: bool, **bulk):
    """Chunked bulk ingest of the dataset file's rows: returns (all rows
    as the ground truth sees them, unit rows where ``normalize``; the
    nq held-out queries: the first rows plus a small intra-cluster
    perturbation)."""
    from vector_store_tpu_torch.benchkit import synth
    from vector_store_tpu_torch.benchkit.common import to_device

    all_vecs = np.empty((n, d), dtype=np.float32)
    held = None
    t0 = time.time()
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        rows_host = np.asarray(dataset[lo:hi])
        block = rows_host / np.linalg.norm(rows_host, axis=-1, keepdims=True) if normalize else rows_host
        all_vecs[lo:hi] = block
        if held is None:
            held = block[:nq] + synth.embedding_sigma(d, 0.1) * held_rng.normal(size=(nq, d)).astype(np.float32)
        extra = {k: v[lo:hi] for k, v in bulk.items()}
        index.upsert_bulk_device(lo, hi, to_device(rows_host, device), rows_host, **extra)
        _log(f"ingested {hi}/{n} ({time.time() - t0:.0f}s)")
    return all_vecs, held


def run_graph(n: int = 1_000_000, d: int = 128, device=None) -> dict:
    """ENGINE=graph at scale: the device bulk build of the lockstep beam
    search graph, then recall@10 (ef walked up to 512 until 0.95), the
    burst rate and the compute-side rate of the beam."""
    import torch

    from vector_store_tpu_torch.benchkit import synth
    from vector_store_tpu_torch.benchkit.common import bench_device, exact_top_k, recall, sync, timed_loop
    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.engine.flat import k_bucket
    from vector_store_tpu_torch.engine.graph import GraphDeviceIndex, graph_beam_search
    from vector_store_tpu_torch.ops.distance import prepare_queries

    device = bench_device(device)
    rng = np.random.default_rng(77)
    batch = int(os.environ.get("SCALE_BATCH", 2048))
    k, nq = 10, 512
    quant = Quantization(os.environ.get("SCALE_QUANT", "BF16").upper())
    out: dict = {"config": f"graph-{n // 1000}k", "n": n, "d": d, "quant": quant.value}
    seed = 77
    index = GraphDeviceIndex(
        d, space_type=SpaceType.EUCLIDEAN, quantization=quant, initial_capacity=n + 1024, device=device,
    )
    t_ds = time.time()
    dataset = synth.rows_file_np(seed, n, d, 512)
    out["dataset_gen_seconds"] = round(time.time() - t_ds, 1)
    t0 = time.time()
    all_vecs, held = _ingest(index, dataset, n, d, device, rng, nq, normalize=False)
    # device-chained build: exact kNN on kernel 1, alpha prune, one
    # whole-graph reverse pass
    built = index.bulk_build_device()
    sync(device)
    build_s = time.time() - t0
    out["build_seconds"] = round(build_s, 1)
    out["bulk_built_nodes"] = built
    out["build_vectors_per_sec"] = round(n / build_s, 0)
    out["device_bytes"] = int(index.device_bytes)

    gt = exact_top_k(all_vecs, held, k, "l2", device)
    gate_q = np.tile(held, (max(1, -(-batch // nq)), 1))[:batch]

    def calc_recall() -> float:
        return recall(index.search(gate_q, k)[:nq], gt, k)

    rec = calc_recall()
    _log(f"graph recall {rec:.4f} @ ef {index.expansion_search}")
    while rec < 0.95 and index.expansion_search < 512:
        index.expansion_search *= 2
        rec = calc_recall()
        _log(f"graph recall {rec:.4f} @ ef {index.expansion_search}")
    out["recall_at_10"] = round(rec, 4)
    out["recall_gate_passed"] = bool(rec >= 0.95)
    out["expansion_search"] = index.expansion_search
    out["search_iters"] = None  # the port's beam runs ef rounds: no iters knob

    index.search(gate_q, k)
    reps = 12
    t0 = time.time()
    index.collect_many([index.search_begin(gate_q, k) for _ in range(reps)])
    out["e2e_qps_burst"] = round(batch * reps / (time.time() - t0), 1)

    # compute-side rate: M back-to-back beam searches at the serving
    # configuration (result width k's bucket, beam and rounds ef)
    m = int(os.environ.get("SCALE_COMPUTE_CHAIN", 16))
    store = index.store
    qs, q_aux = prepare_queries(gate_q, index.space_type, index.quantization)
    qs, q_aux = qs.to(device), q_aux.to(device)
    k_pad = k_bucket(k)
    ef = max(index.expansion_search, k_pad)
    allow = torch.ones((store.capacity,), dtype=torch.bool, device=device)
    valid, entries = index._valid(), index._entries_tensor()

    def one() -> None:
        graph_beam_search(
            store.vectors, store.aux, valid, allow, index.adjacency, entries, qs, q_aux,
            space=index.space_type, quant=index.quantization, k=k_pad, beam_width=ef, iters=ef,
            filtered=False, expand=index.beam_expand,
        )

    dt = timed_loop(one, m, device)
    out["compute_side_qps"] = round(batch * m / dt, 1)
    out["compute_ms_per_batch"] = round(dt * 1e3 / m, 2)
    _log(f"graph compute_side_qps {out['compute_side_qps']} ({out['compute_ms_per_batch']} ms/batch, ef {ef})")
    out["data"] = "synthetic clustered gaussians; exact f32 ground truth"
    return out


def run_partition(n: int = 1_000_000, d: int = 128, n_parts: int | None = None, device=None) -> dict:
    """Local-index cost: a query against a ~1k-row partition of a 1M-row
    table must cost O(partition), not O(N). The partition scan kernel
    (kernel 3) against the masked full scan (kernel 1) on the same index,
    at B 2048 and B 8, as device rates; n_parts scales with n (~976 rows a
    partition, the reference's local-index serving shape)."""
    import torch

    from vector_store_tpu_torch.benchkit import synth
    from vector_store_tpu_torch.benchkit.common import bench_device, timed_loop
    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.engine.flat import FlatDeviceIndex
    from vector_store_tpu_torch.ops.fused_scan import rank_search
    from vector_store_tpu_torch.ops.partition_scan import partition_candidates

    device = bench_device(device)
    batch = int(os.environ.get("SCALE_BATCH", 2048))
    if n_parts is None:
        n_parts = int(os.environ.get("SCALE_NPARTS", max(1024, round(n / 976))))
    seed, k = 55, 10
    out: dict = {"config": f"partition-{n // 1000}k", "n": n, "d": d, "n_parts": n_parts, "quant": "BF16"}
    index = FlatDeviceIndex(
        d, space_type=SpaceType.COSINE, quantization=Quantization.BF16, initial_capacity=n + 1024, device=device,
    )
    dataset = synth.rows_file_np(seed, n, d, 256)
    parts = (np.arange(n) % n_parts).astype(np.int64)
    t0 = time.time()
    _ingest(index, dataset, n, d, device, np.random.default_rng(55), 1, normalize=False, partitions=parts)
    out["ingest_seconds"] = round(time.time() - t0, 1)
    out["rows_per_partition"] = n // n_parts
    sample_q = np.asarray(dataset[: min(batch, n)]).copy()
    sample_p = parts[: sample_q.shape[0]].astype(np.int32)

    # correctness spot check through the serving path
    res = index.search(sample_q[:128], k, partitions=sample_p[:128])
    out["partition_isolation_ok"] = bool(
        all(all(int(s) % n_parts == int(sample_p[i]) for s in r.slots) for i, r in enumerate(res))
    )

    # device rates: the partition kernel against the masked full scan
    index.search(sample_q[:8], k, partitions=sample_p[:8])  # syncs the mirror
    qn = sample_q / np.linalg.norm(sample_q, axis=-1, keepdims=True)
    qs_dev = index.query_tensor(qn)
    bsel = torch.from_numpy(
        np.array([index._part_bucket.get(int(p), -1) for p in sample_p], dtype=np.int32)
    ).to(device)
    pmax = index.part_rows.shape[1]
    for tag, b in (("b2048", batch), ("b8", 8)):
        q_b, bs = qs_dev[:b], bsel[:b]
        mc = 32 if b == batch else 512

        def part() -> None:
            partition_candidates(
                index.part_vecs, index.part_a, index.part_b, index.part_rows, q_b, bs, k=16, pmax=pmax
            )

        def full() -> None:
            rank_search(index.vectors, index.a, index.b, q_b, k=16, block_rows=index.block_rows)

        dt_p = timed_loop(part, mc, device)
        dt_f = timed_loop(full, mc, device)
        out[f"partition_kernel_qps_{tag}"] = round(b * mc / dt_p, 1)
        out[f"full_scan_qps_{tag}"] = round(b * mc / dt_f, 1)
        out[f"partition_speedup_x_{tag}"] = round(dt_f / dt_p, 1)
    _log(f"index device_bytes {index.device_bytes}")  # not a key of the JAX runner's line
    out["data"] = "synthetic clustered gaussians; slot % n_parts partitions"
    return out


def run_filtered(n: int = 1_000_000, d: int = 128, device=None) -> dict:
    """Filtered ANN over the selectivity buckets (50% -> 0.1%) through the
    serving path: HTTP -> the actor's triage -> ladder, device-masked scan
    or the subset-exact terminal (suite.selectivity). Reference:
    crates/benchmark/src/main.rs:45-49,188-190."""
    os.environ["SUITE_N"] = str(n)
    os.environ["SUITE_D"] = str(d)
    os.environ.setdefault("SUITE_QUERIES", "128")
    os.environ.setdefault("SUITE_CONCURRENCY", "128")
    os.environ.setdefault("SUITE_WAIT_BUILD", "1")
    from vector_store_tpu_torch.benchkit import suite

    out = suite.selectivity(device=device)
    out["config"] = f"filtered-{n // 1000}k"
    low = out.get("buckets", {}).get("0.001")
    out["low_selectivity_recall_gate_passed"] = bool(low and low["recall_at_k"] >= 0.95)
    return out


def run_filtered_diverse(n: int = 1_000_000, d: int = 128, device=None) -> dict:
    """Filter diversity: >= 128 distinct range-window signatures a
    selectivity band through the serving path; cold and warm QPS, cache
    sizes, a recall audit (suite.selectivity_diverse)."""
    os.environ["SUITE_N"] = str(n)
    os.environ["SUITE_D"] = str(d)
    os.environ.setdefault("SUITE_CONCURRENCY", "128")
    os.environ.setdefault("SUITE_WAIT_BUILD", "1")
    from vector_store_tpu_torch.benchkit import suite

    out = suite.selectivity_diverse(device=device)
    out["config"] = f"filtered-diverse-{n // 1000}k"
    low = out.get("bands", {}).get("0.001")
    out["low_selectivity_recall_gate_passed"] = bool(low and low["audit_recall_at_k"] >= 0.95)
    return out


def run_filtered_engine(n: int = 1_000_000, d: int = 128, device=None) -> dict:
    """Filtered search on the engine, band by band: the device-masked scan
    (an AllowMaskHandle biasing both regions' scans) as pipelined QPS and
    its mask's first materialization, and the grouped subset-exact
    terminal (one host pass over the match set for a query group)."""
    from vector_store_tpu_torch.benchkit import synth
    from vector_store_tpu_torch.benchkit.common import bench_device, exact_top_k, sync
    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex

    device = bench_device(device)
    seed, k = 42, 10
    batch = int(os.environ.get("SCALE_BATCH", 2048))
    rng = np.random.default_rng(seed)
    out: dict = {"config": f"filtered-engine-{n // 1000}k", "n": n, "d": d, "quant": "BF16", "batch": batch,
                 "bands": {}}
    index = IvfDeviceIndex(
        d, space_type=SpaceType.EUCLIDEAN, quantization=Quantization.BF16, initial_capacity=n, device=device,
        nprobe=int(os.environ.get("SCALE_NPROBE", 32)),
    )
    dataset = synth.rows_file_np(seed, n, d, 256)
    t0 = time.time()
    all_vecs, _ = _ingest(index, dataset, n, d, device, rng, 1, normalize=False)
    sync(device)
    out["ingest_seconds"] = round(time.time() - t0, 1)
    t0 = time.time()
    index.maintain()
    while index.maintain(budget=1):
        pass
    out["build_seconds"] = round(time.time() - t0, 1)
    out["nlist"], out["nprobe"] = index.nlist, index.nprobe

    queries = all_vecs[rng.integers(0, n, size=batch)] + synth.embedding_sigma(d, 0.1) * rng.normal(
        size=(batch, d)
    ).astype(np.float32)
    nq_gate = min(64, batch)
    reps = 24

    # the unfiltered pipelined rate on the same loop (the comparator)
    index.search(queries, k)
    t0 = time.time()
    index.collect_many([index.search_begin(queries, k) for _ in range(reps)])
    out["unfiltered_qps"] = round(batch * reps / (time.time() - t0), 1)

    for frac in (0.5, 0.1, 0.01, 0.001):
        band: dict = {}
        mask = rng.random(n) < frac
        matches = np.flatnonzero(mask)
        band["matching_rows"] = int(matches.size)
        kk = min(k, matches.size)
        gt = exact_top_k(all_vecs, queries[:nq_gate], k, "l2", device, subset=matches)
        if frac >= 1.0 / 32.0:
            # the device-masked regime (the actor's dense and mid bands)
            handle = index.upload_allow_mask(mask)
            t0 = time.time()
            res = index.search(queries, 2 * k, allow_mask=handle)
            band["mask_materialize_s"] = round(time.time() - t0, 2)
            hits = sum(len(set(res[i].slots[:kk].tolist()) & set(gt[i].tolist())) for i in range(nq_gate))
            band["masked_recall_at_10"] = round(hits / (nq_gate * kk), 4)
            t0 = time.time()
            index.collect_many([index.search_begin(queries, 2 * k, allow_mask=handle) for _ in range(reps)])
            band["masked_qps"] = round(batch * reps / (time.time() - t0), 1)
            band["masked_vs_unfiltered"] = round(band["masked_qps"] / out["unfiltered_qps"], 3)
        # the grouped subset-exact terminal (the sparse regime; also
        # measured on dense bands for the whole cost curve)
        group = 128
        t0 = time.time()
        dists, _epochs = index.search_exact_host_subset(queries[:group], matches)
        sub_s = time.time() - t0
        band["subset_exact_group_qps"] = round(group / sub_s, 1)
        band["subset_exact_ms_per_group128"] = round(sub_s * 1e3, 1)
        top1 = matches[np.argmin(dists, axis=1)][:nq_gate]
        band["subset_top1_matches_gt"] = bool((top1 == gt[:, 0]).mean() > 0.95)
        out["bands"][f"{frac:g}"] = band
        _log(f"engine band {frac:g}: {band}")
    _log(f"index device_bytes {index.device_bytes}")  # not a key of the JAX runner's line
    out["data"] = "synthetic clustered gaussians (SIFT-1M shape); exact filtered GT"
    return out


def _cosine_gt(all_vecs: np.ndarray, held: np.ndarray, k: int, device) -> np.ndarray:
    """Exact cosine top-k of the held queries over unit rows."""
    from vector_store_tpu_torch.benchkit.common import exact_top_k

    qn = held / np.linalg.norm(held, axis=-1, keepdims=True)
    return exact_top_k(all_vecs, qn, k, "cos", device)


def run_streaming(n: int = 1_000_000, d: int = 128, device=None) -> dict:
    """BASELINE config 5 on the engine: a 1M-row IVF index serves query
    windows while upserts and removes stream in, and a sliced rebuild
    starts and completes mid-run. Query QPS under churn, churn rates,
    freshness lag, rebuild timing and recall before and after. Reference
    CDC pipeline: crates/vector-store/src/db_cdc/actor.rs:44-50."""
    from vector_store_tpu_torch.benchkit import synth
    from vector_store_tpu_torch.benchkit.common import bench_device, recall, sync
    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex

    device = bench_device(device)
    rng = np.random.default_rng(99)
    seed = 99
    batch = int(os.environ.get("SCALE_BATCH", 2048))
    k, nq = 10, 512
    dur = float(os.environ.get("SCALE_STREAM_SECONDS", 60))
    out: dict = {"config": f"streaming-{n // 1000}k", "n": n, "d": d, "quant": "BF16"}
    index = IvfDeviceIndex(
        d, space_type=SpaceType.COSINE, quantization=Quantization.BF16, initial_capacity=n + 262_144,
        device=device, nprobe=int(os.environ.get("SCALE_NPROBE", 32)),
    )
    t_ds = time.time()
    dataset = synth.rows_file_np(seed, n, d, 1024)
    out["dataset_gen_seconds"] = round(time.time() - t_ds, 1)
    t0 = time.time()
    all_vecs, held = _ingest(index, dataset, n, d, device, rng, nq, normalize=True)
    sync(device)
    out["ingest_seconds"] = round(time.time() - t0, 1)
    t0 = time.time()
    index.maintain()  # full build
    while index.maintain(budget=1):
        pass
    out["build_seconds"] = round(time.time() - t0, 1)
    out["nlist"] = index.nlist

    # exact cosine ground truth on the base rows; churn rows sit in a
    # far-off region, so it holds through the run
    gt = _cosine_gt(all_vecs, held, k, device)
    gate_q = np.tile(held, (max(1, -(-batch // nq)), 1))[:batch]

    def calc_recall() -> float:
        return recall(index.search(gate_q, k)[:nq], gt, k)

    recall0 = calc_recall()
    _log(f"streaming pre-churn recall {recall0:.4f}")
    while recall0 < 0.95 and index.nprobe < min(index.nlist, 512):
        index.nprobe = min(index.nprobe * 2, 512)
        recall0 = calc_recall()
    out["recall_pre_churn"] = round(recall0, 4)
    out["nprobe"] = index.nprobe
    index.search(gate_q, k)

    def churn_vecs(m: int) -> np.ndarray:
        return rng.normal(size=(m, d)).astype(np.float32) + 12.0

    # the rebuild must start and complete mid-run: trigger at ~1.5% delta
    index.rebuild_fraction = 0.015
    next_slot = n
    live_churn: list[int] = []
    q_count = up_count = rm_count = 0
    freshness_ms: list[float] = []
    rebuild_t0 = rebuild_t1 = None
    window_qps: list[float] = []
    phase_s = {"query": 0.0, "upsert": 0.0, "remove": 0.0, "fresh": 0.0, "maintain": 0.0}
    m_up = int(os.environ.get("SCALE_CHURN_BATCH", 2048))
    t_run = time.time()
    i_win = 0
    while time.time() - t_run < dur:
        i_win += 1
        # 1) a query window: 4 batches begun, then collected
        w0 = time.time()
        index.collect_many([index.search_begin(gate_q, k) for _ in range(4)])
        w1 = time.time()
        phase_s["query"] += w1 - w0
        q_count += 4 * batch
        window_qps.append(4 * batch / (w1 - w0))
        # 2) churn: one upsert and one remove batch
        slots_new = np.arange(next_slot, next_slot + m_up, dtype=np.int64)
        next_slot += m_up
        tu = time.time()
        index.upsert_batch(slots_new, np.ones(m_up, np.int32), churn_vecs(m_up))
        phase_s["upsert"] += time.time() - tu
        live_churn.extend(int(s) for s in slots_new)
        up_count += m_up
        if len(live_churn) > 4 * m_up:
            m_rm = m_up // 4
            rm = [live_churn.pop(0) for _ in range(m_rm)]
            tu = time.time()
            index.remove_batch(np.asarray(rm, dtype=np.int64))
            phase_s["remove"] += time.time() - tu
            rm_count += m_rm
        # 3) every 8 windows: a just-upserted far-shell row must be
        # searchable; the lag until it is
        if i_win % 8 == 0:
            probe = churn_vecs(1)
            pslot = next_slot
            next_slot += 1
            tp = time.time()
            index.upsert_batch(np.asarray([pslot]), np.asarray([1], np.int32), probe)
            live_churn.append(pslot)
            while time.time() - tp < 30:
                res = index.search(np.tile(probe, (8, 1)), 1)[0]
                if res.slots.size and int(res.slots[0]) == pslot:
                    freshness_ms.append((time.time() - tp) * 1e3)
                    up_count += 1
                    break
            phase_s["fresh"] += time.time() - tp
        # 4) one maintenance slice (the actor's idle slot)
        tu = time.time()
        building_before = index._build is not None
        index.maintain(budget=4096)
        phase_s["maintain"] += time.time() - tu
        if index._build is not None and not building_before:
            rebuild_t0 = time.time() - t_run
        if building_before and index._build is None:
            rebuild_t1 = time.time() - t_run
    elapsed = time.time() - t_run
    out["phase_seconds"] = {kk: round(v, 1) for kk, v in phase_s.items()}
    out["windows"] = i_win
    out["duration_seconds"] = round(elapsed, 1)
    out["query_qps_under_churn"] = round(q_count / elapsed, 1)
    out["window_qps_median"] = round(float(np.median(window_qps)), 1)
    out["upserts_per_sec"] = round(up_count / elapsed, 1)
    out["removes_per_sec"] = round(rm_count / elapsed, 1)
    out["freshness_ms_samples"] = [round(x, 1) for x in freshness_ms]
    out["freshness_ms_median"] = round(float(np.median(freshness_ms)), 1) if freshness_ms else None
    out["rebuild_started_at_s"] = round(rebuild_t0, 1) if rebuild_t0 is not None else None
    out["rebuild_completed_at_s"] = round(rebuild_t1, 1) if rebuild_t1 is not None else None
    out["rebuild_completed_mid_run"] = bool(rebuild_t1 is not None)
    recall1 = calc_recall()
    out["recall_post_churn"] = round(recall1, 4)
    out["recall_gate_passed"] = bool(recall0 >= 0.95 and recall1 >= 0.95)
    out["data"] = "synthetic clustered unit gaussians; churn rows in a far-off shell, so the exact ground truth holds"
    return out


def run_streaming_actor(n: int = 1_000_000, d: int = 128, device=None) -> dict:
    """BASELINE config 5 through the serving actor: a 1M-row table and
    VsIndexActor serve ann_many batches from concurrent tasks while CDC-style
    operation batches stream in and the actor's own scheduler runs rebuild
    slices. Query p50/p99 split by build-active and idle, freshness samples
    at saturation and at a moderate load, maintenance slice durations and
    recall before and after. Reference: worker.rs:44-118,
    vs_index/mod.rs:30-45, metrics.rs:82-95."""
    import asyncio

    return asyncio.run(_streaming_actor_async(n, d, device))


async def _streaming_actor_async(n: int, d: int, device) -> dict:
    import asyncio

    from vector_store_tpu_torch.benchkit import synth
    from vector_store_tpu_torch.benchkit.common import bench_device
    from vector_store_tpu_torch.core import DbIndexedValue, IndexKey, PrimaryKey, Timestamp, Timestamped
    from vector_store_tpu_torch.db.fake import make_vs_metadata
    from vector_store_tpu_torch.engine import ivf as ivf_mod
    from vector_store_tpu_torch.service.vs_index import VsIndexActor
    from vector_store_tpu_torch.table import Table

    device = bench_device(device)
    rng = np.random.default_rng(99)
    seed = 99
    k, nq = 10, 512
    dur = float(os.environ.get("SCALE_STREAM_SECONDS", 90))
    out: dict = {"config": f"streaming-actor-{n // 1000}k", "n": n, "d": d, "quant": "BF16"}
    KEY = IndexKey("ks", "idx")
    metadata = make_vs_metadata(dimensions=d)  # ef_search default 64 -> nprobe 32
    out["quant"] = metadata.vs_options.quantization.value  # the index's own (the default F32)
    table = Table(metadata)
    actor = VsIndexActor(metadata, table, device=device)
    engine = actor.engine
    engine.rebuild_fraction = 0.015  # a rebuild must start and finish mid-run

    # -- ingest: full-scan rows through the Table ----------------------------
    t_ds = time.time()
    dataset = synth.rows_file_np(seed, n, d, 1024)
    out["dataset_gen_seconds"] = round(time.time() - t_ds, 1)
    ts0 = Timestamp.from_millis(100)
    held = None
    all_vecs = np.empty((n, d), dtype=np.float32)
    t0 = time.time()
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        rows_host = np.asarray(dataset[lo:hi])
        block = rows_host / np.linalg.norm(rows_host, axis=-1, keepdims=True)
        all_vecs[lo:hi] = block
        if held is None:
            held = block[:nq] + synth.embedding_sigma(d, 0.1) * rng.normal(size=(nq, d)).astype(np.float32)
        scan_rows = [
            (PrimaryKey.from_values((lo + j,)), (Timestamped(ts0, DbIndexedValue.vector(rows_host[j].tolist())),))
            for j in range(hi - lo)
        ]
        actor._apply_ops_batch(table.upsert_scan(KEY, scan_rows))  # before start: applied at once
        _log(f"actor ingest {hi}/{n} ({time.time() - t0:.0f}s)")
    out["ingest_seconds"] = round(time.time() - t0, 1)

    t0 = time.time()
    while engine.maintain(budget=1):  # the initial build, slice by slice
        ph = engine.maintain_log[-1] if engine.maintain_log else ("?", 0)
        _log(f"build slice {ph[0]} {ph[1]:.1f}s (total {time.time() - t0:.0f}s)")
    out["build_seconds"] = round(time.time() - t0, 1)
    out["nlist"] = engine.nlist
    engine.maintain_log.clear()

    gt = _cosine_gt(all_vecs, held, k, device)
    _log(f"actor build done ({out['build_seconds']}s), gt ready")
    actor.start()

    async def calc_recall() -> float:
        res = await actor.ann_many(held, k)
        hits = sum(len({pk.values()[0] for pk, _ in row} & set(gt[i].tolist())) for i, row in enumerate(res))
        return hits / (nq * k)

    recall0 = await calc_recall()
    _log(f"actor pre-churn recall {recall0:.4f}")
    while recall0 < 0.95 and engine.nprobe < min(engine.nlist, 512):
        engine.nprobe = min(engine.nprobe * 2, 512)
        recall0 = await calc_recall()
    out["recall_pre_churn"] = round(recall0, 4)
    out["nprobe"] = engine.nprobe

    # -- concurrent serving phase ---------------------------------------------
    stop = asyncio.Event()
    qb = 256  # queries an ann_many call; 16 workers keep ~4096 in flight
    pool = np.tile(held, (max(1, -(-qb * 8 // nq)), 1))
    calls: list[tuple[float, float, int, bool]] = []  # t0, dt, m, build_active
    churn_stats = {"up": 0, "rm": 0, "ms": 0.0}
    fresh_ms: list[float] = []
    next_slot = n
    live_churn: list[int] = []
    churn_ms_counter = [1000]  # strictly increasing writetimes for churn rows
    t_run = time.time()

    def churn_vecs(m: int) -> np.ndarray:
        # far-off shell: the base ground truth stays valid through the run
        return rng.normal(size=(m, d)).astype(np.float32) + 12.0

    def probe_vec() -> np.ndarray:
        # freshness probes need directions of their own in cosine space:
        # random sign vectors are ~1.0 apart from each other, from the
        # churn shell and from the data
        return rng.choice(np.float32([-4.0, 4.0]), size=(1, d)) + 0.01 * rng.normal(size=(1, d)).astype(np.float32)

    async def query_worker(w: int) -> None:
        i = w * qb
        while not stop.is_set():
            q = pool[i % nq : i % nq + qb]
            if q.shape[0] < qb:
                q = pool[:qb]
            b0 = engine._build is not None
            c0 = time.perf_counter()
            await actor.ann_many(q, k)
            dt = time.perf_counter() - c0
            calls.append((time.time() - t_run, dt, q.shape[0], b0 or engine._build is not None))
            i += qb

    async def churn_worker() -> None:
        nonlocal next_slot
        m_up = int(os.environ.get("SCALE_CHURN_BATCH", 512))
        while not stop.is_set():
            vecs = churn_vecs(m_up)
            c0 = time.perf_counter()
            ops: list = []
            for j in range(m_up):
                churn_ms_counter[0] += 1
                ops.extend(table.upsert(
                    KEY, PrimaryKey.from_values((next_slot + j,)),
                    (Timestamped(Timestamp.from_millis(churn_ms_counter[0]), DbIndexedValue.vector(vecs[j].tolist())),),
                ))
            live_churn.extend(range(next_slot, next_slot + m_up))
            next_slot += m_up
            churn_stats["up"] += m_up
            if len(live_churn) > 4 * m_up:
                m_rm = m_up // 4
                for _ in range(m_rm):
                    s = live_churn.pop(0)
                    churn_ms_counter[0] += 1
                    ops.extend(table.delete(KEY, PrimaryKey.from_values((s,)), Timestamp.from_millis(churn_ms_counter[0])))
                churn_stats["rm"] += m_rm
            actor.apply_operations(ops)
            churn_stats["ms"] += (time.perf_counter() - c0) * 1e3
            await asyncio.sleep(0.25)

    async def fresh_worker(pace: float | None = None) -> None:
        # probe queries ride the normal serving batches, paced so that
        # their load is negligible
        nonlocal next_slot
        pace = pace or max(dur / 28.0, 0.5)
        while not stop.is_set():
            probe = probe_vec()
            slot = next_slot
            next_slot += 1
            churn_ms_counter[0] += 1
            ops = table.upsert(
                KEY, PrimaryKey.from_values((slot,)),
                (Timestamped(Timestamp.from_millis(churn_ms_counter[0]), DbIndexedValue.vector(probe[0].tolist())),),
            )
            c0 = time.perf_counter()
            actor.apply_operations(ops)
            live_churn.append(slot)
            while time.perf_counter() - c0 < 20 and not stop.is_set():
                res = await actor.ann(probe[0].tolist(), 1)
                if res and res[0][0].values()[0] == slot:
                    fresh_ms.append((time.perf_counter() - c0) * 1e3)
                    break
                await asyncio.sleep(0.02)
            await asyncio.sleep(pace)

    build_trace: list[tuple[float, str | None]] = []
    sched_trace: list[tuple[float, str | None, int, int]] = []

    async def sampler() -> None:
        while not stop.is_set():
            st = engine._build
            build_trace.append((time.time() - t_run, st.get("phase") if st else None))
            sched_trace.append(
                (time.time() - t_run, engine.maintain_pending(), len(actor._modify_queue), actor._search_queue.qsize())
            )
            await asyncio.sleep(0.05)

    def report_failures(results, what: str) -> None:
        import traceback

        for r in results:
            if isinstance(r, BaseException):
                print(f"[scale] {what} failed:", file=sys.stderr)
                traceback.print_exception(r, file=sys.stderr)

    workers = [asyncio.create_task(query_worker(w)) for w in range(16)]
    workers += [asyncio.create_task(churn_worker()), asyncio.create_task(fresh_worker()),
                asyncio.create_task(sampler())]
    await asyncio.sleep(dur)
    stop.set()
    report_failures(await asyncio.gather(*workers, return_exceptions=True), "worker task")
    elapsed = time.time() - t_run

    # -- moderate-load freshness phase ------------------------------------------
    # at saturation a probe waits behind ~2 full device windows; indexing
    # lag is an operating-load metric (the reference's indexing_lag)
    fresh_saturated = list(fresh_ms)
    fresh_ms.clear()
    stop = asyncio.Event()
    mod_calls: list[float] = []
    mod_dur = min(60.0, dur / 2)

    async def mod_query_worker(w: int) -> None:
        i = w * 64
        while not stop.is_set():
            q = pool[i % nq : i % nq + 64]
            if q.shape[0] < 64:
                q = pool[:64]
            c0 = time.perf_counter()
            await actor.ann_many(q, k)
            mod_calls.append(time.perf_counter() - c0)
            i += 64
            await asyncio.sleep(0.05)

    _log("moderate-load freshness phase")
    workers = [asyncio.create_task(mod_query_worker(w)) for w in range(4)]
    workers += [asyncio.create_task(churn_worker()), asyncio.create_task(fresh_worker(1.2))]
    await asyncio.sleep(mod_dur)
    stop.set()
    report_failures(await asyncio.gather(*workers, return_exceptions=True), "moderate worker")
    fresh_moderate = list(fresh_ms)
    fresh_ms[:] = fresh_saturated
    out["moderate_duration_seconds"] = round(mod_dur, 1)
    if mod_calls:
        out["moderate_qps"] = round(64 * len(mod_calls) / mod_dur, 1)
        out["moderate_call_p50_ms"] = round(float(np.percentile(mod_calls, 50)) * 1e3, 1)
    out["freshness_moderate_samples"] = len(fresh_moderate)
    if fresh_moderate:
        out["freshness_moderate_ms_p50"] = round(float(np.percentile(fresh_moderate, 50)), 1)
        out["freshness_moderate_ms_p95"] = round(float(np.percentile(fresh_moderate, 95)), 1)
        out["freshness_moderate_gate_1s_passed"] = bool(float(np.percentile(fresh_moderate, 50)) < 1000.0)

    # -- reduce -------------------------------------------------------------------
    total_q = sum(m for _, _, m, _ in calls)
    out["duration_seconds"] = round(elapsed, 1)
    out["query_qps_under_churn"] = round(total_q / elapsed, 1)
    out["ann_calls"] = len(calls)
    out["call_batch"] = qb
    lat_all = np.array([dt for _, dt, _, _ in calls]) * 1e3
    lat_bld = np.array([dt for _, dt, _, b in calls if b]) * 1e3
    lat_idl = np.array([dt for _, dt, _, b in calls if not b]) * 1e3

    def pct(a, p):
        return round(float(np.percentile(a, p)), 1) if a.size else None

    out["call_p50_ms"] = pct(lat_all, 50)
    out["call_p99_ms"] = pct(lat_all, 99)
    out["call_p50_ms_build_active"] = pct(lat_bld, 50)
    out["call_p99_ms_build_active"] = pct(lat_bld, 99)
    out["call_p50_ms_idle"] = pct(lat_idl, 50)
    out["call_p99_ms_idle"] = pct(lat_idl, 99)
    out["calls_during_build"] = int(lat_bld.size)
    if lat_bld.size and lat_idl.size:
        out["p99_build_over_idle"] = round(float(np.percentile(lat_bld, 99) / np.percentile(lat_idl, 99)), 2)
        out["p99_gate_3x_passed"] = bool(out["p99_build_over_idle"] <= 3.0)
    out["upserts_per_sec"] = round(churn_stats["up"] / elapsed, 1)
    out["removes_per_sec"] = round(churn_stats["rm"] / elapsed, 1)
    out["churn_host_ms_total"] = round(churn_stats["ms"], 1)
    out["freshness_samples"] = len(fresh_ms)
    if fresh_ms:
        out["freshness_ms_p50"] = round(float(np.percentile(fresh_ms, 50)), 1)
        out["freshness_ms_p95"] = round(float(np.percentile(fresh_ms, 95)), 1)
        out["freshness_gate_1s_passed"] = bool(float(np.percentile(fresh_ms, 50)) < 1000.0)
    # the call latency in 20 s windows
    if calls:
        tl: dict = {}
        for t, dt, _m, _b in calls:
            tl.setdefault(int(t // 20) * 20, []).append(dt * 1e3)
        out["call_p50_ms_by_20s"] = {str(b): round(float(np.percentile(v, 50)), 1) for b, v in sorted(tl.items())}
    # what the maintenance probe saw during the run
    kinds: dict = {}
    for _t, p, _mq, _sq in sched_trace:
        kinds[p] = kinds.get(p, 0) + 1
    out["sched_pending_histogram"] = {str(kk): v for kk, v in kinds.items()}
    out["sched_modify_queue_empty_fraction"] = round(
        sum(1 for _t, _p, mq, _sq in sched_trace if mq == 0) / max(len(sched_trace), 1), 3
    )
    # the rebuild trigger's terms at the end of the run
    out["end_delta_live"] = int((engine._valid_host[: engine.capacity] & (engine._region == ivf_mod._DELTA)).sum())
    out["end_rebuild_floor"] = int(engine._rebuild_floor)
    out["end_rebuild_threshold"] = int(max(engine.kmeans_block, engine.rebuild_fraction * engine._live))
    phases_seen = [p for _, p in build_trace if p is not None]
    out["build_active_fraction"] = round(len(phases_seen) / max(len(build_trace), 1), 3)
    slices = list(engine.maintain_log)
    out["maintain_slices"] = len(slices)
    if slices:
        by_phase: dict[str, list[float]] = {}
        for ph, sdt in slices:
            by_phase.setdefault(ph.rstrip("0123456789"), []).append(sdt)
        out["maintain_slice_ms_max"] = {ph: round(max(v) * 1e3, 1) for ph, v in by_phase.items()}
        swaps = by_phase.get("swap", [])
        out["rebuilds_completed_mid_run"] = len(swaps)
        out["swap_slice_ms"] = [round(s * 1e3, 1) for s in swaps]
    recall1 = await calc_recall()
    out["recall_post_churn"] = round(recall1, 4)
    out["recall_gate_passed"] = bool(recall0 >= 0.95 and recall1 >= 0.95)
    _log(f"index device_bytes {engine.device_bytes}")  # not a key of the JAX runner's line
    await actor.stop()
    out["data"] = (
        "synthetic clustered unit gaussians; churn rows in a far-off shell; queries, churn, freshness and "
        "maintenance all concurrent through the serving actor"
    )
    return out


def run(name: str, device=None) -> dict:
    """A CONFIGS entry on the IVF engine (cosine): ingest, build, recall@10
    with the gate walked over nprobe (to 128) and then the oversample (to
    4, with the exact f32 host re-rank), the burst rate, pipelined QPS with
    p50 and the bounded point, and the compute-side rate of the main
    region's candidate search."""
    import torch

    from vector_store_tpu_torch.benchkit import synth
    from vector_store_tpu_torch.benchkit.common import bench_device, recall, sync, timed_loop
    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex
    from vector_store_tpu_torch.ops.ivf import ivf_candidates

    device = bench_device(device)
    n, d, quant_name = CONFIGS[name]
    n = int(os.environ.get("SCALE_N", n))
    quant = Quantization[quant_name]
    batch = int(os.environ.get("SCALE_BATCH", 2048))
    k, nq = 10, 512
    rng = np.random.default_rng(1234)
    seed, n_centers = 1234, 1024
    out: dict = {"config": name, "n": n, "d": d, "quant": quant_name}
    nprobe0 = int(os.environ.get("SCALE_NPROBE", 32))
    index = IvfDeviceIndex(
        d, space_type=SpaceType.COSINE, quantization=quant, initial_capacity=n + 1024, device=device, nprobe=nprobe0,
    )
    # dataset acquisition outside the ingest and build timers, like the
    # reference benchmark's fbin files on disk before build-index runs
    t_ds = time.time()
    dataset = synth.rows_file_np(seed, n, d, n_centers)
    out["dataset_gen_seconds"] = round(time.time() - t_ds, 1)
    t0 = time.time()
    all_vecs, held = _ingest(index, dataset, n, d, device, rng, nq, normalize=True)
    sync(device)
    ingest_s = time.time() - t0
    t0 = time.time()
    index.maintain()
    sync(device)
    build_s = time.time() - t0
    out["ingest_seconds"] = round(ingest_s, 1)
    out["build_seconds"] = round(build_s, 1)
    out["build_vectors_per_sec"] = round(n / (ingest_s + build_s), 0)
    out["nlist"] = index.nlist
    out["cmax"] = index.cmax
    out["device_bytes"] = int(index.device_bytes)

    t0 = time.time()
    gt = _cosine_gt(all_vecs, held, k, device)
    out["gt_seconds"] = round(time.time() - t0, 1)
    gate_q = np.tile(held, (max(1, -(-batch // nq)), 1))[:batch]

    def calc_recall() -> float:
        return recall(index.search(gate_q, k)[:nq], gt, k)

    rec = calc_recall()
    _log(f"recall {rec:.4f} @ nprobe {index.nprobe}")
    # the gate walk over both knobs: nprobe (candidate scope) and, once it
    # plateaus, the oversample with the exact f32 host re-rank
    while rec < 0.95:
        if index.nprobe < min(max(index.nlist, 1), 128):
            index.nprobe = min(index.nprobe * 2, 128)
        elif index.oversample < 4:
            index.oversample = max(index.oversample * 2, 2)
            index.nprobe = nprobe0
            _log(f"nprobe plateau -> oversample {index.oversample}x + exact f32 host rescore")
        else:
            break
        rec = calc_recall()
        _log(f"recall {rec:.4f} @ nprobe {index.nprobe} oversample {index.oversample}")
    out["recall_at_10"] = round(rec, 4)
    out["recall_gate_passed"] = bool(rec >= 0.95)
    out["nprobe"] = index.nprobe
    out["oversample"] = index.oversample

    if name == "glove":
        # config 2 is a recall sweep over the search knob
        sweep = {}
        saved = index.nprobe
        for np_ in (8, 16, 32, 64):
            index.nprobe = np_
            sweep[str(np_)] = round(calc_recall(), 4)
            _log(f"glove sweep nprobe={np_} recall {sweep[str(np_)]}")
        index.nprobe = saved
        out["recall_sweep_by_nprobe"] = sweep

    # throughput: the burst (24 batches begun, then collected), then
    # windows of `agg` batches with per-batch latency (begin -> the
    # window's collect), then the bounded point (one batch a window)
    queries = gate_q
    index.search(queries, k)
    reps = 24
    t0 = time.time()
    index.collect_many([index.search_begin(queries, k) for _ in range(reps)])
    out["e2e_qps_burst"] = round(batch * reps / (time.time() - t0), 1)

    def e2e_lat(run_iters: int, run_agg: int) -> tuple[float, float]:
        lat: list[float] = []
        t_start = time.time()
        pend: list = []
        starts: list[float] = []
        for _ in range(run_iters):
            starts.append(time.time())
            pend.append(index.search_begin(queries, k))
            if len(pend) >= run_agg:
                index.collect_many(pend)
                now = time.time()
                lat.extend(now - s0 for s0 in starts)
                pend, starts = [], []
        if pend:
            index.collect_many(pend)
            now = time.time()
            lat.extend(now - s0 for s0 in starts)
        return batch * run_iters / (time.time() - t_start), float(np.percentile(lat, 50) * 1e3)

    q_e2e, p50_e2e = e2e_lat(32, 8)
    out["e2e_qps"] = round(q_e2e, 1)
    out["e2e_p50_ms"] = round(p50_e2e, 1)
    q_b, p_b = e2e_lat(12, 1)
    out["bounded_qps_agg1"] = round(q_b, 1)
    out["bounded_p50_ms_agg1"] = round(p_b, 1)
    _log(f"e2e {q_e2e:.0f} qps p50 {p50_e2e:.0f} ms | bounded {q_b:.0f} qps p50 {p_b:.0f} ms")

    # compute-side rate: M back-to-back candidate searches of the main region
    out["compute_side_qps"] = None
    if index.main_vecs is not None:
        m = 32
        qs = index._main_queries(queries / np.linalg.norm(queries, axis=-1, keepdims=True))
        q_live = torch.ones((batch,), dtype=torch.bool, device=device)
        nprobe = min(index.nprobe, index.nlist)
        k_fetch = min(k * index.oversample, max(index.size, k))
        s = index._serving_s(batch)

        def one() -> None:
            ivf_candidates(
                index.main_vecs, index.main_a, index.main_b, index.centroids, qs, q_live,
                k=k_fetch, nprobe=nprobe, s=s, cmax=index.cmax, spherical=True,
            )

        out["compute_side_qps"] = round(batch * m / timed_loop(one, m, device), 1)
    out["data"] = (
        "synthetic clustered unit gaussians at the config's shape; exact f32 cosine ground truth on the stored rows"
    )
    return out


def main() -> None:
    name = sys.argv[1] if len(sys.argv) > 1 else "dbpedia-bf16"
    n = int(os.environ.get("SCALE_N", 1_000_000))
    if name.startswith("graph"):
        result = run_graph(n=n)
    elif name.startswith("partition"):
        result = run_partition(n=n)
    elif name.startswith("filtered-diverse"):
        result = run_filtered_diverse(n=n)
    elif name.startswith("filtered-engine"):
        result = run_filtered_engine(n=n)
    elif name.startswith("filtered"):
        result = run_filtered(n=n)
    elif name.startswith("streaming-actor"):
        result = run_streaming_actor(n=n)
    elif name.startswith("http"):
        from vector_store_tpu_torch.benchkit.http_bench import run_http

        result = run_http(n=n)
    elif name.startswith("streaming"):
        result = run_streaming(n=n)
    else:
        result = run(name)
    from vector_store_tpu_torch.benchkit.common import print_launches

    print_launches()
    line = json.dumps(result)
    print(line, flush=True)
    os.makedirs(os.path.dirname(RUNS_FILE), exist_ok=True)
    with open(RUNS_FILE, "a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
