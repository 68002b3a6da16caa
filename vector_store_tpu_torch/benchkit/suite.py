"""Benchmark suite covering the BASELINE.md configurations beyond the
headline SIFT-1M run (benchkit/headline.py), on the port's engines and
actor (the counterpart of the JAX package's benchkit/suite.py):

  2. GloVe-like: 1.2M x 100-d angular (cosine), recall@10 sweep over
     graph ef_search
  3. DBpedia-like: 1M x 1536-d, bf16 + i8 quantized, recall@10
  4. saturation: concurrent pipelined query load at fixed recall

Each command prints one JSON line. Sizes are env-tunable so smoke runs fit
in CI (SUITE_N, SUITE_BATCH). Every function runs on ``device``, else
BENCH_DEVICE, else ``cuda`` (benchkit/common.py). The JAX suite's count of
device-program compiles per bucket (``jax_log_compiles``) has no
counterpart here: the port compiles no program per shape.

Usage: python -m vector_store_tpu_torch.benchkit.suite <cosine-sweep|ivf-sweep|quantized-highdim|saturation|selectivity|selectivity-diverse>
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _data(n, d, rng, clusters=256):
    centers = rng.normal(size=(clusters, d)).astype(np.float32) * 4
    out = centers[rng.integers(0, clusters, size=n)] + rng.normal(
        size=(n, d)
    ).astype(np.float32)
    return out


def _gt_cosine(queries, vecs, k, chunk=250_000):
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    best_d = np.full((len(queries), 0), np.inf, dtype=np.float32)
    best_i = np.zeros((len(queries), 0), dtype=np.int64)
    for lo in range(0, len(vecs), chunk):
        block = vecs[lo : lo + chunk]
        bn = block / np.linalg.norm(block, axis=1, keepdims=True)
        dist = 1.0 - qn @ bn.T
        top = np.argpartition(dist, min(k, dist.shape[1] - 1), axis=1)[:, :k]
        best_d = np.concatenate([best_d, np.take_along_axis(dist, top, axis=1)], axis=1)
        best_i = np.concatenate([best_i, top + lo], axis=1)
    order = np.argsort(best_d, axis=1)[:, :k]
    return np.take_along_axis(best_i, order, axis=1)


def _recall(results, gt, k):
    return float(
        np.mean([len(set(r.slots.tolist()) & set(gt[i])) / k for i, r in enumerate(results)])
    )


def cosine_sweep(device=None) -> dict:
    """Graph engine recall@10 vs ef_search on angular data (config 2)."""
    from vector_store_tpu_torch.benchkit.common import bench_device
    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.engine.graph import GraphDeviceIndex

    device = bench_device(device)
    n = int(os.environ.get("SUITE_N", 200_000))
    d = 100
    k = 10
    rng = np.random.default_rng(2)
    vecs = _data(n, d, rng)
    queries = _data(64, d, rng)
    gt = _gt_cosine(queries, vecs, k)

    idx = GraphDeviceIndex(
        d,
        space_type=SpaceType.COSINE,
        quantization=Quantization.BF16,
        connectivity=16,
        expansion_add=64,
        initial_capacity=n,
        device=device,
    )
    t0 = time.time()
    step = 8192
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        idx.upsert_batch(np.arange(lo, hi), np.zeros(hi - lo, np.int32), vecs[lo:hi])
        idx.merge_delta(max_batch=4096)
    while idx.merge_delta(max_batch=4096):
        pass
    build_s = time.time() - t0

    sweep = {}
    for ef in (32, 64, 128, 256):
        t0 = time.time()
        res = idx.search(queries, k, expansion=ef)
        dt = time.time() - t0
        sweep[str(ef)] = {
            "recall_at_10": round(_recall(res, gt, k), 4),
            "batch_ms": round(dt * 1e3, 1),
        }
    return {
        "config": "glove-like cosine sweep",
        "n": n,
        "dims": d,
        "build_seconds": round(build_s, 1),
        "build_vectors_per_sec": round(n / build_s, 0),
        "ef_sweep": sweep,
    }


def ivf_sweep(device=None) -> dict:
    """IVF engine (the serving default) recall@10 vs nprobe on angular
    data — the config-2 sweep for the clustered engine; nprobe plays the
    reference's ef_search role."""
    from vector_store_tpu_torch.benchkit.common import bench_device
    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex

    device = bench_device(device)
    n = int(os.environ.get("SUITE_N", 200_000))
    d = 100
    k = 10
    rng = np.random.default_rng(2)
    vecs = _data(n, d, rng)
    queries = _data(64, d, rng)
    gt = _gt_cosine(queries, vecs, k)

    idx = IvfDeviceIndex(
        d,
        space_type=SpaceType.COSINE,
        quantization=Quantization.BF16,
        initial_capacity=n,
        min_build=min(n, 65_536),
        device=device,
    )
    t0 = time.time()
    step = 125_000
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        idx.upsert_batch(np.arange(lo, hi), np.zeros(hi - lo, np.int32), vecs[lo:hi])
    idx.maintain()
    build_s = time.time() - t0

    sweep = {}
    for nprobe in (16, 32, 64, 128):
        idx.nprobe = nprobe
        idx.search(queries, k)  # warm the shape
        t0 = time.time()
        res = idx.search(queries, k)
        dt = time.time() - t0
        sweep[str(nprobe)] = {
            "recall_at_10": round(_recall(res, gt, k), 4),
            "batch_ms": round(dt * 1e3, 1),
        }
    return {
        "config": "glove-like ivf nprobe sweep",
        "n": n,
        "dims": d,
        "nlist": idx.nlist,
        "build_seconds": round(build_s, 1),
        "build_vectors_per_sec": round(n / build_s, 0),
        "nprobe_sweep": sweep,
    }


def quantized_highdim(device=None) -> dict:
    """bf16 vs i8 recall on 1536-d embeddings (config 3). The JAX suite's
    ``approx`` (TPU approximate top-k) has no counterpart: the port's scans
    are exact."""
    from vector_store_tpu_torch.benchkit.common import bench_device
    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.engine.flat import FlatDeviceIndex

    device = bench_device(device)
    n = int(os.environ.get("SUITE_N", 100_000))
    d = 1536
    k = 10
    rng = np.random.default_rng(3)
    vecs = _data(n, d, rng, clusters=128)
    queries = _data(64, d, rng, clusters=128)
    gt = _gt_cosine(queries, vecs, k, chunk=50_000)

    out = {"config": "dbpedia-like 1536-d quantized", "n": n, "dims": d}
    for quant in (Quantization.BF16, Quantization.I8):
        idx = FlatDeviceIndex(
            d,
            space_type=SpaceType.COSINE,
            quantization=quant,
            initial_capacity=n,
            device=device,
        )
        step = 50_000
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            idx.upsert_batch(np.arange(lo, hi), np.zeros(hi - lo, np.int32), vecs[lo:hi])
        res = idx.search(queries, k)
        out[quant.value.lower()] = {"recall_at_10": round(_recall(res, gt, k), 4)}
    return out


def saturation(device=None) -> dict:
    """Pipelined throughput at fixed recall (config 4 shape)."""
    from vector_store_tpu_torch.benchkit.common import bench_device
    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.engine.flat import FlatDeviceIndex

    device = bench_device(device)
    n = int(os.environ.get("SUITE_N", 500_000))
    d = 96
    k = 10
    batch = int(os.environ.get("SUITE_BATCH", 2048))
    rng = np.random.default_rng(4)
    idx = FlatDeviceIndex(
        d,
        space_type=SpaceType.EUCLIDEAN,
        quantization=Quantization.BF16,
        initial_capacity=n,
        device=device,
    )
    step = 125_000
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        idx.upsert_batch(
            np.arange(lo, hi), np.zeros(hi - lo, np.int32), _data(hi - lo, d, rng)
        )
    queries = _data(batch, d, rng)
    idx.search(queries, k)
    iters = 15
    t0 = time.time()
    prev = None
    for _ in range(iters):
        pend = idx.search_begin(queries, k)
        if prev is not None:
            idx.search_collect(prev)
        prev = pend
    idx.search_collect(prev)
    dt = time.time() - t0
    return {
        "config": "deep-like saturation",
        "n": n,
        "dims": d,
        "batch": batch,
        "qps": round(batch * iters / dt, 0),
        "batch_ms": round(dt / iters * 1e3, 2),
    }


def selectivity(device=None) -> dict:
    """Filtered-search QPS/recall over selectivity buckets 50% -> 0.1%
    (reference crates/benchmark/src/main.rs:45-49,188-190). Exercises the
    oversample+retry loop whose cost scales inversely with selectivity:
    each row carries one filtering value; bucket b restricts to the rows
    whose value == b, matching a fraction of the corpus."""
    import asyncio

    from vector_store_tpu_torch.benchkit.common import bench_device
    from vector_store_tpu_torch.benchkit.harness import SELECTIVITY_BUCKETS, search_http

    device = bench_device(device)
    n = int(os.environ.get("SUITE_N", 100_000))
    d = int(os.environ.get("SUITE_D", 64))
    k = 10
    n_queries = int(os.environ.get("SUITE_QUERIES", 128))
    concurrency = int(os.environ.get("SUITE_CONCURRENCY", 64))
    rng = np.random.default_rng(9)
    vecs = _data(n, d, rng)

    # assign each row to the narrowest bucket it samples into, so bucket b
    # matches ~fraction b of rows: labels chosen by cumulative thresholds
    labels = np.full(n, -1, dtype=np.int64)
    u = rng.random(n)
    acc = 0.0
    for bi, frac in enumerate(SELECTIVITY_BUCKETS):
        labels[(u >= acc) & (u < acc + frac)] = bi
        acc += frac

    async def run() -> dict:
        from aiohttp.test_utils import TestServer

        from vector_store_tpu_torch.db.fake import (
            FakeDb,
            FakeIndex,
            FakeTable,
            make_vs_metadata,
            vector_row,
        )
        from vector_store_tpu_torch.run import build_service
        from vector_store_tpu_torch.service.config import Config
        from vector_store_tpu_torch.service.node_state import IndexStatus, NodeStatus

        db = FakeDb()
        db.add_table(FakeTable("ks", "tbl", ("pk",)))
        rows = [
            vector_row(
                (i,), vecs[i].tolist(), 100, filtering=[(100, int(labels[i]))]
            )
            for i in range(n)
        ]
        db.add_index(
            FakeIndex(
                metadata=make_vs_metadata(
                    dimensions=d, filtering_columns=("bucket",)
                ),
                scan=rows,
            )
        )
        service = await build_service(db, Config(monitor_indexes_interval=0.1), device=device)
        http = TestServer(service.app)
        await http.start_server()
        try:
            while service.node_state.get_status() is not NodeStatus.SERVING:
                await asyncio.sleep(0.1)
            entry = service.indexes.get_vs(("ks", "idx"))
            while (
                entry.status is not IndexStatus.SERVING
                or await entry.actor.count() < n
            ):
                service.engine.update_entries()
                await asyncio.sleep(0.2)

            engine = entry.actor.engine
            if (
                os.environ.get("SUITE_WAIT_BUILD") == "1"
                and hasattr(engine, "main_vecs")
                and n >= getattr(engine, "min_build", 1 << 62)
                and getattr(engine, "_ivf_ok", True)
            ):
                # measure against the CLUSTERED serving engine (the actor's
                # idle maintenance slot runs the rebuild + shape warming)
                deadline = time.time() + 2400
                while engine.main_vecs is None or engine.maintain_pending() is not None:
                    assert time.time() < deadline, "IVF build never completed"
                    entry.actor._modify_event.set()
                    await asyncio.sleep(0.5)
                print(
                    f"[suite] ivf built: nlist={engine.nlist}", file=sys.stderr,
                    flush=True,
                )

            url = f"http://127.0.0.1:{http.port}"
            queries = _data(n_queries, d, rng)
            out: dict = {"config": "filtered selectivity buckets", "n": n, "buckets": {}}
            out["engine"] = type(engine).__name__
            for bi, frac in enumerate(SELECTIVITY_BUCKETS):
                allowed = np.flatnonzero(labels == bi)
                if allowed.size == 0:
                    continue
                # exact filtered ground truth (cosine — the index metric)
                sub = vecs[allowed]
                qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
                sn = sub / np.linalg.norm(sub, axis=1, keepdims=True)
                d2 = 1.0 - qn @ sn.T
                kk = min(k, allowed.size)
                top = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
                gt = allowed[top]

                def filt(i, b=bi):
                    return {
                        "restrictions": [{"type": "==", "lhs": "bucket", "rhs": b}],
                        "allow_filtering": True,
                    }

                # warmup pass (untimed): first contact with this filter
                # populates the restriction-signature ladder/match caches;
                # the timed window below then measures steady state
                await search_http(
                    url,
                    "ks",
                    "idx",
                    queries[: min(16, n_queries)],
                    gt[: min(16, n_queries)],
                    kk,
                    min(16, concurrency),
                    filter_template=filt,
                )
                esc0 = entry.actor._escalations
                ex0 = entry.actor._exact_fallbacks
                res = await search_http(
                    url,
                    "ks",
                    "idx",
                    queries,
                    gt,
                    kk,
                    concurrency,
                    filter_template=filt,
                )
                out["buckets"][f"{frac:g}"] = {
                    "qps": round(res["qps"], 1),
                    "p50_ms": round(res["p50_ms"], 2),
                    "recall_at_k": round(res["recall_at_k"], 4),
                    "matching_rows": int(allowed.size),
                    "oversample_escalations": entry.actor._escalations - esc0,
                    "exact_host_fallbacks": entry.actor._exact_fallbacks - ex0,
                }
                print(
                    f"[suite] bucket {frac:g}: {out['buckets'][f'{frac:g}']}",
                    file=sys.stderr,
                    flush=True,
                )
            return out
        finally:
            await http.close()
            await service.stop()

    return asyncio.run(run())


def selectivity_diverse(device=None) -> dict:
    """Filter-DIVERSITY artifact (VERDICT r4 #3): the selectivity bench
    above uses ONE filter value per band, so the ladder/match/mask caches
    amortize across 128 identical-signature queries — while the reference's
    per-id predicate (usearch.rs:224-248) pays zero per-filter precompute
    and serves fresh filters as its NORMAL case. Here every band carries
    >=128 DISTINCT signatures: each row holds a uniform int in [0, 2^20)
    and a band-frac filter is a range window  lo <= bucket < lo+frac*2^20
    at a per-signature random offset — same selectivity, fresh signature.

    Per band this measures: a COLD pass (every signature's first contact:
    ladder walks, match-set builds, mask promotions) and a WARM pass (the
    same signature population revisited), plus actor cache sizes/bytes and
    escalation counters, and an exact-recall audit on a signature subset.

    Reference: crates/benchmark/src/main.rs:45-49 (selectivity buckets);
    usearch.rs:224-248 (per-id predicate cost model)."""
    import asyncio

    from vector_store_tpu_torch.benchkit.common import bench_device
    from vector_store_tpu_torch.benchkit.harness import SELECTIVITY_BUCKETS, search_http

    device = bench_device(device)
    n = int(os.environ.get("SUITE_N", 100_000))
    d = int(os.environ.get("SUITE_D", 64))
    k = 10
    sigs = int(os.environ.get("SUITE_SIGNATURES", 128))
    warm_rounds = int(os.environ.get("SUITE_WARM_ROUNDS", 8))
    concurrency = int(os.environ.get("SUITE_CONCURRENCY", 128))
    audit_sigs = 8
    val_space = 1 << 20
    rng = np.random.default_rng(17)
    vecs = _data(n, d, rng)
    vals = rng.integers(0, val_space, size=n)

    async def run() -> dict:
        from aiohttp.test_utils import TestServer

        from vector_store_tpu_torch.db.fake import (
            FakeDb,
            FakeIndex,
            FakeTable,
            make_vs_metadata,
            vector_row,
        )
        from vector_store_tpu_torch.run import build_service
        from vector_store_tpu_torch.service.config import Config
        from vector_store_tpu_torch.service.node_state import IndexStatus, NodeStatus

        db = FakeDb()
        db.add_table(FakeTable("ks", "tbl", ("pk",)))
        rows = [
            vector_row(
                (i,), vecs[i].tolist(), 100, filtering=[(100, int(vals[i]))]
            )
            for i in range(n)
        ]
        db.add_index(
            FakeIndex(
                metadata=make_vs_metadata(
                    dimensions=d, filtering_columns=("bucket",)
                ),
                scan=rows,
            )
        )
        service = await build_service(db, Config(monitor_indexes_interval=0.1), device=device)
        http = TestServer(service.app)
        await http.start_server()
        try:
            while service.node_state.get_status() is not NodeStatus.SERVING:
                await asyncio.sleep(0.1)
            entry = service.indexes.get_vs(("ks", "idx"))
            while (
                entry.status is not IndexStatus.SERVING
                or await entry.actor.count() < n
            ):
                service.engine.update_entries()
                await asyncio.sleep(0.2)
            engine = entry.actor.engine
            if (
                os.environ.get("SUITE_WAIT_BUILD") == "1"
                and hasattr(engine, "main_vecs")
                and n >= getattr(engine, "min_build", 1 << 62)
                and getattr(engine, "_ivf_ok", True)
            ):
                deadline = time.time() + 2400
                while engine.main_vecs is None or engine.maintain_pending() is not None:
                    assert time.time() < deadline, "IVF build never completed"
                    entry.actor._modify_event.set()
                    await asyncio.sleep(0.5)
                print(
                    f"[suite] ivf built: nlist={engine.nlist}",
                    file=sys.stderr,
                    flush=True,
                )

            url = f"http://127.0.0.1:{http.port}"
            actor = entry.actor
            out: dict = {
                "config": "filtered selectivity, diverse signatures",
                "n": n,
                "signatures_per_band": sigs,
                "bands": {},
            }
            out["engine"] = type(engine).__name__
            for frac in SELECTIVITY_BUCKETS:
                width = max(int(frac * val_space), 1)
                los = rng.choice(val_space - width, size=sigs, replace=False)
                windows = [(int(lo), int(lo + width)) for lo in los]

                def filt(i, w=windows):
                    lo, hi = w[i % len(w)]
                    return {
                        "restrictions": [
                            {"type": ">=", "lhs": "bucket", "rhs": lo},
                            {"type": "<", "lhs": "bucket", "rhs": hi},
                        ],
                        "allow_filtering": True,
                    }

                band_q = _data(sigs, d, rng)
                c0 = {
                    "esc": actor._escalations,
                    "exact": actor._exact_fallbacks,
                    "masked": actor._masked_dispatches,
                }
                # COLD: one query per distinct signature, every signature's
                # first contact since process start
                cold = await search_http(
                    url, "ks", "idx", band_q, None, k, concurrency,
                    filter_template=filt,
                )
                cold_counters = {
                    "oversample_escalations": actor._escalations - c0["esc"],
                    "exact_host_fallbacks": actor._exact_fallbacks - c0["exact"],
                    "masked_dispatches": actor._masked_dispatches - c0["masked"],
                }
                # WARM: same signature population revisited warm_rounds x
                warm_q = _data(sigs * warm_rounds, d, rng)
                w0 = {
                    "esc": actor._escalations,
                    "exact": actor._exact_fallbacks,
                    "masked": actor._masked_dispatches,
                }
                warm = await search_http(
                    url, "ks", "idx", warm_q, None, k, concurrency,
                    filter_template=filt,
                )
                warm_counters = {
                    "oversample_escalations": actor._escalations - w0["esc"],
                    "exact_host_fallbacks": actor._exact_fallbacks - w0["exact"],
                    "masked_dispatches": actor._masked_dispatches - w0["masked"],
                }
                # recall AUDIT on a signature subset (exact filtered GT)
                aq = _data(audit_sigs * 4, d, rng)
                gt_rows = []
                for i in range(len(aq)):
                    lo, hi = windows[i % len(windows)]
                    allowed = np.flatnonzero((vals >= lo) & (vals < hi))
                    sub = vecs[allowed]
                    qn = aq[i] / np.linalg.norm(aq[i])
                    sn = sub / np.linalg.norm(sub, axis=1, keepdims=True)
                    dd = 1.0 - sn @ qn
                    kk = min(k, allowed.size)
                    top = np.argpartition(dd, kk - 1)[:kk]
                    gt_rows.append(
                        np.pad(allowed[top], (0, k - kk), constant_values=-1)
                    )
                audit = await search_http(
                    url, "ks", "idx", aq, np.asarray(gt_rows), k, 16,
                    filter_template=filt,
                )
                out["bands"][f"{frac:g}"] = {
                    "matching_rows_per_sig": int(round(frac * n)),
                    "cold_qps": round(cold["qps"], 1),
                    "cold_p50_ms": round(cold["p50_ms"], 2),
                    "cold_p99_ms": round(cold["p99_ms"], 2),
                    "cold_counters": cold_counters,
                    "warm_qps": round(warm["qps"], 1),
                    "warm_p50_ms": round(warm["p50_ms"], 2),
                    "warm_p99_ms": round(warm["p99_ms"], 2),
                    "warm_counters": warm_counters,
                    "audit_recall_at_k": round(audit["recall_at_k"], 4),
                    "cache_sizes": {
                        "ladder": len(actor._ladder_cache),
                        "match": len(actor._match_cache),
                        "match_mb": round(actor._match_bytes / 1e6, 1),
                        "allow": len(actor._allow_cache),
                    },
                }
                print(
                    f"[suite] diverse band {frac:g}: "
                    f"{out['bands'][f'{frac:g}']}",
                    file=sys.stderr,
                    flush=True,
                )
            return out
        finally:
            await http.close()
            await service.stop()

    return asyncio.run(run())


def main() -> None:
    cmd = sys.argv[1] if len(sys.argv) > 1 else "cosine-sweep"
    fn = {
        "cosine-sweep": cosine_sweep,
        "ivf-sweep": ivf_sweep,
        "quantized-highdim": quantized_highdim,
        "saturation": saturation,
        "selectivity": selectivity,
        "selectivity-diverse": selectivity_diverse,
    }[cmd]
    print(json.dumps(fn()))


if __name__ == "__main__":
    main()
