"""The sharded IVF engine past toy size, through the serving actor.

Twin of scripts/sharded_scale_gate.py: the full actor path (Table ->
VsIndexActor(ivf-sharded) -> sharded build -> ann_many) at SHARDED_GATE_N
rows (default 65,536) of SHARDED_GATE_D dimensions (default 16) over 8
shards with:

- a recall@10 gate of 0.95 against exact ground truth (nprobe doubles up
  to 256 until it passes, as the JAX gate walks it);
- each shard's placed rows and the cmax capacity accounting;
- one low-selectivity filtered request (the grouped subset-exact
  terminal), whose keys must equal the exact filtered ranking;
- one local-index request (the factory gives a local index the flat
  engine).

    python -m vector_store_tpu_torch.bench.sharded_gate
    SHARDED_GATE_DEVICE=cpu SHARDED_GATE_N=8192 python -m vector_store_tpu_torch.bench.sharded_gate

The device is cuda (every shard on card i % cards) unless
SHARDED_GATE_DEVICE names another. It prints progress lines and, last, one
JSON object (config sharded-gate-<n>k), after a ``[launches] {...}`` line of
the scan kernels' launch counts (benchkit/common.py).
"""

from __future__ import annotations

import asyncio
import json
import os
import time

import numpy as np
import torch

from vector_store_tpu_torch.benchkit.common import print_launches
from vector_store_tpu_torch.core import DbIndexedValue, IndexKey, PrimaryKey, Timestamp, Timestamped
from vector_store_tpu_torch.core.filters import Restriction
from vector_store_tpu_torch.core.types import DbIndexPartitioning
from vector_store_tpu_torch.db.fake import make_vs_metadata
from vector_store_tpu_torch.engine.flat import FlatDeviceIndex
from vector_store_tpu_torch.parallel.serving import ShardedIvfServingEngine
from vector_store_tpu_torch.service.vs_index import VsIndexActor
from vector_store_tpu_torch.table import Table

KEY = IndexKey("ks", "idx")
K, NQ, SHARDS = 10, 64, 8


async def main() -> dict:
    n = int(os.environ.get("SHARDED_GATE_N", 65536))
    d = int(os.environ.get("SHARDED_GATE_D", 16))
    device = torch.device(os.environ.get("SHARDED_GATE_DEVICE", "cuda"))
    rng = np.random.default_rng(31)
    out: dict = {"config": f"sharded-gate-{n // 1000}k", "n": n, "d": d, "shards": SHARDS}

    # clustered rows (cosine) and a rare filtering value on ~0.2% of rows
    centers = rng.normal(size=(64, d)).astype(np.float32) * 4
    vecs = centers[rng.integers(0, 64, size=n)] + rng.normal(size=(n, d)).astype(np.float32)
    fvals = rng.integers(0, 500, size=n)  # value v matches ~n / 500 rows

    md = make_vs_metadata(dimensions=d, filtering_columns=("bucket",))
    table = Table(md)
    actor = VsIndexActor(md, table, engine_kind="ivf-sharded", shards=SHARDS, device=device)
    engine = actor.engine
    assert isinstance(engine, ShardedIvfServingEngine), type(engine)
    out["mesh"] = [str(dev) for dev in engine.mesh.shard_devices]

    t0 = time.perf_counter()
    ts0 = Timestamp.from_millis(100)
    chunk = 8192
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        rows = [
            (
                PrimaryKey.from_values((lo + j,)),
                (
                    Timestamped(ts0, DbIndexedValue.vector(vecs[lo + j].tolist())),
                    Timestamped(ts0, DbIndexedValue.filtering(int(fvals[lo + j]))),
                ),
            )
            for j in range(hi - lo)
        ]
        actor._apply_ops_batch(table.upsert_scan(KEY, rows))
        print(f"[gate] ingest {hi}/{n} ({time.perf_counter() - t0:.1f} s)", flush=True)
    out["ingest_seconds"] = round(time.perf_counter() - t0, 3)
    assert engine.size == n, engine.size

    t0 = time.perf_counter()
    engine.maintain()  # the sharded k-means and the cluster-sharded layout
    out["build_seconds"] = round(time.perf_counter() - t0, 3)
    idx = engine._idx
    assert idx.main_vecs is not None, "the sharded build did not run"
    out["nlist"], out["cmax"] = idx.nlist, idx.cmax

    # each shard's placed rows and its capacity (nlist / shards clusters
    # of cmax positions)
    per_shard = idx.placed_per_shard()
    seg = idx.nlist_local * idx.cmax
    out["per_shard_rows"] = per_shard
    out["placed_rows"] = int(sum(per_shard))
    out["delta_spill_rows"] = n - out["placed_rows"]
    out["shard_fill_fraction"] = [round(c / seg, 3) for c in per_shard]
    assert sum(per_shard) + idx._delta_next == n, (sum(per_shard), idx._delta_next)
    assert max(per_shard) <= seg and min(per_shard) > 0, per_shard
    print(f"[gate] per-shard rows {per_shard} (cap {seg} a shard)", flush=True)

    actor.start()
    try:
        # the recall gate against exact cosine ground truth
        held = vecs[:NQ] + 0.1 * rng.normal(size=(NQ, d)).astype(np.float32)
        qn = held / np.linalg.norm(held, axis=1, keepdims=True)
        vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
        gt = np.argsort(1.0 - qn @ vn.T, axis=1)[:, :K]

        async def recall() -> float:
            res = await actor.ann_many(held, K)
            hits = sum(len({pk.values()[0] for pk, _ in row} & set(gt[i].tolist())) for i, row in enumerate(res))
            return hits / (NQ * K)

        t0 = time.perf_counter()
        r = await recall()
        while r < 0.95 and idx.nprobe < min(idx.nlist, 256):
            idx.nprobe = min(idx.nprobe * 2, 256)
            r = await recall()
        out["recall_at_10"] = round(r, 4)
        out["nprobe"] = idx.nprobe
        out["recall_gate_passed"] = bool(r >= 0.95)
        out["search_seconds"] = round(time.perf_counter() - t0, 3)
        print(f"[gate] recall@10 {r:.4f} at nprobe {idx.nprobe}", flush=True)
        assert r >= 0.95, r

        # a low-selectivity filtered request -> the grouped subset-exact terminal
        v = int(fvals[0])
        matches = np.flatnonzero(fvals == v)
        qf = vecs[matches[0]].tolist()
        ex0 = actor._exact_fallbacks
        res = await actor.filtered_ann(qf, [Restriction.eq("bucket", v)], 5)
        got = [pk.values()[0] for pk, _ in res]
        qfn = np.asarray(qf) / np.linalg.norm(qf)
        gt_f = matches[np.argsort(1.0 - vn[matches] @ qfn)[:5]].tolist()
        out["filtered_matching_rows"] = int(matches.size)
        out["filtered_exact"] = bool(got == gt_f)
        out["filtered_used_terminal"] = bool(actor._exact_fallbacks > ex0)
        print(f"[gate] filtered ({matches.size} matches): got {got} exact {gt_f} "
              f"terminal={out['filtered_used_terminal']}", flush=True)
        assert got == gt_f, (got, gt_f)
    finally:
        await actor.stop()

    # a local index: the factory gives it the flat engine
    md_l = make_vs_metadata(
        dimensions=d, partitioning=DbIndexPartitioning.local(("pk",)), keyspace="ks", index="lidx"
    )
    table_l = Table(md_l)
    actor_l = VsIndexActor(md_l, table_l, engine_kind="ivf-sharded", shards=SHARDS, device=device)
    assert isinstance(actor_l.engine, FlatDeviceIndex), type(actor_l.engine)
    actor_l.start()
    try:
        ops = []
        for i in range(64):
            ops.extend(table_l.upsert(
                IndexKey("ks", "lidx"), PrimaryKey.from_values((i,)),
                (Timestamped(ts0, DbIndexedValue.vector(vecs[i].tolist())),),
            ))
        actor_l.apply_operations(ops)
        deadline = time.time() + 60
        while await actor_l.count() < 64:
            assert time.time() < deadline
            await asyncio.sleep(0.05)
        res = await actor_l.filtered_ann(vecs[3].tolist(), [Restriction.eq("pk", 3)], 1)
        assert res and res[0][0].values()[0] == 3, res
        out["local_fallback_ok"] = True
        print("[gate] local-index request served by the flat engine", flush=True)
    finally:
        await actor_l.stop()

    out["data"] = "synthetic clustered gaussians, cosine; exact host ground truth"
    return out


if __name__ == "__main__":
    result = asyncio.run(main())
    print_launches()
    print(json.dumps(result))
