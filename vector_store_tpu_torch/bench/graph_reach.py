"""How well the graph engine reaches its own rows at graph-1000k, on one GPU.

Builds the graph of vector_store_tpu/benchkit/scale.py's graph-1000k
shape (1,000,000 x 128 rows in 512 Gaussian clusters, EUCLIDEAN, BF16,
the index's default connectivity 16 and expansion 128 / 64) directly on
the engine, with the device bulk build, and reads it twice: after the
build, and after the refinement pass that ``maintain`` runs next (the
JAX package's rule: a pass once the graph has grown 25%). Each reading:
the share of 1024 stored rows whose own vector finds them first (a
self-query), and recall@10 of 512 held queries (stored rows plus noise)
against exact f32, at beam widths 64 (the default), 128, 256 and 512.
Last, 256 new rows near the data are merged in one slice and queried.

    python -m vector_store_tpu_torch.bench.graph_reach [--rows N] [--device cpu]

It prints one line per reading and, last, a JSON object of them all.
chip_smoke.py phase 11 serves the same shape through the service.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from vector_store_tpu_torch.core.types import Quantization, SpaceType
from vector_store_tpu_torch.engine.graph import GraphDeviceIndex
from vector_store_tpu_torch.ops.distance import pairwise_distance
from vector_store_tpu_torch.ops.topk import merge_min_k

SEED = 20261025
DIMS, CLUSTERS, HELD, SELF, FRESH, K = 128, 512, 512, 1024, 256, 10
BEAMS = (None, 128, 256, 512)  # None: the index's expansion_search (64)


def clustered_rows(rng, n: int) -> np.ndarray:
    """n rows around CLUSTERS unit-norm centers, per-component sigma
    0.4 / sqrt(d) (chip_smoke.py's generator)."""
    centers = rng.standard_normal((CLUSTERS, DIMS), dtype=np.float32) / np.sqrt(DIMS)
    rows = rng.standard_normal((n, DIMS), dtype=np.float32) * np.float32(0.4 / np.sqrt(DIMS))
    rows += centers[rng.integers(0, CLUSTERS, size=n)]
    return rows


def exact_top_k(data: torch.Tensor, queries: torch.Tensor, k: int) -> np.ndarray:
    """Exact euclidean top-k ids in f32, in chunks of rows."""
    no_aux = torch.zeros(max(queries.shape[0], 262_144), device=queries.device)  # unused by euclidean
    best_d = torch.full((queries.shape[0], k), float("inf"), device=queries.device)
    best_i = torch.full((queries.shape[0], k), -1, dtype=torch.int64, device=queries.device)
    for lo in range(0, data.shape[0], 262_144):
        block = data[lo : lo + 262_144]
        d = pairwise_distance(
            queries, block, SpaceType.EUCLIDEAN, Quantization.F32, no_aux[: queries.shape[0]], no_aux[: block.shape[0]]
        )
        bd, bi = torch.topk(d, k, dim=1, largest=False)
        best_d, best_i = merge_min_k(best_d, best_i, bd, bi + lo)
    return best_i.cpu().numpy()


def reading(g: GraphDeviceIndex, data, picked, held, gt) -> dict:
    out = {}
    for ef in BEAMS:
        res = g.search(data[picked], 3, expansion=ef)
        found = np.mean([r.slots.size > 0 and r.slots[0] == i for r, i in zip(res, picked)])
        got = g.search(held, K, expansion=ef)
        recall = np.mean([len(set(r.slots.tolist()) & set(t.tolist())) / K for r, t in zip(got, gt)])
        out[f"ef {ef or g.expansion_search}"] = {"self_found": float(found), "recall": float(recall)}
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=1_000_000)
    parser.add_argument("--device", default="cuda", help="cpu: a rehearsal at a small --rows")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("graph_reach needs a CUDA device")
    rng = np.random.default_rng(SEED)
    n = args.rows
    data = clustered_rows(rng, n)
    held = data[rng.integers(0, n, size=HELD)] + rng.standard_normal((HELD, DIMS), dtype=np.float32) * (
        np.float32(0.1 / np.sqrt(DIMS))
    )
    gt = exact_top_k(torch.from_numpy(data).to(device), torch.from_numpy(held).to(device), K)
    picked = rng.choice(n, size=SELF, replace=False)
    g = GraphDeviceIndex(DIMS, space_type=SpaceType.EUCLIDEAN, quantization=Quantization.BF16, device=device)
    for lo in range(0, n, 131_072):
        hi = min(lo + 131_072, n)
        g.upsert_batch(np.arange(lo, hi), np.zeros(hi - lo, np.int32), data[lo:hi])
    out = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu", "rows": n}

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t = time.perf_counter()
    g.bulk_build_device()  # what the first merge_delta of a 1M backlog runs
    sync()
    out["build"] = {"path": g.last_build, "seconds": time.perf_counter() - t}
    out["after build"] = reading(g, data, picked, held, gt)
    print(f"[graph_reach] {g.last_build} bulk build of {n} rows in {out['build']['seconds']:.1f} s: "
          f"{out['after build']}", flush=True)

    t, steps = time.perf_counter(), 0
    while g.maintain():
        steps += 1
    sync()
    out["refinement"] = {"slices": steps, "seconds": time.perf_counter() - t}
    out["after refinement"] = reading(g, data, picked, held, gt)
    print(f"[graph_reach] refinement: {steps} slices in {out['refinement']['seconds']:.1f} s: "
          f"{out['after refinement']}", flush=True)

    fresh = data[rng.integers(0, n, size=FRESH)] + rng.standard_normal((FRESH, DIMS), dtype=np.float32) * (
        np.float32(0.1 / np.sqrt(DIMS))
    )
    g.upsert_batch(np.arange(n, n + FRESH), np.ones(FRESH, np.int32), fresh)
    g.merge_delta()
    out["merged new rows"] = {}
    for ef in (None, 256):
        res = g.search(fresh, 3, expansion=ef)
        found = np.mean([r.slots.size > 0 and r.slots[0] == n + j for j, r in enumerate(res)])
        out["merged new rows"][f"ef {ef or g.expansion_search}"] = float(found)
    print(f"[graph_reach] {FRESH} new rows merged in one slice, found first: {out['merged new rows']}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
