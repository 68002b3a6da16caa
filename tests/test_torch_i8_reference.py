"""The port's I8 IVF engine against the benchmark's plain reference
(``benchmark/reference.py``), with the main region built, on the CPU.

The ``openai-500k-i8`` deployment at its published width: 1536-d unit
rows drawn as ``benchmark/data.py`` draws them, stored as int8, cosine,
4x oversampling and exact float32 rescoring. 4,096 rows reach
``min_build``, so the build swaps in and the main region answers through
the grouped scan's plain twin; 256 rows written after the build stay in
the lossy delta, so ``_merge_regions`` merges the delta's distances with
the main region's ranks. Every served distance is held to the float64
cosine distance of the served key, and recall@10 to the exact top 10.
The 4,096 rows fall into 128 clusters, of which a query probes 4: the
deployment's share (32 of 1,024). The delta's headroom is cut to 8,192
rows (the engine keeps 131,072 free), since the CPU scans the delta's
whole capacity with int64 products.

With ``rescoring: false`` the delta answers with its storage-precision
distances while no main region exists (once one is built, ``ids_postprocess``
recomputes f32 distances and keeps only the device's order), and those
distances fail the same tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import data, reference  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.engine import ivf  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 2020
MAIN_ROWS, DELTA_ROWS, K = 4096, 256, 10
CFG = {"dimensions": 1536,
       "rows": {"count": MAIN_ROWS + DELTA_ROWS, "clusters": 32, "sigma": 0.4, "unit": True},
       "queries": {"pool": 128, "noise": 0.1}}
NPROBE = 4
# The rescored distance is 0.5 |q - v|^2 of unit f32 vectors, summed in
# f32 over 1536 terms: it rounds by ~1e-7 (the widest gap measured here is
# 5.2e-8). Int8 storage rounds each component by up to half of 1/127,
# which moves a distance by ~1e-2 (measured here: 1.1e-2). 1e-5 sits
# ~200x above the first and ~1000x under the second.
DIST_TOL = 1e-5
# 3x the recall@10 miss measured on this seed (0.0352: 45 of 1,280)
RECALL_FLOOR = 1.0 - 3 * 0.0352


@pytest.fixture(autouse=True)
def small_delta_headroom(monkeypatch):
    monkeypatch.setattr(ivf, "DELTA_MARGIN", 8192)


def inputs():
    rows = data.base_rows(CFG, SEED, CPU)
    return rows.numpy(), data.values_of(data.query_codes(CFG, rows, SEED))


def served(rows, queries, **kw):
    """(slots [q, K], distances [q, K]) of the port's engine over ``rows``
    (slot i holds row i): the first MAIN_ROWS before the build, the rest
    after it."""
    idx = ivf.IvfDeviceIndex(1536, space_type=SpaceType.COSINE, quantization=Quantization.I8, device=CPU,
                             min_build=MAIN_ROWS, nprobe=NPROBE, **kw)
    idx.upsert_batch(np.arange(MAIN_ROWS), np.ones(MAIN_ROWS, np.int32), rows[:MAIN_ROWS])
    if kw.get("rescoring", True):
        assert idx.maintain() and idx.nlist > 0 and idx.main_vecs is not None
    n = rows.shape[0]
    idx.upsert_batch(np.arange(MAIN_ROWS, n), np.ones(n - MAIN_ROWS, np.int32), rows[MAIN_ROWS:])
    results = idx.search(queries, K)
    assert all(r.slots.size == K for r in results)
    return np.stack([r.slots for r in results]), np.stack([r.distances for r in results]).astype(np.float64)


def dist_gap(rows, queries, slots, dists) -> float:
    ref, _ = reference.pair_distances(queries, rows[slots], "COSINE", CPU)
    return float(np.abs(dists - ref).max())


def recall(rows, queries, slots) -> float:
    want, _ = reference.exact_top_k(torch.from_numpy(rows), torch.from_numpy(queries), K, "COSINE")
    return float(np.mean([np.intersect1d(s, w).size / K for s, w in zip(slots, want)]))


def test_i8_ivf_matches_the_plain_reference():
    rows, queries = inputs()
    slots, dists = served(rows, queries)
    assert (slots >= MAIN_ROWS).any(), "the delta answered nothing"
    assert dist_gap(rows, queries, slots, dists) <= DIST_TOL
    assert recall(rows, queries, slots) >= RECALL_FLOOR


def test_storage_precision_distances_fail_the_tolerance():
    rows, queries = inputs()
    slots, dists = served(rows, queries, rescoring=False)
    assert dist_gap(rows, queries, slots, dists) > DIST_TOL
