"""IVF engine: the port's IvfDeviceIndex against the JAX IvfDeviceIndex.

The JAX engine is built as tests/test_engine_ivf.py builds it (interpret
mode, exact selectors, no int8 query uplink); its state is carried into
the port with load_state (this removes k-means randomness from the
comparison), then both take the same upserts and removals and answer the
same queries: slots and epochs must be equal, distances within 1e-5.
The port's own k-means build must reach the JAX test's recall bar.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_parity import jax_state, to_jax  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex  # noqa: E402

CPU = torch.device("cpu")
N, D = 4096, 32
# delta scan block of both engines: fewer, larger blocks keep the JAX
# kernel's interpret-mode grid short (the rule is the same at any size)
DELTA_BLOCK = 8192


@pytest.fixture
def interp_pallas(monkeypatch):
    """Run the JAX flat engine's Pallas kernel in interpret mode (the IVF
    delta region goes through it)."""
    import vector_store_tpu.ops.pallas_scan as ps

    orig = ps.pallas_rank_search
    monkeypatch.setattr(
        ps, "pallas_rank_search", lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
    )


def clustered(n, d, n_clusters=64, seed=1):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 4
    assign = rng.integers(0, n_clusters, size=n)
    return centers[assign] + rng.normal(size=(n, d)).astype(np.float32)


def jax_index(space):
    from vector_store_tpu.engine.ivf import IvfDeviceIndex as JaxIvf

    return JaxIvf(
        D, space_type=to_jax(space), quantization=to_jax(Quantization.F32), initial_capacity=4096,
        min_build=1024, kmeans_block=1024, nprobe=16, kmeans_iters=4,
        interpret=True, query_i8=False, approx_select=False,
    )


def port_index(space, **kw):
    return IvfDeviceIndex(
        D, space_type=space, quantization=Quantization.F32, device=CPU,
        initial_capacity=4096, min_build=1024, kmeans_block=1024, nprobe=16,
        kmeans_iters=4, scan_block_rows=DELTA_BLOCK, **kw,
    )


def assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.slots, w.slots)
        np.testing.assert_array_equal(g.epochs, w.epochs)
        np.testing.assert_allclose(g.distances, w.distances, rtol=0, atol=1e-5)


@pytest.mark.parametrize("space", (SpaceType.EUCLIDEAN, SpaceType.COSINE))
def test_loaded_state_serves_like_jax(interp_pallas, space):
    rng = np.random.default_rng(2)
    vecs = clustered(N, D)
    j = jax_index(space)
    j.upsert_batch(np.arange(N), np.full(N, 5, np.int32), vecs)
    assert j.maintain() and j.main_vecs is not None
    j._delta.pallas_block = DELTA_BLOCK

    p = port_index(space)
    p.load_state(jax_state(j))
    assert (p.nlist, p.cmax, p.size) == (j.nlist, j.cmax, j.size)

    # the same delta traffic on both: new rows, updates of main rows, removals
    new = clustered(300, D, seed=3)
    new_slots = np.arange(N, N + 300)
    upd_slots = rng.choice(N, size=100, replace=False)
    gone = rng.choice(N, size=50, replace=False)
    for eng in (j, p):
        eng.upsert_batch(new_slots, np.full(300, 7, np.int32), new)
        eng.upsert_batch(upd_slots, np.full(100, 9, np.int32), vecs[upd_slots] + 0.1)
        eng.remove_batch(gone)
    assert p.size == j.size

    queries = np.concatenate([vecs[rng.integers(0, N, 24)], new[:8]]) + 0.05 * rng.normal(
        size=(32, D)
    ).astype(np.float32)
    assert_same_results(p.search(queries, 10), j.search(queries, 10))
    # a skewed batch: duplicates saturate cluster slots and take the retry path
    skew = np.repeat(queries[:2], 20, axis=0)
    assert_same_results(p.search(skew, 10), j.search(skew, 10))


def test_own_build_recall_and_lifecycle():
    n, b, k = N, 32, 10
    rng = np.random.default_rng(77)
    vecs = clustered(n, D)
    idx = port_index(SpaceType.EUCLIDEAN)
    idx.upsert_batch(np.arange(n), np.full(n, 5, np.int32), vecs)
    # below a build, the delta serves exactly (slot translation included)
    res = idx.search(vecs[:4], 3)
    assert [r.slots[0] for r in res] == [0, 1, 2, 3]
    assert idx.maintain_pending() == "start"
    while idx.maintain(budget=1):
        pass
    assert idx.main_vecs is not None and idx.maintain_pending() is None
    queries = vecs[rng.integers(0, n, size=b)] + 0.05 * rng.normal(size=(b, D)).astype(np.float32)
    res = idx.search(queries, k)
    gt = np.argsort(((queries[:, None, :] - vecs[None]) ** 2).sum(-1), axis=1)[:, :k]
    hits = sum(len(set(r.slots.tolist()) & set(g.tolist())) for r, g in zip(res, gt))
    assert hits / (b * k) >= 0.85, hits / (b * k)
    for r in res:
        assert (r.epochs == 5).all() and (np.diff(r.distances) >= -1e-6).all()

    # a row written mid-build lands through the dirty re-entry path
    idx.upsert_batch(np.arange(n, n + 2000), np.full(2000, 6, np.int32), clustered(2000, D, seed=4))
    assert idx.maintain_pending() == "start"
    idx.maintain(budget=1)  # snapshot taken
    idx.upsert_batch([0], [8], vecs[:1] * 3)
    idx.remove_batch([1])
    idx.maintain()
    res = idx.search(np.stack([vecs[0] * 3, vecs[1]]), 2)
    assert res[0].slots[0] == 0 and res[0].epochs[0] == 8
    assert 1 not in res[1].slots.tolist()
    assert idx.size == n + 2000 - 1


def test_exact_host_and_global_only_errors():
    """search_exact_host ranks every live row; a search naming a partition
    and an unsupported kind raise the JAX engine's ValueErrors (both
    engines side by side: tests/test_torch_engine_ivf_suite_churn.py)."""
    idx = port_index(SpaceType.COSINE)
    vecs = clustered(64, D)
    idx.upsert_batch(np.arange(64), np.zeros(64, np.int32), vecs)
    res = idx.search_exact_host(vecs[3], 64)
    assert res.slots[0] == 3 and res.slots.size == 64
    assert abs(res.distances[0]) < 1e-6
    with pytest.raises(ValueError, match="serves global indexes only"):
        idx.search(vecs[:1], 1, partitions=np.array([3]))
    with pytest.raises(ValueError, match="supports float/i8 quantizations"):
        IvfDeviceIndex(D, quantization=Quantization.B1, device=CPU)


def test_rows_written_mid_build_make_the_next_rebuild_due():
    """The rebuild floor: the rows of the delta right after a swap are that
    build's own spill; rows written during the build re-enter the delta
    after the swap and count as growth. More of them than
    max(kmeans_block, rebuild_fraction * live) make a rebuild due at once
    (the JAX engine raised its floor over them, and a first build that
    overlapped a long ingest left most rows in the delta for good)."""
    idx = port_index(SpaceType.EUCLIDEAN)
    idx.upsert_batch(np.arange(N), np.full(N, 5, np.int32), clustered(N, D))
    assert idx.maintain_pending() == "start"
    idx.maintain(budget=1)  # the snapshot
    m = 2000
    idx.upsert_batch(np.arange(N, N + m), np.full(m, 6, np.int32), clustered(m, D, seed=5))
    assert m > max(idx.kmeans_block, idx.rebuild_fraction * idx.size)
    while idx._build is not None:
        idx.maintain(budget=1)
    floor = idx._rebuild_floor
    assert floor == idx._delta_live() and idx.maintain_pending() == "reenter"
    while idx.maintain_pending() == "reenter":
        idx.maintain(budget=1)
    assert idx._delta_live() - floor >= m
    assert idx.maintain_pending() == "start"
    idx.maintain()
    assert idx._main_rows >= 0.8 * idx.size and idx._delta_live() < m
    assert idx.maintain_pending() is None
