"""Twins of tests/test_engine_ivf.py, part 1: build and search, the
lifecycle, the ops and I8 storage, run on the port's IvfDeviceIndex on
torch.device("cpu") beside the JAX engine built as the reference suite
builds it (interpret mode, exact selectors, no int8 query uplink). Part 2,
tests/test_torch_engine_ivf_suite_churn.py, holds the rest of the suite.

Every case of the reference classes below, and what holds it here:

| reference case | port test |
|---|---|
| TestIvfBuildAndSearch::test_recall_after_build | test_recall_after_build |
| TestIvfBuildAndSearch::test_delegate_before_build | test_delegate_before_build |
| TestIvfBuildAndSearch::test_sampled_kmeans_rebuild | test_sampled_kmeans_rebuild |
| TestIvfBuildAndSearch::test_cosine_space | test_cosine_space |
| TestIvfLifecycle::test_upsert_after_build_lands_in_delta | test_upsert_after_build_lands_in_delta |
| TestIvfLifecycle::test_remove_from_main_and_delta | test_remove_from_main_and_delta |
| TestIvfLifecycle::test_upsert_main_slot_moves_to_delta | test_upsert_main_slot_moves_to_delta |
| TestIvfLifecycle::test_incremental_rebuild_merges_delta | test_incremental_rebuild_merges_delta |
| TestIvfLifecycle::test_sliced_rebuild_with_mid_build_mutations | test_sliced_rebuild_with_mid_build_mutations |
| TestIvfLifecycle::test_allow_mask | tests/test_torch_masked_filter.py::test_partial_probe_masked_ids_match_jax and ::test_full_probe_masked_ids_are_exact |
| TestIvfLifecycle::test_collect_many_mixed | test_collect_many_mixed |
| TestIvfLifecycle::test_device_bytes_and_size | test_device_bytes_and_size |
| TestIvfOps::test_ivf_layout_overflow | test_ivf_layout_overflow |
| TestIvfOps::test_ivf_layout_second_choice | test_ivf_layout_second_choice (and tests/test_torch_grouped_scan.py::test_layout_places_overflow_in_second_choice) |
| TestIvfOps::test_kmeans_clusters_separate_data | test_kmeans_clusters_separate_data |
| TestIvfOps::test_regroup_packed_matches_argsort_fallback | test_regroup_packed_matches_argsort_fallback (and tests/test_torch_grouped_scan.py::test_regroup_is_first_come_within_cluster) |
| TestIvfOps::test_ivf_candidates_approx_matches_exact_on_cpu | skipped: do not carry over (approx_max_k) |
| TestIvfOps::test_choose_geometry | test_choose_geometry |
| TestIvfI8::test_i8_recall (3 spaces) | test_i8_recall (3 spaces) |
| TestIvfI8::test_i8_delta_and_main_merge | test_i8_delta_and_main_merge |
| TestIvfI8::test_ivf_supports_i8 | test_ivf_supports_i8 |
| TestIvfI8::test_windowed_upload_matches_plain_search | skipped: do not carry over (the super-batch query upload) |
| TestIvfI8::test_windowed_upload_delegate_path | skipped: do not carry over (the super-batch query upload) |
| TestIvfI8::test_u24_id_packing_roundtrip | skipped: do not carry over (u24 id packing) |

Each twin runs the reference case's steps on the port and keeps its
assertions. Tolerances, by path:

- Exact paths (the delta below min_build, a state loaded from the JAX
  engine through ``load_state``, ``search_exact_host``, the ops): slots,
  epochs, sizes and counters equal; distances within 1e-5 * (1 + |d|),
  plus 1e-6 times the rows' largest squared norm below a build, where the
  JAX engine answers with its delta's f32 device distances. Both deltas
  scan in blocks of 256 rows, so kernel 1's lane minima fall alike.
- The port's own k-means build (seeded from a strided sample; the JAX
  engine's from jax.random): recall@k against the exact numpy oracle no
  lower than the case's threshold and than the JAX engine's recall minus
  0.01; after a rebuild, the facts the case asserts (a row found first
  with its epoch, a removed row gone, the size) hold on both engines.
- I8: the main region's bf16 products round like the JAX engine's only
  within a bf16 step, so loaded I8 state is compared by each row's first
  hit and epoch, not id for id.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from torch_ivf_suite import (  # noqa: E402,F401
    DELTA,
    MAIN,
    NOT_CARRIED,
    assert_same,
    both_built,
    clustered,
    exact_topk,
    ingest,
    interp_pallas,
    jax_index,
    port_index,
    recall,
)
from torch_parity import to_jax  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402



# -- TestIvfBuildAndSearch ------------------------------------------------------


def test_recall_after_build(interp_pallas):
    n, d, b, k = 4096, 32, 32, 10
    rng = np.random.default_rng(77)
    vecs, _ = clustered(n, d)
    j, p = jax_index(d), port_index(d)
    ingest((j, p), np.arange(n), np.full(n, 5), vecs)
    assert p.main_vecs is None
    assert j.maintain() is True and p.maintain() is True
    assert p.main_vecs is not None and p.nlist == j.nlist
    assert p.nlist >= 64 or p.nlist == 64
    queries = vecs[rng.integers(0, n, size=b)] + 0.05 * rng.normal(size=(b, d)).astype(np.float32)
    res = p.search(queries, k)
    gt = exact_topk(queries, vecs, k, SpaceType.EUCLIDEAN)
    got, want = recall(res, gt), recall(j.search(queries, k), gt)
    assert got >= 0.85 and got >= want - 0.01, (got, want)
    for r in res:
        assert (r.epochs == 5).all()
        assert (np.diff(r.distances) >= -1e-6).all()


def test_delegate_before_build(interp_pallas):
    n, d, b, k = 512, 32, 16, 5
    vecs, _ = clustered(n, d)
    j, p = jax_index(d, min_build=10**9), port_index(d, min_build=10**9)
    ingest((j, p), np.arange(n) * 3, np.full(n, 2), vecs)
    assert p.maintain() is False and j.maintain() is False  # below min_build
    res = p.search(vecs[:b], k)
    assert_same(res, j.search(vecs[:b], k), norm2=(vecs**2).sum(1).max())
    for i, r in enumerate(res):
        assert r.slots[0] == i * 3  # slot translation delta pos -> slot
        assert r.distances[0] == pytest.approx(0.0, abs=1e-3)
        assert (r.epochs == 2).all()


def test_sampled_kmeans_rebuild(interp_pallas):
    """Rebuilds above the sample cap cluster on a row sample and label the
    full set in one assignment pass; recall must hold."""
    n, d, b, k = 4096, 32, 16, 10
    rng = np.random.default_rng(78)
    vecs, _ = clustered(n, d)
    j, p = jax_index(d, kmeans_sample_cap=1024), port_index(d, kmeans_sample_cap=1024)
    ingest((j, p), np.arange(n), np.zeros(n), vecs)
    assert j.maintain() and p.maintain()
    queries = vecs[rng.integers(0, n, size=b)]
    gt = exact_topk(queries, vecs, k, SpaceType.EUCLIDEAN)
    got, want = recall(p.search(queries, k), gt), recall(j.search(queries, k), gt)
    assert got >= 0.8 and got >= want - 0.01, (got, want)


def test_cosine_space(interp_pallas):
    n, d, b, k = 2048, 32, 16, 5
    vecs, _ = clustered(n, d)
    j, p = jax_index(d, SpaceType.COSINE), port_index(d, SpaceType.COSINE)
    ingest((j, p), np.arange(n), np.zeros(n), vecs)
    assert j.maintain() and p.maintain()
    queries = vecs[:b]
    res = p.search(queries, k)
    gt = exact_topk(queries, vecs, k, SpaceType.COSINE)
    got, want = recall(res, gt), recall(j.search(queries, k), gt)
    assert got >= 0.8 and got >= want - 0.01, (got, want)
    for r in res:
        assert (r.distances >= -1e-6).all() and (r.distances <= 2.0).all()


# -- TestIvfLifecycle (the JAX engine's build, loaded into the port) -------------


def built(n=2048, d=32):
    vecs, _ = clustered(n, d)
    j, p = both_built(vecs, 1, d)
    return j, p, vecs


def test_upsert_after_build_lands_in_delta(interp_pallas):
    j, p, vecs = built()
    n, d = vecs.shape
    new = np.random.default_rng(5).normal(size=(8, d)).astype(np.float32) * 20 + 100
    ingest((j, p), np.arange(n, n + 8), np.full(8, 9), new)
    assert p.size == j.size == n + 8
    res = p.search(new, 3)
    assert_same(res, j.search(new, 3))
    for i, r in enumerate(res):
        assert r.slots[0] == n + i
        assert r.epochs[0] == 9
        assert r.distances[0] == pytest.approx(0.0, abs=1e-2)


def test_remove_from_main_and_delta(interp_pallas):
    j, p, vecs = built()
    n, d = vecs.shape
    # remove a main-resident slot
    assert p._region[7] == j._region[7] == MAIN
    for eng in (j, p):
        eng.remove_batch(np.asarray([7]))
    q = vecs[7:8].repeat(8, axis=0)
    res = p.search(q, 5)
    assert_same(res, j.search(q, 5))
    assert not any(7 in r.slots for r in res)
    # add to delta, then remove
    new = np.full((1, d), 55.0, np.float32)
    ingest((j, p), [n], [1], new)
    for eng in (j, p):
        eng.remove_batch(np.asarray([n]))
    res = p.search(new.repeat(8, axis=0), 5)
    assert_same(res, j.search(new.repeat(8, axis=0), 5))
    assert not any(n in r.slots for r in res)
    assert p.size == j.size == vecs.shape[0] - 1


def test_upsert_main_slot_moves_to_delta(interp_pallas):
    j, p, vecs = built()
    d = vecs.shape[1]
    new = np.full((1, d), -40.0, np.float32)
    ingest((j, p), [3], [8], new)
    assert p._region[3] == j._region[3] == DELTA
    res = p.search(new.repeat(8, axis=0), 3)
    assert_same(res, j.search(new.repeat(8, axis=0), 3))
    assert res[0].slots[0] == 3 and res[0].epochs[0] == 8
    # the OLD vector at slot 3 must not be findable anymore
    res_old = p.search(vecs[3:4].repeat(8, axis=0), 5)
    assert_same(res_old, j.search(vecs[3:4].repeat(8, axis=0), 5))
    for r in res_old:
        if 3 in r.slots:
            # it's the new value's distance, not the old one's
            assert r.distances[list(r.slots).index(3)] > 1.0


def test_incremental_rebuild_merges_delta(interp_pallas):
    j, p, vecs = built()
    n, d = vecs.shape
    extra, _ = clustered(1200, d, seed=9)
    ingest((j, p), np.arange(n, n + 1200), np.zeros(1200), extra)
    assert p.maintain() is True and j.maintain() is True  # delta > 20% of live
    # only cluster-overflow spill remains in the delta (< 2% of rows)
    assert int((p._region == DELTA).sum()) <= (n + 1200) * 0.02
    assert p.size == j.size == n + 1200
    for eng in (j, p):
        res = eng.search(extra[:8], 3)
        assert [r.slots[0] for r in res] == list(range(n, n + 8))
        assert all(r.epochs[0] == 0 for r in res)


def test_sliced_rebuild_with_mid_build_mutations(interp_pallas):
    """Budgeted maintain() advances the rebuild one bounded slice at a time;
    upserts/removes landing between slices must be reconciled at swap
    (stale snapshot copies tombstoned, current values served). Both engines
    record the same dirty slots and serve the same slots and epochs."""
    j, p, vecs = built()
    n, d = vecs.shape
    extra, _ = clustered(1200, d, seed=11)
    ingest((j, p), np.arange(n, n + 1200), np.zeros(1200), extra)
    for eng in (j, p):
        assert eng.maintain(budget=1) is True  # snapshot slice
        assert eng._build is not None
    # mutations between slices
    new5 = np.full((1, d), 77.0, np.float32)
    ns = n + 1200
    new_row = np.full((1, d), -88.0, np.float32)
    for eng in (j, p):
        eng.upsert_batch(np.asarray([5]), np.asarray([9]), new5)
        eng.remove_batch(np.asarray([6]))
        eng.upsert_batch(np.asarray([ns]), np.asarray([3]), new_row)
    assert p._build["dirty"] == j._build["dirty"] == {5, 6, ns}
    for eng in (j, p):
        steps = 0
        while eng._build is not None:
            assert eng.maintain(budget=1) is True
            steps += 1
        assert steps >= 1
        # the swap queued the mid-build mutations for bounded re-entry:
        # during the lag window the STALE snapshot copy of slot 5 must not
        # serve
        assert eng.maintain_pending() == "reenter"
        for rr in eng.search(vecs[5:6].repeat(8, axis=0), 10):
            for s, dist in zip(rr.slots, rr.distances):
                if s == 5:
                    assert dist > 1.0
        while eng.maintain_pending() == "reenter":
            assert eng.maintain(budget=1) is True
    for q, slot, epoch, k in ((new5, 5, 9, 3), (new_row, ns, 3, 1)):
        got, want = p.search(q.repeat(8, axis=0), k)[0], j.search(q.repeat(8, axis=0), k)[0]
        # the upserted value and the slot created mid-build serve with their epochs
        assert got.slots[0] == want.slots[0] == slot and got.epochs[0] == want.epochs[0] == epoch
        assert got.distances[0] == pytest.approx(0.0, abs=1e-2)
    # removed slot is gone
    assert not any(6 in rr.slots for rr in p.search(vecs[6:7].repeat(8, axis=0), 5))
    # the stale snapshot copy of slot 5 must not serve at distance 0
    for rr in p.search(vecs[5:6].repeat(8, axis=0), 10):
        for s, dist in zip(rr.slots, rr.distances):
            if s == 5:
                assert dist > 1.0
    assert p.size == j.size == n + 1200 + 1 - 1
    np.testing.assert_array_equal(p._epochs_host[[5, ns]], j._epochs_host[[5, ns]])


def test_collect_many_mixed(interp_pallas):
    j, p, vecs = built()
    out = p.collect_many([p.search_begin(vecs[:8], 3), p.search_begin(vecs[8:16], 3)])
    want = j.collect_many([j.search_begin(vecs[:8], 3), j.search_begin(vecs[8:16], 3)])
    for got_batch, want_batch in zip(out, want):
        assert_same(got_batch, want_batch)
    assert out[0][0].slots[0] == 0
    assert out[1][0].slots[0] == 8


def test_device_bytes_and_size(interp_pallas):
    j, p, vecs = built()
    assert p.size == j.size == vecs.shape[0]
    assert p.device_bytes > 0


# -- TestIvfOps --------------------------------------------------------------------


def test_ivf_layout_overflow():
    from vector_store_tpu.ops.ivf import ivf_layout as jax_layout
    from vector_store_tpu_torch.ops.ivf import ivf_layout

    labels = np.array([0, 0, 0, 1, 1, 2], dtype=np.int32)
    live = np.array([1, 1, 1, 1, 0, 1], dtype=bool)
    pos, overflow = (x.numpy() for x in ivf_layout(torch.from_numpy(labels), torch.from_numpy(live), nlist=4, cmax=2))
    jpos, joverflow = jax_layout(jnp.asarray(labels), jnp.asarray(live), nlist=4, cmax=2)
    np.testing.assert_array_equal(pos, np.asarray(jpos))
    np.testing.assert_array_equal(overflow, np.asarray(joverflow))
    # cluster 0 holds rows 0,1 at positions 0,1; row 2 overflows
    assert set(pos[:2].tolist()) == {0, 1}
    assert pos[2] == -1 and overflow[2]
    assert pos[3] == 2  # cluster 1 first slot
    assert pos[4] == -1 and not overflow[4]  # dead row: no spill
    assert pos[5] == 4  # cluster 2 first slot


def test_ivf_layout_second_choice():
    from vector_store_tpu.ops.ivf import ivf_layout as jax_layout
    from vector_store_tpu_torch.ops.ivf import ivf_layout

    def both(labels, labels2, nlist):
        labels, labels2 = np.asarray(labels, np.int32), np.asarray(labels2, np.int32)
        live = np.ones(labels.shape, bool)
        pos, overflow = ivf_layout(
            torch.from_numpy(labels), torch.from_numpy(live), nlist=nlist, cmax=2,
            labels2=torch.from_numpy(labels2),
        )
        jpos, joverflow = jax_layout(
            jnp.asarray(labels), jnp.asarray(live), nlist=nlist, cmax=2, labels2=jnp.asarray(labels2)
        )
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(overflow.numpy(), np.asarray(joverflow))
        return pos.numpy(), overflow.numpy()

    pos, overflow = both([0, 0, 0, 0, 1, 3], [1, 1, 1, 2, 0, 0], 4)
    # rows 0,1 fill cluster 0; row 4 takes cluster 1 slot 0 (round 1).
    assert set(pos[:2].tolist()) == {0, 1}
    assert pos[4] == 2
    assert pos[5] == 6  # cluster 3 first slot
    # overflow rows 2,3: row 2 -> cluster 1 after its round-1 row
    # (position 3); row 3 -> cluster 2 (empty, position 4)
    assert pos[2] == 3 and not overflow[2]
    assert pos[3] == 4 and not overflow[3]
    # second choice saturated: three rows overflowing into one single-slot
    # cluster spill the losers to the delta
    pos, overflow = both([0, 0, 0, 0], [1, 1, 1, 1], 2)
    assert set(pos[:2].tolist()) == {0, 1}
    assert (pos[2:] >= 0).sum() == 2  # both cluster-1 slots taken
    assert overflow.sum() == 0
    _, overflow = both([0, 0, 0, 0, 0], [1, 1, 1, 1, 1], 2)
    assert overflow.sum() == 1  # one loser spills


def test_kmeans_clusters_separate_data():
    from vector_store_tpu_torch.ops.ivf import kmeans

    rng = np.random.default_rng(77)
    n, d = 1024, 16
    half = n // 2
    x = np.zeros((n, d), np.float32)
    x[:half] = 10.0 + rng.normal(size=(half, d)).astype(np.float32)
    x[half:] = -10.0 + rng.normal(size=(half, d)).astype(np.float32)
    # the port draws its seed rows with a torch.Generator (the JAX engine
    # with jax.random); any seed must separate the blobs
    for seed in range(4):
        _, labels = kmeans(
            torch.from_numpy(x), torch.ones((n,)), nlist=2, iters=5, block=256,
            generator=torch.Generator().manual_seed(seed),
        )
        labels = labels.numpy()
        # the two blobs must not share a label
        assert len(set(labels[:half].tolist())) == 1
        assert len(set(labels[half:].tolist())) == 1
        assert labels[0] != labels[-1]


def test_regroup_packed_matches_argsort_fallback():
    """The port has one regroup (a stable sort); it assigns exactly the
    slots of both JAX paths (the packed-key sort and the argsort fallback
    rank pairs by (cluster, pair index))."""
    from vector_store_tpu.ops.ivf import _regroup_pairs
    from vector_store_tpu_torch.ops.ivf import regroup_pairs

    rng = np.random.default_rng(77)
    b, nprobe, nlist, s = 64, 8, 16, 16  # saturates several clusters
    probes = rng.integers(0, nlist + 1, size=(b, nprobe)).astype(np.int32)  # sentinel ids == nlist
    got = [x.numpy() for x in regroup_pairs(torch.from_numpy(probes), nlist=nlist, s=s)]
    for fallback in (False, True):
        want = _regroup_pairs(jnp.asarray(probes), nlist=nlist, s=s, nprobe=nprobe, force_fallback=fallback)
        for a, c in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(c))
    qtab, filled, row_of_pair = got
    # every filled slot's qtab entry must point at a query whose row_of_pair
    # maps back to that slot
    for r in np.flatnonzero(filled).tolist():
        assert r in row_of_pair[qtab[r]].tolist()


@pytest.mark.skip(reason=NOT_CARRIED + "approx_max_k (VECTOR_STORE_IVF_APPROX) has no torch counterpart")
def test_ivf_candidates_approx_matches_exact_on_cpu():
    pass


def test_choose_geometry():
    from vector_store_tpu.ops import ivf as jivf
    from vector_store_tpu_torch.ops.ivf import choose_budget, choose_cmax, choose_nlist

    assert choose_nlist(1_000_000) == 2048
    assert choose_nlist(1000) == 64
    cmax = choose_cmax(1_000_000, 2048)
    assert cmax % 128 == 0 and cmax * 2048 >= 1_000_000
    s = choose_budget(2048, 32, 1024)
    assert s >= 2 * (2048 * 32 // 1024) and s % 16 == 0
    # nlist and the slot budget are the JAX package's rules (cmax rounds up
    # to whole lane groups instead of the JAX shape ladder)
    for n in (0, 1000, 4096, 65_536, 1_000_000, 10_000_000):
        assert choose_nlist(n) == jivf.choose_nlist(n)
    for b, nprobe, nlist in ((2048, 32, 1024), (128, 4, 64), (4096, 32, 2048), (1, 16, 8192)):
        assert choose_budget(b, nprobe, nlist) == jivf.choose_budget(b, nprobe, nlist)


# -- TestIvfI8 ---------------------------------------------------------------------


@pytest.mark.parametrize("space", [SpaceType.EUCLIDEAN, SpaceType.COSINE, SpaceType.DOT_PRODUCT])
def test_i8_recall(interp_pallas, space):
    n, d, b, k = 4096, 32, 24, 10
    rng = np.random.default_rng(77)
    vecs, _ = clustered(n, d)
    if space is not SpaceType.COSINE:
        # I8 storage takes [-1, 1] -> [-127, 127]: euclidean/dot inputs are
        # pre-scaled into range (cosine normalizes first)
        vecs = vecs / np.abs(vecs).max()
    j, p = jax_index(d, space, Quantization.I8), port_index(d, space, Quantization.I8)
    ingest((j, p), np.arange(n), np.full(n, 3), vecs)
    assert p.maintain() is True and j.maintain() is True
    assert p.main_vecs is not None and p.main_vecs.dtype == torch.int8
    queries = vecs[rng.integers(0, n, size=b)] + 0.02 * rng.normal(size=(b, d)).astype(np.float32)
    res = p.search(queries, k)
    if space is SpaceType.DOT_PRODUCT:
        gt = np.argsort(1.0 - queries @ vecs.T, axis=1)[:, :k]
    else:
        gt = exact_topk(queries, vecs, k, space)
    got, want = recall(res, gt), recall(j.search(queries, k), gt)
    assert got >= 0.8 and got >= want - 0.01, (space, got, want)
    for r in res:
        assert (r.epochs == 3).all()
        assert (np.diff(r.distances) >= -1e-6).all()


def test_i8_delta_and_main_merge(interp_pallas):
    """Post-build upserts land in the I8 delta and merge with main-region
    candidates; distances are exact f32 from the host mirror."""
    n, d = 2048, 32
    vecs, _ = clustered(n, d)
    vecs = vecs / np.abs(vecs).max()  # I8 storage expects [-1, 1]
    j, p = both_built(vecs, 0, d, SpaceType.EUCLIDEAN, Quantization.I8)
    assert p._delta.rescore
    new = np.random.default_rng(5).normal(size=(8, d)).astype(np.float32) * 0.02 + 0.9  # inside the i8 range
    ingest((j, p), np.arange(n, n + 8), np.full(8, 7), new)
    for eng in (j, p):
        for i, r in enumerate(eng.search(new, 3)):
            assert r.slots[0] == n + i
            assert r.epochs[0] == 7
            assert r.distances[0] == pytest.approx(0.0, abs=1e-5)


def test_ivf_supports_i8():
    from vector_store_tpu.engine.ivf import ivf_supports as jax_supports
    from vector_store_tpu_torch.engine.ivf import ivf_supports

    assert ivf_supports(SpaceType.COSINE, Quantization.I8)
    assert ivf_supports(SpaceType.EUCLIDEAN, Quantization.I8)
    assert not ivf_supports(SpaceType.HAMMING, Quantization.I8)
    assert not ivf_supports(SpaceType.COSINE, Quantization.B1)
    for space in SpaceType:
        for quant in Quantization:
            assert ivf_supports(space, quant) == jax_supports(to_jax(space), to_jax(quant))


@pytest.mark.skip(reason=NOT_CARRIED + "the super-batch query upload (upload_queries, split_query_windows)")
def test_windowed_upload_matches_plain_search():
    pass


@pytest.mark.skip(reason=NOT_CARRIED + "the super-batch query upload (upload_queries, split_query_windows)")
def test_windowed_upload_delegate_path():
    pass


@pytest.mark.skip(reason=NOT_CARRIED + "u24 id packing of the TPU relay's result pull")
def test_u24_id_packing_roundtrip():
    pass
