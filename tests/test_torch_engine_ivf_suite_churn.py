"""Twins of tests/test_engine_ivf.py, part 2: dropped pairs and the slot
budget, delta churn, the failed-rebuild restore and duplicate slots, run
on the port's IvfDeviceIndex on torch.device("cpu") beside the JAX engine
built as the reference suite builds it (part 1,
tests/test_torch_engine_ivf_suite_lifecycle.py, states the tolerances of
all three parts; part 3, tests/test_torch_engine_ivf_suite_reentry.py,
holds the post-swap re-entry cases).

| reference case | port test |
|---|---|
| TestIvfDroppedPairs::test_duplicate_heavy_batch_retries | test_duplicate_heavy_batch_retries (and tests/test_torch_engine_ivf.py::test_loaded_state_serves_like_jax) |
| TestIvfDroppedPairs::test_slot_budget_escalates_after_drops | test_slot_budget_escalates_after_drops |
| TestIvfDroppedPairs::test_exact_host_escalation | test_exact_host_escalation |
| TestIvfDeltaChurn::test_delta_positions_recycled | test_delta_positions_recycled |
| TestIvfRebuildFailure::test_failed_rebuild_restores_and_keeps_serving | test_failed_rebuild_restores_and_keeps_serving (the reference's failure, and one inside the swap) |
| TestIvfDuplicateSlots::test_upsert_duplicates_last_wins | test_upsert_duplicates_last_wins |

Also here: test_global_only_errors_and_ignored_partitions_like_jax, both
engines through the constructor's refusal of an unsupported kind, a
search that names a partition, and an upsert that carries partitions.

Tolerances: as in part 1. Exact paths compare slots, epochs, sizes and the
counters (``dropped_pair_queries``, ``s_boost``, the delta's positions)
equal; rows at equal distance (the point-mass rows) compare as sets of
(distance, slot). After the port's own rebuild, the facts each case
asserts hold on both engines.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_ivf_suite import (  # noqa: E402,F401
    CPU,
    assert_same,
    assert_same_up_to_ties,
    both_built,
    clustered,
    exact_topk,
    ingest,
    interp_pallas,
    jax_index,
    port_index,
)
from torch_parity import to_jax  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex  # noqa: E402



# -- TestIvfDroppedPairs -------------------------------------------------------------


def skewed_pair():
    """16 clusters of 2048 rows at nprobe 4; 128 identical queries
    saturate the probed clusters' S query slots (S = 16 << 128)."""
    n, d = 2048, 16
    vecs, _ = clustered(n, d, n_clusters=16)
    j, p = both_built(vecs, 0, d, nprobe=4)
    q = vecs[11] + 0.01
    gt = exact_topk(q[None, :], vecs, 5, SpaceType.EUCLIDEAN)[0]
    return j, p, np.repeat(q[None, :], 128, axis=0), gt


def test_duplicate_heavy_batch_retries(interp_pallas):
    """The grouped scan drops the overflow pairs, and the engine must
    detect it and re-dispatch those queries."""
    j, p, batch, gt = skewed_pair()
    res = p.search(batch, 5)
    assert p.dropped_pair_queries > 0, "test setup no longer provokes drops; shrink S or grow the batch"
    assert_same(res, j.search(batch, 5))
    assert p.dropped_pair_queries == j.dropped_pair_queries
    for r in res:
        # every duplicate query gets the SAME, correct top-1
        assert r.slots.size >= 1
        assert r.slots[0] == gt[0]


def test_slot_budget_escalates_after_drops(interp_pallas):
    """The first dropping batch bumps s_boost, and the SAME batch searched
    again at the escalated budget produces zero drops (s caps at the batch,
    where drops are impossible: one pair per query per cluster). Both
    engines take the same budget and boost after every search."""
    j, p, batch, gt = skewed_pair()
    assert p.s_boost == j.s_boost == 1
    assert p._serving_s(128) == j._serving_s(128)
    assert_same(p.search(batch, 5), j.search(batch, 5))
    assert p.dropped_pair_queries == j.dropped_pair_queries > 0
    assert p.s_boost == j.s_boost > 1, "drops must escalate the slot budget"
    assert p._serving_s(128) == j._serving_s(128) == 128
    before = p.dropped_pair_queries
    res = p.search(batch, 5)
    assert_same(res, j.search(batch, 5))
    assert p.dropped_pair_queries == j.dropped_pair_queries == before, (
        "escalated budget should serve the same skewed batch drop-free"
    )
    assert p.s_boost == j.s_boost
    for r in res:
        assert r.slots[0] == gt[0]


def test_exact_host_escalation(interp_pallas):
    n, d, k = 2048, 16, 50
    vecs, _ = clustered(n, d)
    j, p = both_built(vecs, 4, d)
    q = vecs[123] + 0.01
    res = p.search_exact_host(q, k)
    assert_same([res], [j.search_exact_host(q, k)])
    gt = exact_topk(q[None, :], vecs, k, SpaceType.EUCLIDEAN)[0]
    assert res.slots.tolist() == gt.tolist()
    assert (res.epochs == 4).all()
    assert (np.diff(res.distances) >= -1e-6).all()
    # full-index k: complete ranking, no device programs involved
    res_all = p.search_exact_host(q, n)
    assert res_all.slots.size == n
    assert_same([res_all], [j.search_exact_host(q, n)])


# -- TestIvfDeltaChurn ------------------------------------------------------------------


def test_delta_positions_recycled(interp_pallas):
    """remove/re-add churn on a small (never rebuilt) index must not grow
    the delta: freed positions are recycled, in the JAX engine's order."""
    rng = np.random.default_rng(77)
    d, n = 16, 256
    j, p = jax_index(d, min_build=10**9), port_index(d, min_build=10**9)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    ingest((j, p), np.arange(n), np.zeros(n), vecs)
    high = p._delta_next
    cap0 = p._delta.capacity
    churn = rng.normal(size=(50, 64, d)).astype(np.float32)
    for i in range(50):
        for eng in (j, p):
            eng.remove_batch(np.arange(0, 64))
        ingest((j, p), np.arange(0, 64), np.full(64, i + 1), churn[i])
    assert p._delta_next == j._delta_next == high  # all churn reused freed positions
    assert p._delta.capacity == cap0
    np.testing.assert_array_equal(p._delta_free, j._delta_free)
    np.testing.assert_array_equal(p._pos[:n], j._pos[:n])
    assert p.size == j.size == n
    q = np.asarray(p._vecs_host[3])[None, :].repeat(8, 0)
    r = p.search(q, 3)
    assert_same(r, j.search(q, 3), norm2=(churn**2).sum(-1).max())
    assert r[0].slots[0] == 3 and r[0].epochs[0] == 50


# -- TestIvfRebuildFailure ----------------------------------------------------------------


@pytest.mark.parametrize("where", ["spill_reentry", "swap"])
def test_failed_rebuild_restores_and_keeps_serving(interp_pallas, monkeypatch, where):
    """A rebuild that throws must restore the previous main + delta and
    keep serving them; maintain() answers False, as the JAX engine's, and
    a later rebuild succeeds. ``spill_reentry`` fails where the reference
    case does, in the fresh delta's device-side spill ingest (the arrays
    slice on both engines: FlatDeviceIndex.upsert_bulk_device);
    ``swap`` fails the port's swap itself after it replaced the main
    region (its tombstone of the snapshot's stale rows), which the
    snapshot taken before the swap must undo. The JAX engine always takes
    the reference's failure; both restored engines answer id for id."""
    from vector_store_tpu.engine.flat import FlatDeviceIndex as JaxFlat
    from vector_store_tpu_torch.engine.flat import FlatDeviceIndex

    n, d = 2048, 32
    vecs, _ = clustered(n, d)
    j, p = both_built(vecs, 1, d)
    extra, _ = clustered(1200, d, seed=5)
    ingest((j, p), np.arange(n, n + 1200), np.zeros(1200), extra)
    # a point mass larger than any cmax guarantees cluster overflow, so the
    # spill re-entry is certain to fire
    mass = np.full((300, d), 55.0, np.float32)
    ingest((j, p), np.arange(n + 1200, n + 1500), np.zeros(300), mass)
    size_before = p.size
    assert size_before == j.size

    # start a budgeted rebuild, mutate mid-build, then make the rebuild
    # throw once
    for eng in (j, p):
        assert eng.maintain(budget=1) is True
        assert eng._build is not None
    new5 = np.full((1, d), 77.0, np.float32)
    ingest((j, p), [5], [9], new5)

    calls = {"jax": 0, "port": 0}

    def boom(side):
        def fail(*a, **kw):
            calls[side] += 1
            raise RuntimeError("injected rebuild failure")

        return fail

    port_target = (FlatDeviceIndex, "upsert_bulk_device") if where == "spill_reentry" else (
        IvfDeviceIndex, "_tombstone_main"
    )
    with monkeypatch.context() as m:
        m.setattr(JaxFlat, "upsert_bulk_device", boom("jax"))
        m.setattr(*port_target, boom("port"))
        for eng in (j, p):
            while eng._build is not None:
                if not eng.maintain(budget=1):
                    break
    assert calls == {"jax": 1, "port": 1}  # the injected failure fired once on each
    assert p._build is None and j._build is None
    # NOT disabled: the old main region serves (the JAX engine's _ivf_ok)
    assert j._ivf_ok is True
    assert p.main_vecs is not None and p.build_failures == 1
    assert p.maintain_pending() == "start"  # the rebuild is due again
    assert p.size == j.size == size_before
    # old state serves: pre-rebuild rows AND the mid-build mutation
    r = p.search(new5.repeat(8, axis=0), 3)
    assert_same_up_to_ties(r, j.search(new5.repeat(8, axis=0), 3))  # the mass rows tie
    assert r[0].slots[0] == 5 and r[0].epochs[0] == 9
    r = p.search(extra[:8], 3)
    assert_same(r, j.search(extra[:8], 3))
    assert r[0].slots[0] == n
    # and a later rebuild succeeds cleanly
    for eng in (j, p):
        assert eng.maintain() is True
        r = eng.search(new5.repeat(8, axis=0), 3)[0]
        assert r.slots[0] == 5 and r.epochs[0] == 9
    assert p.build_failures == 1 and p.size == j.size == size_before


# -- TestIvfDuplicateSlots -----------------------------------------------------------------


def test_upsert_duplicates_last_wins(interp_pallas):
    rng = np.random.default_rng(77)
    n, d = 512, 16
    j, p = jax_index(d), port_index(d)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    ingest((j, p), np.arange(n), np.zeros(n), vecs)
    v2 = np.full((d,), 7.0, np.float32)
    ingest((j, p), [3, 3], [1, 2], np.stack([vecs[3], v2]))
    assert p.size == j.size == n
    q = np.repeat(v2[None, :], 8, axis=0)
    res = p.search(q, 1)
    assert_same(res, j.search(q, 1), norm2=float(v2 @ v2))
    assert res[0].slots[0] == 3 and res[0].epochs[0] == 2
    for eng in (j, p):
        eng.remove_batch(np.asarray([3, 3]))
    assert p.size == j.size == n - 1


# -- the errors of a global-only engine ------------------------------------------------------


def test_global_only_errors_and_ignored_partitions_like_jax(interp_pallas):
    """Both engines refuse an unsupported kind and a search that names a
    partition with the same ValueError, and take an upsert's partitions
    and ignore them."""
    from vector_store_tpu.engine.ivf import IvfDeviceIndex as JaxIvf

    errors = []
    for cls, kw, q in ((JaxIvf, {}, to_jax(Quantization.B1)), (IvfDeviceIndex, {"device": CPU}, Quantization.B1)):
        with pytest.raises(ValueError, match="IVF engine supports float/i8 quantizations") as exc:
            cls(8, quantization=q, **kw)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]

    n, d = 64, 16
    vecs, _ = clustered(n, d, seed=3)
    j, p = jax_index(d), port_index(d)
    plain = port_index(d)
    parts = np.arange(n) % 4
    for eng in (j, p):
        eng.upsert_batch(np.arange(n), np.zeros(n, np.int32), vecs, partitions=parts)
    plain.upsert_batch(np.arange(n), np.zeros(n, np.int32), vecs)
    assert p.size == j.size == n
    res = p.search(vecs[:8], 5)
    assert_same(res, plain.search(vecs[:8], 5))
    assert_same(res, j.search(vecs[:8], 5), norm2=(vecs**2).sum(1).max())
    for eng in (j, p):
        with pytest.raises(ValueError, match="IVF engine serves global indexes only"):
            eng.search(vecs[:1], 1, partitions=np.array([3]))
        # -1 names no partition: a global query
        assert_same(eng.search(vecs[:1], 1, partitions=np.array([-1])), eng.search(vecs[:1], 1))
