"""Filtered ANN on the device: the port's engines against the JAX package's.

The same rows and masks, drawn with numpy from a seed, go to both sides.
The JAX IVF engine runs as tests/test_masked_filter.py runs it (interpret
mode, no int8 query uplink); its state is carried into the port with
load_state, so both search one clustering. The port's wrappers take their
plain versions for CPU tensors.

- IVF, a slot filter as an ndarray and as an AllowMaskHandle, 10% and
  0.1% of the rows allowed: with nprobe = nlist both sides return the ids
  of the exact filtered ranking; with nprobe < nlist the same ids as each
  other; below min_build (the delta answers alone) the same ids as each
  other, and only allowed rows.
- A row upserted into the delta after the handle was made is found; a
  matching row removed after the handle made its masked copy is gone (the
  port tombstones the main region in place, so the handle's copy must be
  made again); a batch whose pairs overflow their clusters' slots is
  retried with the filter, and returns only allowed rows and a full count.
- The flat engine with a mask (F32, BF16, I8) returns the JAX flat
  engine's ids, F32 distances within 1e-6; a masked query of a local
  index takes the masked scan, not the partition directory.
- search_exact_host_subset: distances within 1e-6 + 1e-5 |d| of the JAX
  engine's, epochs equal, +inf and -1 for dead and out-of-range slots.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_parity import jax_state, to_jax  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.engine.flat import FlatDeviceIndex  # noqa: E402
from vector_store_tpu_torch.engine.ivf import AllowMaskHandle, IvfDeviceIndex  # noqa: E402

CPU = torch.device("cpu")
D = 16
K = 10
FRACS = (0.1, 0.001)
DELTA_BLOCK = 256  # the JAX delta's Pallas block in interpret mode


@pytest.fixture
def interp_pallas(monkeypatch):
    """The JAX delta's Pallas scan in interpret mode."""
    import vector_store_tpu.ops.pallas_scan as ps

    orig = ps.pallas_rank_search
    monkeypatch.setattr(
        ps, "pallas_rank_search", lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
    )


def rows(n, seed=77):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def slot_mask(n, frac, seed):
    """A mask allowing round(frac * n) slots (at least one)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(n, dtype=bool)
    mask[rng.choice(n, size=max(1, round(frac * n)), replace=False)] = True
    return mask


def jax_ivf(n_build, min_build=256):
    from vector_store_tpu.engine.ivf import IvfDeviceIndex as JaxIvf

    return JaxIvf(
        D, space_type=to_jax(SpaceType.COSINE), quantization=to_jax(Quantization.F32),
        initial_capacity=4096, interpret=True, query_i8=False, min_build=min_build,
        kmeans_block=1024, kmeans_iters=2, approx_select=False,
    )


def ivf_pair(n=2000, full_probe=True):
    """A built JAX IVF engine and the port's, loaded with its state."""
    vecs = rows(n)
    j = jax_ivf(n)
    j.upsert_batch(np.arange(n), np.full(n, 1, np.int32), vecs)
    assert j.maintain() is True and j.main_vecs is not None
    j._warm_queue.clear()
    p = IvfDeviceIndex(
        D, space_type=SpaceType.COSINE, quantization=Quantization.F32, device=CPU,
        initial_capacity=4096, min_build=256, kmeans_block=1024, kmeans_iters=2,
        scan_block_rows=DELTA_BLOCK,
    )
    p.load_state(jax_state(j))
    nprobe = j.nlist if full_probe else max(1, j.nlist // 8)
    j.nprobe = p.nprobe = nprobe
    return j, p, vecs


def brute_filtered(vecs, mask, q, k):
    sub = np.flatnonzero(mask)
    vn = vecs[sub] / np.linalg.norm(vecs[sub], axis=1, keepdims=True)
    d = 1.0 - vn @ (q / np.linalg.norm(q))
    return sub[np.argsort(d, kind="stable")][:k]


def slots_of(results):
    return [r.slots.tolist() for r in results]


def as_form(engine, mask, form):
    return engine.upload_allow_mask(mask) if form == "handle" else mask


@pytest.mark.parametrize("form", ("ndarray", "handle"))
@pytest.mark.parametrize("frac", FRACS)
def test_full_probe_masked_ids_are_exact(interp_pallas, frac, form):
    j, p, vecs = ivf_pair()
    mask = slot_mask(len(vecs), frac, seed=5)
    qs = vecs[np.random.default_rng(6).choice(len(vecs), 5, replace=False)] + 0.01
    got = p.search(qs, K, allow_mask=as_form(p, mask, form))
    want = j.search(qs, K, allow_mask=as_form(j, mask, form))
    for qi, q in enumerate(qs):
        exact = brute_filtered(vecs, mask, q, K).tolist()
        assert got[qi].slots.tolist() == exact, (qi, got[qi].slots, exact)
        assert want[qi].slots.tolist() == exact
        np.testing.assert_allclose(got[qi].distances, want[qi].distances, rtol=0, atol=1e-6)


@pytest.mark.parametrize("frac", FRACS)
def test_partial_probe_masked_ids_match_jax(interp_pallas, frac):
    j, p, vecs = ivf_pair(full_probe=False)
    assert p.nprobe < p.nlist
    mask = slot_mask(len(vecs), frac, seed=8)
    qs = vecs[:12] + 0.02
    hp, hj = p.upload_allow_mask(mask), j.upload_allow_mask(mask)
    got, want = p.search(qs, K, allow_mask=hp), j.search(qs, K, allow_mask=hj)
    assert slots_of(got) == slots_of(want)
    for r in got:
        assert mask[r.slots].all()


@pytest.mark.parametrize("frac", FRACS)
def test_masked_search_below_min_build(interp_pallas, frac):
    n = 1000
    vecs = rows(n, seed=3)
    j = jax_ivf(n, min_build=1 << 30)
    p = IvfDeviceIndex(
        D, space_type=SpaceType.COSINE, quantization=Quantization.F32, device=CPU,
        initial_capacity=4096, min_build=1 << 30, scan_block_rows=DELTA_BLOCK,
    )
    for eng in (j, p):
        eng.upsert_batch(np.arange(n), np.full(n, 2, np.int32), vecs)
    assert p.main_vecs is None
    mask = slot_mask(n, frac, seed=4)
    qs = vecs[:6] + 0.01
    for form in ("ndarray", "handle"):
        got = p.search(qs, K, allow_mask=as_form(p, mask, form))
        want = j.search(qs, K, allow_mask=as_form(j, mask, form))
        assert slots_of(got) == slots_of(want)
        for r in got:
            assert r.slots.size == min(K, int(mask.sum())) and mask[r.slots].all()


def test_row_upserted_after_the_handle_is_found(interp_pallas):
    j, p, vecs = ivf_pair()
    n = len(vecs)
    mask = np.zeros(n + 1, dtype=bool)
    mask[:n] = slot_mask(n, 0.1, seed=9)
    mask[n] = True  # a slot the filter allows before its row exists
    moved = int(np.flatnonzero(mask[:n])[0])  # an allowed row of the main region
    handles = {id(e): e.upload_allow_mask(mask) for e in (j, p)}
    q_new, q_moved = rows(1, seed=10)[0], rows(1, seed=11)[0]
    for eng in (j, p):
        eng.search(vecs[:2], K, allow_mask=handles[id(eng)])  # the handle makes its copy
        eng.upsert_batch(np.array([n, moved]), np.array([3, 3], np.int32), np.stack([q_new, q_moved]))
    got = p.search(np.stack([q_new, q_moved]), K, allow_mask=handles[id(p)])
    want = j.search(np.stack([q_new, q_moved]), K, allow_mask=handles[id(j)])
    assert got[0].slots[0] == n and got[1].slots[0] == moved
    assert got[0].epochs[0] == 3 and abs(got[0].distances[0]) <= 1e-6
    assert slots_of(got) == slots_of(want)


def test_removed_row_is_gone_from_a_cached_handle(interp_pallas):
    j, p, vecs = ivf_pair()
    mask = slot_mask(len(vecs), 0.1, seed=12)
    target = int(np.flatnonzero(mask)[3])
    assert p._region[target] == 1  # the main region holds it
    q = vecs[target][None, :] + 0.001
    hp, hj = p.upload_allow_mask(mask), j.upload_allow_mask(mask)
    assert p.search(q, K, allow_mask=hp)[0].slots[0] == target
    assert hp.materializations == 1
    p.search(q, K, allow_mask=hp)
    assert hp.materializations == 1  # reused, not made again
    for eng in (j, p):
        eng.remove_batch(np.array([target]))
    got, want = p.search(q, K, allow_mask=hp), j.search(q, K, allow_mask=hj)
    assert target not in got[0].slots.tolist()
    assert hp.materializations == 2  # the tombstone made the copy stale
    assert slots_of(got) == slots_of(want)
    assert got[0].slots.tolist() == brute_filtered(vecs, mask & (np.arange(len(vecs)) != target), q[0], K).tolist()


def test_overflowing_masked_batch_is_retried_masked(interp_pallas):
    _, p, vecs = ivf_pair()
    mask = slot_mask(len(vecs), 0.1, seed=13)
    p._serving_s = lambda b: 16  # every cluster takes 16 (query, cluster) pairs
    q = vecs[:2] + 0.01
    batch = np.repeat(q, 20, axis=0)  # 20 pairs in each probed cluster
    got = p.search(batch, K, allow_mask=p.upload_allow_mask(mask))
    assert p.dropped_pair_queries > 0
    for i, r in enumerate(got):
        assert r.slots.size == K and mask[r.slots].all()
        assert r.slots.tolist() == brute_filtered(vecs, mask, batch[i], K).tolist()


def test_handle_type_and_translation():
    """The handle keeps its host mask; a slot mask shorter than the engine
    allows nothing past its end, in either region."""
    p = IvfDeviceIndex(
        D, space_type=SpaceType.COSINE, quantization=Quantization.F32, device=CPU,
        initial_capacity=1024, min_build=1 << 30, scan_block_rows=DELTA_BLOCK,
    )
    vecs = rows(50, seed=14)
    p.upsert_batch(np.arange(50), np.ones(50, np.int32), vecs)
    h = p.upload_allow_mask(np.ones(20, dtype=bool))
    assert isinstance(h, AllowMaskHandle) and h.host.shape == (20,)
    res = p.search(vecs[30:32], 50, allow_mask=h)
    assert all(r.slots.size == 20 and (r.slots < 20).all() for r in res)


def jax_flat(space, quant):
    from vector_store_tpu.engine.flat import FlatDeviceIndex as JaxFlat

    return JaxFlat(
        D, space_type=to_jax(space), quantization=to_jax(quant), initial_capacity=1024,
        block_rows=128,
    )


@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("quant", (Quantization.F32, Quantization.BF16, Quantization.I8))
def test_flat_masked_search_matches_jax(quant, frac):
    """Ids equal to the JAX flat engine's, F32 distances within 1e-6. The
    JAX engine orders BF16 rows by their storage-precision distances, the
    port by exact f32 ones from its host mirror: the same ids, in either
    order. The JAX engine ranks BF16 rows for f32 queries, the port for
    queries in the storage type, so the BF16 case takes bf16-exact queries
    and the dot product (a cosine query is normalized after rounding). I8
    rows are re-ranked by one bf16 tier on both sides. Where
    fewer rows are live and allowed than an I8 scan fetches (oversample x
    k), the JAX engine's bf16 rescore tier also ranks the scan's empty
    candidates, whose row ids it keeps at +inf, and returns removed or
    filtered-out rows after the allowed ones; the port returns only the
    allowed ones, so those are compared."""
    n = 900
    vecs = rows(n, seed=15)
    space = SpaceType.DOT_PRODUCT if quant is Quantization.BF16 else SpaceType.COSINE
    # one row a lane group (block_rows 128): the port's group minimum is
    # the exact scan the JAX engine runs on the CPU
    p = FlatDeviceIndex(D, space, quant, device=CPU, initial_capacity=1024, block_rows=128)
    j = jax_flat(space, quant)
    gone = np.arange(0, n, 97)
    for eng in (j, p):
        eng.upsert_batch(np.arange(n), np.full(n, 4, np.int32), vecs)
        eng.remove_batch(gone)
    mask = slot_mask(n, frac, seed=16)
    mask[0] = True  # a removed row the filter allows stays removed
    live = mask.copy()
    live[gone] = False
    qs = vecs[np.flatnonzero(live)[:4]] + 0.01
    if quant is Quantization.BF16:
        qs = torch.from_numpy(qs).to(torch.bfloat16).float().numpy()
    got, want = p.search(qs, K, allow_mask=mask), j.search(qs, K, allow_mask=mask)
    for g, w in zip(got, want):
        w_live = live[w.slots]
        if quant is Quantization.BF16:
            assert sorted(g.slots.tolist()) == sorted(w.slots.tolist())
        else:
            assert g.slots.tolist() == w.slots[w_live].tolist()
            np.testing.assert_array_equal(g.epochs, w.epochs[w_live])
        assert g.slots.size == min(K, int(live.sum())) and live[g.slots].all()
        if quant is Quantization.F32:
            np.testing.assert_allclose(g.distances, w.distances, rtol=0, atol=1e-6)


@pytest.mark.parametrize("space", (SpaceType.COSINE, SpaceType.EUCLIDEAN, SpaceType.DOT_PRODUCT))
def test_subset_exact_host_matches_jax(space):
    from vector_store_tpu.engine.ivf import IvfDeviceIndex as JaxIvf

    n = 300
    vecs = rows(n, seed=17)
    j = JaxIvf(
        D, space_type=to_jax(space), quantization=to_jax(Quantization.F32), initial_capacity=1024,
        interpret=True, query_i8=False, min_build=1 << 30,
    )
    p = IvfDeviceIndex(D, space_type=space, quantization=Quantization.F32, device=CPU,
                       initial_capacity=1024, min_build=1 << 30)
    rng = np.random.default_rng(18)
    epochs = rng.integers(1, 9, size=n).astype(np.int32)
    for eng in (j, p):
        eng.upsert_batch(np.arange(n), epochs, vecs)
        eng.remove_batch(np.array([7]))
    slots = np.concatenate([np.sort(rng.choice(n, 40, replace=False)), [7, 10**9, -1]])
    qs = rng.normal(size=(5, D)).astype(np.float32)
    dp, ep = p.search_exact_host_subset(qs, slots)
    dj, ej = j.search_exact_host_subset(qs, slots)
    assert dp.shape == (5, slots.size) and dp.dtype == np.float32
    np.testing.assert_array_equal(ep, ej)
    assert (ep[-2:] == -1).all() and np.isinf(dp[:, -3:]).all()
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dp), fin)
    assert (np.abs(dp[fin] - dj[fin]) <= 1e-6 + 1e-5 * np.abs(dj[fin])).all()
    # and it agrees with the full exact ranking of the same engine
    full = p.search_exact_host(qs[0], n)
    by_slot = dict(zip(full.slots.tolist(), full.distances.tolist()))
    for s, d in zip(slots[:40], dp[0, :40]):
        assert abs(d - by_slot[int(s)]) <= 1e-6 + 1e-5 * abs(d)


def test_flat_masked_partitioned_search_skips_the_directory():
    """A masked search of a local index scans the masked table, not the
    partition directory (as the JAX engine does), and returns the JAX
    engine's ids: rows of the query's partition that the filter allows."""
    from vector_store_tpu.engine.flat import FlatDeviceIndex as JaxFlat

    n = 400
    vecs = rows(n, seed=19)
    parts = np.arange(n) % 4
    p = FlatDeviceIndex(D, SpaceType.COSINE, Quantization.F32, device=CPU, initial_capacity=512,
                        block_rows=128, reserve_increment=1000)
    j = JaxFlat(D, space_type=to_jax(SpaceType.COSINE), quantization=to_jax(Quantization.F32),
                initial_capacity=512, block_rows=128, reserve_increment=1000)
    for eng in (j, p):
        eng.upsert_batch(np.arange(n), np.full(n, 1, np.int32), vecs, partitions=parts.astype(np.int32))
    assert p._part_rows_host is not None and p._part_directory_wins()
    mask = slot_mask(n, 0.1, seed=20)
    psel = np.array([1, 2, 3], np.int32)
    qs = vecs[[1, 2, 3]] + 0.01
    got, want = p.search(qs, K, psel, allow_mask=mask), j.search(qs, K, psel, allow_mask=mask)
    assert slots_of(got) == slots_of(want)
    for r, part in zip(got, psel):
        allowed = mask & (parts == part)
        assert r.slots.tolist() == brute_filtered(vecs, allowed, vecs[part] + 0.01, K).tolist()
