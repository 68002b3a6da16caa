"""I8 storage on the global IVF path and the g-clusters grouped scan: the
port against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides; each
side gets its own enums (torch_parity.to_jax). The JAX package's Pallas
kernels run in interpret mode, as its own tests run them; the port's
wrappers take their plain versions for CPU tensors.

- I8 codes are equal bit for bit (both round half to even);
- I8 distances agree within 1e-6 relative (both take an exact integer
  product, rounded once to f32);
- the flat engine's exact I8 scan returns the ids of the JAX
  ``_flat_search`` and its bf16 rescore tier those of ``_rescore_stage``
  (equal wherever the distance is not tied);
- the cluster-major relayout folds the 127x scale into (a, b) as the JAX
  engine does, within 1e-6 relative;
- the grouped scan over int8 rows with bf16 queries matches the JAX
  kernel at a shape where ``_choose_g`` runs g > 1 clusters per grid step
  (the body of kernel 4): ranks within 1e-4 * (1 + |r|), and recall
  against the exact oracle no lower;
- an I8 IVF engine loaded from a JAX engine answers like it: the final
  top-k (after the f32 host rescore) equal in >= 99% of (query, rank)
  places, recall@10 no lower;
- the stage-ablation script's combo equals its base at a toy shape.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import to_jax  # noqa: E402
from vector_store_tpu.ops import distance as jdist  # noqa: E402
from vector_store_tpu.ops import ivf as jivf  # noqa: E402
from vector_store_tpu.ops import quantize as jquant  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.engine.flat import FlatDeviceIndex, normalize_rows  # noqa: E402
from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex, _build_main_arrays  # noqa: E402
from vector_store_tpu_torch.ops import distance, ivf, quantize  # noqa: E402
from vector_store_tpu_torch.ops.fused_scan import INVALID_BIAS, LANES  # noqa: E402

I8, BF16 = Quantization.I8, Quantization.BF16
SPACES = (SpaceType.EUCLIDEAN, SpaceType.COSINE, SpaceType.DOT_PRODUCT)
CPU = torch.device("cpu")
RANK_RTOL = 1e-4


def unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def space_rows(rng, n, d, space):
    """Rows an I8 index of ``space`` stores without clipping: unit rows
    for cosine and dot, components well inside [-1, 1] for euclidean."""
    if space is SpaceType.EUCLIDEAN:
        return (rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    return unit_rows(rng, n, d)


def assert_same_topk(d_got, i_got, d_want, i_want, rtol=1e-6):
    """Equal distances (relative to the batch's largest: euclidean ones
    cancel |q|^2 + |v|^2 - 2 q.v, whose norms both sides sum in another
    order), and equal ids wherever a distance is not tied with another in
    its row (the two top-k orders of ties may differ)."""
    atol = rtol * float(np.abs(d_want).max())
    np.testing.assert_allclose(d_got, d_want, rtol=rtol, atol=atol)
    for dg, ig, iw in zip(d_got, i_got, i_want):
        tied = np.isclose(dg[:, None], dg[None, :], rtol=rtol, atol=atol).sum(1) > 1
        np.testing.assert_array_equal(ig[~tied], iw[~tied])
        assert set(ig[tied]) == set(iw[tied]) or tied[-1]


def test_i8_codes_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.2, 1.2, size=(64, 40)).astype(np.float32)
    halves = np.arange(-20, 20) + 0.5
    x[0] = (halves / 127).astype(np.float32)  # x * 127 == k + 0.5 exactly
    assert (x[0] * np.float32(127) == halves).all()
    got = quantize.quantize_for_storage(x, I8)
    want = jquant.quantize_for_storage(x, to_jax(I8))
    assert got.dtype == torch.int8 and quantize.storage_dtype(I8) is torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(quantize.quantize_i8(torch.from_numpy(x)).numpy(), want)
    for d in (1, 3, 16, 40, 1536):
        dp = quantize.padded_dim(d, I8)
        assert dp >= d and dp % 16 == 0 and dp - d < 16


@pytest.mark.parametrize("space", SPACES)
def test_i8_distances_match_jax(space):
    rng = np.random.default_rng(2)
    d = 40
    q, v = space_rows(rng, 9, d, space), space_rows(rng, 33, d, space)
    jspace, ji8 = to_jax(space), to_jax(I8)
    qs, q_aux = distance.prepare_queries(q, space, I8)
    vs, v_aux = distance.prepare_queries(v, space, I8)
    jq, jq_aux = jdist.prepare_queries(q, jspace, ji8)
    jv, jv_aux = jdist.prepare_queries(v, jspace, ji8)
    assert qs.dtype == torch.int8
    np.testing.assert_array_equal(qs[:, :d].numpy(), jq[:, :d])
    np.testing.assert_allclose(q_aux.numpy(), jq_aux, rtol=1e-6)
    np.testing.assert_allclose(v_aux.numpy(), jv_aux, rtol=1e-6)

    want = np.asarray(jdist.pairwise_distance(
        jnp.asarray(jq), jnp.asarray(jv), jspace, ji8, jnp.asarray(jq_aux), jnp.asarray(jv_aux)
    ))
    got = distance.pairwise_distance(qs, vs, space, I8, q_aux, v_aux).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)

    idx = rng.integers(0, v.shape[0], size=(q.shape[0], 5))
    want_b = np.asarray(jdist.query_block_distance(
        jnp.asarray(jq), jnp.asarray(jv)[idx], jspace, ji8, jnp.asarray(jq_aux), jnp.asarray(jv_aux)[idx]
    ))
    ti = torch.from_numpy(idx)
    got_b = distance.query_block_distance(qs, vs[ti], space, I8, q_aux, v_aux[ti]).numpy()
    np.testing.assert_allclose(got_b, want_b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("space", SPACES)
def test_flat_i8_search_and_rescore_match_jax(space):
    from vector_store_tpu.engine import flat as jflat

    rng = np.random.default_rng(3)
    n, d, nq, k, block = 600, 40, 12, 8, 256
    x = space_rows(rng, n, d, space)
    idx = FlatDeviceIndex(d, space, I8, device=CPU, initial_capacity=1024, block_rows=block)
    idx.upsert_batch(np.arange(n), np.zeros(n, np.int32), x)
    idx.remove_batch(np.arange(0, n, 7))
    queries = x[rng.integers(0, n, nq)] + 0.05 * rng.normal(size=(nq, d)).astype(np.float32)
    if space is SpaceType.COSINE:
        queries = normalize_rows(queries)
    qs, q_aux = distance.prepare_queries(queries, space, I8)
    kk = k * idx.oversample
    dist, slots = idx._flat_search(qs, kk)

    cap = idx.capacity
    packed = jflat._flat_search(
        jnp.asarray(idx.vectors.numpy()), jnp.asarray(idx.aux.numpy()), jnp.asarray(idx._epochs_host),
        jnp.asarray(idx._valid_host), jnp.asarray(idx.parts.numpy()), jnp.asarray(qs.numpy()),
        jnp.asarray(q_aux.numpy()), jnp.full((nq,), -1, jnp.int32), jnp.ones((cap,), bool),
        space=to_jax(space), quant=to_jax(I8), k=kk, block_rows=block, approx=False, use_parts=False,
    )
    jd, ji, _ = jflat.unpack_results(np.asarray(packed))
    assert_same_topk(dist.numpy(), slots.numpy(), jd, ji)

    # the bf16 tier re-ranks the same candidates
    rqs, rq_aux = distance.prepare_queries(queries, space, BF16)
    got_d, got_i = idx._rescore_stage(slots, rqs, rq_aux, k)
    jres = jflat._rescore_stage(
        packed, jnp.asarray(idx.rescore_vectors.float().numpy(), jnp.bfloat16),
        jnp.asarray(idx.rescore_aux.numpy()), jnp.asarray(rqs.float().numpy(), jnp.bfloat16),
        jnp.asarray(rq_aux.numpy()), space=to_jax(space), k=k,
    )
    rd, ri, _ = jflat.unpack_results(np.asarray(jres))
    assert_same_topk(got_d.numpy(), got_i.numpy(), rd, ri, rtol=1e-5)
    # and the search entry point serves the tier's order
    res = idx.search(queries, k)
    np.testing.assert_array_equal(np.stack([r.slots for r in res]), got_i.numpy())


@pytest.mark.parametrize("space", SPACES)
def test_build_main_arrays_folds_the_i8_scale(space):
    from vector_store_tpu.engine.ivf import _build_main_arrays as jbuild

    rng = np.random.default_rng(4)
    n, d, nlist, cmax = 300, 40, 4, 64  # 256 positions: some rows spill
    codes = quantize.quantize_for_storage(space_rows(rng, n, 48, space), I8).numpy()
    codes[:, d:] = 0
    l1 = rng.choice(nlist, size=n, p=[0.5, 0.3, 0.15, 0.05]).astype(np.int32)
    l2 = ((l1 + 1 + rng.integers(0, nlist - 1, n)) % nlist).astype(np.int32)
    vecs, a, b, pos2slot, pos = _build_main_arrays(
        torch.from_numpy(codes), torch.from_numpy(np.stack([l1, l2], 1)),
        torch.arange(n, dtype=torch.int32), nlist=nlist, cmax=cmax, space=space, scale=quantize.I8_SCALE,
    )
    kind = {SpaceType.EUCLIDEAN: "euclid", SpaceType.COSINE: "cosine", SpaceType.DOT_PRODUCT: "dot"}[space]
    jv, jpaux, jp2s, jpos, _ = jbuild(
        jnp.asarray(codes), jnp.ones((n,), bool), jnp.asarray(l1), jnp.arange(n, dtype=jnp.int32),
        jnp.asarray(l2), nlist=nlist, cmax=cmax, space_kind=kind, dt="int8", scale=127.0,
    )
    assert (np.asarray(jpos) < 0).any()
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(pos2slot.numpy(), np.asarray(jp2s))
    np.testing.assert_array_equal(vecs.numpy(), np.asarray(jv))
    np.testing.assert_allclose(a.numpy(), np.asarray(jpaux)[0], rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jpaux)[1], rtol=1e-6)


def test_grouped_scan_i8_matches_jax_kernel():
    nlist, cmax, s, d = 16, 256, 16, 40
    assert jivf._choose_g(nlist, cmax, 128, s, 1) > 1  # the g-clusters body (kernel 4)
    rng = np.random.default_rng(5)
    x = unit_rows(rng, nlist * cmax, d)
    codes = quantize.quantize_for_storage(x, I8)
    sq = codes.float().square().sum(-1)
    a = -1.0 / sq.sqrt()  # cosine, the 127x scale folded in
    b = torch.zeros(nlist * cmax)
    b[::9] = INVALID_BIAS  # empty positions
    q = torch.from_numpy(unit_rows(rng, nlist * s, d)).to(torch.bfloat16)

    dp = quantize.padded_dim(d, I8)
    vs = torch.nn.functional.pad(codes, (0, dp - d))
    qg = torch.nn.functional.pad(q, (0, dp - d))
    rank, row = ivf.grouped_scan(qg, vs, a, b, s, cmax)

    paux = np.zeros((8, nlist * cmax), np.float32)
    paux[0], paux[1] = a.numpy(), b.numpy()
    jr, joff = jivf._grouped_scan(
        jnp.asarray(np.pad(q.float().numpy(), [(0, 0), (0, 128 - d)]), jnp.bfloat16),
        jnp.asarray(np.pad(codes.numpy(), [(0, 0), (0, 128 - d)])),
        jnp.asarray(paux), s=s, cmax=cmax, interpret=True,
    )
    jr = np.asarray(jr)
    slot = np.arange(nlist * s)[:, None]
    jrow = (slot // s) * cmax + np.asarray(joff).astype(np.int64) + np.arange(LANES)
    r = rank.numpy()
    assert (np.abs(r - jr) <= RANK_RTOL * (1 + np.abs(jr))).all()
    # a differing row is a near tie of the JAX winner in the same group
    full = np.full((nlist * s, nlist * cmax), np.inf, np.float32)
    for c in range(nlist):
        rows = slice(c * cmax, (c + 1) * cmax)
        full[c * s : (c + 1) * s, rows] = (
            a[rows].numpy() * (q[c * s : (c + 1) * s].float().numpy() @ codes[rows].float().numpy().T)
            + b[rows].numpy()
        )
    got_row = row.numpy().astype(np.int64)
    diff = got_row != jrow
    assert ((got_row % cmax) % LANES == np.arange(LANES))[diff].all()
    won = np.take_along_axis(full, got_row, 1)
    assert (np.abs(won - jr) <= RANK_RTOL * (1 + np.abs(jr)))[diff].all()

    # recall@10 of each slot's 128 candidates against the exact top-10 of
    # its cluster in true f32
    def recall(rows):
        hits = []
        for i in range(nlist * s):
            c = i // s
            rr = np.arange(c * cmax, (c + 1) * cmax)
            live = rr[b.numpy()[rr] < 1e29]
            true = live[np.argsort(-(x[live] @ q[i].float().numpy()))[:10]]
            cand = rows[i][np.argsort(np.take_along_axis(full[i], rows[i], 0))[:10]]
            hits.append(len(set(true) & set(cand)) / 10)
        return float(np.mean(hits))

    assert recall(got_row) >= recall(jrow)


def _clustered_unit(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, d)).astype(np.float32)
    x = centers[rng.integers(0, 64, n)] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    return normalize_rows(x)


def test_i8_ivf_loaded_from_jax_serves_like_jax():
    from vector_store_tpu.engine.ivf import IvfDeviceIndex as JaxIvf

    n, d, k = 4096, 32, 10
    rng = np.random.default_rng(6)
    vecs = _clustered_unit(n, d, seed=1)
    j = JaxIvf(
        d, space_type=to_jax(SpaceType.COSINE), quantization=to_jax(I8), initial_capacity=4096,
        min_build=1024, kmeans_block=1024, nprobe=16, kmeans_iters=4,
        interpret=True, query_i8=False, approx_select=False,
    )
    j.upsert_batch(np.arange(n), np.full(n, 5, np.int32), vecs)
    assert j.maintain() and j.main_vecs is not None

    p = IvfDeviceIndex(
        d, space_type=SpaceType.COSINE, quantization=I8, device=CPU, initial_capacity=4096,
        min_build=1024, kmeans_block=1024, nprobe=16, kmeans_iters=4,
    )
    assert p.oversample == j.oversample == 4
    p.load_state({
        "main_vecs": np.asarray(j.main_vecs),
        "main_paux": np.asarray(j.main_paux),
        "main_pos2slot": np.asarray(j.main_pos2slot),
        "centroids": np.asarray(j.centroids),
        "nlist": j.nlist,
        "cmax": j.cmax,
        "_region": j._region,
        "_pos": j._pos,
        "_epochs_host": j._epochs_host,
        "_valid_host": j._valid_host,
        "_vecs_host": j._vecs_host,
        "_delta_pos2slot_host": j._delta_pos2slot_host,
        "_delta_next": j._delta_next,
        "_delta_free": j._delta_free,
        "delta_vectors": np.asarray(j._delta.vectors),
        "delta_paux": np.asarray(j._delta.paux),
        "delta_valid": np.asarray(j._delta.valid),
        "delta_epochs": np.asarray(j._delta.epochs),
        "delta_rescore_vectors": np.asarray(j._delta.rescore_vectors.astype(jnp.float32)),
        "delta_rescore_aux": np.asarray(j._delta.rescore_aux),
    })
    assert (p.nlist, p.cmax, p.size) == (j.nlist, j.cmax, j.size)
    assert p.main_vecs.dtype == torch.int8 and p._delta.rescore

    # the same delta traffic on both: new rows, updates of main rows, removals
    new = _clustered_unit(300, d, seed=3)
    upd = rng.choice(n, size=100, replace=False)
    gone = rng.choice(n, size=50, replace=False)
    for eng in (j, p):
        eng.upsert_batch(np.arange(n, n + 300), np.full(300, 7, np.int32), new)
        eng.upsert_batch(upd, np.full(100, 9, np.int32), normalize_rows(vecs[upd] + 0.1))
        eng.remove_batch(gone)
    assert p.size == j.size

    queries = normalize_rows(
        np.concatenate([vecs[rng.integers(0, n, 40)], new[:8]])
        + 0.05 * rng.normal(size=(48, d)).astype(np.float32)
    )
    got = np.stack([r.slots for r in p.search(queries, k)])
    want = np.stack([r.slots for r in j.search(queries, k)])
    assert np.mean(got == want) >= 0.99

    live = np.flatnonzero(p._valid_host)
    truth = live[np.argsort(-(queries @ p._vecs_host[live].T), axis=1)[:, :k]]

    def recall(ids):
        return np.mean([len(set(a) & set(t)) / k for a, t in zip(ids, truth)])

    assert recall(got) >= recall(want)


@pytest.mark.parametrize("space", SPACES, ids=lambda s: s.name)
def test_delta_only_i8_without_rescoring_answers_like_jax(space):
    """An I8 IVF engine with rescoring off and no main region yet answers
    with its delta's storage-precision distances, in the delta's order
    (ties to the lower delta position), as the JAX engine does: the same
    slots in the same order, distances within 1e-6; with updates and
    removals of delta rows between."""
    from vector_store_tpu.engine.ivf import IvfDeviceIndex as JaxIvf

    rng = np.random.default_rng(17)
    n, d, k = 400, 16, 20
    vecs = space_rows(rng, n, d, space)
    j = JaxIvf(
        d, space_type=to_jax(space), quantization=to_jax(I8), initial_capacity=1024, min_build=4096,
        rescoring=False, interpret=True, query_i8=False, approx_select=False,
    )
    p = IvfDeviceIndex(d, space_type=space, quantization=I8, device=CPU, initial_capacity=1024,
                       min_build=4096, rescoring=False)
    order = rng.permutation(n)
    for eng in (j, p):
        eng.upsert_batch(order, np.full(n, 3, np.int32), vecs[order])
        eng.upsert_batch(order[:20], np.full(20, 4, np.int32), vecs[order[20:40]])
        eng.remove_batch(order[40:50])
    assert j.main_vecs is None and p.main_vecs is None and p.oversample == 1
    queries = vecs[rng.integers(0, n, 12)] + 0.02 * rng.normal(size=(12, d)).astype(np.float32)
    for got, want in zip(p.search(queries, k), j.search(queries, k)):
        np.testing.assert_array_equal(got.slots, want.slots)
        np.testing.assert_array_equal(got.epochs, want.epochs)
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-6, atol=1e-6)
        assert not set(got.slots.tolist()) & set(order[40:50].tolist())


def test_stage_ablation_combo_equals_base_on_cpu():
    from vector_store_tpu_torch.bench import ivf_stage

    prob = ivf_stage.make_problem(CPU, b=64, d=16, nlist=16, cmax=256, nprobe=4, k=8, seed=3)
    assert prob.s == ivf.choose_budget(64, 4, 16)
    eq = ivf_stage.equivalence(prob)
    assert eq["ok"] and eq["max_rank_diff"] <= 1e-4 and eq["pos_agreement"] == 1.0
    # every row of the table runs; the fakes keep the output shapes
    for _, kw in ivf_stage.ROWS:
        rank, pos = ivf_stage.pipeline(prob, **kw)
        assert rank.shape == (64, 8) and pos.dtype == torch.int32
    # merge_v2 (the whole gather) picks the winners of the base merge
    base = ivf_stage.pipeline(prob)
    v2 = ivf_stage.pipeline(prob, merge="v2")
    assert torch.equal(base[0], v2[0]) and torch.equal(base[1], v2[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        ivf_stage.run(CPU)
