"""The graph engine (ENGINE=graph): the port against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides (each
with its own enums, torch_parity.to_jax); a JAX graph is carried into the
port with ``load_state(jax_graph_state(j))``.

- ``alpha_prune`` keeps the JAX ``_alpha_prune``'s ids (distances within
  1e-5) for every storage and space on the same candidates;
- ``bulk_prune_chunk`` gives the JAX ``_bulk_prune_chunk``'s edges, the
  hash-random bridges included, from the same raw scan output (ranks of
  float storage, distances of I8 storage);
- ``bulk_reverse`` and ``_apply_reverse_edges`` give the JAX rows on a
  JAX-built adjacency;
- ``graph_beam_search`` on a JAX graph returns the JAX ids exactly on F32
  rows (distances within 1e-5; BF16 rows within 2e-2), at expand 1 and
  4, unfiltered and filtered, and the engines' ``search`` agree;
- then a twin of each case of tests/test_engine_graph.py. Where the JAX
  test states a floor, the port meets it; a build of the port differs from
  the JAX engine's on the CPU (its float store resolves distances from an
  f32 host mirror, the JAX package's TPU path, and its scan keeps one
  minimum a lane), so recall is also held within 0.02 of the JAX
  engine's on the same rows.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import jax_graph_state, to_jax  # noqa: E402
from vector_store_tpu.engine import graph as jgraph  # noqa: E402
from vector_store_tpu.ops import distance as jdist  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.engine.flat import FlatDeviceIndex, normalize_rows  # noqa: E402
from vector_store_tpu_torch.engine.graph import (  # noqa: E402
    GraphDeviceIndex,
    alpha_prune,
    ava_u32,
    bulk_prune_chunk,
    bulk_reverse,
    graph_beam_search,
)
from vector_store_tpu_torch.ops import distance  # noqa: E402
from vector_store_tpu_torch.ops.fused_scan import INVALID_BIAS, paux_coeffs, rank_search  # noqa: E402

F32, BF16, I8, B1 = Quantization.F32, Quantization.BF16, Quantization.I8, Quantization.B1
EUC, COS, DOT = SpaceType.EUCLIDEAN, SpaceType.COSINE, SpaceType.DOT_PRODUCT
SPACES = (EUC, COS, DOT)
CPU = torch.device("cpu")


def storage(rows: np.ndarray, space, quant):
    """Both sides' storage rows of f32 ``rows`` (unit rows first for a
    cosine float or I8 index, as the engines store them) and one aux."""
    if space is COS and quant is not B1:
        rows = normalize_rows(rows)
    p_rows, _ = distance.prepare_queries(rows, space, quant)
    j_rows, j_aux = jdist.prepare_queries(rows, to_jax(space), to_jax(quant))
    return p_rows, np.asarray(j_rows), np.asarray(j_aux, np.float32)


def unpack(packed):
    packed = np.asarray(packed)
    return packed[0], packed[1].view(np.int32), packed[2].view(np.int32)


# --- free functions -------------------------------------------------------------


@pytest.mark.parametrize("quant", (F32, BF16, I8, B1), ids=lambda q: q.name)
@pytest.mark.parametrize("space", SPACES, ids=lambda s: s.name)
def test_alpha_prune_matches_jax(quant, space):
    rng = np.random.default_rng(11)
    n, d, b, c, m = 300, 16, 24, 40, 12
    rows = rng.normal(size=(n, d)).astype(np.float32) * (0.3 if quant is I8 and space is EUC else 1.0)
    p_rows, j_rows, aux = storage(rows, space, quant)
    cand = np.stack([rng.permutation(n)[:c] for _ in range(b)]).astype(np.int32)
    cand[:, c - 5 :] = -1  # a padded tail
    q = p_rows[rng.integers(0, n, size=b)]
    safe = np.maximum(cand, 0)
    d0 = distance.query_block_distance(
        q, p_rows[torch.from_numpy(safe).long()], space, quant,
        torch.from_numpy(aux[rng.integers(0, n, size=b)]), torch.from_numpy(aux[safe]),
    ).numpy()
    d0 = np.where(cand >= 0, d0, np.inf).astype(np.float32)
    order = np.argsort(d0, axis=1, kind="stable")
    cand, d0 = np.take_along_axis(cand, order, 1), np.take_along_axis(d0, order, 1)
    safe = np.maximum(cand, 0)

    ji, jd = jgraph._alpha_prune(
        jnp.asarray(cand), jnp.asarray(d0), jnp.asarray(j_rows[safe]), jnp.asarray(aux[safe]),
        m=m, alpha=1.2, space=to_jax(space), quant=to_jax(quant),
    )
    pi, pd = alpha_prune(
        torch.from_numpy(cand), torch.from_numpy(d0), p_rows[torch.from_numpy(safe).long()],
        torch.from_numpy(aux[safe]), m=m, alpha=1.2, space=space, quant=quant,
    )
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    assert (pi.numpy() >= 0).sum(1).min() > 1
    if quant is not B1:  # a B1 row's byte-space L2 dominates nothing
        assert (pi.numpy() >= 0).sum() < b * m  # the prune dropped candidates


def test_beam_selections_break_ties_as_lax_top_k():
    """The beam's selections (min_k and merge_min_k with ``stable``) pick
    the JAX ids where many distances tie, +inf pads included: ties go to
    the lower position, as lax.top_k sends them."""
    from vector_store_tpu.ops import topk as jtopk
    from vector_store_tpu_torch.ops import topk

    rng = np.random.default_rng(17)
    d = rng.integers(0, 4, size=(6, 96)).astype(np.float32)
    d[rng.random(d.shape) < 0.3] = np.inf
    ids = rng.permutation(6 * 96).reshape(6, 96).astype(np.int32)
    got_d, got_i = topk.min_k(torch.from_numpy(d), torch.from_numpy(ids), 40, stable=True)
    want_d, want_i = jtopk.min_k(jnp.asarray(d), jnp.asarray(ids), 40)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    new_d = np.where(rng.random((6, 32)) < 0.5, np.inf, 1.0).astype(np.float32)
    new_i = (1000 + np.arange(6 * 32)).reshape(6, 32).astype(np.int32)
    got = topk.merge_min_k(got_d, got_i, torch.from_numpy(new_d), torch.from_numpy(new_i), stable=True)
    want = jtopk.merge_min_k(want_d, want_i, jnp.asarray(new_d), jnp.asarray(new_i))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_ava_u32_matches_jax():
    x = np.concatenate([np.arange(64), [2**31 - 1, 2**32 - 1, 123456789]]).astype(np.int64)
    want = np.asarray(jgraph._ava_u32(jnp.asarray(x.astype(np.uint32)))).astype(np.int64)
    np.testing.assert_array_equal(ava_u32(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize(
    "quant,space", ((F32, EUC), (BF16, COS), (I8, EUC)), ids=("F32-EUCLIDEAN", "BF16-COSINE", "I8-EUCLIDEAN")
)
def test_bulk_prune_chunk_matches_jax(quant, space):
    """One chunk of the device bulk build from the same raw scan output:
    ranks of the fused scan for float storage (the JAX "pallas" kind),
    distances for I8 (the "xla" kind); the bridges drawn by the hash."""
    rng = np.random.default_rng(12)
    n, cap, d, k, lo, b = 300, 384, 16, 17, 40, 64
    rows = rng.normal(size=(n, d)).astype(np.float32) * (0.3 if quant is I8 else 1.0)
    p_rows, j_rows, aux = storage(rows, space, quant)
    p_vecs = torch.zeros((cap, p_rows.shape[1]), dtype=p_rows.dtype)
    p_vecs[:n] = p_rows
    j_vecs = np.zeros((cap, j_rows.shape[1]), dtype=j_rows.dtype)
    j_vecs[:n] = j_rows
    aux_c = np.zeros(cap, np.float32)
    aux_c[:n] = aux
    queries = p_vecs[lo : lo + b]
    q2 = None
    if quant is I8:
        dist = distance.pairwise_distance(
            queries, p_vecs[:n], space, quant, torch.from_numpy(aux_c[lo : lo + b]), torch.from_numpy(aux)
        )
        raw, ids = torch.topk(dist, k, dim=1, largest=False)
        ids = ids.to(torch.int32)
        kind = "xla"
    else:
        a, bias = paux_coeffs(space, p_vecs)
        bias[n:] = INVALID_BIAS
        raw, ids = rank_search(p_vecs, a, bias, queries, k=k, block_rows=128)
        kind = "pallas"
        if space is EUC:
            q2 = torch.from_numpy((rows[lo : lo + b].astype(np.float64) ** 2).sum(-1).astype(np.float32))
    packed = np.stack([raw.numpy(), ids.numpy().view(np.float32)])
    q2b = jnp.zeros((b,), jnp.float32) if q2 is None else jnp.asarray(q2.numpy())
    kw = dict(m=10, alpha=1.2, k=k, r_rand=8, m_bridge=4)
    ji, jd = jgraph._bulk_prune_chunk(
        jnp.asarray(packed), jnp.int32(lo), jnp.int32(0), jnp.int32(n), q2b, jnp.asarray(j_vecs),
        jnp.asarray(aux_c), kind=kind, space=to_jax(space), quant=to_jax(quant), **kw,
    )
    pi, pd = bulk_prune_chunk(
        raw, ids, lo, 0, n, q2, p_vecs, torch.from_numpy(aux_c), is_dist=quant is I8,
        space=space, quant=quant, **kw,
    )
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    finite = np.isfinite(np.asarray(jd))
    np.testing.assert_array_equal(np.isfinite(pd.numpy()), finite)
    np.testing.assert_allclose(pd.numpy()[finite], np.asarray(jd)[finite], rtol=1e-5, atol=1e-5)
    assert (pi.numpy()[:, 10:] >= 0).any()  # bridges survived


@functools.lru_cache(maxsize=None)
def jax_graph(n, d, space, quant=F32, merges=True, connectivity=8, seed=21, **kw):
    """A JAX graph over n seeded rows (incremental merges of 256, or one
    device bulk build), with its rows."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    g = jgraph.GraphDeviceIndex(
        d, space_type=to_jax(space), quantization=to_jax(quant), initial_capacity=2048,
        connectivity=connectivity, expansion_add=32, expansion_search=48, **kw,
    )
    g.upsert_batch(np.arange(n), np.zeros(n, np.int32), vecs)
    if merges:
        while g.merge_delta(max_batch=256):
            pass
    else:
        g.bulk_build_device()
    return g, vecs


def port_of(j, vecs, **kw):
    """The port's engine carrying the JAX graph ``j``'s state."""
    space = SpaceType[j.space_type.name]
    quant = Quantization[j.quantization.name]
    p = GraphDeviceIndex(
        j.dimensions, space_type=space, quantization=quant, connectivity=j.connectivity,
        expansion_add=j.expansion_add, expansion_search=j.expansion_search,
        initial_capacity=j.capacity, device=CPU, oversample=j.oversample, rescoring=j.rescoring, **kw,
    )
    host = normalize_rows(vecs) if space is COS else vecs
    p.load_state(jax_graph_state(j, host))
    return p


@pytest.mark.parametrize("space", (EUC, COS), ids=lambda s: s.name)
def test_bulk_reverse_matches_jax(space):
    j, _ = jax_graph(900, 16, space, merges=False)
    near = np.asarray(j.adjacency)[:, : j.near_deg].copy()
    near[:, j.near_deg // 2 :] = -1  # the built graph is the pass's fixed point
    cap = near.shape[0]
    rb = next(r for r in (512, 256, 128) if cap % r == 0)
    kw = dict(m=j.near_deg, r=8, alpha=1.2, max_forced=max(1, j.near_deg // 4), row_block=rb)
    want = jgraph._bulk_reverse(
        jnp.asarray(near), j.store.vectors, j.store.aux, j.store.valid,
        space=to_jax(space), quant=to_jax(F32), **kw,
    )
    p_vecs = torch.from_numpy(np.asarray(j.store.vectors)[:, :16].copy())
    got = bulk_reverse(
        torch.from_numpy(near.copy()), p_vecs, torch.from_numpy(np.array(j.store.aux)),
        torch.from_numpy(np.array(j.store.valid)), space=space, quant=F32, **kw,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != near).any()


def test_apply_reverse_edges_matches_jax():
    j, vecs = jax_graph(700, 16, EUC)
    p = port_of(j, vecs)
    rng = np.random.default_rng(13)
    slots = rng.choice(700, size=64, replace=False).astype(np.int64)
    sel_i = np.asarray(j.adjacency)[rng.choice(700, size=64)].copy()
    sel_d = np.sort(rng.random(size=sel_i.shape).astype(np.float32), axis=1)
    sel_d[sel_i < 0] = np.inf
    jgraph_copy = jgraph.GraphDeviceIndex.__new__(jgraph.GraphDeviceIndex)
    jgraph_copy.__dict__.update(j.__dict__)  # the cached graph stays as it was
    jgraph_copy._apply_reverse_edges(slots, sel_i.copy(), sel_d.copy())
    p._apply_reverse_edges(slots, sel_i.copy(), sel_d.copy())
    cap = np.asarray(jgraph_copy.adjacency).shape[0]
    want = np.asarray(jgraph_copy.adjacency)
    np.testing.assert_array_equal(p.adjacency.numpy()[:cap], want)
    assert (want != np.asarray(j.adjacency)).any()


def test_merge_and_refine_slices_match_jax():
    """An incremental merge (exact candidates, intra-batch peers, prune,
    reverse edges, forced back-links) and two refinement slices on a
    carried JAX graph leave the JAX rows and entry set. 120 rows: every
    lane group of the port's fused scan holds one row, so its candidates
    are exact, as the JAX engine's on the CPU."""
    rng = np.random.default_rng(16)
    vecs = rng.normal(size=(120, 16)).astype(np.float32)
    j = jgraph.GraphDeviceIndex(16, space_type=to_jax(EUC), quantization=to_jax(F32), initial_capacity=256,
                                connectivity=8, expansion_add=32, expansion_search=48)
    j.upsert_batch(np.arange(90), np.zeros(90, np.int32), vecs[:90])
    while j.merge_delta(max_batch=40):
        pass
    p = port_of(j, vecs)
    for eng in (j, p):
        eng.upsert_batch(np.arange(90, 120), np.ones(30, np.int32), vecs[90:])
        assert eng.merge_delta(max_batch=64) == 30
        eng.refine_step(max_batch=64)
        eng.refine_step(max_batch=64)
    want = np.asarray(j.adjacency)
    np.testing.assert_array_equal(p.adjacency.numpy()[: want.shape[0]], want)
    assert p._entries == j._entries and p._refine_cursor == j._refine_cursor == 120


@pytest.mark.parametrize("filtered", (False, True), ids=("all", "filtered"))
@pytest.mark.parametrize("expand", (1, 4))
@pytest.mark.parametrize("space", (EUC, COS), ids=lambda s: s.name)
def test_beam_search_matches_jax(space, expand, filtered):
    j, vecs = jax_graph(1200, 16, space)
    p = port_of(j, vecs)
    rng = np.random.default_rng(14)
    queries = vecs[rng.integers(0, 1200, size=24)] + 0.3 * rng.normal(size=(24, 16)).astype(np.float32)
    allow = rng.random(j.capacity) < 0.3 if filtered else np.ones(j.capacity, bool)
    k, ef = 16, 48
    jq, jqa = jdist.prepare_queries(queries, to_jax(space), to_jax(F32))
    want_d, want_i, _ = unpack(jgraph._graph_beam_search(
        j.store.vectors, j.store.aux, j.store.epochs, j.store.valid, jnp.asarray(allow), j.adjacency,
        j._entries_array(), jnp.asarray(jq), jnp.asarray(jqa), space=to_jax(space), quant=to_jax(F32),
        k=k, beam_width=ef, iters=ef, filtered=filtered, expand=expand,
    ))
    pq, pqa = distance.prepare_queries(queries, space, F32)
    am = torch.zeros(p.capacity, dtype=torch.bool)
    am[: j.capacity] = torch.from_numpy(allow)
    got_d, got_i = graph_beam_search(
        p.store.vectors, p.store.aux, p._valid(), am, p.adjacency, p._entries_tensor(), pq, pqa,
        space=space, quant=F32, k=k, beam_width=ef, iters=ef, filtered=filtered, expand=expand,
    )
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0, atol=1e-5)
    assert (want_i >= 0).all()
    if filtered:
        assert allow[want_i].all()


@pytest.mark.parametrize("quant", (F32, BF16), ids=lambda q: q.name)
def test_search_of_a_carried_graph_matches_jax(quant):
    """The engines' search on one graph: the same slots, distances within
    1e-5 (F32) or 2e-2 absolute and relative (BF16: the JAX engine on the CPU reports
    the bf16 rows' distances, the port exact f32 ones from its mirror)."""
    j, vecs = jax_graph(1000, 16, EUC, quant)
    p = port_of(j, vecs)
    rng = np.random.default_rng(15)
    queries = vecs[:16] + 0.05 * rng.normal(size=(16, 16)).astype(np.float32)
    for want, got in zip(j.search(queries, 10), p.search(queries, 10)):
        assert set(got.slots.tolist()) == set(want.slots.tolist())
        order = np.argsort(want.slots)
        np.testing.assert_allclose(
            got.distances[np.argsort(got.slots)], want.distances[order],
            rtol=1e-5 if quant is F32 else 2e-2, atol=1e-5 if quant is F32 else 2e-2,
        )
        np.testing.assert_array_equal(got.epochs, 0)


# --- twins of tests/test_engine_graph.py ------------------------------------------


def build_index(n=2000, d=32, space=EUC, seed=3, **kw):
    """The port's graph over n seeded rows, merged 512 at a time (the JAX
    test's build_index); returns it and its rows."""
    kw.setdefault("initial_capacity", 4096)
    kw.setdefault("connectivity", 8)
    kw.setdefault("expansion_add", 32)
    kw.setdefault("expansion_search", 48)
    idx = GraphDeviceIndex(d, space_type=space, device=CPU, **kw)
    vecs = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    idx.upsert_batch(np.arange(n), np.zeros(n, np.int32), vecs)
    while idx.merge_delta(max_batch=512):
        pass
    return idx, vecs


def recall_at_k(idx, vecs, queries, k=10, **search_kw):
    oracle = FlatDeviceIndex(vecs.shape[1], space_type=idx.space_type, device=CPU, initial_capacity=len(vecs))
    oracle.upsert_batch(np.arange(len(vecs)), np.zeros(len(vecs), np.int32), vecs)
    got = idx.search(queries, k, **search_kw)
    return float(np.mean([len(set(w.slots) & set(g.slots)) / k for w, g in zip(oracle.search(queries, k), got)]))


def jax_recall(vecs, queries, space=EUC, quant=F32, k=10, **kw):
    """The JAX engine's recall on the same rows, built the same way."""
    kw = {"initial_capacity": 4096, "connectivity": 8, "expansion_add": 32, "expansion_search": 48, **kw}
    j = jgraph.GraphDeviceIndex(vecs.shape[1], space_type=to_jax(space), quantization=to_jax(quant), **kw)
    j.upsert_batch(np.arange(len(vecs)), np.zeros(len(vecs), np.int32), vecs)
    while j.merge_delta(max_batch=512):
        pass
    oracle = FlatDeviceIndex(vecs.shape[1], space_type=space, device=CPU, initial_capacity=len(vecs))
    oracle.upsert_batch(np.arange(len(vecs)), np.zeros(len(vecs), np.int32), vecs)
    return float(np.mean([
        len(set(w.slots) & set(g.slots)) / k for w, g in zip(oracle.search(queries, k), j.search(queries, k))
    ]))


class TestGraphSearch:
    def test_recall(self):
        idx, vecs = build_index()
        queries = np.random.default_rng(4).normal(size=(32, 32)).astype(np.float32)
        r = recall_at_k(idx, vecs, queries, k=10)
        assert r >= 0.9, f"recall {r}"
        assert r >= jax_recall(vecs, queries) - 0.02
        assert idx.graph_nodes == 2000
        assert idx.delta_count == 0

    def test_self_recall(self):
        idx, vecs = build_index(n=1000)
        res = idx.search(vecs[:16], k=1)
        hits = sum(1 for i, r in enumerate(res) if r.slots.size and r.slots[0] == i)
        assert hits >= 15
        assert all(r.distances[0] == 0.0 for r in res if r.slots.size and r.slots[0] < 16)

    def test_cosine_recall(self):
        idx, vecs = build_index(space=COS, n=1500)
        queries = np.random.default_rng(5).normal(size=(16, 32)).astype(np.float32)
        r = recall_at_k(idx, vecs, queries, k=10)
        assert r >= 0.85, f"recall {r}"
        assert r >= jax_recall(vecs, queries, COS) - 0.02


class TestStreaming:
    def test_delta_searchable_before_merge(self):
        idx, _ = build_index(n=500)
        new = np.random.default_rng(6).normal(size=(10, 32)).astype(np.float32) + 50.0  # far cluster
        idx.upsert_batch(np.arange(500, 510), np.zeros(10, np.int32), new)
        assert idx.delta_count == 10
        res = idx.search(new[3][None], k=1)[0]
        assert res.slots[0] == 503  # found exactly via the delta

    def test_merge_moves_delta_to_graph(self):
        idx, _ = build_index(n=500)
        new = np.random.default_rng(7).normal(size=(10, 32)).astype(np.float32) + 50.0
        idx.upsert_batch(np.arange(500, 510), np.zeros(10, np.int32), new)
        assert idx.merge_delta() == 10
        assert idx.delta_count == 0
        assert idx.graph_nodes == 510
        res = idx.search(new[3][None], k=1, expansion=64)[0]
        assert res.slots.size and res.slots[0] == 503

    def test_remove_tombstones(self):
        idx, vecs = build_index(n=500)
        target = vecs[7][None]
        assert idx.search(target, k=1)[0].slots[0] == 7
        idx.remove_batch(np.array([7]))
        res = idx.search(target, k=1)[0]
        assert res.slots.size == 0 or res.slots[0] != 7

    def test_remove_from_delta(self):
        idx, _ = build_index(n=100)
        new = np.random.default_rng(8).normal(size=(5, 32)).astype(np.float32)
        idx.upsert_batch(np.arange(100, 105), np.zeros(5, np.int32), new)
        idx.remove_batch(np.array([102]))
        assert idx.delta_count == 4
        assert 102 not in idx.search(new[2][None], k=5)[0].slots

    def test_empty_graph_delta_only(self):
        idx = GraphDeviceIndex(16, initial_capacity=256, device=CPU)
        vecs = np.random.default_rng(9).normal(size=(20, 16)).astype(np.float32)
        idx.upsert_batch(np.arange(20), np.zeros(20, np.int32), vecs)
        res = idx.search(vecs[4][None], k=3)[0]
        assert res.slots[0] == 4

    def test_empty_index(self):
        idx = GraphDeviceIndex(16, initial_capacity=256, device=CPU)
        res = idx.search(np.zeros((1, 16), np.float32), k=3)[0]
        assert res.slots.size == 0


class TestFilteredGraph:
    def test_allow_mask(self):
        idx, vecs = build_index(n=600)
        allow = np.zeros(idx.capacity, dtype=bool)
        allow[100:200] = True
        res = idx.search(vecs[5][None], k=10, allow_mask=allow)[0]
        assert res.slots.size > 0
        assert np.all((res.slots >= 100) & (res.slots < 200))

    def test_partitions_rejected(self):
        idx, vecs = build_index(n=100)
        with pytest.raises(ValueError):
            idx.search(vecs[:1], k=1, partitions=np.array([0]))


def test_quantized_graph_recall():
    idx, vecs = build_index(n=1000, quantization=BF16)
    queries = np.random.default_rng(10).normal(size=(16, 32)).astype(np.float32)
    r = recall_at_k(idx, vecs, queries, k=10)
    assert r >= 0.85, f"recall {r}"
    assert r >= jax_recall(vecs, queries, quant=BF16) - 0.02


class TestCompaction:
    def test_compact_drops_tombstones(self):
        idx, vecs = build_index(n=600)
        idx.remove_batch(np.arange(0, 600, 3))
        assert idx.compact() == 400
        assert idx.graph_nodes == 400
        assert idx.delta_count == 0
        res = idx.search(vecs[1][None], k=1)[0]  # 1 % 3 != 0: live
        assert res.slots[0] == 1
        assert 0 not in idx.search(vecs[0][None], k=5)[0].slots

    def test_compact_then_insert(self):
        idx, _ = build_index(n=300)
        idx.remove_batch(np.arange(100))
        idx.compact()
        new = np.random.default_rng(11).normal(size=(5, 32)).astype(np.float32) + 30
        idx.upsert_batch(np.arange(300, 305), np.zeros(5, np.int32), new)
        idx.merge_delta()
        res = idx.search(new[2][None], k=1, expansion=64)[0]
        assert res.slots[0] == 302


def test_refine_improves_or_keeps_recall():
    idx, vecs = build_index(n=1200)
    queries = np.random.default_rng(12).normal(size=(24, 32)).astype(np.float32)
    before = recall_at_k(idx, vecs, queries, k=10)
    idx.refine(max_batch=512)
    after = recall_at_k(idx, vecs, queries, k=10)
    assert after >= before - 0.02, (before, after)
    assert idx.graph_nodes == 1200


class TestBulkBuild:
    def test_bulk_build_matches_incremental_quality(self):
        rng = np.random.default_rng(5)
        n, d, k = 6000, 16, 10
        vecs = rng.normal(size=(n, d)).astype(np.float32)
        g = GraphDeviceIndex(d, space_type=EUC, quantization=F32, connectivity=8, expansion_add=32,
                             expansion_search=64, device=CPU)
        g.upsert_batch(np.arange(n), np.zeros(n, np.int32), vecs)
        assert g.bulk_build() == n
        assert g.graph_nodes == n and g.delta_count == 0 and g.last_build == "host"
        queries = vecs[:64] + 0.05 * rng.normal(size=(64, d)).astype(np.float32)
        gt = np.argsort(((queries[:, None, :] - vecs[None, :, :]) ** 2).sum(-1), axis=1)[:, :k]
        res = g.search(queries, k, expansion=128)
        recall = np.mean([len(set(r.slots.tolist()) & set(gt[i].tolist())) / k for i, r in enumerate(res)])
        assert recall >= 0.9, recall

    def test_merge_delta_auto_bulk(self, monkeypatch):
        """An empty graph with a large contiguous backlog takes the device
        bulk build, and a small max_batch does not fragment it."""
        monkeypatch.setattr(GraphDeviceIndex, "BULK_BUILD_THRESHOLD", 1000)
        rng = np.random.default_rng(6)
        n, d = 1500, 8
        vecs = rng.normal(size=(n, d)).astype(np.float32)
        g = GraphDeviceIndex(d, space_type=COS, quantization=F32, connectivity=8, expansion_add=32, device=CPU)
        g.upsert_batch(np.arange(n), np.zeros(n, np.int32), vecs)
        assert g.merge_delta(128) == n
        assert g.graph_nodes == n and g.last_build == "device"
        res = g.search(vecs[:4], 3)
        assert res[0].slots[0] == 0


class TestGraphIdsOnlyPull:
    def test_ids_pull_matches_full_pull(self):
        """Float storage resolves the beam's winners as ids with exact f32
        host distances: the same slots as the beam's own device
        distances, in exact ascending order."""
        idx, vecs = build_index(n=1024, d=16)
        queries = vecs[:8] + 0.01 * np.random.default_rng(13).normal(size=(8, 16)).astype(np.float32)
        pend = idx.search_begin(queries, 5)
        assert pend.graph_ids and pend.graph_d is None
        got = idx.search_collect(pend)
        qs, qa = distance.prepare_queries(queries, EUC, F32)
        st = idx.store
        allow = torch.ones(st.capacity, dtype=torch.bool)
        full_d, full_i = graph_beam_search(
            st.vectors, st.aux, idx._valid(), allow, idx.adjacency, idx._entries_tensor(), qs, qa,
            space=EUC, quant=F32, k=16, beam_width=48, iters=48, filtered=False, expand=idx.beam_expand,
        )
        for b, g in enumerate(got):
            assert g.slots[0] == full_i[b, 0]
            assert set(g.slots.tolist()) == set(full_i[b, :5].tolist())
            np.testing.assert_allclose(np.sort(g.distances), full_d[b, :5].numpy(), atol=2e-2)
            assert (np.diff(g.distances) >= -1e-6).all()


class TestGraphRescoring:
    """Near-tied rows whose spacing I8 quantization destroys come back in
    exact order with rescoring (oversampled beam + exact f32 host
    re-rank) and in storage-precision order with rescoring=False."""

    N = 400
    QUERY = np.array([0.5, 0.3, 0.7] + [0.0] * 13, dtype=np.float32)

    def _near_tied(self):
        out = np.tile(self.QUERY, (self.N, 1))
        i = np.arange(self.N, dtype=np.float32)[:, None]
        out[:, :3] += i * 0.001 * np.array([2.0, 4.0, 8.0], np.float32)
        return out

    def _built(self, **kw):
        idx = GraphDeviceIndex(16, space_type=EUC, quantization=I8, initial_capacity=1024, connectivity=8,
                               expansion_add=32, expansion_search=256, device=CPU, **kw)
        vecs = self._near_tied()
        order = np.arange(self.N)
        np.random.default_rng(7).shuffle(order)
        idx.upsert_batch(order, np.zeros(self.N, np.int32), vecs[order])
        while idx.merge_delta(max_batch=256):
            pass
        assert idx.graph_nodes == self.N and idx.delta_count == 0
        return idx

    def test_rescoring_restores_exact_order(self):
        idx = self._built(oversample=5, rescoring=True)
        assert idx.oversample == 5 and idx.rescoring
        res = idx.search(self.QUERY[None, :], k=64)[0]
        assert res.slots.shape[0] <= 64  # the oversampled fetch stays inside k
        got = res.slots.tolist()
        assert got == sorted(got), f"exact order expected, got {got[:12]}..."

    def test_rescoring_false_exposes_storage_order(self):
        idx = self._built(rescoring=False)
        assert idx.oversample == 1 and not idx.rescoring
        got = idx.search(self.QUERY[None, :], k=64)[0].slots[:64].tolist()
        assert got != sorted(got), "rescoring=False never reached the beam's resolution"

    def test_default_oversample_for_lossy_quant(self):
        idx = self._built()
        assert idx.oversample == 4 and idx.rescoring


def test_preview_traversal_is_refused(monkeypatch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GraphDeviceIndex(16, device=CPU, preview_dims=8)
    monkeypatch.setenv("VECTOR_STORE_GRAPH_PREVIEW", "16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GraphDeviceIndex(16, quantization=I8, device=CPU)
