"""The exact scan's extent (``FlatDeviceIndex._flat_search``), on the CPU.

The scan reads the blocks up to ``high``, the mark past which no slot was
ever written, and ranks them in one pass where the batch and the extent
fit its chunk budget (``PLAIN_CHUNK_ELEMS``); otherwise chunk by chunk
with a stable merge. For I8 and B1 storage, cosine and euclidean, every
case holds the bounded scan to

- the JAX package's ``_flat_search`` over the whole capacity: B1
  distances and slots equal; I8 distances within 1e-6 relative and slots
  equal wherever a distance is not tied;
- the port's block-by-block walk of the whole capacity (``high`` at the
  capacity and a chunk budget of one block), bit for bit.

Cases: a delta holding only a build's spill rows; slots freed below the
mark and reused; an upsert past the mark; growth by the reserve
increment; a device allow mask; fewer live rows than k ((+inf, -1)
padding); equal distances across a 4,096-row block edge (the lower slot
wins); chunked walks where the batch and extent pass the budget, forced
by a smaller budget and at the real one.

The counters ``scan_rows`` and ``scan_capacity_rows`` (``flat_scans``):
a 131,072-row delta holding 7,000 rows reads 8,192 rows a search; an
upsert past the mark raises what a search reads, a remove does not lower
it; the IVF engine's counters run on across a rebuild's swap, and the
service's internals counters sum them over the served indexes.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import to_jax  # noqa: E402
from vector_store_tpu.engine import flat as jflat  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.engine import flat  # noqa: E402
from vector_store_tpu_torch.engine.flat import FlatDeviceIndex, normalize_rows  # noqa: E402
from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex  # noqa: E402
from vector_store_tpu_torch.ops import distance  # noqa: E402

I8, B1 = Quantization.I8, Quantization.B1
COSINE, EUCLIDEAN = SpaceType.COSINE, SpaceType.EUCLIDEAN
CPU = torch.device("cpu")
D, BLOCK, CAP, NQ = 40, 256, 4096, 12


def rows(rng, n, space, quant):
    """Rows an index stores without clipping: unit rows for cosine, small
    components for euclidean I8, plain normals for B1."""
    x = rng.normal(size=(n, D)).astype(np.float32)
    if quant is B1:
        return x
    return normalize_rows(x) if space is COSINE else 0.3 * x


def make(quant, space, cap=CAP, block=BLOCK, **kw):
    return FlatDeviceIndex(D, space, quant, device=CPU, initial_capacity=cap, block_rows=block, **kw)


def write(idx, slots, x):
    slots = np.asarray(slots)
    idx.upsert_batch(slots, np.zeros(slots.size, np.int32), x)


def spill(idx, x):
    """Rows at [0, n) as a build leaves its delta: the device bulk path
    (B1 has none: its rows go through upsert_batch)."""
    if idx.quantization is B1:
        write(idx, np.arange(x.shape[0]), x)
    else:
        idx.upsert_bulk_device(0, x.shape[0], torch.from_numpy(x), x)


def near(rng, x, n=NQ):
    return x[rng.integers(0, x.shape[0], n)] + 0.05 * rng.normal(size=(n, D)).astype(np.float32)


def case_spill(rng, quant, space):
    x = rows(rng, 700, space, quant)
    idx = make(quant, space)
    spill(idx, x)
    assert idx.high == 700
    return idx, near(rng, x), None


def case_freed_reused(rng, quant, space):
    x = rows(rng, 700, space, quant)
    idx = make(quant, space)
    spill(idx, x)
    freed = np.arange(0, 700, 5)
    idx.remove_batch(freed)
    y = rows(rng, freed.size // 2, space, quant)
    write(idx, freed[: y.shape[0]], y)
    assert idx.high == 700
    return idx, np.concatenate([near(rng, x, 6), near(rng, y, 6)]), None


def case_past_mark(rng, quant, space):
    x = rows(rng, 700, space, quant)
    idx = make(quant, space)
    spill(idx, x)
    far = rows(rng, 1, space, quant)
    write(idx, [3000], far)
    assert idx.high == 3001
    return idx, np.concatenate([near(rng, x, NQ - 1), far]), None


def case_growth(rng, quant, space):
    x = rows(rng, 500, space, quant)
    idx = make(quant, space, cap=512, reserve_increment=512)
    write(idx, np.arange(500), x)
    far = rows(rng, 1, space, quant)
    write(idx, [1100], far)
    assert (idx.capacity, idx.high) == (1280, 1101)
    return idx, np.concatenate([near(rng, x, NQ - 1), far]), None


def case_allow_mask(rng, quant, space):
    x = rows(rng, 700, space, quant)
    idx = make(quant, space)
    spill(idx, x)
    allow = rng.random(idx.capacity) < 0.5
    return idx, near(rng, x), allow


def case_few_rows(rng, quant, space):
    x = rows(rng, 5, space, quant)
    idx = make(quant, space, block=32)  # extent 32 < k 64
    write(idx, np.arange(5), x)
    idx.remove_batch([2])
    return idx, near(rng, x), None


def case_block_edge(rng, quant, space):
    x = rows(rng, 5000, space, quant)
    x[4090:4102] = x[4090]  # twelve equal rows across the edge at 4096
    idx = make(quant, space, cap=8192, block=4096)
    spill(idx, x)
    return idx, np.concatenate([x[[4090] * 4], near(rng, x, NQ - 4)]), None


CASES = {
    "spill": case_spill,
    "freed_reused": case_freed_reused,
    "past_mark": case_past_mark,
    "growth": case_growth,
    "allow_mask": case_allow_mask,
    "few_rows": case_few_rows,
    "block_edge": case_block_edge,
}


def prepared(idx, queries):
    if idx.normalize:
        queries = normalize_rows(queries)
    return distance.prepare_queries(queries, idx.space_type, idx.quantization)


def bias(idx, allow):
    return None if allow is None else idx.masked_bias(torch.from_numpy(allow))


def walk_whole(idx, qs, k, b, monkeypatch):
    """The scan before the bound: every block of the capacity, one at a
    time."""
    with monkeypatch.context() as m:
        m.setattr(flat, "PLAIN_CHUNK_ELEMS", 1)
        m.setattr(idx, "high", idx.capacity)
        return idx._flat_search(qs, k, b=b)


def jax_whole(idx, qs, q_aux, k, allow):
    cap = idx.capacity
    packed = jflat._flat_search(
        jnp.asarray(idx.vectors.numpy()), jnp.asarray(idx.aux.numpy()), jnp.asarray(idx._epochs_host),
        jnp.asarray(idx._valid_host), jnp.asarray(idx.parts.numpy()), jnp.asarray(qs.numpy()),
        jnp.asarray(q_aux.numpy()), jnp.full((qs.shape[0],), -1, jnp.int32),
        jnp.asarray(np.ones(cap, bool) if allow is None else allow),
        space=to_jax(idx.space_type), quant=to_jax(idx.quantization), k=k, block_rows=idx.block_rows,
        approx=False, use_parts=False,
    )
    jd, ji, _ = jflat.unpack_results(np.asarray(packed))
    return jd, ji


def assert_like_jax(idx, dist, slots, jd, ji, rtol=1e-6):
    """Empty places (+inf; the port's slot -1, the JAX scan's its
    position) alike. B1: distances and slots equal. I8: distances within
    rtol of the batch's largest finite one, slots equal wherever a
    distance is not tied in its row."""
    d, i = dist.numpy(), slots.numpy()
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(d), fin)
    np.testing.assert_array_equal(i[~fin], -1)
    if idx.quantization is B1:
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(i[fin], ji[fin])
        return
    atol = rtol * float(np.abs(jd[fin]).max())
    np.testing.assert_allclose(d[fin], jd[fin], rtol=rtol, atol=atol)
    for dg, ig, iw in zip(d, i, ji):
        tied = np.isclose(dg[:, None], dg[None, :], rtol=rtol, atol=atol).sum(1) > 1
        np.testing.assert_array_equal(ig[~tied], iw[~tied])


def check(idx, queries, allow, monkeypatch, k=None):
    k = idx.lossy_fetch(8) if k is None else k
    qs, q_aux = prepared(idx, queries)
    b = bias(idx, allow)
    dist, slots = idx._flat_search(qs, k, b=b)
    want_d, want_i = walk_whole(idx, qs, k, b, monkeypatch)
    assert torch.equal(dist, want_d) and torch.equal(slots, want_i)
    assert_like_jax(idx, dist, slots, *jax_whole(idx, qs, q_aux, k, allow))
    return dist, slots


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("space", (COSINE, EUCLIDEAN), ids=lambda s: s.name)
@pytest.mark.parametrize("quant", (I8, B1), ids=lambda q: q.name)
def test_bounded_scan_answers_like_the_whole_capacity(quant, space, case, monkeypatch):
    rng = np.random.default_rng([list(CASES).index(case), quant is I8, space is COSINE])
    idx, queries, allow = CASES[case](rng, quant, space)
    before = idx.flat_scans()
    dist, slots = check(idx, queries, allow, monkeypatch)
    extent = -(-idx.high // idx.block_rows) * idx.block_rows
    assert idx.flat_scans()[0] - before[0] >= extent  # this scan read the extent (and the walk all)
    s = slots.numpy()
    live = idx._valid_host[np.maximum(s, 0)] & (s >= 0)
    assert (live == np.isfinite(dist.numpy())).all()
    if allow is not None:
        assert allow[s[s >= 0]].all()
    if case == "few_rows":  # four live rows, then (+inf, -1) padding
        assert (s[:, :4] >= 0).all() and (s[:, 4:] == -1).all()
        assert np.isinf(dist.numpy()[:, 4:]).all()
    if case in ("past_mark", "growth"):  # the row past the old mark is found
        assert s[-1, 0] == idx.high - 1
    if case == "block_edge":  # equal rows across the edge: the lower slots win
        np.testing.assert_array_equal(s[:4, :4], np.tile(np.arange(4090, 4094), (4, 1)))


@pytest.mark.parametrize("blocks", (1, 2), ids=("block_by_block", "two_block_chunks"))
@pytest.mark.parametrize("space", (COSINE, EUCLIDEAN), ids=lambda s: s.name)
@pytest.mark.parametrize("quant", (I8, B1), ids=lambda q: q.name)
def test_scan_past_the_budget_walks_in_chunks(quant, space, blocks, monkeypatch):
    """A batch and extent past the chunk budget walk chunks of whole
    blocks with the stable merge, and answer as one pass does."""
    rng = np.random.default_rng(7)
    idx, queries, _ = case_spill(rng, quant, space)  # extent: three blocks
    width = 8 * idx.dp if quant is B1 else idx.dp
    k = idx.lossy_fetch(8)
    qs, _ = prepared(idx, queries)
    one_pass = idx._flat_search(qs, k)
    with monkeypatch.context() as m:
        m.setattr(flat, "PLAIN_CHUNK_ELEMS", blocks * max(NQ, width) * BLOCK)
        chunked = check(idx, queries, None, monkeypatch)
    assert torch.equal(chunked[0], one_pass[0]) and torch.equal(chunked[1], one_pass[1])


def test_batch_past_the_real_budget_walks_block_by_block(monkeypatch):
    """2,049 queries over two 4,096-row blocks pass 2^24 distances: the
    scan walks the blocks one at a time, as the JAX package does."""
    rng = np.random.default_rng(8)
    x = rows(rng, 5000, COSINE, I8)
    idx = make(I8, COSINE, cap=8192, block=4096)
    spill(idx, x)
    queries = near(rng, x, 2049)
    assert queries.shape[0] * 8192 > flat.PLAIN_CHUNK_ELEMS
    check(idx, queries, None, monkeypatch)


def test_scan_reads_the_written_blocks_only():
    """A 131,072-row delta holding 7,000 rows reads 8,192 rows a search;
    an upsert past the mark raises the count, a remove does not lower it."""
    rng = np.random.default_rng(9)
    idx = make(I8, COSINE, cap=131_072, block=4096, reserve_increment=131_072)
    x = rows(rng, 7000, COSINE, I8)
    spill(idx, x)
    assert (idx.capacity, idx.high, idx.flat_scans()) == (131_072, 7000, (0, 0))
    q = near(rng, x, 4)
    idx.search(q, 10)
    assert idx.flat_scans() == (8192, 131_072)
    write(idx, [20_000], x[:1])
    idx.search(q, 10)
    assert idx.flat_scans() == (8192 + 20_480, 2 * 131_072)
    idx.remove_batch(np.concatenate([np.arange(0, 7000, 2), [20_000]]))
    assert idx.high == 20_001
    idx.search(q, 10)
    assert idx.flat_scans() == (8192 + 2 * 20_480, 3 * 131_072)


def test_load_state_sets_the_mark_from_the_valid_slots():
    rng = np.random.default_rng(10)
    src = make(I8, COSINE)
    write(src, np.arange(900), rows(rng, 900, COSINE, I8))
    src.remove_batch(np.arange(600, 900))
    state = {
        "vectors": src.vectors.numpy(), "paux": np.stack([src.a.numpy(), src.b.numpy()]),
        "valid": src._valid_host, "epochs": src._epochs_host, "_vecs_host": None,
        "rescore_vectors": src.rescore_vectors.float().numpy(), "rescore_aux": src.rescore_aux.numpy(),
        "_part_bucket": {}, "_part_rows_host": None, "_part_count": None,
        "_slot_part": np.full(src.capacity, -1), "_slot_pos": np.full(src.capacity, -1),
        "_part_overflow": False,
    }
    dst = make(I8, COSINE)
    dst.load_state(state)
    assert dst.high == 600
    empty = make(I8, COSINE)
    empty.load_state({**state, "valid": np.zeros(src.capacity, bool)})
    assert empty.high == 0
    qs, _ = prepared(empty, rows(rng, 3, COSINE, I8))
    d, i = empty._flat_search(qs, 16)  # nothing written: nothing read
    assert empty.flat_scans() == (0, empty.capacity)
    assert np.isinf(d.numpy()).all() and (i.numpy() == -1).all()


@pytest.mark.parametrize("space", (COSINE, EUCLIDEAN), ids=lambda s: s.name)
def test_ivf_build_bounds_its_delta(space, monkeypatch):
    """After an I8 build the fresh delta holds only the spill rows: its
    mark is the engine's next position, a search reads the blocks up to
    it, and the counters run on across the next rebuild's swap."""
    rng = np.random.default_rng(11)
    n = 4096
    x = rows(rng, n, space, I8)
    x[: n // 2] = x[0]  # half the rows in one spot: more than two clusters hold
    p = IvfDeviceIndex(
        D, space_type=space, quantization=I8, device=CPU, initial_capacity=n,
        min_build=1024, kmeans_block=1024, nprobe=16, kmeans_iters=4,
    )
    p.upsert_batch(np.arange(n), np.zeros(n, np.int32), x)
    assert p.maintain() and p.main_vecs is not None
    delta = p._delta
    assert 0 < delta.size and delta.high == p._delta_next < delta.capacity
    queries = near(rng, x)
    before = p.flat_scans()
    p.search(queries, 10)
    extent = -(-delta.high // delta.block_rows) * delta.block_rows
    assert p.flat_scans() == (before[0] + extent, before[1] + delta.capacity)
    check(delta, queries, None, monkeypatch)

    y = rows(rng, 1100, space, I8)
    p.upsert_batch(np.arange(n, n + 1100), np.zeros(1100, np.int32), y)
    p.search(queries, 10)
    counted = p.flat_scans()
    assert p.maintain() and p._delta is not delta  # a second build swapped a fresh delta in
    assert p.flat_scans() == counted


def test_internals_sum_the_served_scans():
    from vector_store_tpu_torch.run import _Internals
    from vector_store_tpu_torch.service.indexes import Indexes

    rng = np.random.default_rng(12)
    a, b = make(I8, COSINE), make(B1, COSINE)
    write(a, np.arange(300), rows(rng, 300, COSINE, I8))
    write(b, np.arange(600), rows(rng, 600, COSINE, B1))
    a.search(rows(rng, 2, COSINE, I8), 5)
    b.search(rows(rng, 2, COSINE, B1), 5)
    indexes = Indexes()
    for key, engine in (("a", a), ("b", b), ("host", object())):  # a host engine has no scan
        indexes.vs_entries[key] = SimpleNamespace(actor=SimpleNamespace(engine=engine))
    counters = _Internals(indexes).counters()
    assert counters["flat-scan-rows"] == 512 + 768
    assert counters["flat-scan-capacity-rows"] == 2 * CAP
