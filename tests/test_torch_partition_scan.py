"""Kernel 3 (partition rank scan): the port's plain version against the JAX
Pallas kernel run in interpret mode, on the same numpy inputs; and the
plain versions of what the CUDA kernel adds around the scan: the batch
sorted into bucket tiles, the split of a bucket's rows into chunks, and the
merge of the chunks' candidates.

The partition-major storage holds P buckets of pmax positions; each query
scans only its bucket bsel[i]. The JAX kernel reports each candidate as an
f32 offset; its position is bsel * pmax + offset + lane. Ranks agree
within 1e-5 * (1 + |r|) (f32 sums in another order); positions must be
equal except in lane groups whose two best ranks differ by no more than
that tolerance (a near tie may go either way; an exact tie goes to the
smaller position on both sides).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import to_jax  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu.ops import partition_scan as jpart  # noqa: E402
from vector_store_tpu_torch.ops import fused_scan  # noqa: E402
from vector_store_tpu_torch.ops import partition_scan as ps  # noqa: E402
from vector_store_tpu_torch.ops.distance import prepare_queries  # noqa: E402

P, PMAX, D, B = 6, 256, 64, 8
LANES = fused_scan.LANES
RTOL = 1e-5


def _case(space, quant, seed=3, n_queries=B):
    """Partition-major storage with ~5% empty positions and one empty
    bucket (4), queries and their buckets."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(P * PMAX, D)).astype(np.float32)
    queries = rng.normal(size=(n_queries, D)).astype(np.float32)
    if space is SpaceType.COSINE:
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    vs, _ = prepare_queries(vecs, space, quant)
    qs, _ = prepare_queries(queries, space, quant)
    a, b = fused_scan.paux_coeffs(space, vs)
    empty = rng.random(P * PMAX) < 0.05
    empty[4 * PMAX : 5 * PMAX] = True
    b[torch.from_numpy(empty)] = fused_scan.INVALID_BIAS
    rows = np.where(empty, -1, 1000 + np.arange(P * PMAX)).astype(np.int32).reshape(P, PMAX)
    bsel = torch.from_numpy(rng.integers(0, P, size=n_queries).astype(np.int32))
    return vs, qs, a, b, bsel, torch.from_numpy(rows)


def _jax_inputs(vs, qs, a, b, quant):
    from vector_store_tpu.ops.quantize import storage_dtype

    dt = storage_dtype(to_jax(quant))
    pad = lambda x: np.pad(x.float().numpy(), [(0, 0), (0, 128 - x.shape[1])])  # noqa: E731
    paux = np.zeros((8, vs.shape[0]), np.float32)
    paux[0], paux[1] = a.numpy(), b.numpy()
    return jnp.asarray(pad(vs), dt), jnp.asarray(paux), jnp.asarray(pad(qs), dt)


def _full_ranks(vs, qs, a, b, bsel):
    """[B, PMAX] exact ranks of each query's bucket."""
    return _full_ranks_of(vs, a, b, qs, bsel, PMAX)


def _full_ranks_of(vs, a, b, qs, bsel, pmax):
    sel = bsel.long()
    v = vs.float().view(-1, pmax, vs.shape[1])[sel]
    return a.view(-1, pmax)[sel] * torch.einsum("bd,bmd->bm", qs.float(), v) + b.view(-1, pmax)[sel]


@pytest.mark.parametrize("quant", (Quantization.F32, Quantization.BF16))
@pytest.mark.parametrize("space", (SpaceType.EUCLIDEAN, SpaceType.COSINE))
def test_plain_matches_pallas_kernel(space, quant):
    _check_against_pallas(*_case(space, quant)[:5], quant)


@pytest.mark.parametrize("quant", (Quantization.F32, Quantization.BF16))
def test_plain_matches_pallas_kernel_on_a_skewed_batch(quant):
    """A batch whose hot bucket holds more than two of the CUDA kernel's
    query tiles, beside queries on other buckets and the empty one."""
    vs, qs, a, b, _, _ = _case(SpaceType.DOT_PRODUCT, quant, seed=9, n_queries=40)
    rng = np.random.default_rng(9)
    bsel = np.r_[np.full(2 * ps.TILE_QUERIES + 3, 1), [4, 0, 5, 1, 2]].astype(np.int32)
    _check_against_pallas(vs, qs, a, b, torch.from_numpy(rng.permutation(bsel)), quant)


def _check_against_pallas(vs, qs, a, b, bsel, quant):
    nq = qs.shape[0]
    rank, pos = ps.partition_scan(vs, a, b, qs, bsel, PMAX)  # CPU: plain version
    assert rank.shape == pos.shape == (nq, LANES) and pos.dtype == torch.int32

    jv, jp, jq = _jax_inputs(vs, qs, a, b, quant)
    jr, jo = jpart.partition_rank_scan(jv, jp, jq, jnp.asarray(bsel.numpy()), pmax=PMAX, interpret=True)
    jr, jo = np.asarray(jr), np.asarray(jo)
    jpos = bsel.numpy()[:, None].astype(np.int64) * PMAX + jo.astype(np.int64) + np.arange(LANES)

    np.testing.assert_allclose(rank.numpy(), jr, rtol=RTOL, atol=RTOL)
    full = _full_ranks(vs, qs, a, b, bsel)
    two = torch.topk(full.view(nq, PMAX // LANES, LANES), 2, dim=1, largest=False).values
    gap = two[:, 1] - two[:, 0]
    # exact ties (the empty bucket's 1e30s) must go to the smaller position
    near_tie = ((gap > 0) & (gap <= RTOL * (1 + two[:, 0].abs()))).numpy()
    assert (~near_tie).mean() > 0.9
    np.testing.assert_array_equal(pos.numpy()[~near_tie], jpos[~near_tie])
    # every candidate is its lane group's true minimum, inside its bucket
    off = pos.long() - bsel.long()[:, None] * PMAX
    assert ((off >= 0) & (off < PMAX) & (off % LANES == torch.arange(LANES))).all()
    np.testing.assert_array_equal(full.gather(1, off).numpy(), rank.numpy())


def test_plain_chunks_bound_memory(monkeypatch):
    """The plain version gathers a few queries' buckets at a time; chunked
    and whole-batch results are identical."""
    vs, qs, a, b, bsel, _ = _case(SpaceType.EUCLIDEAN, Quantization.F32)
    whole = ps.partition_scan_plain(vs, a, b, qs, bsel, PMAX)
    monkeypatch.setattr(ps, "PLAIN_CHUNK_ELEMS", 3 * PMAX * D)  # 3 queries a chunk
    chunked = ps.partition_scan_plain(vs, a, b, qs, bsel, PMAX)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


@pytest.mark.parametrize("k", (5, 40, 200))
def test_candidates_match_jax(k):
    """Slots of the full partitioned search, with an unknown partition
    (bsel -1) and a query on the empty bucket 4."""
    quant = Quantization.F32
    vs, qs, a, b, bsel, rows = _case(SpaceType.DOT_PRODUCT, quant, seed=4)
    bsel[2], bsel[5] = -1, 4
    ids = ps.partition_candidates(vs, a, b, rows, qs, bsel, k=k, pmax=PMAX)
    assert ids.shape == (B, k) and ids.dtype == torch.int32

    jv, jp, jq = _jax_inputs(vs, qs, a, b, quant)
    want = jpart.partition_candidates(
        jv, jp, jnp.asarray(rows.numpy()), jq, jnp.asarray(bsel.numpy()), k=k, pmax=PMAX, interpret=True
    )
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    assert (ids[2] == -1).all() and (ids[5] == -1).all()
    assert (ids[0, : min(k, LANES)] >= 1000).all()  # full buckets fill min(k, 128)
    if k > LANES:
        assert (ids[:, LANES:] == -1).all()


def test_wrapper_checks_inputs_and_device():
    vs, qs, a, b, bsel, _ = _case(SpaceType.EUCLIDEAN, Quantization.F32)
    launches = ps.partition_scan.launches
    with pytest.raises(TypeError):
        ps.partition_scan(vs, a, b, qs.half(), bsel, PMAX)
    with pytest.raises(ValueError):  # pmax not a whole number of lanes
        ps.partition_scan(vs, a, b, qs, bsel, 192)
    with pytest.raises(ValueError):  # positions not a whole number of buckets
        ps.partition_scan(vs[:-LANES], a[:-LANES], b[:-LANES], qs, bsel, PMAX)
    with pytest.raises(ValueError):
        ps.partition_scan(vs, a, b, qs, bsel.long(), PMAX)
    with pytest.raises(ValueError):
        ps.partition_scan(vs, a, b, qs, bsel[:3], PMAX)
    with pytest.raises(ValueError):
        ps.partition_scan(vs, a, b, qs.t().contiguous().t(), bsel, PMAX)
    meta = [t.to("meta") for t in (vs, a, b, qs, bsel)]
    with pytest.raises(ValueError, match="no scan kernel"):
        ps.partition_scan(*meta, PMAX)
    assert ps.partition_scan.launches == launches  # CPU never counts


# -- the CUDA kernel's tiling, split and merge, in their plain versions ------


def _bsel(layout, rng):
    return {
        "uniform": lambda: rng.integers(0, 50, size=300),
        "zipf": lambda: rng.zipf(1.1, size=300) % 50,
        "one bucket": lambda: np.full(2 * ps.TILE_QUERIES + 5, 7),
        "B 1": lambda: np.array([3]),
        "empty": lambda: np.zeros(0, np.int64),
    }[layout]().astype(np.int32)


@pytest.mark.parametrize("layout", ["uniform", "zipf", "one bucket", "B 1", "empty"])
def test_bucket_tiles_against_numpy(layout):
    """Every query in exactly one tile, a tile inside one bucket with at
    most TILE_QUERIES queries, queries of a bucket in batch order."""
    bsel = _bsel(layout, np.random.default_rng(len(layout)))
    perm, sorted_bsel, run_start = ps.bucket_order(torch.from_numpy(bsel))
    order = np.argsort(bsel, kind="stable")
    np.testing.assert_array_equal(perm.numpy(), order)
    np.testing.assert_array_equal(sorted_bsel.numpy(), bsel[order])
    assert sorted_bsel.dtype == run_start.dtype == torch.int32
    want = []  # (first sorted position, count): each bucket's run cut every TILE_QUERIES
    for bucket in np.unique(bsel):
        run = np.flatnonzero(bsel[order] == bucket)
        want += [(run[k], min(ps.TILE_QUERIES, run.size - k)) for k in range(0, run.size, ps.TILE_QUERIES)]
    got = ps.tiles(sorted_bsel, run_start)
    np.testing.assert_array_equal(got.numpy().reshape(-1, 2), np.array(want, np.int64).reshape(-1, 2))
    covered = np.concatenate([np.arange(f, f + n) for f, n in want] or [np.zeros(0, np.int64)])
    np.testing.assert_array_equal(np.sort(covered), np.arange(bsel.size))
    for f, n in want:
        assert 1 <= n <= ps.TILE_QUERIES and len(set(bsel[order][f : f + n])) == 1


@pytest.mark.parametrize(
    "nq,pmax,chunk",
    [(2048, 1024, 1024), (264, 1024, 1024), (132, 1024, 512), (64, 1024, 128), (8, 1024, 128), (8, 16384, 384),
     (1, 128, 128), (2048, 16384, 16384)],
)
def test_chunk_rows_follow_the_batch(nq, pmax, chunk):
    """A bucket is split only when the batch's tiles give 132
    multiprocessors fewer than two blocks each, into whole lane groups."""
    got = ps.chunk_rows_for(nq, pmax, 132)
    assert got == chunk and got % LANES == 0 and got <= pmax
    assert -(-pmax // got) * nq >= min(2 * 132, nq * pmax // LANES)  # enough blocks, or one per lane group


def _chunk_folds(vs, a, b, qs, bsel, pmax, chunk):
    """The plain fold of each chunk of chunk rows of every bucket, as
    [splits, B, 128] candidates with absolute positions."""
    nb, dp = vs.shape[0] // pmax, vs.shape[1]
    ranks, poss = [], []
    for lo in range(0, pmax, chunk):
        cut = slice(lo, lo + chunk)
        r, p = ps.partition_scan_plain(
            vs.view(nb, pmax, dp)[:, cut].reshape(-1, dp), a.view(nb, pmax)[:, cut].reshape(-1),
            b.view(nb, pmax)[:, cut].reshape(-1), qs, bsel, chunk,
        )
        p = p.long()
        ranks.append(r)
        poss.append(((p // chunk) * pmax + lo + p % chunk).int())
    return torch.stack(ranks), torch.stack(poss)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("chunk", (128, 256, 512))
def test_split_merge_equals_the_unsplit_fold(dtype, chunk):
    """Integer-valued rows rank exactly whatever the order of the sums, so
    the merged chunks must give the unsplit fold bit for bit; bucket 1
    repeats its first 256 rows (ties across chunks on purpose, which the
    smaller position must win) and bucket 2 is empty."""
    rng = np.random.default_rng(chunk)
    nb, pmax, dp, nq = 4, 1024, 16, 30
    vs = torch.from_numpy(rng.integers(-3, 4, size=(nb * pmax, dp)).astype(np.float32)).to(dtype)
    vs.view(nb, pmax, dp)[1, 256:512] = vs.view(nb, pmax, dp)[1, :256]
    qs = torch.from_numpy(rng.integers(-3, 4, size=(nq, dp)).astype(np.float32)).to(dtype)
    a = torch.full((nb * pmax,), -1.0)
    b = torch.from_numpy(rng.integers(0, 3, size=nb * pmax).astype(np.float32))
    b.view(nb, pmax)[1, 256:512] = b.view(nb, pmax)[1, :256]
    b.view(nb, pmax)[2] = fused_scan.INVALID_BIAS
    bsel = torch.from_numpy(rng.integers(0, nb, size=nq).astype(np.int32))
    bsel[:3] = torch.tensor([1, 2, 1], dtype=torch.int32)
    rank, pos = ps.merge_chunks_plain(*_chunk_folds(vs, a, b, qs, bsel, pmax, chunk))
    want_rank, want_pos = ps.partition_scan_plain(vs, a, b, qs, bsel, pmax)
    assert torch.equal(rank, want_rank) and torch.equal(pos, want_pos)
    full = _full_ranks_of(vs, a, b, qs, bsel, pmax)
    groups = full.view(nq, pmax // LANES, LANES)
    assert int((groups == groups.min(dim=1, keepdim=True).values).sum(dim=1).gt(1).sum()) > 100  # many ties


def test_tile_size_is_the_kernels():
    """TILE_QUERIES (the plain tiling's size) is TILE of the CUDA source."""
    import re

    from vector_store_tpu_torch.ops import kernels

    src = (kernels.CSRC_DIR / "partition_scan.cu").read_text()
    assert int(re.search(r"constexpr int TILE = (\d+);", src).group(1)) == ps.TILE_QUERIES
