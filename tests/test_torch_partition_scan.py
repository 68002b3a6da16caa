"""Kernel 3 (partition rank scan): the port's plain version against the JAX
Pallas kernel run in interpret mode, on the same numpy inputs.

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


def _case(space, quant, seed=3):
    """Partition-major storage with ~5% empty positions and one empty
    bucket (4), queries and their buckets."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(P * PMAX, D)).astype(np.float32)
    queries = rng.normal(size=(B, D)).astype(np.float32)
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
    bsel = torch.from_numpy(rng.integers(0, P, size=B).astype(np.int32))
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
    sel = bsel.long()
    v = vs.float().view(P, PMAX, -1)[sel]
    return a.view(P, PMAX)[sel] * torch.einsum("bd,bmd->bm", qs.float(), v) + b.view(P, PMAX)[sel]


@pytest.mark.parametrize("quant", (Quantization.F32, Quantization.BF16))
@pytest.mark.parametrize("space", (SpaceType.EUCLIDEAN, SpaceType.COSINE))
def test_plain_matches_pallas_kernel(space, quant):
    vs, qs, a, b, bsel, _ = _case(space, quant)
    rank, pos = ps.partition_scan(vs, a, b, qs, bsel, PMAX)  # CPU: plain version
    assert rank.shape == pos.shape == (B, LANES) and pos.dtype == torch.int32

    jv, jp, jq = _jax_inputs(vs, qs, a, b, quant)
    jr, jo = jpart.partition_rank_scan(jv, jp, jq, jnp.asarray(bsel.numpy()), pmax=PMAX, interpret=True)
    jr, jo = np.asarray(jr), np.asarray(jo)
    jpos = bsel.numpy()[:, None].astype(np.int64) * PMAX + jo.astype(np.int64) + np.arange(LANES)

    np.testing.assert_allclose(rank.numpy(), jr, rtol=RTOL, atol=RTOL)
    full = _full_ranks(vs, qs, a, b, bsel)
    two = torch.topk(full.view(B, PMAX // LANES, LANES), 2, dim=1, largest=False).values
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
