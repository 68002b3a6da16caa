"""Kernel 1 (fused rank scan): the port's plain version against the JAX
Pallas kernel run in interpret mode, on the same numpy inputs.

The JAX kernel reports each candidate as an f32 offset; its position is
block_base + offset + lane. Ranks agree within 1e-5 * (1 + |r|) (f32 sums
in another order); positions must be equal except in groups whose two
best ranks lie within that tolerance of each other (a near tie may go
either way).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import to_jax  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu.ops import pallas_scan as jscan  # noqa: E402
from vector_store_tpu_torch.ops import fused_scan  # noqa: E402
from vector_store_tpu_torch.ops.distance import prepare_queries  # noqa: E402

N, D, B, BLOCK = 4096, 64, 8, 256
LANES = fused_scan.LANES
RTOL = 1e-5


def _case(space, quant, seed=9):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    queries = rng.normal(size=(B, D)).astype(np.float32)
    if space is SpaceType.COSINE:
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    vs, _ = prepare_queries(vecs, space, quant)
    qs, _ = prepare_queries(queries, space, quant)
    a, b = fused_scan.paux_coeffs(space, vs)
    dead = rng.random(N) < 0.05  # tombstoned rows
    b[torch.from_numpy(dead)] = fused_scan.INVALID_BIAS
    return vs, qs, a, b


def _jax_inputs(vs, qs, a, b, quant):
    from vector_store_tpu.ops.quantize import storage_dtype

    dt = storage_dtype(to_jax(quant))
    pad = lambda x: np.pad(x.float().numpy(), [(0, 0), (0, 128 - x.shape[1])])  # noqa: E731
    paux = np.zeros((8, N), np.float32)
    paux[0], paux[1] = a.numpy(), b.numpy()
    return jnp.asarray(pad(qs), dt), jnp.asarray(pad(vs), dt), jnp.asarray(paux)


def near_tie_mask(rank_full: torch.Tensor, nrows: int) -> np.ndarray:
    """[B, groups*128] True where a group's two best ranks are within tol."""
    nq = rank_full.shape[0]
    g = rank_full.view(nq, -1, nrows // LANES, LANES)
    two = torch.topk(g, 2, dim=2, largest=False).values
    gap = (two[:, :, 1] - two[:, :, 0]).abs()
    return (gap <= RTOL * (1 + two[:, :, 0].abs())).reshape(nq, -1).numpy()


@pytest.mark.parametrize("quant", (Quantization.F32, Quantization.BF16))
@pytest.mark.parametrize("space", (SpaceType.EUCLIDEAN, SpaceType.COSINE))
def test_plain_matches_pallas_kernel(space, quant):
    vs, qs, a, b = _case(space, quant)
    rank, pos = fused_scan.fused_scan(qs, vs, a, b, BLOCK)  # CPU: plain version
    assert rank.shape == pos.shape == (B, N // BLOCK * LANES)
    assert pos.dtype == torch.int32

    jr, jo = jscan._fused_scan(*_jax_inputs(vs, qs, a, b, quant), block_rows=BLOCK, interpret=True)
    jr, jo = np.asarray(jr), np.asarray(jo)
    lanes = np.tile(np.arange(LANES), N // BLOCK)
    base = np.repeat(np.arange(N // BLOCK) * BLOCK, LANES)
    jpos = base + jo.astype(np.int64) + lanes

    np.testing.assert_allclose(rank.numpy(), jr, rtol=RTOL, atol=RTOL)
    full = a * (qs.float() @ vs.float().T) + b
    ok = ~near_tie_mask(full, BLOCK)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(pos.numpy()[ok], jpos[ok])
    # every candidate is its group's true minimum
    np.testing.assert_array_equal(
        full.gather(1, pos.long()).numpy(), rank.numpy()
    )


@pytest.mark.parametrize("space", (SpaceType.EUCLIDEAN, SpaceType.DOT_PRODUCT))
def test_rank_search_matches_pallas_ids(space):
    quant = Quantization.F32
    vs, qs, a, b = _case(space, quant, seed=10)
    k = 10
    rank, ids = fused_scan.rank_search(vs, a, b, qs, k=k, block_rows=BLOCK)
    jq, jv, jp = _jax_inputs(vs, qs, a, b, quant)
    packed = np.asarray(jscan.pallas_rank_search(jv, jp, jq, k=k, block_rows=BLOCK, interpret=True))
    np.testing.assert_allclose(rank.numpy(), packed[0], rtol=RTOL, atol=RTOL)
    np.testing.assert_array_equal(ids.numpy(), packed[1].view(np.int32))
    assert (torch.diff(rank, dim=1) >= 0).all()


def test_rank_search_pads_and_drops_dead_rows():
    vs, qs, a, b = _case(SpaceType.EUCLIDEAN, Quantization.F32)
    b[:] = fused_scan.INVALID_BIAS
    b[:3] = 0.0  # three live rows only
    rank, ids = fused_scan.rank_search(vs, a, b, qs, k=5, block_rows=N)
    assert (ids[:, :3] >= 0).all() and (ids[:, 3:] == -1).all()
    rank, ids = fused_scan.rank_search(vs[:LANES], a[:LANES], b[:LANES], qs, k=200, block_rows=LANES)
    assert ids.shape == (B, 200) and (ids[:, LANES:] == -1).all()


def test_wrapper_checks_inputs_and_device():
    vs, qs, a, b = _case(SpaceType.EUCLIDEAN, Quantization.F32)
    launches = fused_scan.fused_scan.launches
    with pytest.raises(TypeError):
        fused_scan.fused_scan(qs.half(), vs, a, b, BLOCK)
    with pytest.raises(ValueError):
        fused_scan.fused_scan(qs[:, :60].contiguous(), vs[:, :60].contiguous(), a, b, BLOCK)
    with pytest.raises(ValueError):
        fused_scan.fused_scan(qs, vs, a, b, 300)
    with pytest.raises(ValueError):
        fused_scan.fused_scan(qs.t().contiguous().t(), vs, a, b, BLOCK)
    meta = [t.to("meta") for t in (qs, vs, a, b)]
    with pytest.raises(ValueError, match="no scan kernel"):
        fused_scan.fused_scan(*meta, BLOCK)
    assert fused_scan.fused_scan.launches == launches  # CPU never counts
