"""Port ops (vector_store_tpu_torch.ops) against the JAX package's ops on
the same numpy inputs: quantization, distances, top-k, for F32/F16/BF16 x
euclidean/cosine/dot.

Tolerances: storage values must match exactly (both round to nearest
even); distances agree within 1e-6 relative to the largest distance of
the case in F32, and within the storage dtype's epsilon for F16/BF16 (the
inputs are the same quantized values; only the f32 summation order
differs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import to_jax  # noqa: E402
from vector_store_tpu.ops import distance as jdist  # noqa: E402
from vector_store_tpu.ops import pallas_scan as jscan  # noqa: E402
from vector_store_tpu.ops import quantize as jquant  # noqa: E402
from vector_store_tpu.ops import topk as jtopk  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.ops import distance, fused_scan, quantize, topk  # noqa: E402

QUANTS = (Quantization.F32, Quantization.F16, Quantization.BF16)
SPACES = (SpaceType.EUCLIDEAN, SpaceType.COSINE, SpaceType.DOT_PRODUCT)
EPS = {Quantization.F32: 1e-6, Quantization.F16: 2.0**-10, Quantization.BF16: 2.0**-7}


def _data(seed, n=24, b=6, d=13):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(b, d)).astype(np.float32),
        rng.normal(size=(n, d)).astype(np.float32),
    )


def _f32(x):
    return np.asarray(jnp.asarray(x, dtype=jnp.float32))


@pytest.mark.parametrize("quant", QUANTS)
def test_quantize_matches_jax(quant):
    x = np.random.default_rng(1).normal(size=(7, 11)).astype(np.float32) * 3
    got = quantize.quantize_for_storage(x, quant)
    assert got.dtype == quantize.storage_dtype(quant)
    np.testing.assert_array_equal(got.float().numpy(), _f32(jquant.quantize_for_storage(x, to_jax(quant))))
    for d in (1, 3, 8, 13, 128, 1536):
        dp = quantize.padded_dim(d, quant)
        assert dp >= d and dp % 8 == 0 and dp - d < 8


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("space", SPACES)
def test_distances_match_jax(quant, space):
    q, v = _data(2)
    qs, q_aux = distance.prepare_queries(q, space, quant)
    vs, v_aux = distance.prepare_queries(v, space, quant)
    jspace, jquant_t = to_jax(space), to_jax(quant)
    jq, jq_aux = jdist.prepare_queries(q, jspace, jquant_t)
    jv, jv_aux = jdist.prepare_queries(v, jspace, jquant_t)
    d = q.shape[1]
    np.testing.assert_array_equal(qs[:, :d].float().numpy(), _f32(jq)[:, :d])
    np.testing.assert_allclose(q_aux.numpy(), jq_aux, rtol=1e-6)
    np.testing.assert_allclose(v_aux.numpy(), jv_aux, rtol=1e-6)

    want = np.asarray(
        jdist.pairwise_distance(
            jnp.asarray(jq), jnp.asarray(jv), jspace, jquant_t,
            jnp.asarray(jq_aux), jnp.asarray(jv_aux),
        )
    )
    got = distance.pairwise_distance(qs, vs, space, quant, q_aux, v_aux).numpy()
    tol = EPS[quant] * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)

    # per-query gathered rows (the beam-search shape)
    idx = np.random.default_rng(3).integers(0, v.shape[0], size=(q.shape[0], 5))
    want_b = np.asarray(
        jdist.query_block_distance(
            jnp.asarray(jq), jnp.asarray(jv)[idx], jspace, jquant_t,
            jnp.asarray(jq_aux), jnp.asarray(jv_aux)[idx],
        )
    )
    got_b = distance.query_block_distance(
        qs, vs[torch.from_numpy(idx)], space, quant, q_aux, v_aux[torch.from_numpy(idx)]
    ).numpy()
    np.testing.assert_allclose(got_b, want_b, rtol=0, atol=tol)
    assert distance.effective_space(space, quant).name == jdist.effective_space(jspace, jquant_t).name


@pytest.mark.parametrize("space", SPACES)
def test_rank_coefficients_match_jax(space):
    _, v = _data(4)
    vs, _ = distance.prepare_queries(v, space, Quantization.F32)
    a, b = fused_scan.paux_coeffs(space, vs)
    ja, jb = jscan.paux_coeffs(to_jax(space), v)
    np.testing.assert_array_equal(a.numpy(), ja)
    np.testing.assert_allclose(b.numpy(), jb, rtol=1e-6)
    rank = np.random.default_rng(5).normal(size=(3, 4)).astype(np.float32)
    q2 = np.abs(rank[:, 0]) * 4
    np.testing.assert_array_equal(
        fused_scan.rank_to_distance(space, rank, q2), jscan.rank_to_distance(to_jax(space), rank, q2)
    )
    allow = torch.tensor([True, False] * 12)
    masked = fused_scan.apply_allow_to_paux(b, allow)
    assert (masked[~allow] == fused_scan.INVALID_BIAS).all()
    assert torch.equal(masked[allow], b[allow])
    for quant in QUANTS + (Quantization.I8,):
        assert fused_scan.supports(space, quant) == jscan.supports(to_jax(space), to_jax(quant))


@pytest.mark.parametrize("n,k", [(40, 7), (5, 9)])
def test_topk_matches_jax(n, k):
    rng = np.random.default_rng(n)
    d = rng.normal(size=(4, n)).astype(np.float32)
    ids = rng.permutation(4 * n).reshape(4, n).astype(np.int32)
    got_d, got_i = topk.min_k(torch.from_numpy(d), torch.from_numpy(ids), k)
    want_d, want_i = jtopk.min_k(jnp.asarray(d), jnp.asarray(ids), k)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))

    new_d = rng.normal(size=(4, 6)).astype(np.float32)
    new_i = (1000 + np.arange(24)).reshape(4, 6).astype(np.int32)
    got = topk.merge_min_k(got_d, got_i, torch.from_numpy(new_d), torch.from_numpy(new_i), approx=True)
    want = jtopk.merge_min_k(want_d, want_i, jnp.asarray(new_d), jnp.asarray(new_i))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
