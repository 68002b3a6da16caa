"""B1 (binary) storage and Hamming distance: the port against the JAX
package, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides; each
side gets its own enums (torch_parity.to_jax). The JAX side is all XLA
(its Pallas kernels take no B1), so nothing runs in interpret mode.

- packed bytes equal the JAX package's (and ``np.packbits``) bit for bit,
  at odd widths; unpacking inverts them;
- the popcount aux and the Hamming distances (``pairwise_distance``,
  ``query_block_distance``) are equal exactly, whatever space the index
  declares (B1 forces Hamming): both are exact integers;
- the flat engine's Hamming scan (``_flat_search``) returns the JAX scan's
  distances exactly and its ids exactly too: both break ties to the lower
  slot (lax.top_k's order); its bf16 rescore tier (``_rescore_stage``)
  re-ranks the same candidates to the same ids, distances within 1e-5
  relative; removed rows stay out;
- ``search`` at one candidate count (k 16: the JAX engine's k bucket 16 x
  oversample 4 = 64 candidates on both sides) answers like the JAX
  engine, with rescoring on and off: the same slots and epochs, distances
  within 1e-6 of the row's largest (euclidean bf16 distances cancel
  |q|^2 + |v|^2 - 2 q.v, summed in another order);
- the JAX ``test_quantized_recall[B1]`` twin: the JAX engine's rows and
  recall@10 >= 0.6 on its data, at its candidate count;
- ``load_state`` from a JAX B1 engine answers the same;
- ``device_bytes`` counts what the JAX engine counts (vectors, rescore
  tier), apart from the per-slot metadata, which the JAX package keeps in
  another layout (an [8, cap] f32 paux, valid and epochs on the device:
  45 bytes a slot against the port's a, b, aux and parts, 16).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from test_torch_i8 import assert_same_topk  # noqa: E402
from torch_parity import jax_flat_state, to_jax  # noqa: E402
from vector_store_tpu.ops import distance as jdist  # noqa: E402
from vector_store_tpu.ops import quantize as jquant  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.engine.flat import FlatDeviceIndex  # noqa: E402
from vector_store_tpu_torch.ops import distance, quantize  # noqa: E402

B1, BF16 = Quantization.B1, Quantization.BF16
SPACES = (SpaceType.EUCLIDEAN, SpaceType.COSINE, SpaceType.DOT_PRODUCT)
CPU = torch.device("cpu")


def jax_flat(d, space, rescoring=True, block=128, capacity=1024):
    from vector_store_tpu.engine.flat import FlatDeviceIndex as JaxFlat

    return JaxFlat(
        d, space_type=to_jax(space), quantization=to_jax(B1), initial_capacity=capacity,
        block_rows=block, rescoring=rescoring,
    )


def port_flat(d, space, rescoring=True, block=128, capacity=1024):
    return FlatDeviceIndex(
        d, space, B1, device=CPU, initial_capacity=capacity, block_rows=block, rescoring=rescoring,
    )


@pytest.mark.parametrize("d", (1, 3, 8, 13, 1536))
def test_pack_b1_matches_jax(d):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(9, d)).astype(np.float32)
    x[0, 0] = 0.0  # zero is not > 0
    x[1, -1] = -0.0
    got = quantize.quantize_for_storage(x, B1)
    want = jquant.quantize_for_storage(x, to_jax(B1))
    assert got.dtype == torch.uint8 and quantize.storage_dtype(B1) is torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.packbits(x > 0, axis=-1))
    np.testing.assert_array_equal(quantize.unpack_b1(got, d).numpy(), jquant.unpack_b1(want, d))
    dp = quantize.padded_dim(d, B1)
    assert dp >= -(-d // 8) and dp % 8 == 0 and dp - -(-d // 8) < 8
    # the popcount aux of padded rows
    qs, aux = distance.prepare_queries(x, SpaceType.COSINE, B1)
    jqs, jaux = jdist.prepare_queries(x, to_jax(SpaceType.COSINE), to_jax(B1))
    assert qs.shape == (9, dp)
    np.testing.assert_array_equal(qs[:, : want.shape[1]].numpy(), jqs[:, : want.shape[1]])
    np.testing.assert_array_equal(aux.numpy(), jaux)
    np.testing.assert_array_equal(aux.numpy(), (x > 0).sum(-1))


@pytest.mark.parametrize("space", SPACES + (SpaceType.HAMMING,))
def test_hamming_distances_match_jax(space):
    rng = np.random.default_rng(2)
    d = 43
    q, v = rng.normal(size=(9, d)).astype(np.float32), rng.normal(size=(33, d)).astype(np.float32)
    jspace = to_jax(space)
    qs, q_aux = distance.prepare_queries(q, space, B1)
    vs, v_aux = distance.prepare_queries(v, space, B1)
    jq, jq_aux = jdist.prepare_queries(q, jspace, to_jax(B1))
    jv, jv_aux = jdist.prepare_queries(v, jspace, to_jax(B1))
    np.testing.assert_array_equal(v_aux.numpy(), jv_aux)
    want = np.asarray(jdist.pairwise_distance(
        jnp.asarray(jq), jnp.asarray(jv), jspace, to_jax(B1), jnp.asarray(jq_aux), jnp.asarray(jv_aux)
    ))
    got = distance.pairwise_distance(qs, vs, space, B1, q_aux, v_aux).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ((q[:, None] > 0) != (v[None] > 0)).sum(-1))

    idx = rng.integers(0, v.shape[0], size=(q.shape[0], 5))
    want_b = np.asarray(jdist.query_block_distance(
        jnp.asarray(jq), jnp.asarray(jv)[idx], jspace, to_jax(B1), jnp.asarray(jq_aux), jnp.asarray(jv_aux)[idx]
    ))
    ti = torch.from_numpy(idx)
    got_b = distance.query_block_distance(qs, vs[ti], space, B1, q_aux, v_aux[ti]).numpy()
    np.testing.assert_array_equal(got_b, want_b)


def test_hamming_needs_packed_rows():
    """The JAX package cannot take a Hamming distance of float rows (its
    bit unpacking shifts the floats); the port refuses them by name."""
    x = torch.ones((2, 8))
    with pytest.raises(ValueError, match="HAMMING"):
        distance.pairwise_distance(x, x, SpaceType.HAMMING, Quantization.F32, x[:, 0], x[:, 0])


def _flat_pair(space, seed, n=600, d=40, rescoring=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    p = port_flat(d, space, rescoring)
    j = jax_flat(d, space, rescoring)
    for eng in (p, j):
        eng.upsert_batch(np.arange(n), np.arange(n, dtype=np.int32) % 5, x)
        eng.remove_batch(np.arange(0, n, 7))
    queries = x[rng.integers(0, n, 12)] + 0.3 * rng.normal(size=(12, d)).astype(np.float32)
    return p, j, x, queries


@pytest.mark.parametrize("space", SPACES)
def test_flat_b1_search_and_rescore_match_jax(space):
    from vector_store_tpu.engine import flat as jflat

    p, _, x, queries = _flat_pair(space, 3)
    assert not p.normalize  # a B1 cosine index keeps its rows' scale
    qs, q_aux = distance.prepare_queries(queries, space, B1)
    k = 8
    kk = p.lossy_fetch(k)  # the JAX engine's count: bucket 16 x oversample 4
    assert kk == 64
    dist, slots = p._flat_search(qs, kk)
    cap = p.capacity
    packed = jflat._flat_search(
        jnp.asarray(p.vectors.numpy()), jnp.asarray(p.aux.numpy()), jnp.asarray(p._epochs_host),
        jnp.asarray(p._valid_host), jnp.asarray(p.parts.numpy()), jnp.asarray(qs.numpy()),
        jnp.asarray(q_aux.numpy()), jnp.full((12,), -1, jnp.int32), jnp.ones((cap,), bool),
        space=to_jax(space), quant=to_jax(B1), k=kk, block_rows=p.block_rows, approx=False, use_parts=False,
    )
    jd, ji, _ = jflat.unpack_results(np.asarray(packed))
    np.testing.assert_array_equal(dist.numpy(), jd)
    # Hamming distances tie often: both sides take the lower slot
    np.testing.assert_array_equal(slots.numpy(), ji)
    assert not np.isin(slots.numpy(), np.arange(0, 600, 7)).any()

    rqs, rq_aux = distance.prepare_queries(queries, space, BF16)
    got_d, got_i = p._rescore_stage(slots, rqs, rq_aux, k)
    jres = jflat._rescore_stage(
        packed, jnp.asarray(p.rescore_vectors.float().numpy(), jnp.bfloat16),
        jnp.asarray(p.rescore_aux.numpy()), jnp.asarray(rqs.float().numpy(), jnp.bfloat16),
        jnp.asarray(rq_aux.numpy()), space=to_jax(space), k=k,
    )
    rd, ri, _ = jflat.unpack_results(np.asarray(jres))
    assert_same_topk(got_d.numpy(), got_i.numpy(), rd, ri, rtol=1e-5)
    # the search entry point serves the tier's order and distances
    res = p.search(queries, k)
    np.testing.assert_array_equal(np.stack([r.slots for r in res]), got_i.numpy())
    np.testing.assert_array_equal(np.stack([r.distances for r in res]), got_d.numpy())


@pytest.mark.parametrize("rescoring", (True, False))
@pytest.mark.parametrize("space", (SpaceType.COSINE, SpaceType.EUCLIDEAN))
def test_flat_b1_engine_answers_like_jax(space, rescoring):
    p, j, _, queries = _flat_pair(space, 4, rescoring=rescoring)
    assert p.rescore is j.rescore is rescoring and p.oversample == j.oversample
    k = 16  # the JAX engine's k bucket: 64 candidates (or 16) on both sides
    for got, want in zip(p.search(queries, k), j.search(queries, k)):
        np.testing.assert_array_equal(got.slots, want.slots)
        np.testing.assert_array_equal(got.epochs, want.epochs)
        # euclidean bf16 distances cancel |q|^2 + |v|^2 - 2 q.v: within 1e-6
        # of the row's largest
        atol = 1e-6 * max(1.0, float(np.abs(want.distances).max()))
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-6, atol=atol)
        if not rescoring:  # the Hamming counts themselves
            assert (got.distances == np.round(got.distances)).all()


@pytest.mark.parametrize("quant", (B1, Quantization.I8), ids=["b1", "i8"])
@pytest.mark.parametrize("space", (SpaceType.COSINE, SpaceType.EUCLIDEAN))
def test_lossy_search_at_k10_fetches_what_jax_fetches(space, quant):
    """At k 10 the port fetches the JAX engine's candidate count (k rounded
    up to its bucket 16, times oversample 4: 64) and returns its k-10 slots,
    epochs and distances."""
    from vector_store_tpu.engine.flat import FlatDeviceIndex as JaxFlat

    rng = np.random.default_rng(11)
    n, d = 600, 40
    x = rng.normal(size=(n, d)).astype(np.float32)
    p = FlatDeviceIndex(d, space, quant, device=CPU, initial_capacity=1024, block_rows=128)
    j = JaxFlat(d, space_type=to_jax(space), quantization=to_jax(quant), initial_capacity=1024, block_rows=128)
    for eng in (p, j):
        eng.upsert_batch(np.arange(n), np.arange(n, dtype=np.int32) % 5, x)
        eng.remove_batch(np.arange(0, n, 7))
    assert p.lossy_fetch(10) == 64 and p.lossy_fetch(17) == 256
    queries = x[rng.integers(0, n, 12)] + 0.3 * rng.normal(size=(12, d)).astype(np.float32)
    for got, want in zip(p.search(queries, 10), j.search(queries, 10)):
        np.testing.assert_array_equal(got.slots, want.slots)
        np.testing.assert_array_equal(got.epochs, want.epochs)
        atol = 1e-6 * max(1.0, float(np.abs(want.distances).max()))
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-6, atol=atol)


def test_quantized_recall_b1_twin():
    """tests/test_engine_flat.py::test_quantized_recall[B1] on the port: its
    data shape, at the JAX engine's candidate count (search at k 10 takes
    its k bucket 16 x oversample 4 = 64 Hamming candidates; the port takes
    64 at k 16, truncated to 10). The port returns the JAX engine's rows,
    and recall@10 against the exact cosine top-10 holds the JAX test's
    floor, 0.6. (The port's own k 10 fetches the same 64 candidates:
    test_lossy_search_at_k10_fetches_what_jax_fetches.)"""
    from vector_store_tpu.engine.flat import FlatDeviceIndex as JaxFlat

    rng = np.random.default_rng(7)
    d, n = 64, 400
    base = rng.normal(size=(n, d)).astype(np.float32)
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    p = FlatDeviceIndex(d, SpaceType.COSINE, B1, device=CPU, initial_capacity=512, block_rows=128)
    j = JaxFlat(d, space_type=to_jax(SpaceType.COSINE), quantization=to_jax(B1), initial_capacity=512,
                block_rows=128)
    for eng in (p, j):
        eng.upsert_batch(np.arange(n), np.zeros(n, np.int32), base)
    q = base[:20] + 0.01 * rng.normal(size=(20, d)).astype(np.float32)
    res = [r.truncated(10) for r in p.search(q, 16)]
    for got, want in zip(res, j.search(q, 10)):
        np.testing.assert_array_equal(got.slots, want.slots)
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-6, atol=1e-6)
    dots = q @ base.T
    recall = np.mean([
        len(set(np.argsort(-dots[row])[:10]) & set(res[row].slots.tolist())) / 10 for row in range(20)
    ])
    assert recall >= 0.6, recall


def test_load_state_from_jax_b1_engine():
    _, j, _, queries = _flat_pair(SpaceType.COSINE, 5)
    p = port_flat(40, SpaceType.COSINE)
    p.load_state(jax_flat_state(j))
    assert p.size == j.size and p._vecs_host is None
    assert p.vectors.dtype is torch.uint8 and p.vectors.shape[1] == quantize.padded_dim(40, B1)
    for got, want in zip(p.search(queries, 16), j.search(queries, 16)):
        np.testing.assert_array_equal(got.slots, want.slots)
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-6, atol=1e-6)
    # and takes mutations on after it
    p.remove_batch(np.array([1, 2]))
    assert p.size == j.size - 2


def test_device_bytes_count_what_jax_counts():
    """At 1024 dimensions both pad a packed row to 128 bytes and a bf16
    rescore row to 1024 elements; the capacities are equal (1024)."""
    d = 1024
    p, j = port_flat(d, SpaceType.COSINE), jax_flat(d, SpaceType.COSINE)
    assert p.capacity == j.capacity == 1024 and p.dp == j.dp == 128 and p.dp_rescore == j.dp_rescore
    cap = p.capacity
    assert p.device_bytes == cap * (128 + 16) + cap * (2 * 1024 + 4)
    assert p.device_bytes - j.device_bytes == cap * (16 - 45)
    # rescoring off: no tier on either side
    p0, j0 = port_flat(d, SpaceType.COSINE, rescoring=False), jax_flat(d, SpaceType.COSINE, rescoring=False)
    assert p0.device_bytes - j0.device_bytes == cap * (16 - 45) and p0.device_bytes == cap * (128 + 16)


def test_bulk_device_ingest_refuses_b1():
    p = port_flat(8, SpaceType.COSINE)
    with pytest.raises(ValueError, match="B1"):
        p.upsert_bulk_device(0, 2, torch.ones((2, 8)), np.ones((2, 8), np.float32))
