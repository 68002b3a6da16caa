"""The quantization_and_rescoring validator, served by the port.

Twin of tests/test_validator_rescoring.py
(crates/validator/src/quantization_and_rescoring.rs:98-330): 500 vectors
whose distance from the query grows with pk by ~0.001-scale steps,
inserted in a shuffled order, driven over HTTP through
vector_store_tpu_torch.run.build_service on torch.device("cpu"); each case
also runs the JAX service on the same rows, and the port answers with the
same primary keys, distances within 1e-6, where both fetch the same
candidates and break ties alike. One case of the IVF engine differs: at
F32 the port's fused scan (kernel 1; its plain version on the CPU) keeps
one minimum a lane of 128, as the JAX package's Pallas kernel does on a
TPU, where the JAX engine on the CPU runs its exact XLA scan: at k 100
over 500 rows the two share 75 keys (group-min kernels compare by recall
against an exact oracle, ROADMAP queue 3), and every key both return has
the same distance within 1e-6. At I8 without rescoring both answer from
the delta (500 rows: no main region yet) with its storage-precision
distances, in its order: the same keys in the same order.

The four cases run at I8, and the quantized ones also at B1, which every
row of this data packs to the same bits (all components > 0): every
Hamming distance is 0, and

- without rescoring the storage order is the slot order (both sides break
  ties to the lower slot), not the pk order;
- with rescoring at oversampling 5 both sides re-rank all 500 rows in
  bf16, which restores the top-100 set but not its order (bf16 rows of
  neighbouring pks coincide; the JAX service answers the same order);
- with the default oversample 4 the port re-ranks 4 x 100 = 400 of the
  tied rows (the lowest slots) where the JAX engine's k bucket fetches all
  500: there the answers differ, and the port keeps at least 0.7 of the
  JAX service's top 100 (each true neighbour is among 400 of 500 shuffled
  slots: 0.8 expected).
"""

import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

import vector_store_tpu.db.fake as jax_fake  # noqa: E402
import vector_store_tpu.service.config as jax_config  # noqa: E402
import vector_store_tpu_torch.db.fake as port_fake  # noqa: E402
import vector_store_tpu_torch.service.config as port_config  # noqa: E402
from torch_parity import to_jax  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization  # noqa: E402

N = 500
LIMIT = 100
QUERY = [0.5, 0.3, 0.7]
I8, B1 = Quantization.I8, Quantization.B1


def _embeddings() -> dict[int, list[float]]:
    # reference generate_test_vectors: query + i*0.001*(2,4,8)
    out = {}
    for i in range(N):
        off = i * 0.001
        out[i] = [QUERY[0] + off * 2.0, QUERY[1] + off * 4.0, QUERY[2] + off * 8.0]
    return out


async def _serve_one(jax_side: bool, quantization: Quantization, **vs_kwargs):
    fake = jax_fake if jax_side else port_fake
    db = fake.FakeDb()
    db.add_table(fake.FakeTable("ks", "tbl", ("pk",)))
    emb = _embeddings()
    order = list(emb)
    np.random.default_rng(7).shuffle(order)
    rows = [fake.vector_row((pk,), emb[pk], 100) for pk in order]
    quant = to_jax(quantization) if jax_side else quantization
    db.add_index(fake.FakeIndex(
        metadata=fake.make_vs_metadata(dimensions=3, quantization=quant, **vs_kwargs), scan=rows,
    ))
    if jax_side:
        from vector_store_tpu.run import build_service

        service = await build_service(db, jax_config.Config(monitor_indexes_interval=0.05))
    else:
        from vector_store_tpu_torch.run import build_service

        service = await build_service(
            db, port_config.Config(monitor_indexes_interval=0.05), device=torch.device("cpu")
        )
    client = TestClient(TestServer(service.app))
    await client.start_server()
    deadline = asyncio.get_event_loop().time() + 30
    while True:
        resp = await client.get("/api/v1/indexes/ks/idx/status")
        if resp.status == 200:
            s = await resp.json()
            if s["count"] == N and s["status"] == "SERVING":
                break
        assert asyncio.get_event_loop().time() < deadline
        await asyncio.sleep(0.05)
    return service, client


async def _serve(quantization: Quantization, **vs_kwargs):
    """The port's and the JAX package's services over the same rows."""
    port = await _serve_one(False, quantization, **vs_kwargs)
    jax = await _serve_one(True, quantization, **vs_kwargs)
    return port, jax


async def _ann(client) -> dict:
    resp = await client.post("/api/v1/indexes/ks/idx/ann", json={"vector": QUERY, "limit": LIMIT})
    assert resp.status == 200, await resp.text()
    data = await resp.json()
    assert len(data["primary_keys"]["pk"]) == LIMIT
    return data


async def _answers(port, jax, compare="keys"):
    """Both services' pks; ``compare`` the port's against the JAX
    service's: "keys" (equal lists, equal distances), "common" (equal
    distances of the keys both return) or None."""
    got, want = await _ann(port[1]), await _ann(jax[1])
    pks, jax_pks = got["primary_keys"]["pk"], want["primary_keys"]["pk"]
    if compare == "keys":
        assert pks == jax_pks
    if compare in ("keys", "common"):
        mine, theirs = dict(zip(pks, got["distances"])), dict(zip(jax_pks, want["distances"]))
        common = sorted(set(mine) & set(theirs))
        assert common
        np.testing.assert_allclose([mine[k] for k in common], [theirs[k] for k in common], rtol=0, atol=1e-6)
    return pks, jax_pks


async def _stop(*pairs):
    for service, client in pairs:
        await client.close()
        await service.stop()


def _engine(pair):
    return pair[0].indexes.get_vs(("ks", "idx")).actor.engine


async def test_non_quantized_index_returns_correctly_ranked_vectors():
    """quantization_and_rescoring.rs:98-155: f32 precision distinguishes
    the 0.001-step vectors; results ordered by pk."""
    port, jax = await _serve(Quantization.F32, oversampling=5.0, rescoring=False)
    try:
        pks, _ = await _answers(port, jax, "common")
        assert pks == sorted(pks), f"f32 must rank the near-tied vectors correctly; got {pks[:12]}..."
    finally:
        await _stop(port, jax)


@pytest.mark.parametrize("quant", (I8, B1), ids=["I8", "B1"])
async def test_quantized_index_misranks_without_rescoring(quant):
    """quantization_and_rescoring.rs:157-230: quantization collapses the
    small differences; with rescoring off the storage-precision order
    shows through and is NOT the true (pk) order."""
    port, jax = await _serve(quant, oversampling=5.0, rescoring=False)
    try:
        engine = _engine(port)
        assert engine.rescoring is False and engine.oversample == 1
        pks, _ = await _answers(port, jax)
        assert pks != sorted(pks), "the rescoring=false option is not reaching the engine"
    finally:
        await _stop(port, jax)


@pytest.mark.parametrize("quant", (I8, B1), ids=["I8", "B1"])
async def test_rescoring_restores_ranking_for_quantized_index(quant):
    """quantization_and_rescoring.rs:232-330: the oversampled fetch and
    the re-rank correct the ranking: the pk order at I8 (the exact f32
    host rescore of the IVF engine); at B1 the top-100 set, ordered by the
    bf16 tier within its ties."""
    port, jax = await _serve(quant, oversampling=5.0, rescoring=True)
    try:
        engine = _engine(port)
        assert engine.rescoring is True and engine.oversample == 5  # ceil(oversampling option)
        pks, _ = await _answers(port, jax)
        if quant is I8:
            assert pks == sorted(pks), f"rescoring must restore exact rank order; got {pks[:12]}..."
        else:
            assert sorted(pks) == list(range(LIMIT))
    finally:
        await _stop(port, jax)


@pytest.mark.parametrize("quant", (I8, B1), ids=["I8", "B1"])
async def test_rescoring_default_is_on(quant):
    """No options: lossy storage rescoring defaults on (the engines'
    default oversample factors apply)."""
    port, jax = await _serve(quant)
    try:
        engine = _engine(port)
        assert engine.rescoring is True and engine.oversample >= 2
        pks, jax_pks = await _answers(port, jax, "keys" if quant is I8 else None)
        if quant is I8:
            assert pks == sorted(pks)
        else:  # 400 of the 500 tied rows re-ranked (the module docstring)
            assert engine.oversample == 4
            assert len(set(pks) & set(jax_pks)) >= 0.7 * LIMIT
            assert sorted(jax_pks) == list(range(LIMIT))
    finally:
        await _stop(port, jax)
