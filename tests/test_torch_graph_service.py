"""ENGINE=graph served by the port, beside the JAX service, on the CPU.

Both services run ``engine_kind="graph"`` over the same seeded FakeDb
rows (each with its own package's FakeDb, Config and enums), the port
through vector_store_tpu_torch.run.build_service on torch.device("cpu"):

- the actor's exclusive maintenance slices merge the whole delta into the
  graph (``delta_count == 0``, ``graph_nodes == n``);
- a self-query answers distance 0.0 and the JAX service's key;
- a CDC insert is found while it sits in the delta (the merges are held
  back for that query) and again once the graph holds it; a delete no
  longer answers;
- the I8 oversampling/rescoring contract of the JAX engine's
  TestGraphRescoring holds over HTTP: near-tied rows come back in exact
  order with rescoring, in storage order without;
- filtered queries answer the JAX service's keys (a 300-row graph, whose
  beam at the ladder's widths visits every node, so both are exact).
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
from vector_store_tpu_torch.core.types import ExpansionSearch, Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.engine.graph import GraphDeviceIndex  # noqa: E402

CPU = torch.device("cpu")
N, DIMS = 300, 8


def seeded_db(fake, vecs, labels=None, order=None, **vs_kwargs):
    """A FakeDb of ``fake``'s package: one global index over ``vecs`` (row
    i under pk i, scanned in ``order``), with a filtering column
    ``bucket`` when ``labels`` are given."""
    db = fake.FakeDb()
    columns = {} if labels is None else {"bucket": "int"}
    db.add_table(fake.FakeTable("ks", "tbl", ("pk",), columns=columns))
    rows = [
        fake.vector_row(
            (i,), vecs[i].tolist(), 100, **({} if labels is None else {"filtering": [(100, int(labels[i]))]})
        )
        for i in (range(len(vecs)) if order is None else order.tolist())
    ]
    md = fake.make_vs_metadata(
        dimensions=vecs.shape[1], filtering_columns=() if labels is None else ("bucket",), **vs_kwargs
    )
    db.add_index(fake.FakeIndex(metadata=md, scan=rows))
    return db


async def start(jax_side, db):
    if jax_side:
        from vector_store_tpu.run import build_service

        service = await build_service(db, jax_config.Config(monitor_indexes_interval=0.05, engine_kind="graph"))
    else:
        from vector_store_tpu_torch.run import build_service

        service = await build_service(
            db, port_config.Config(monitor_indexes_interval=0.05, engine_kind="graph"), device=CPU
        )
    client = TestClient(TestServer(service.app))
    await client.start_server()
    return service, client


async def wait_for(cond, timeout=60.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not await cond():
        assert asyncio.get_running_loop().time() < deadline, "timed out"
        await asyncio.sleep(0.05)


async def wait_merged(service, client, n):
    """Until the index serves n rows and its graph holds all of them."""

    async def merged():
        resp = await client.get("/api/v1/indexes/ks/idx/status")
        body = await resp.json() if resp.status == 200 else {}
        if body.get("count") != n or body.get("status") != "SERVING":
            return False
        engine = service.indexes.get_vs(("ks", "idx")).actor.engine
        return engine.delta_count == 0 and engine.graph_nodes == n

    await wait_for(merged)
    return service.indexes.get_vs(("ks", "idx")).actor.engine


async def ann(client, vector, limit, **extra):
    resp = await client.post(
        "/api/v1/indexes/ks/idx/ann", json={"vector": [float(x) for x in vector], "limit": limit, **extra}
    )
    assert resp.status == 200, await resp.text()
    return await resp.json()


async def stop(*pairs):
    for service, client in pairs:
        await client.close()
        await service.stop()


async def test_graph_service_merges_and_answers_like_jax():
    vecs = np.random.default_rng(31).normal(size=(N, DIMS)).astype(np.float32)
    port = await start(False, seeded_db(port_fake, vecs))
    jax = await start(True, seeded_db(jax_fake, vecs))
    try:
        engine = await wait_merged(*port, N)
        await wait_merged(*jax, N)
        assert isinstance(engine, GraphDeviceIndex)
        assert service_memory_holds(port[0], engine)
        for i in (0, 17, 123, 299):
            got, want = await ann(port[1], vecs[i], 3), await ann(jax[1], vecs[i], 3)
            assert got["primary_keys"]["pk"][0] == want["primary_keys"]["pk"][0] == i
            assert got["distances"][0] == 0.0
        queries = np.random.default_rng(32).normal(size=(8, DIMS)).astype(np.float32)
        for q in queries:
            got, want = await ann(port[1], q, 5), await ann(jax[1], q, 5)
            assert got["primary_keys"] == want["primary_keys"]
            np.testing.assert_allclose(got["distances"], want["distances"], rtol=0, atol=1e-6)
    finally:
        await stop(port, jax)


def service_memory_holds(service, engine) -> bool:
    """The memory governor counts the graph engine's device bytes (the
    store and the adjacency)."""
    used = service.memory.device_bytes_used()
    return used >= engine.device_bytes > engine.store.device_bytes


async def test_cdc_insert_found_in_delta_and_graph_and_delete_vanishes():
    vecs = np.random.default_rng(33).normal(size=(N, DIMS)).astype(np.float32)
    db = seeded_db(port_fake, vecs)
    service, client = await start(False, db)
    try:
        engine = await wait_merged(service, client, N)
        real = engine.maintain
        engine.maintain = lambda max_batch=4096: False  # hold the merges back
        dbi = db.db_indexes[("ks", "idx")]
        new = np.full(DIMS, 3.0, np.float32)
        await dbi.push_cdc(port_fake.vector_row((N,), new.tolist(), 200))
        await wait_for(lambda: _count_is(client, N + 1))
        assert engine.delta_count == 1 and engine.graph_nodes == N
        got = await ann(client, new, 1)
        assert got["primary_keys"]["pk"] == [N] and got["distances"] == [0.0]

        engine.maintain = real  # the next modify batch makes a slice due
        other = np.full(DIMS, -3.0, np.float32)
        await dbi.push_cdc(port_fake.vector_row((N + 1,), other.tolist(), 201))
        await wait_merged(service, client, N + 2)
        got = await ann(client, new, 1)
        assert got["primary_keys"]["pk"] == [N] and got["distances"] == [0.0]

        await dbi.push_cdc(port_fake.delete_row((N,), 300))
        await wait_for(lambda: _count_is(client, N + 1))
        got = await ann(client, new, 5)
        assert N not in got["primary_keys"]["pk"]
    finally:
        await stop((service, client))


async def _count_is(client, n) -> bool:
    resp = await client.get("/api/v1/indexes/ks/idx/status")
    return resp.status == 200 and (await resp.json())["count"] == n


def near_tied() -> np.ndarray:
    """TestGraphRescoring's rows: the query plus i * 0.001 * (2, 4, 8)."""
    query = np.array([0.5, 0.3, 0.7] + [0.0] * 13, dtype=np.float32)
    out = np.tile(query, (400, 1))
    out[:, :3] += np.arange(400, dtype=np.float32)[:, None] * 0.001 * np.array([2.0, 4.0, 8.0], np.float32)
    return out


@pytest.mark.parametrize("rescoring", (True, False), ids=("rescoring", "no-rescoring"))
async def test_i8_rescoring_contract_over_http(rescoring):
    vecs = near_tied()
    order = np.random.default_rng(7).permutation(400)  # slots are not pk order
    kw = dict(
        space_type=SpaceType.EUCLIDEAN, quantization=Quantization.I8, expansion_search=ExpansionSearch(256),
        rescoring=rescoring, oversampling=5.0,
    )
    service, client = await start(False, seeded_db(port_fake, vecs, order=order, **kw))
    try:
        engine = await wait_merged(service, client, 400)
        assert engine.rescoring is rescoring and engine.oversample == (5 if rescoring else 1)
        got = (await ann(client, vecs[0], 64))["primary_keys"]["pk"]
        assert len(got) == 64
        if rescoring:
            assert got == sorted(got), f"exact order expected, got {got[:12]}..."
        else:
            assert got != sorted(got), "rescoring=False never reached the beam's resolution"
    finally:
        await stop((service, client))


async def test_filtered_queries_answer_the_jax_keys():
    rng = np.random.default_rng(34)
    vecs = rng.normal(size=(N, DIMS)).astype(np.float32)
    labels = rng.integers(0, 10, size=N)
    port = await start(False, seeded_db(port_fake, vecs, labels))
    jax = await start(True, seeded_db(jax_fake, vecs, labels))
    try:
        await wait_merged(*port, N)
        await wait_merged(*jax, N)
        for q in rng.normal(size=(6, DIMS)).astype(np.float32):
            for value in (0, 3):
                flt = {"restrictions": [{"type": "==", "lhs": "bucket", "rhs": value}], "allow_filtering": True}
                got, want = await ann(port[1], q, 5, filter=flt), await ann(jax[1], q, 5, filter=flt)
                assert got["primary_keys"] == want["primary_keys"]
                np.testing.assert_allclose(got["distances"], want["distances"], rtol=0, atol=1e-6)
                assert (labels[got["primary_keys"]["pk"]] == value).all() and len(got["primary_keys"]["pk"]) == 5
    finally:
        await stop(port, jax)

