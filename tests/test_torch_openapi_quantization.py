"""Quantization modes and the memory governor over HTTP, served by the port.

Twin of tests/test_openapi_quantization.py (reference integration
quantization.rs and memory_limit.rs): the five quantization modes and the
budget cases driven through vector_store_tpu_torch.run.build_service on
torch.device("cpu"). Where the JAX service runs beside it on the same
FakeDb rows, the port answers with the same primary keys, distances
within 1e-6, at one candidate count: the JAX engines round a fetch up to
a k bucket of 16, 64, 256 or 1024 candidates, the port fetches limit x
oversample, so a global index is compared at limit 16 (64 candidates of a
lossy index on both sides) over 100 rows. (Where the JAX flat engine
fetches more candidates than rows are live, its rescore tier also ranks
never-written slots and the JAX service answers 500 "epoch out of range":
a fault of the JAX package, ROADMAP queue 3.)

A local B1 and a local I8 index (4 partitions x 10 rows, a (pk, ck) key)
are held to the JAX service the same way, with the options
``rescoring: false`` and ``oversampling: 5``, a clustering-key filter and a
CDC insert found first: a B1 index reports a rounded Hamming distance, 0
for the row itself; an I8 index on the flat engine reports its bf16
rescore tier's distance, within 1e-6 of 0 for the row itself, on both
services.
"""

import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

import vector_store_tpu.core.types as jax_types  # noqa: E402
import vector_store_tpu.db.fake as jax_fake  # noqa: E402
import vector_store_tpu.service.config as jax_config  # noqa: E402
import vector_store_tpu_torch.core.types as port_types  # noqa: E402
import vector_store_tpu_torch.db.fake as port_fake  # noqa: E402
import vector_store_tpu_torch.service.config as port_config  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization  # noqa: E402

CPU = torch.device("cpu")
JAX, PORT = "jax", "port"
QUANTS = [Quantization.F32, Quantization.F16, Quantization.BF16, Quantization.I8, Quantization.B1]
N, DIMS = 100, 16
LIMIT = 16


def modules(side):
    return (jax_types, jax_fake, jax_config) if side == JAX else (port_types, port_fake, port_config)


async def serve(side, db, n, **config):
    """A service of ``side`` over ``db`` and its test client, once the index
    serves ``n`` rows."""
    if side == JAX:
        from vector_store_tpu.run import build_service

        service = await build_service(db, jax_config.Config(monitor_indexes_interval=0.05, **config))
    else:
        from vector_store_tpu_torch.run import build_service

        service = await build_service(db, port_config.Config(monitor_indexes_interval=0.05, **config), device=CPU)
    client = TestClient(TestServer(service.app))
    await client.start_server()
    await wait_count(client, n)
    return service, client


async def wait_count(client, n, timeout=30.0):
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        resp = await client.get("/api/v1/indexes/ks/idx/status")
        if resp.status == 200:
            data = await resp.json()
            if data["status"] == "SERVING" and data["count"] == n:
                return
        assert asyncio.get_event_loop().time() < deadline, f"index never reached {n} rows"
        await asyncio.sleep(0.05)


async def ann(client, vector, limit, restrictions=None):
    body = {"vector": [float(x) for x in vector], "limit": limit}
    if restrictions:
        body["filter"] = {"restrictions": restrictions, "allow_filtering": True}
    resp = await client.post("/api/v1/indexes/ks/idx/ann", json=body)
    assert resp.status == 200, await resp.text()
    return await resp.json()


def assert_same_answer(got, want):
    assert got["primary_keys"] == want["primary_keys"]
    np.testing.assert_allclose(got["distances"], want["distances"], rtol=0, atol=1e-6)


async def stop(*pairs):
    for service, client in pairs:
        await client.close()
        await service.stop()


def global_db(side, vecs, quant, **md_kwargs):
    types, fake, _ = modules(side)
    db = fake.FakeDb()
    db.add_table(fake.FakeTable("ks", "tbl", ("pk",)))
    rows = [fake.vector_row((i,), vecs[i].tolist(), 100) for i in range(len(vecs))]
    md = fake.make_vs_metadata(dimensions=vecs.shape[1], quantization=types.Quantization[quant.name], **md_kwargs)
    db.add_index(fake.FakeIndex(metadata=md, scan=rows))
    return db


@pytest.mark.parametrize("quant", QUANTS, ids=[q.name for q in QUANTS])
async def test_quantization_modes_over_http(quant):
    """All five quantization modes serve correct self-queries over HTTP
    (integration quantization.rs parity), and rank every row as the JAX
    service does, at limit 16."""
    rng = np.random.default_rng(99)
    vecs = rng.normal(size=(N, DIMS)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    port = await serve(PORT, global_db(PORT, vecs, quant), N)
    jax = await serve(JAX, global_db(JAX, vecs, quant), N)
    try:
        data = await ann(port[1], vecs[7], 3)
        assert data["primary_keys"]["pk"][0] == 7
        if quant is Quantization.B1:
            assert data["distances"][0] == 0.0  # a rounded Hamming distance
        info = await (await port[1].get("/api/v1/indexes/ks/idx")).json()
        assert info["options"]["quantization"] == quant.value
        for q in np.concatenate([vecs[[7, 30]], rng.normal(size=(2, DIMS)).astype(np.float32)]):
            assert_same_answer(await ann(port[1], q, LIMIT), await ann(jax[1], q, LIMIT))
    finally:
        await stop(port, jax)


def local_db(side, vecs, quant, **vs_kwargs):
    """4 partitions x 10 rows of a local index on pk, key (pk, ck)."""
    types, fake, _ = modules(side)
    db = fake.FakeDb()
    db.add_table(fake.FakeTable("ks", "tbl", ("pk", "ck")))
    rows = [fake.vector_row((i % 4, i // 4), vecs[i].tolist(), 100) for i in range(len(vecs))]
    md = fake.make_vs_metadata(
        dimensions=vecs.shape[1], primary_key_columns=("pk", "ck"), partition_key_count=1,
        partitioning=types.DbIndexPartitioning.local(("pk",)), quantization=types.Quantization[quant.name],
        **vs_kwargs,
    )
    db.add_index(fake.FakeIndex(metadata=md, scan=rows))
    return db


OPTIONS = [{}, {"rescoring": False}, {"oversampling": 5.0}]


@pytest.mark.parametrize("options", OPTIONS, ids=["default", "no-rescoring", "oversampling-5"])
@pytest.mark.parametrize("quant", (Quantization.I8, Quantization.B1), ids=["I8", "B1"])
async def test_local_lossy_index_over_http(quant, options):
    from vector_store_tpu_torch.engine.flat import FlatDeviceIndex

    rng = np.random.default_rng(31)
    n, d = 40, 8
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    dbs = {PORT: local_db(PORT, vecs, quant, **options), JAX: local_db(JAX, vecs, quant, **options)}
    port = await serve(PORT, dbs[PORT], n)
    jax = await serve(JAX, dbs[JAX], n)
    try:
        engine = port[0].indexes.get_vs(("ks", "idx")).actor.engine
        assert isinstance(engine, FlatDeviceIndex) and engine.quantization is quant
        assert engine.rescore is (options.get("rescoring", True))
        assert engine.oversample == (1 if not engine.rescore else 5 if options else 4)
        queries = np.concatenate([vecs[[5, 22]], rng.normal(size=(2, d)).astype(np.float32)])
        for q, p in zip(queries, (1, 2, 0, 3)):
            part = [{"type": "==", "lhs": "pk", "rhs": p}]
            for limit, extra in ((3, []), (10, []), (3, [{"type": ">=", "lhs": "ck", "rhs": 4}])):
                got = await ann(port[1], q, limit, part + extra)
                assert set(got["primary_keys"]["pk"]) <= {p}
                assert all(ck >= 4 for ck in got["primary_keys"]["ck"]) or not extra
                assert_same_answer(got, await ann(jax[1], q, limit, part + extra))
        # a query without its partition is refused alike
        for service, client in (port, jax):
            resp = await client.post("/api/v1/indexes/ks/idx/ann", json={"vector": vecs[0].tolist(), "limit": 3})
            assert resp.status == 400
        # a CDC insert is found first, at distance 0 (B1) or within 1e-6 (I8)
        new = rng.normal(size=d).astype(np.float32)
        for side, (_, client) in ((PORT, port), (JAX, jax)):
            fake = modules(side)[1]
            await dbs[side].db_indexes[("ks", "idx")].push_cdc(fake.vector_row((2, 100), new.tolist(), 200))
            await wait_count(client, n + 1)
        part = [{"type": "==", "lhs": "pk", "rhs": 2}]
        got = await ann(port[1], new, 3, part)
        assert (got["primary_keys"]["pk"][0], got["primary_keys"]["ck"][0]) == (2, 100)
        if quant is Quantization.B1:
            assert got["distances"][0] == 0.0
        else:
            assert abs(got["distances"][0]) <= 1e-6
        assert_same_answer(got, await ann(jax[1], new, 3, part))
    finally:
        await stop(port, jax)



async def wait_dropped(service, timeout=10.0):
    entry = service.indexes.get_vs(("ks", "idx"))
    deadline = asyncio.get_event_loop().time() + timeout
    while entry.actor._dropped_adds == 0:
        assert asyncio.get_event_loop().time() < deadline
        await asyncio.sleep(0.05)


@pytest.mark.parametrize("quant", (Quantization.F32, Quantization.B1), ids=["F32", "B1"])
async def test_hbm_budget_drops_adds(quant):
    """Device accounting: the engine registers its device footprint with the
    governor (for B1 the packed rows and the bf16 rescore tier), and an
    index outgrowing the device budget flips the governor to Cannot before
    the device runs out (memory.rs:23-25 in spirit): new rows are dropped."""
    vecs = np.random.default_rng(98).normal(size=(10, 8)).astype(np.float32)
    db = global_db(PORT, vecs, quant)
    service, client = await serve(PORT, db, 10, engine_kind="flat")
    try:
        used = service.memory.device_bytes_used()
        engine = service.indexes.get_vs(("ks", "idx")).actor.engine
        assert used == engine.device_bytes > 0
        if quant is Quantization.B1:
            cap = engine.capacity
            assert engine.vectors.dtype is torch.uint8 and engine.rescore_vectors is not None
            assert used == cap * (engine.dp + 16) + cap * (2 * engine.dp_rescore + 4)
        service.memory._task.cancel()
        service.memory.device_limit = used // 2
        assert service.memory.check() is False
        await db.db_indexes[("ks", "idx")].push_cdc(port_fake.vector_row((100,), [9.0] * 8, 200))
        await wait_dropped(service)
        # raising the budget relieves pressure
        service.memory.device_limit = used * 10
        assert service.memory.check() is True
    finally:
        await stop((service, client))


@pytest.mark.parametrize("quant", (Quantization.F32, Quantization.B1), ids=["F32", "B1"])
async def test_host_mirror_accounted(quant):
    """Host accounting: engines report their host mirrors (engine.host_bytes:
    slot bookkeeping, and for float storage the f32 vector mirror; lossy
    storage reports device distances and keeps none) and a host limit
    binds on that attribution."""
    vecs = np.random.default_rng(97).normal(size=(10, 8)).astype(np.float32)
    service, client = await serve(PORT, global_db(PORT, vecs, quant), 10, engine_kind="flat")
    try:
        engine = service.indexes.get_vs(("ks", "idx")).actor.engine
        used_host = service.memory.host_bytes_used()
        assert used_host == engine.host_bytes > 0
        assert (engine._vecs_host is None) is (quant is Quantization.B1)
        assert service.memory.device_bytes_used() > 0
        service.memory._task.cancel()
        service.memory.config_limit = max(1, used_host // 2)
        assert service.memory.check() is False
        service.memory.config_limit = None
        assert service.memory.check() is True
    finally:
        await stop((service, client))


async def test_memory_limit_drops_adds():
    """When the governor reports Cannot, new vectors are dropped rather
    than indexed (memory_limit.rs / usearch.rs:1156-1177 parity); once
    pressure is relieved, later adds land."""
    vecs = np.random.default_rng(96).normal(size=(10, 8)).astype(np.float32)
    db = global_db(PORT, vecs, Quantization.F32)
    service, client = await serve(PORT, db, 10, engine_kind="flat")
    try:
        service.memory.can_allocate = False
        service.memory._task.cancel()  # no periodic check overrides the flag
        dbi = db.db_indexes[("ks", "idx")]
        await dbi.push_cdc(port_fake.vector_row((100,), [9.0] * 8, 200))
        await wait_dropped(service)
        resp = await client.get("/api/v1/indexes/ks/idx/status")
        assert (await resp.json())["count"] == 10
        service.memory.can_allocate = True
        await dbi.push_cdc(port_fake.vector_row((101,), [8.0] * 8, 300))
        await wait_count(client, 11)
    finally:
        await stop((service, client))
