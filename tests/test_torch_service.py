"""The port's HTTP service against the JAX service: the verify-skill flow.

Both services are seeded with the same FakeDb contents (100 rows in 3-d,
one default index: COSINE, F32, global) and served on local ports; the
same ANN requests must return the same primary keys with distances within
1e-6. A self-query returns distance 0.0, a CDC upsert becomes searchable,
the graph engine serves a global index under ``engine_kind="graph"``, the
sharded engines serve a global B1 index as the JAX service does, and an
engine kind the factory does not name is served by the flat engine, as
in the JAX service.

A local (per-partition) index is served like the JAX service serves it:
4 partitions x 5 rows with a (pk, ck) primary key, the layout of
tests/test_validator_filtering.py (so each partition fits one lane group
and the kernel path's group minimum is exact).
"""

import asyncio
import json
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
aiohttp = pytest.importorskip("aiohttp")

import vector_store_tpu.core.types as jax_types  # noqa: E402
import vector_store_tpu.db.fake as jax_fake  # noqa: E402
import vector_store_tpu.service.config as jax_config  # noqa: E402
import vector_store_tpu_torch.core.types as port_types  # noqa: E402
import vector_store_tpu_torch.db.fake as port_fake  # noqa: E402
import vector_store_tpu_torch.service.config as port_config  # noqa: E402
from vector_store_tpu_torch.service.node_state import IndexStatus  # noqa: E402

# each service gets its own package's FakeDb, Config and enums: nothing
# typed by the JAX package crosses into the port
JAX = (jax_types, jax_fake, jax_config.Config)
PORT = (port_types, port_fake, port_config.Config)

N, DIMS = 100, 3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def seeded_db(vecs, side=PORT, **md_kwargs):
    _, fake, _ = side
    db = fake.FakeDb()
    db.add_table(fake.FakeTable("ks", "tbl", ("pk",)))
    rows = [fake.vector_row((i,), vecs[i].tolist(), 100) for i in range(len(vecs))]
    db.add_index(fake.FakeIndex(metadata=fake.make_vs_metadata(dimensions=DIMS, **md_kwargs), scan=rows))
    return db


async def start(serve_fn, db, side=PORT, engine_kind="auto", **kw):
    port = free_port()
    service = await serve_fn(
        db, side[2](uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.05, engine_kind=engine_kind), **kw
    )
    return service, f"http://127.0.0.1:{port}/api/v1/indexes/ks/idx"


async def wait_count(http, base, n, timeout=30.0):
    """Until the index is SERVING with n rows."""
    deadline = asyncio.get_running_loop().time() + timeout
    while True:
        async with http.get(f"{base}/status") as resp:
            body = await resp.json() if resp.status == 200 else {}
            if body.get("count") == n and body.get("status") == "SERVING":
                return
        if asyncio.get_running_loop().time() > deadline:
            raise TimeoutError(f"index never reached {n} rows")
        await asyncio.sleep(0.05)


async def ann(http, base, vector, limit, **extra):
    body = {"vector": list(map(float, vector)), "limit": limit, **extra}
    async with http.post(f"{base}/ann", json=body) as resp:
        text = await resp.text()  # error bodies are plain messages
        return resp.status, json.loads(text) if resp.status == 200 else text


async def test_port_serves_like_jax_service():
    from vector_store_tpu.run import serve as jax_serve
    from vector_store_tpu_torch.run import serve

    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(N, DIMS)).astype(np.float32)
    queries = rng.normal(size=(12, DIMS)).astype(np.float32)
    jax_db, port_db = seeded_db(vecs, JAX), seeded_db(vecs)
    jax_svc, jax_base = await start(jax_serve, jax_db, JAX)
    port_svc, base = await start(serve, port_db, device=torch.device("cpu"))
    try:
        async with aiohttp.ClientSession() as http:
            await wait_count(http, jax_base, N)
            await wait_count(http, base, N)
            for q in queries:
                _, want = await ann(http, jax_base, q, 5)
                status, got = await ann(http, base, q, 5)
                assert status == 200, got
                assert got["primary_keys"] == want["primary_keys"]
                np.testing.assert_allclose(got["distances"], want["distances"], rtol=0, atol=1e-6)
            # self-query: distance exactly 0.0
            status, got = await ann(http, base, vecs[7], 3)
            assert got["primary_keys"]["pk"][0] == 7 and got["distances"][0] == 0.0
            # CDC upsert becomes searchable
            new = np.array([0.3, -2.0, 0.9], np.float32)
            await port_db.db_indexes[("ks", "idx")].push_cdc(port_fake.vector_row((1000,), new.tolist(), 200))
            await wait_count(http, base, N + 1)
            status, got = await ann(http, base, new, 1)
            assert got["primary_keys"]["pk"] == [1000] and got["distances"] == [0.0]
            # wrong dimensions: 400 from the actor's DimensionMismatch
            status, _ = await ann(http, base, [1.0, 2.0], 1)
            assert status == 400
    finally:
        await port_svc.stop()
        await jax_svc.stop()


async def test_global_i8_index_serves_like_jax_service():
    """A global I8 index (COSINE): the integer scan, its bf16 rescore tier
    and the exact f32 host distances answer like the JAX service."""
    from vector_store_tpu.run import serve as jax_serve
    from vector_store_tpu_torch.run import serve

    rng = np.random.default_rng(9)
    vecs = rng.normal(size=(N, DIMS)).astype(np.float32)
    queries = rng.normal(size=(12, DIMS)).astype(np.float32)
    jax_db = seeded_db(vecs, JAX, quantization=jax_types.Quantization.I8)
    port_db = seeded_db(vecs, quantization=port_types.Quantization.I8)
    jax_svc, jax_base = await start(jax_serve, jax_db, JAX)
    port_svc, base = await start(serve, port_db, device=torch.device("cpu"))
    try:
        async with aiohttp.ClientSession() as http:
            await wait_count(http, jax_base, N)
            await wait_count(http, base, N)
            engine = port_svc.indexes.get_vs(("ks", "idx")).actor.engine
            assert engine.quantization is port_types.Quantization.I8 and engine._delta.rescore
            for q in queries:
                _, want = await ann(http, jax_base, q, 5)
                status, got = await ann(http, base, q, 5)
                assert status == 200, got
                assert got["primary_keys"] == want["primary_keys"]
                np.testing.assert_allclose(got["distances"], want["distances"], rtol=0, atol=1e-6)
            status, got = await ann(http, base, vecs[11], 3)
            assert got["primary_keys"]["pk"][0] == 11 and got["distances"][0] == 0.0
            new = np.array([-0.4, 1.5, 0.2], np.float32)
            await port_db.db_indexes[("ks", "idx")].push_cdc(port_fake.vector_row((1000,), new.tolist(), 200))
            await wait_count(http, base, N + 1)
            status, got = await ann(http, base, new, 1)
            assert got["primary_keys"]["pk"] == [1000] and got["distances"] == [0.0]
    finally:
        await port_svc.stop()
        await jax_svc.stop()


# a global B1 index under the engine kinds past the IVF engine: the graph
# engine serves it, and the sharded engines serve it as the JAX service
# does (the same statuses, keys and distances); the flat engine serves it
# under the other kinds (tests/test_torch_openapi_quantization.py)
@pytest.mark.parametrize("engine_kind", ["graph", "ivf-sharded", "graph-sharded"])
async def test_b1_index_under_graph_and_sharded_kinds_serves_like_jax(engine_kind):
    from vector_store_tpu.run import serve as jax_serve
    from vector_store_tpu_torch.engine.graph import GraphDeviceIndex
    from vector_store_tpu_torch.parallel.serving import ShardedGraphServingEngine, ShardedIvfServingEngine
    from vector_store_tpu_torch.run import serve

    vecs = np.random.default_rng(6).normal(size=(10, DIMS)).astype(np.float32)
    svc, base = await start(
        serve, seeded_db(vecs, quantization=port_types.Quantization.B1), engine_kind=engine_kind,
        device=torch.device("cpu"),
    )
    jax_svc = None
    try:
        async with aiohttp.ClientSession() as http:
            await wait_count(http, base, len(vecs))
            actor = svc.indexes.get_vs(("ks", "idx")).actor
            # a filtered query reaches the actor as well
            restrict = {"restrictions": [{"type": "==", "lhs": "pk", "rhs": 0}], "allow_filtering": True}
            if engine_kind == "graph":  # the graph engine serves it
                assert isinstance(actor.engine, GraphDeviceIndex)
                status, body = await ann(http, base, vecs[0], 1, filter=restrict)
                assert status == 200 and body["primary_keys"]["pk"] == [0], body
                status, body = await ann(http, base, vecs[3], 1)
                assert status == 200 and body["primary_keys"]["pk"] == [3], body
                return
            engine_cls = ShardedIvfServingEngine if engine_kind == "ivf-sharded" else ShardedGraphServingEngine
            assert isinstance(actor.engine, engine_cls)
            jax_svc, jax_base = await start(
                jax_serve, seeded_db(vecs, JAX, quantization=jax_types.Quantization.B1), JAX,
                engine_kind=engine_kind,
            )
            await wait_count(http, jax_base, len(vecs))
            for q, extra in ((vecs[0], {"filter": restrict}), (vecs[3], {}), (vecs[5], {}), (vecs[8], {})):
                want = await ann(http, jax_base, q, 3, **extra)
                got = await ann(http, base, q, 3, **extra)
                assert want[0] == 200 and got == want, (got, want)
    finally:
        await svc.stop()
        if jax_svc is not None:
            await jax_svc.stop()


async def test_unknown_engine_kind_serves_like_jax_service():
    """An engine kind the factory does not name is served by the flat
    engine, as the JAX factory's fall-through serves it."""
    from vector_store_tpu.run import serve as jax_serve
    from vector_store_tpu_torch.engine.flat import FlatDeviceIndex
    from vector_store_tpu_torch.run import serve

    rng = np.random.default_rng(12)
    vecs = rng.normal(size=(N, DIMS)).astype(np.float32)
    queries = rng.normal(size=(8, DIMS)).astype(np.float32)
    jax_svc, jax_base = await start(jax_serve, seeded_db(vecs, JAX), JAX, engine_kind="hnsw")
    port_svc, base = await start(serve, seeded_db(vecs), engine_kind="hnsw", device=torch.device("cpu"))
    try:
        async with aiohttp.ClientSession() as http:
            await wait_count(http, jax_base, N)
            await wait_count(http, base, N)
            assert isinstance(port_svc.indexes.get_vs(("ks", "idx")).actor.engine, FlatDeviceIndex)
            for q in queries:
                _, want = await ann(http, jax_base, q, 5)
                status, got = await ann(http, base, q, 5)
                assert status == 200, got
                assert got["primary_keys"] == want["primary_keys"]
                np.testing.assert_allclose(got["distances"], want["distances"], rtol=0, atol=1e-6)
    finally:
        await port_svc.stop()
        await jax_svc.stop()


N_PK, N_CK, LOCAL_DIMS = 4, 5, 4


def local_vec(pk: int, ck: int) -> list[float]:
    """Distinct directions for every (pk, ck): no cosine ties."""
    return [float(pk + 1), float(ck + 1), 1.0, 0.0]


def local_db(side=PORT):
    types, fake, _ = side
    db = fake.FakeDb()
    db.add_table(fake.FakeTable("ks", "tbl", ("pk", "ck")))
    rows = [
        fake.vector_row((pk, ck), local_vec(pk, ck), 100) for pk in range(N_PK) for ck in range(N_CK)
    ]
    md = fake.make_vs_metadata(
        dimensions=LOCAL_DIMS,
        primary_key_columns=("pk", "ck"),
        partition_key_count=1,
        partitioning=types.DbIndexPartitioning.local(("pk",)),
    )
    db.add_index(fake.FakeIndex(metadata=md, scan=rows))
    return db


def in_partition(pk, **extra):
    return {"filter": {"restrictions": [{"type": "==", "lhs": "pk", "rhs": pk}], "allow_filtering": True}, **extra}


async def wait_first(http, base, vector, pk, key, timeout=30.0):
    """Until a partition-restricted query returns ``key`` first."""
    deadline = asyncio.get_running_loop().time() + timeout
    while True:
        status, got = await ann(http, base, vector, 3, **in_partition(pk))
        if status == 200 and got["primary_keys"]["pk"][:1] == [key[0]] and got["primary_keys"]["ck"][:1] == [key[1]]:
            return got
        if asyncio.get_running_loop().time() > deadline:
            raise TimeoutError(f"{key} never came first: {got}")
        await asyncio.sleep(0.05)


async def test_local_index_serves_like_jax_service():
    from vector_store_tpu.run import serve as jax_serve
    from vector_store_tpu_torch.run import serve

    n = N_PK * N_CK
    rng = np.random.default_rng(8)
    queries = rng.normal(size=(12, LOCAL_DIMS)).astype(np.float32)
    jax_db, port_db = local_db(JAX), local_db()
    jax_svc, jax_base = await start(jax_serve, jax_db, JAX)
    port_svc, base = await start(serve, port_db, device=torch.device("cpu"))
    try:
        async with aiohttp.ClientSession() as http:
            await wait_count(http, jax_base, n)
            await wait_count(http, base, n)
            actor = port_svc.indexes.get_vs(("ks", "idx")).actor
            assert actor.engine._part_rows_host is not None
            for i, q in enumerate(queries):
                pk, limit = i % N_PK, (3, 7)[i % 2]  # 7: more than the partition holds
                _, want = await ann(http, jax_base, q, limit, **in_partition(pk))
                status, got = await ann(http, base, q, limit, **in_partition(pk))
                assert status == 200, got
                assert got["primary_keys"] == want["primary_keys"]
                assert set(got["primary_keys"]["pk"]) == {pk}  # partition isolation
                assert len(got["distances"]) == min(limit, N_CK)
                np.testing.assert_allclose(got["distances"], want["distances"], rtol=0, atol=1e-6)
            # self-query
            _, got = await ann(http, base, local_vec(2, 3), 2, **in_partition(2))
            assert (got["primary_keys"]["pk"][0], got["primary_keys"]["ck"][0]) == (2, 3)
            assert abs(got["distances"][0]) <= 1e-6
            # an unknown partition answers an empty result
            for b in (jax_base, base):
                status, got = await ann(http, b, queries[0], 3, **in_partition(99))
                assert status == 200 and got["primary_keys"] == {"pk": [], "ck": []}, got
            # a global query on a local-only index: 400
            status, body = await ann(http, base, queries[0], 3)
            assert status == 400 and "Global ANN query is not supported" in body
            # CDC: an update of (1, 2)'s vector in its own partition and an
            # insert of (3, 9); both become the first hit at distance 0
            upd, new = [0.2, -1.0, 3.0, 0.5], [-2.0, 0.3, 0.1, 1.0]
            for db, (_, fake, _) in ((jax_db, JAX), (port_db, PORT)):
                await db.db_indexes[("ks", "idx")].push_cdc(fake.vector_row((1, 2), upd, 200))
                await db.db_indexes[("ks", "idx")].push_cdc(fake.vector_row((3, 9), new, 200))
            for vec, pk, key in ((upd, 1, (1, 2)), (new, 3, (3, 9))):
                want = await wait_first(http, jax_base, vec, pk, key)
                got = await wait_first(http, base, vec, pk, key)
                assert got["primary_keys"] == want["primary_keys"]
                assert abs(got["distances"][0]) <= 1e-6
                np.testing.assert_allclose(got["distances"], want["distances"], rtol=0, atol=1e-6)
            await wait_count(http, base, n + 1)
    finally:
        await port_svc.stop()
        await jax_svc.stop()


async def test_service_requires_cuda_by_default():
    from vector_store_tpu_torch.run import build_service

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        await build_service(port_fake.FakeDb(), port_config.Config())
