"""Twin of tests/test_streaming_load.py (the BASELINE config 5 shape):
continuous CDC upserts and deletes while concurrent queries run, on the
JAX service and on the port's (run.build_service on torch.device("cpu"):
table/__init__.py and service/vs_index.py under CDC while queries run).

| reference case | port test |
|---|---|
| test_streaming_upserts_while_querying | test_streaming_upserts_while_querying |

Both services take the same writes (the rows drawn once from a seed); the
queries are random on each side. Tolerance: no query fails on either
side, the late insert is found first on both, and both final row counts
pass the reference's bound (> 50). The counts themselves depend on timing
on both services: an insert and the delete of the same key that land in
one modify batch leave the row counted (ROADMAP.md queue 3), so they are
not compared. The twin is bounded by 60 s; the reference's own waits run
inside it.
"""

import asyncio

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("aiohttp")

from torch_service_twins import stop, twin  # noqa: E402

DIMS = 8


async def test_streaming_upserts_while_querying():
    rng = np.random.default_rng(123)
    base = rng.normal(size=(50, DIMS)).astype(np.float32)
    writes = rng.normal(size=(60, DIMS)).astype(np.float32)
    late = rng.normal(size=DIMS).astype(np.float32) * 10

    async def case(side):
        fake = side.fake
        db = fake.FakeDb()
        db.add_table(fake.FakeTable("ks", "tbl", ("pk",)))
        db.add_index(fake.FakeIndex(
            metadata=fake.make_vs_metadata(dimensions=DIMS),
            scan=[fake.vector_row((i,), base[i].tolist(), 100) for i in range(50)],
        ))
        service, client = await side.start(db)
        try:
            deadline = asyncio.get_event_loop().time() + 20
            while True:
                resp = await client.get("/api/v1/indexes/ks/idx/status")
                if resp.status == 200:
                    d = await resp.json()
                    if d["status"] == "SERVING" and d["count"] == 50:
                        break
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.05)

            dbi = db.db_indexes[("ks", "idx")]
            stop_load = asyncio.Event()
            query_errors = []
            qrng = np.random.default_rng(7)

            async def querier():
                while not stop_load.is_set():
                    q = qrng.normal(size=DIMS).astype(np.float32)
                    resp = await client.post("/api/v1/indexes/ks/idx/ann", json={"vector": q.tolist(), "limit": 5})
                    if resp.status != 200:
                        query_errors.append(await resp.text())
                    await asyncio.sleep(0.01)

            async def writer():
                ts = 200
                for i in range(60):
                    await dbi.push_cdc(fake.vector_row((100 + i,), writes[i].tolist(), ts))
                    ts += 1
                    if i % 3 == 0 and i > 0:
                        await dbi.push_cdc(fake.delete_row((100 + i - 1,), ts))
                        ts += 1
                    await asyncio.sleep(0.005)

            q_tasks = [asyncio.get_running_loop().create_task(querier()) for _ in range(4)]
            await writer()
            await asyncio.sleep(1.0)
            stop_load.set()
            await asyncio.gather(*q_tasks)

            # freshness: a late-inserted vector is findable
            await dbi.push_cdc(fake.vector_row((999,), late.tolist(), 10_000))
            deadline = asyncio.get_event_loop().time() + 15
            while True:
                resp = await client.post("/api/v1/indexes/ks/idx/ann", json={"vector": late.tolist(), "limit": 1})
                data = await resp.json()
                if resp.status == 200 and data["primary_keys"]["pk"] == [999]:
                    break
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.05)
            final = await (await client.get("/api/v1/indexes/ks/idx/status")).json()
            return {"errors": query_errors, "count": final["count"]}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert not port["errors"], port["errors"][:3]
    assert not jax["errors"], jax["errors"][:3]
    assert port["count"] > 50 and jax["count"] > 50  # inserts landed (minus deletes)
    assert port["count"] <= 50 + 60 + 1 and jax["count"] <= 50 + 60 + 1
