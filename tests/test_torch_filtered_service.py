"""Filtered ANN through the port's service, on the CPU.

Twins of the JAX package's service cases, driven through
vector_store_tpu_torch.run.build_service on torch.device("cpu"):

- the mid-selectivity regime (tests/test_masked_filter.py
  ``_serve_mid_selectivity``): a filter matching 10% of the rows walks the
  ladder to step 16, is promoted to a device allow-mask and answers the
  exact filtered top-k; repeats reuse the handle; a write makes a new one,
  through which a new matching row is found;
- the grouped subset-exact terminal (tests/test_filtered_terminal.py
  ``TestServiceTerminalPath``): a filter matching 0.5% exhausts the ladder,
  the terminal answers exactly, the match cache serves repeats, a write
  refreshes it, and /api/internals/counters mirrors the counters;
- the learned ladder (tests/test_ladder_seed.py): a repeat filter enters
  the ladder at the step it needed, on the port's pipelined path (the
  JAX case drives the simulator engine, which the port does not have);
- one run of the same filtered requests through the JAX service and the
  port's, each regime in turn: keys equal, distances within 1e-6;
- local indexes under the engine kinds that serve only global indexes
  (graph, ivf-sharded, graph-sharded) take the flat engine and answer 200;
  a global index under those kinds takes the graph engine or the sharded
  engine of the kind and answers 200.
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
from vector_store_tpu_torch.core.types import DbIndexPartitioning  # noqa: E402
from vector_store_tpu_torch.db.fake import (  # noqa: E402
    FakeDb,
    FakeIndex,
    FakeTable,
    make_vs_metadata,
    vector_row,
)
from vector_store_tpu_torch.run import build_service  # noqa: E402
from vector_store_tpu_torch.service.config import Config  # noqa: E402
from vector_store_tpu_torch.service.node_state import IndexStatus  # noqa: E402

CPU = torch.device("cpu")
RNG = np.random.default_rng(77)


def labelled_db(vecs, labels, fake=port_fake):
    """A FakeDb (of ``fake``'s package) with one global index and a
    filtering column ``bucket``: row i holds labels[i]."""
    db = fake.FakeDb()
    db.add_table(fake.FakeTable("ks", "tbl", ("pk",), columns={"bucket": "int"}))
    rows = [
        fake.vector_row((i,), vecs[i].tolist(), 100, filtering=[(100, int(labels[i]))])
        for i in range(len(vecs))
    ]
    db.add_index(fake.FakeIndex(
        metadata=fake.make_vs_metadata(dimensions=vecs.shape[1], filtering_columns=("bucket",)),
        scan=rows,
    ))
    return db


async def start(db, build=None, config=None):
    """The port's service (or ``build``'s) over ``db`` on a test server."""
    if build is None:
        service = await build_service(db, config or Config(monitor_indexes_interval=0.05), device=CPU)
    else:
        service = await build(db, config)
    client = TestClient(TestServer(service.app))
    await client.start_server()
    return service, client


async def wait_serving(client, n, timeout=60):
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        resp = await client.get("/api/v1/indexes/ks/idx/status")
        if resp.status == 200:
            st = await resp.json()
            if st["status"] == "SERVING" and st["count"] == n:
                return
        assert asyncio.get_event_loop().time() < deadline
        await asyncio.sleep(0.05)


def bucket_filter(value):
    return {"restrictions": [{"type": "==", "lhs": "bucket", "rhs": value}], "allow_filtering": True}


async def filtered(client, q, k, value):
    resp = await client.post(
        "/api/v1/indexes/ks/idx/ann",
        json={"vector": [float(x) for x in q], "limit": k, "filter": bucket_filter(value)},
    )
    assert resp.status == 200, await resp.text()
    return await resp.json()


def brute_filtered(vecs, mask, q, k):
    sub = np.flatnonzero(mask)
    vn = vecs[sub] / np.linalg.norm(vecs[sub], axis=1, keepdims=True)
    d = 1.0 - vn @ (q / np.linalg.norm(q))
    return sub[np.argsort(d, kind="stable")][:k]


async def test_mid_selectivity_promotes_to_device_mask():
    n, d, k = 3000, 16, 10
    vecs = RNG.normal(size=(n, d)).astype(np.float32)
    labels = (np.arange(n) % 10 == 3).astype(np.int64)  # 10% selectivity
    db = labelled_db(vecs, labels)
    service, client = await start(db)
    try:
        await wait_serving(client, n)
        actor = service.indexes.get_vs(("ks", "idx")).actor
        eng = actor.engine
        # cluster now, and probe every cluster so masked answers are exact
        eng.min_build, eng.kmeans_block, eng.kmeans_iters = 1024, 1024, 2
        assert eng.maintain() is True and eng.main_vecs is not None
        eng.nprobe = eng.nlist
        mask = labels == 1

        async def keys(q):
            return (await filtered(client, q, k, 1))["primary_keys"]["pk"]

        # the first query walks 1 -> 4 -> 16; at 16 the triage computes the
        # match set (10%: dense) and dispatches it device-masked
        q0 = vecs[3] + 0.01
        assert await keys(q0) == brute_filtered(vecs, mask, q0, k).tolist()
        assert actor._masked_dispatches >= 1 and len(actor._allow_cache) == 1
        sig = next(iter(actor._allow_cache))
        # a repeat goes straight to the mask (the allow cache marks it)
        before = actor._masked_dispatches
        q1 = vecs[13] + 0.01
        assert await keys(q1) == brute_filtered(vecs, mask, q1, k).tolist()
        assert actor._masked_dispatches > before
        handle = actor._allow_cache[sig][1]
        # more repeats reuse the same handle and its masked copy
        before = actor._masked_dispatches
        for i in (23, 33, 43):
            qi = vecs[i] + 0.01
            assert await keys(qi) == brute_filtered(vecs, mask, qi, k).tolist()
        assert actor._masked_dispatches >= before + 3
        assert actor._allow_cache[sig][1] is handle and handle.materializations == 1
        # a write moves the stamp: a new matching row at the query point is
        # found through a new handle
        new_vec = (q1 / np.linalg.norm(q1)).astype(np.float32)
        await db.db_indexes[("ks", "idx")].push_cdc(
            vector_row((n,), new_vec.tolist(), 200, filtering=[(200, 1)])
        )
        deadline = asyncio.get_event_loop().time() + 30
        while (got := await keys(new_vec))[:1] != [n]:
            assert asyncio.get_event_loop().time() < deadline, got
            await asyncio.sleep(0.1)
        assert actor._allow_cache[sig][1] is not handle
        counters = await (await client.get("/api/internals/counters")).json()
        assert counters["vs_index_masked_dispatches"] == actor._masked_dispatches
        assert counters["vs_index_oversample_escalations"] >= 2
    finally:
        await client.close()
        await service.stop()


async def test_low_selectivity_end_to_end():
    n, d, k = 3000, 8, 10
    rare = 15  # rows matching the filter: 0.5%
    vecs = RNG.normal(size=(n, d)).astype(np.float32)
    labels = np.zeros(n, dtype=np.int64)
    rare_rows = RNG.choice(n, size=rare, replace=False)
    labels[rare_rows] = 7
    db = labelled_db(vecs, labels)
    service, client = await start(db)
    try:
        await wait_serving(client, n)
        qn = vecs[rare_rows[0]] + 0.01
        want = set(brute_filtered(vecs, labels == 7, qn, k).tolist())
        actor = service.indexes.get_vs(("ks", "idx")).actor

        async def ids():
            return set((await filtered(client, qn, k, 7))["primary_keys"]["pk"])

        assert await ids() == want
        # the ladder exhausted: the grouped terminal answered and cached the
        # match set, and the counters surface mirrors it
        assert actor._exact_fallbacks >= 1
        counters = await (await client.get("/api/internals/counters")).json()
        assert counters.get("vs_index_exact_host_fallbacks", 0) >= 1, counters
        assert any(v[1].size == rare for v in actor._match_cache.values())
        # a repeat is answered from the cached match set, with no scan
        begins = []
        orig = actor.engine.search_begin
        actor.engine.search_begin = lambda *a, **kw: begins.append(1) or orig(*a, **kw)
        before = actor._exact_fallbacks
        assert await ids() == want
        assert actor._exact_fallbacks > before and not begins
        # a write puts a new row in the bucket: the stamp refreshes the
        # match set and the row is reachable
        new_vec = (qn / np.linalg.norm(qn)).astype(np.float32)
        await db.db_indexes[("ks", "idx")].push_cdc(
            vector_row((n,), new_vec.tolist(), 200, filtering=[(200, 7)])
        )
        deadline = asyncio.get_event_loop().time() + 30
        while n not in (got := await ids()):
            assert asyncio.get_event_loop().time() < deadline, got
            await asyncio.sleep(0.1)
    finally:
        await client.close()
        await service.stop()


def ranked_vectors(n, d):
    """vecs[i] at an angle from e1 that grows with i: for the query e1 the
    cosine rank order is the index order."""
    theta = (np.arange(n) + 1) * (np.pi / 2) / (n + 1)
    out = np.zeros((n, d), dtype=np.float32)
    out[:, 0], out[:, 1] = np.cos(theta), np.sin(theta)
    return out


async def test_repeat_filter_enters_the_ladder_at_its_learned_step():
    """The 4 matches rank 48, 52, 56 and 60: out of reach of the limit x 1
    and x 4 steps, in reach of x 16. The first query walks the ladder; a
    repeat enters at 16 with one search."""
    n, d, limit, matches = 256, 8, 4, (48, 52, 56, 60)
    labels = np.zeros(n, dtype=np.int64)
    labels[list(matches)] = 7
    service, client = await start(labelled_db(ranked_vectors(n, d), labels))
    try:
        await wait_serving(client, n)
        actor = service.indexes.get_vs(("ks", "idx")).actor
        calls: list[int] = []
        orig = actor.engine.search_begin
        actor.engine.search_begin = lambda q, k, *a, **kw: calls.append(k) or orig(q, k, *a, **kw)
        e1 = np.eye(d, dtype=np.float32)[0]
        got = await filtered(client, e1, limit, 7)
        assert got["primary_keys"]["pk"] == list(matches)
        assert calls == [limit * 1, limit * 4, limit * 16], calls
        calls.clear()
        got = await filtered(client, e1, limit, 7)
        assert got["primary_keys"]["pk"] == list(matches)
        assert calls == [limit * 16], calls
        # 4 matches of 256 rows: neither sparse enough for the terminal nor
        # dense enough for the mask; the ladder served both
        assert actor._masked_dispatches == 0 and actor._exact_fallbacks == 0
    finally:
        await client.close()
        await service.stop()


async def test_filtered_regimes_answer_like_jax_service():
    """120 rows (under one lane group of the port's scan, so both sides
    scan exactly) with three labels: 0 on half the rows (the ladder), 1 on
    ~10% (promoted to the mask after the ladder reaches 16) and 7 on one
    row (the terminal). The same requests, one at a time, to both
    services."""
    from vector_store_tpu.run import build_service as jax_build

    n, d, limit = 120, 8, 3
    rng = np.random.default_rng(21)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    labels = np.where(rng.random(n) < 0.5, 0, 2)
    labels[rng.choice(np.flatnonzero(labels == 2), 12, replace=False)] = 1
    labels[int(np.flatnonzero(labels == 2)[0])] = 7
    queries = rng.normal(size=(4, d)).astype(np.float32)
    port_svc, port = await start(labelled_db(vecs, labels))
    jax_svc, jaxc = await start(
        labelled_db(vecs, labels, jax_fake), jax_build, jax_config.Config(monitor_indexes_interval=0.05)
    )
    try:
        await wait_serving(port, n)
        await wait_serving(jaxc, n)
        for value in (0, 1, 7):
            for q in queries:
                want = await filtered(jaxc, q, limit, value)
                got = await filtered(port, q, limit, value)
                assert got["primary_keys"] == want["primary_keys"], (value, got, want)
                np.testing.assert_allclose(got["distances"], want["distances"], rtol=0, atol=1e-6)
                assert (labels[got["primary_keys"]["pk"]] == value).all()
        actors = [svc.indexes.get_vs(("ks", "idx")).actor for svc in (port_svc, jax_svc)]
        for attr in ("_masked_dispatches", "_exact_fallbacks", "_escalations"):
            assert getattr(actors[0], attr) == getattr(actors[1], attr), attr
        assert actors[0]._masked_dispatches > 0 and actors[0]._exact_fallbacks > 0
        assert set(actors[0]._ladder_cache.values()) == set(actors[1]._ladder_cache.values())
    finally:
        for c in (port, jaxc):
            await c.close()
        await port_svc.stop()
        await jax_svc.stop()


@pytest.mark.parametrize("kind", ("graph", "ivf-sharded", "graph-sharded"))
async def test_local_index_served_under_unported_engine_kinds(kind):
    from vector_store_tpu_torch.engine.flat import FlatDeviceIndex
    from vector_store_tpu_torch.engine.graph import GraphDeviceIndex
    from vector_store_tpu_torch.parallel.serving import ShardedGraphServingEngine, ShardedIvfServingEngine

    config = Config(monitor_indexes_interval=0.05, engine_kind=kind)
    # a local index: 4 partitions x 5 rows
    db = FakeDb()
    db.add_table(FakeTable("ks", "tbl", ("pk", "ck")))
    md = make_vs_metadata(
        dimensions=4, primary_key_columns=("pk", "ck"), partition_key_count=1,
        partitioning=DbIndexPartitioning.local(("pk",)),
    )
    db.add_index(FakeIndex(
        metadata=md,
        scan=[vector_row((p, c), [p + 1.0, c + 1.0, 1.0, 0.0], 100) for p in range(4) for c in range(5)],
    ))
    service, client = await start(db, config=config)
    try:
        await wait_serving(client, 20)
        assert isinstance(service.indexes.get_vs(("ks", "idx")).actor.engine, FlatDeviceIndex)
        resp = await client.post("/api/v1/indexes/ks/idx/ann", json={
            "vector": [3.0, 2.0, 1.0, 0.0], "limit": 3,
            "filter": {"restrictions": [{"type": "==", "lhs": "pk", "rhs": 2}], "allow_filtering": True},
        })
        assert resp.status == 200, await resp.text()
        body = await resp.json()
        assert body["primary_keys"]["pk"] == [2, 2, 2] and body["primary_keys"]["ck"][0] == 1
    finally:
        await client.close()
        await service.stop()
    # a global index under the same kind: the graph or sharded engine
    # serves it
    db = labelled_db(RNG.normal(size=(10, 4)).astype(np.float32), np.zeros(10, np.int64))
    service, client = await start(db, config=config)
    try:
        deadline = asyncio.get_event_loop().time() + 10
        while (entry := service.indexes.get_vs(("ks", "idx"))) is None or (
            entry.status is not IndexStatus.SERVING
        ):
            assert asyncio.get_event_loop().time() < deadline
            await asyncio.sleep(0.05)
        body = {"vector": [1.0, 0, 0, 0], "limit": 1, "filter": bucket_filter(0)}
        engine_cls = {"graph": GraphDeviceIndex, "ivf-sharded": ShardedIvfServingEngine,
                      "graph-sharded": ShardedGraphServingEngine}[kind]
        assert isinstance(entry.actor.engine, engine_cls)
        await wait_serving(client, 10)
        resp = await client.post("/api/v1/indexes/ks/idx/ann", json=body)
        assert resp.status == 200, await resp.text()
        assert len((await resp.json())["primary_keys"]["pk"]) == 1
    finally:
        await client.close()
        await service.stop()
