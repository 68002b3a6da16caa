"""The sharded engines served by the port, beside the JAX service.

Twins of tests/test_sharded_service.py: the port's factory builds
ShardedIvfServingEngine / ShardedGraphServingEngine over a mesh of 8
shards on torch.device("cpu") (``Config(engine_kind=..., shards=8)``),
and the whole stack (FakeDb -> full scan -> table -> sharded engine ->
HTTP ANN) serves with a recall gate, post-build freshness and removal, a
local index falls to the flat engine, the grouped subset-exact terminal
answers low-selectivity filters, and the exact-host distances keep the
device paths' dot-product convention. One side-by-side case serves the
same rows through the JAX service on its 8 virtual CPU devices and
compares the answers (ROADMAP queue 3's group-min rule: equal key sets
where distances tie).

Tolerances: recall >= 0.9 as the JAX twins; exact-host distances within
1e-5; side-by-side distances within 1e-5.
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
from vector_store_tpu_torch.core.types import DbIndexPartitioning, IndexKey, Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.db.fake import delete_row, make_vs_metadata, vector_row  # noqa: E402
from vector_store_tpu_torch.parallel import make_mesh  # noqa: E402
from vector_store_tpu_torch.parallel.serving import (  # noqa: E402
    ShardedGraphServingEngine,
    ShardedIvfServingEngine,
)
from vector_store_tpu_torch.run import build_service  # noqa: E402
from vector_store_tpu_torch.service.config import Config  # noqa: E402

CPU = torch.device("cpu")
RNG = np.random.default_rng(21)
DIMS = 16


def exact_top_k(vecs: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    # the index default space is cosine
    vn = vecs / np.linalg.norm(vecs, axis=-1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=-1, keepdims=True)
    return np.argsort(1.0 - qn @ vn.T, axis=1, kind="stable")[:, :k]


def recall_at_k(got_ids, gt: np.ndarray, k: int) -> float:
    return float(np.mean([len(set(g) & set(gt[i].tolist())) / k for i, g in enumerate(got_ids)]))


async def _wait_serving(client, count, timeout=60.0):
    deadline = asyncio.get_running_loop().time() + timeout
    d = None
    while True:
        resp = await client.get("/api/v1/indexes/ks/idx/status")
        if resp.status == 200:
            d = await resp.json()
            if d["status"] == "SERVING" and d["count"] == count:
                return
        assert asyncio.get_running_loop().time() < deadline, d
        await asyncio.sleep(0.05)


async def _ann(client, q, k, **extra):
    resp = await client.post("/api/v1/indexes/ks/idx/ann", json={"vector": q.tolist(), "limit": k, **extra})
    assert resp.status == 200, await resp.text()
    return await resp.json()


async def _ann_ids(client, q, k, **extra):
    return (await _ann(client, q, k, **extra))["primary_keys"]["pk"]


async def _serve(db, engine_kind: str, fake=None, config_cls=Config, build=build_service, **kw):
    service = await build(db, config_cls(monitor_indexes_interval=0.05, engine_kind=engine_kind, shards=8), **kw)
    client = TestClient(TestServer(service.app))
    await client.start_server()
    return service, client


def seeded_db(fake, base, labels=None):
    db = fake.FakeDb()
    columns = {} if labels is None else {"bucket": "int"}
    db.add_table(fake.FakeTable("ks", "tbl", ("pk",), columns=columns))
    rows = [
        fake.vector_row((i,), base[i].tolist(), 100, **({} if labels is None else {"filtering": [(100, int(labels[i]))]}))
        for i in range(len(base))
    ]
    md = fake.make_vs_metadata(dimensions=DIMS, filtering_columns=() if labels is None else ("bucket",))
    db.add_index(fake.FakeIndex(metadata=md, scan=rows))
    return db


async def run_sharded_service(engine_kind: str, n: int, built_check):
    """Serve on a sharded engine, gate recall before and after the build,
    prove post-build freshness and removal."""
    base = RNG.normal(size=(n, DIMS)).astype(np.float32)
    db = seeded_db(port_fake, base)
    service, client = await _serve(db, engine_kind, device=CPU)
    try:
        await _wait_serving(client, n)
        actor = service.indexes.get_vs(IndexKey("ks", "idx")).actor
        engine = actor.engine
        assert engine.n_shards == 8
        assert [d.type for d in engine.mesh.shard_devices] == ["cpu"] * 8

        queries = base[:12] + 0.05 * RNG.normal(size=(12, DIMS)).astype(np.float32)
        gt = exact_top_k(base, queries, 10)

        async def gated_recall():
            return recall_at_k([await _ann_ids(client, q, 10) for q in queries], gt, 10)

        r_pre = await gated_recall()
        assert r_pre >= 0.9, f"pre-build recall {r_pre}"

        # drop the threshold so the actor's idle maintenance slot builds
        engine.min_build = 64
        deadline = asyncio.get_running_loop().time() + 120
        while not built_check(engine):
            assert asyncio.get_running_loop().time() < deadline, "build never ran"
            actor._modify_event.set()  # nudge the scheduler
            await asyncio.sleep(0.1)
        r_post = await gated_recall()
        assert r_post >= 0.9, f"post-build recall {r_post}"

        # a post-build CDC upsert is searchable at once (the delta)
        dbi = db.db_indexes[("ks", "idx")]
        new_vec = (RNG.normal(size=DIMS) * 10 + 50).astype(np.float32)
        await dbi.push_cdc(vector_row((n,), new_vec.tolist(), 200))
        deadline = asyncio.get_running_loop().time() + 30
        while await _ann_ids(client, new_vec, 1) != [n]:
            assert asyncio.get_running_loop().time() < deadline, "fresh row unsearchable"
            await asyncio.sleep(0.1)

        # removal takes effect
        await dbi.push_cdc(delete_row((n,), 300))
        deadline = asyncio.get_running_loop().time() + 30
        while await _ann_ids(client, new_vec, 1) == [n]:
            assert asyncio.get_running_loop().time() < deadline, "remove never landed"
            await asyncio.sleep(0.1)
    finally:
        await client.close()
        await service.stop()


async def test_sharded_ivf_service_recall_and_freshness():
    def built(engine):
        assert isinstance(engine, ShardedIvfServingEngine)
        return engine._idx.main_vecs is not None

    await run_sharded_service("ivf-sharded", n=600, built_check=built)


async def test_sharded_graph_service_recall_and_freshness():
    def built(engine):
        assert isinstance(engine, ShardedGraphServingEngine)
        return engine._idx is not None

    await run_sharded_service("graph-sharded", n=512, built_check=built)


async def test_local_index_falls_back_to_flat():
    """The sharded engines serve global indexes; a local (per-partition)
    index gets the flat engine instead."""
    from vector_store_tpu_torch.engine.flat import FlatDeviceIndex
    from vector_store_tpu_torch.service.vs_index import VsIndexActor
    from vector_store_tpu_torch.table import Table

    md = make_vs_metadata(dimensions=8, partitioning=DbIndexPartitioning.local(("pk",)))
    for kind in ("ivf-sharded", "graph-sharded"):
        actor = VsIndexActor(md, Table(md), engine_kind=kind, shards=8, device=CPU)
        assert isinstance(actor.engine, FlatDeviceIndex)


async def run_sharded_filtered_terminal(engine_kind: str):
    """Low-selectivity filtered ANN through a sharded engine: the ladder is
    hopeless (S * 64 < N), so the actor's grouped terminal answers from the
    engine's search_exact_host_subset. The returned keys equal the exact
    filtered ranking."""
    n, k = 2000, 5
    base = RNG.normal(size=(n, DIMS)).astype(np.float32)
    # bucket 7 matches 8 rows: 8 * 64 = 512 < 2000
    labels = np.zeros(n, dtype=np.int64)
    members = np.arange(0, n, 250)[:8]
    labels[members] = 7
    db = seeded_db(port_fake, base, labels)
    service, client = await _serve(db, engine_kind, device=CPU)
    restrict = {"filter": {"restrictions": [{"type": "==", "lhs": "bucket", "rhs": 7}], "allow_filtering": True}}
    try:
        await _wait_serving(client, n)
        actor = service.indexes.get_vs(IndexKey("ks", "idx")).actor
        assert actor.engine.n_shards == 8

        # random queries, not near the members: the ladder exhausts
        queries = RNG.normal(size=(4, DIMS)).astype(np.float32)
        gt = members[exact_top_k(base[members], queries, k)]
        before = actor._exact_fallbacks
        for qi, q in enumerate(queries):
            assert await _ann_ids(client, q, k, **restrict) == gt[qi].tolist()
        assert actor._exact_fallbacks > before, "terminal path never taken"

        # a repeat query with the cached (fresh) match set goes straight to
        # the grouped terminal: no engine search at all
        calls = []
        inner = actor.engine.search

        def counting(queries, k, partitions=None):
            calls.append(k)
            return inner(queries, k, partitions=partitions)

        actor.engine.search = counting
        try:
            assert await _ann_ids(client, queries[0], k, **restrict) == gt[0].tolist()
            assert calls == [], f"expected the direct terminal, saw {calls}"
        finally:
            actor.engine.search = inner
    finally:
        await client.close()
        await service.stop()


async def test_sharded_ivf_filtered_grouped_terminal():
    await run_sharded_filtered_terminal("ivf-sharded")


async def test_sharded_graph_filtered_grouped_terminal():
    await run_sharded_filtered_terminal("graph-sharded")


def test_sharded_exact_host_dot_product_convention():
    """The exact-host fallbacks rank and report distances in the device
    paths' convention (1 - dot for dot product), dead slots +inf."""
    mesh = make_mesh(8, devices=[CPU])
    n, d = 64, 8
    vecs = RNG.normal(size=(n, d)).astype(np.float32)
    slots = np.arange(n)
    epochs = np.full(n, 3, np.int32)
    q = RNG.normal(size=(d,)).astype(np.float32)
    want = 1.0 - vecs @ q

    for cls in (ShardedIvfServingEngine, ShardedGraphServingEngine):
        eng = cls(mesh, d, space_type=SpaceType.DOT_PRODUCT, quantization=Quantization.F32)
        eng.upsert_batch(slots, epochs, vecs)
        res = eng.search_exact_host(q, n)
        got = res.distances[np.argsort(res.slots, kind="stable")]
        np.testing.assert_allclose(got, want[np.sort(res.slots)], atol=1e-5)
        sub = np.array([5, 11, n + 99], dtype=np.int64)
        dists, eps = eng.search_exact_host_subset(q[None, :], sub)
        np.testing.assert_allclose(dists[0, :2], want[sub[:2]], atol=1e-5)
        assert np.isinf(dists[0, 2]) and eps[2] == -1
        assert (eps[:2] == 3).all()


@pytest.mark.parametrize("engine_kind", ["ivf-sharded", "graph-sharded"])
async def test_port_serves_like_jax_sharded_service(engine_kind):
    """The same rows behind the JAX service (8 virtual CPU devices) and
    the port's (8 shards on the CPU), before and after the first build:
    the same keys, or the same key set where distances tie within 1e-5
    (the group-min rule), distances within 1e-5."""
    from vector_store_tpu.run import build_service as jax_build_service

    rng = np.random.default_rng(4)
    n = 700
    base = rng.normal(size=(n, DIMS)).astype(np.float32)
    queries = base[:16] + 0.05 * rng.normal(size=(16, DIMS)).astype(np.float32)
    jax_svc, jax_client = await _serve(
        seeded_db(jax_fake, base), engine_kind, config_cls=jax_config.Config, build=jax_build_service
    )
    port_svc, port_client = await _serve(seeded_db(port_fake, base), engine_kind, device=CPU)

    async def compare():
        for q in queries:
            want = await _ann(jax_client, q, 10)
            got = await _ann(port_client, q, 10)
            np.testing.assert_allclose(got["distances"], want["distances"], rtol=0, atol=1e-5)
            g, w, dist = got["primary_keys"]["pk"], want["primary_keys"]["pk"], want["distances"]
            assert sorted(g) == sorted(w)
            for i in np.nonzero(np.asarray(g) != np.asarray(w))[0]:
                # a key may move only within a run of tied distances
                assert any(abs(dist[i] - dist[j]) <= 1e-5 for j in (i - 1, i + 1) if 0 <= j < len(dist))

    try:
        await _wait_serving(jax_client, n)
        await _wait_serving(port_client, n)
        await compare()  # before any build: the exact sharded deltas
        engines = [svc.indexes.get_vs(IndexKey("ks", "idx")).actor.engine for svc in (jax_svc, port_svc)]
        for e in engines:
            e.min_build = 64
        deadline = asyncio.get_running_loop().time() + 120
        while not all(
            (e._idx.nlist > 0 and e._pending == 0) if engine_kind == "ivf-sharded" else (e._idx is not None and not e._delta)
            for e in engines
        ):
            assert asyncio.get_running_loop().time() < deadline, "a build never ran"
            for svc in (jax_svc, port_svc):
                svc.indexes.get_vs(IndexKey("ks", "idx")).actor._modify_event.set()
            await asyncio.sleep(0.1)
        if engine_kind == "ivf-sharded":
            assert engines[1]._idx.nlist == engines[0]._idx.nlist
        await compare()
    finally:
        await port_client.close()
        await jax_client.close()
        await port_svc.stop()
        await jax_svc.stop()


async def test_sharded_gate_runs_on_cpu(monkeypatch):
    """The scale gate (bench/sharded_gate.py, the twin of
    scripts/sharded_scale_gate.py) at 8,192 rows over 8 CPU shards: its
    recall gate, placement accounting, filtered terminal and local
    fallback all hold."""
    from vector_store_tpu_torch.bench import sharded_gate

    monkeypatch.setenv("SHARDED_GATE_N", "8192")
    monkeypatch.setenv("SHARDED_GATE_DEVICE", "cpu")
    out = await sharded_gate.main()
    assert out["recall_gate_passed"] and out["recall_at_10"] >= 0.95
    assert len(out["per_shard_rows"]) == 8 and min(out["per_shard_rows"]) > 0
    assert out["placed_rows"] + out["delta_spill_rows"] == 8192
    assert out["filtered_exact"] and out["filtered_used_terminal"] and out["local_fallback_ok"]
