"""Twins of tests/test_ivf_service.py: the IVF engine driven through the
full service (the actor's maintenance, ``make_engine``'s ``auto``), each
case run on the JAX service and on the port's (run.build_service on
torch.device("cpu")), and the rebuild floor on both engines.

| reference case | port test |
|---|---|
| test_auto_engine_is_ivf_and_rebuild_serves | test_auto_engine_is_ivf_and_rebuild_serves |
| test_low_selectivity_filter_uses_exact_escalation | test_low_selectivity_filter_uses_exact_escalation |
| test_begin_window_single_upload_matches_per_batch | skipped: do not carry over (the super-batch query upload) |
| test_rebuild_progresses_under_continuous_query_load | test_rebuild_progresses_under_continuous_query_load |
| TestRebuildFloor::test_own_spill_does_not_retrigger_rebuild | test_own_spill_does_not_retrigger_rebuild |

Tolerance. Below the build both services answer exactly; a self-query's
first key and distance are compared (the JAX delta scans exactly on the
CPU, the port's through kernel 1's lane minima, which always keep the
query's own row: ROADMAP.md queue 3). After each engine's own k-means
build the facts each case asserts hold on both services: the self-queries
found first at distance 0 (within 1e-3, the case's bound), the CDC row
found, every filtered key matching. The exact host escalation answers
exactly on both: keys equal, distances within 1e-6 * (1 + |d|) plus
1e-6 times the rows' largest squared norm. Each twin is bounded by 60 s;
the reference's own waits run inside it.
"""

import asyncio

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("aiohttp")

from torch_ivf_suite import interp_pallas  # noqa: E402,F401
from torch_service_twins import JAX, PORT, assert_same, norm2, request, stop, twin  # noqa: E402

DIMS = 16


def ivf_class(side):
    if side is JAX:
        from vector_store_tpu.engine.ivf import IvfDeviceIndex
    else:
        from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex
    return IvfDeviceIndex


def vector_db(side, base, **md_kwargs):
    fake = side.fake
    db = fake.FakeDb()
    db.add_table(fake.FakeTable("ks", "tbl", ("pk",)))
    rows = [fake.vector_row((i,), base[i].tolist(), 100) for i in range(len(base))]
    db.add_index(fake.FakeIndex(metadata=fake.make_vs_metadata(dimensions=DIMS, **md_kwargs), scan=rows))
    return db


async def _wait_serving(client, count, timeout=30.0):
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        resp = await client.get("/api/v1/indexes/ks/idx/status")
        if resp.status == 200:
            d = await resp.json()
            if d["status"] == "SERVING" and d["count"] == count:
                return
        assert asyncio.get_event_loop().time() < deadline, d
        await asyncio.sleep(0.05)


def shrink_thresholds(side, engine, **kw):
    """The reference's lowered build thresholds (and, on the JAX engine,
    its interpret-mode delta for the rebuild)."""
    for name, value in kw.items():
        setattr(engine, name, value)
    if side is JAX:
        engine.interpret = True


async def ann(client, vector, limit, **extra):
    return await request(
        client, "POST", "/api/v1/indexes/ks/idx/ann", json={"vector": vector.tolist(), "limit": limit, **extra}
    )


async def test_auto_engine_is_ivf_and_rebuild_serves(interp_pallas):
    n = 1500
    rng = np.random.default_rng(31)
    base = rng.normal(size=(n, DIMS)).astype(np.float32)
    new_vec = (rng.normal(size=DIMS) * 10 + 50).astype(np.float32)

    async def case(side):
        db = vector_db(side, base)
        service, client = await side.start(db)
        try:
            await _wait_serving(client, n)
            actor = service.indexes.get_vs(side.types.IndexKey("ks", "idx")).actor
            engine = actor.engine
            assert isinstance(engine, ivf_class(side))
            # pre-build: delta delegation serves exact answers
            assert engine.main_vecs is None
            status, body = await ann(client, base[42], 3)
            pre = (status, body["primary_keys"]["pk"][0], body["distances"][0])

            # drop the thresholds so the actor's idle maintenance reclusters
            shrink_thresholds(side, engine, min_build=256, kmeans_block=512, nprobe=16)
            deadline = asyncio.get_event_loop().time() + 60
            while engine.main_vecs is None:
                assert asyncio.get_event_loop().time() < deadline
                actor._modify_event.set()  # nudge the scheduler
                await asyncio.sleep(0.1)
            nlist = engine.nlist

            # post-build: clustered main region serves; self-query still exact
            post = []
            for q in (7, 99, 1234):
                status, body = await ann(client, base[q], 3)
                post.append((status, body["primary_keys"]["pk"][0], body["distances"][0]))

            # streaming upsert after the build lands in the delta and serves
            await db.db_indexes[("ks", "idx")].push_cdc(side.fake.vector_row((n,), new_vec.tolist(), 200))
            deadline = asyncio.get_event_loop().time() + 20
            while True:
                status, body = await ann(client, new_vec, 1)
                if status == 200 and body["primary_keys"]["pk"] == [n]:
                    break
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.1)
            return {"pre": pre, "nlist": nlist, "post": post}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port["pre"], jax["pre"], norm2(base))
    assert port["pre"][:2] == (200, 42)
    assert port["pre"][2] == pytest.approx(0.0, abs=1e-3)
    assert port["nlist"] == jax["nlist"] and port["nlist"] >= 64
    for got in (jax["post"], port["post"]):
        for (status, pk, dist), q in zip(got, (7, 99, 1234)):
            assert status == 200 and pk == q
            assert dist == pytest.approx(0.0, abs=1e-3)


async def test_low_selectivity_filter_uses_exact_escalation(interp_pallas, monkeypatch):
    """A filter matching ~0.3% of rows must still return ``limit`` rows:
    the actor's oversample steps exhaust against the IVF candidate cap and
    the exact host-mirror escalation completes the result."""
    import vector_store_tpu.engine.ivf as jax_ivf_mod

    monkeypatch.setattr(jax_ivf_mod.IvfDeviceIndex, "_set_delta_interpret", lambda self: None)
    n = 3000
    vecs = np.random.default_rng(32).normal(size=(n, DIMS)).astype(np.float32)

    async def case(side):
        fake = side.fake
        db = fake.FakeDb()
        db.add_table(fake.FakeTable("ks", "tbl", ("pk",), columns={"rare": "int"}))
        rows = [
            fake.vector_row((i,), vecs[i].tolist(), 100, filtering=[(100, 1 if i % 300 == 0 else 0)])
            for i in range(n)  # 10 matching rows (~0.33%)
        ]
        md = fake.make_vs_metadata(dimensions=DIMS, filtering_columns=("rare",))
        db.add_index(fake.FakeIndex(metadata=md, scan=rows))
        service, client = await side.start(db, engine_kind="auto")
        try:
            await _wait_serving(client, n)
            eng = service.indexes.get_vs(("ks", "idx")).actor.engine
            # shrink thresholds and cluster NOW so the candidate cap is real
            shrink_thresholds(side, eng, min_build=1024, kmeans_block=1024, kmeans_iters=2)
            assert eng.maintain() is True
            if side is JAX:
                eng._warm_queue.clear()
            assert eng.main_vecs is not None
            return await ann(
                client, vecs[0], 10,
                filter={"restrictions": [{"type": "==", "lhs": "rare", "rhs": 1}], "allow_filtering": True},
            )
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax, norm2(vecs))
    status, data = port
    assert status == 200, data
    got = data["primary_keys"]["pk"]
    assert len(got) == 10, got  # ALL matching rows found
    assert all(pk % 300 == 0 for pk in got), got


@pytest.mark.skip(
    reason="Do not carry over (ROADMAP.md): the super-batch query upload of _begin_window "
    "(one upload_queries transfer behind several dispatch batches)"
)
async def test_begin_window_single_upload_matches_per_batch():
    pass


async def test_rebuild_progresses_under_continuous_query_load(interp_pallas):
    """The sliced rebuild must START and COMPLETE while queries flow
    continuously: concurrent-safe slices (kmeans/assign/arrays) dispatch
    alongside live search batches; only the swap waits for a drained
    pipeline."""
    n = 1200
    base = np.random.default_rng(33).normal(size=(n, DIMS)).astype(np.float32)

    async def case(side):
        service, client = await side.start(vector_db(side, base))
        try:
            await _wait_serving(client, n)
            actor = service.indexes.get_vs(side.types.IndexKey("ks", "idx")).actor
            engine = actor.engine
            assert engine.main_vecs is None
            assert engine.maintain_pending() is None  # below min_build

            # continuous query pressure: keep >= 4 ann calls in flight
            stop_load = asyncio.Event()
            answers: list[int] = []
            finals: list[int] = []

            async def pound(worker: int) -> None:
                i = worker
                while not stop_load.is_set():
                    res = await actor.ann(base[i % n].tolist(), 3)
                    assert res, "query returned empty under rebuild"
                    answers.append(i % n)
                    i += 7
                # one final correctness check per worker
                res = await actor.ann(base[worker].tolist(), 1)
                finals.append(res[0][0].values()[0])

            pounders = [asyncio.create_task(pound(w)) for w in range(4)]
            await asyncio.sleep(0.2)  # load established

            # now make the rebuild due: it must start AND finish under load
            shrink_thresholds(side, engine, min_build=256, kmeans_block=512, nprobe=16)
            deadline = asyncio.get_event_loop().time() + 90
            while engine.main_vecs is None:
                assert asyncio.get_event_loop().time() < deadline, (
                    f"rebuild never completed under continuous query load; maintain_log={list(engine.maintain_log)}"
                )
                await asyncio.sleep(0.05)
            built_at = len(answers)
            stop_load.set()
            await asyncio.gather(*pounders)
            status, body = await ann(client, base[77], 3)
            return {
                "built_at": built_at,
                "finals": sorted(finals),
                "phases": {p for p, _ in engine.maintain_log},
                "post": (status, body["primary_keys"]["pk"][0]),
            }
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    for got in (jax, port):
        assert got["built_at"] > 0, "no queries were answered while building"
        assert got["finals"] == [0, 1, 2, 3]
        # the slice log must show the full phase walk
        for expected in ("start", "kmeans", "assign", "arrays", "swap"):
            assert expected in got["phases"], got["phases"]
        # post-build correctness through the service
        assert got["post"] == (200, 77)


def test_own_spill_does_not_retrigger_rebuild(monkeypatch):
    """A rebuild's cluster-overflow spill re-enters the delta; the trigger
    must measure growth ABOVE the post-swap floor (forced here with nlist
    2 x cmax 128: half the rows spill). Both engines, each on its own
    build."""
    import vector_store_tpu.engine.ivf as jax_ivf_mod
    import vector_store_tpu_torch.engine.ivf as port_ivf_mod

    for mod in (jax_ivf_mod, port_ivf_mod):
        monkeypatch.setattr(mod, "choose_cmax", lambda n, nlist, h: 128)
        monkeypatch.setattr(mod, "choose_nlist", lambda n: 2)
    rng = np.random.default_rng(4)
    n, d = 512, 8
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    extra = rng.normal(size=(128, d)).astype(np.float32)
    for side in (JAX, PORT):
        kw = dict(
            space_type=side.types.SpaceType.EUCLIDEAN, quantization=side.types.Quantization.BF16,
            initial_capacity=2048, min_build=256, kmeans_block=64, kmeans_iters=2, rebuild_fraction=0.05,
        )
        if side is PORT:
            import torch

            kw["device"] = torch.device("cpu")
        idx = ivf_class(side)(d, **kw)
        if side is JAX:
            idx.interpret = True  # CPU backend: grouped kernel in interpret mode
        idx.upsert_batch(np.arange(n, dtype=np.int64), np.zeros(n, np.int32), vecs)
        assert idx._should_rebuild()
        idx.maintain()  # full build; ~half the rows spill back to delta
        while side is JAX and idx._warm_queue:
            idx.maintain(budget=1)
        assert idx.main_vecs is not None
        spill = idx._rebuild_floor
        assert spill > int(0.05 * n) + 64, spill  # spill >> threshold
        # the floor gates the trigger: no rebuild of the build's own spill
        assert not idx._should_rebuild()
        assert not idx.maintain(budget=1)
        # genuinely NEW churn above the floor still triggers a rebuild
        idx.upsert_batch(np.arange(n, n + 128, dtype=np.int64), np.zeros(128, np.int32), extra)
        assert idx._should_rebuild()
        # search correctness with the spill serving from the delta
        assert [r.slots[0] for r in idx.search(vecs[:4], 3)] == [0, 1, 2, 3]
