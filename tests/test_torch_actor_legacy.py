"""The port's actor on its legacy (non-pipelined) path and the host
engines behind the service.

Engines without ``search_begin`` (the simulator, OpenSearch) run
``VsIndexActor._execute_search_batch``: one engine search a rung of the
oversample ladder. Twins, through the port's actor and service on the CPU,
of tests/test_ladder_seed.py (a repeat filter enters the ladder at its
learned rung), the four cases of tests/test_actor_maintenance_concurrency.py
(modify batches against maintenance slices, with ``SlowSliceEngine`` built
on the port's SimulatorIndex) and
tests/test_validator_index_modify.py::test_version_only_change_with_simulator_keeps_index.
Beside them: ``ann_many`` answers as ``ann`` does, a filter too sparse for
the ladder ends on the exact terminal, and the VECTOR_STORE_USEARCH_SIMULATOR
and VECTOR_STORE_OPENSEARCH_URI settings start the port's service.
"""

import asyncio
import threading
import time
import uuid

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
from aiohttp import web  # noqa: E402
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from test_opensearch_sim import MockOpenSearch  # noqa: E402

from vector_store_tpu_torch.core import (  # noqa: E402
    DbIndexedValue,
    IndexKey,
    PrimaryKey,
    Timestamp,
    Timestamped,
)
from vector_store_tpu_torch.core.types import IndexVersion  # noqa: E402
from vector_store_tpu_torch.db.fake import (  # noqa: E402
    FakeDb,
    FakeIndex,
    FakeTable,
    make_vs_metadata,
    vector_row,
)
from vector_store_tpu_torch.engine import OpenSearchIndex, SimulatorIndex  # noqa: E402
from vector_store_tpu_torch.run import build_service  # noqa: E402
from vector_store_tpu_torch.service.config import Config, load_config  # noqa: E402
from vector_store_tpu_torch.service.vs_index import VsIndexActor  # noqa: E402
from vector_store_tpu_torch.table import Table  # noqa: E402

CPU = torch.device("cpu")
KEY = IndexKey("ks", "idx")


async def start(db, config):
    service = await build_service(db, config, device=CPU)
    client = TestClient(TestServer(service.app))
    await client.start_server()
    return service, client


async def wait_status(client, *, count=None, status="SERVING", timeout=30.0):
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        resp = await client.get("/api/v1/indexes/ks/idx/status")
        if resp.status == 200:
            d = await resp.json()
            if d["status"] == status and (count is None or d["count"] == count):
                return d
        assert asyncio.get_event_loop().time() < deadline, (resp.status, await resp.text())
        await asyncio.sleep(0.05)


def bucket_filter(value):
    return {"restrictions": [{"type": "==", "lhs": "bucket", "rhs": value}], "allow_filtering": True}


def labelled_db(vecs, labels):
    db = FakeDb()
    db.add_table(FakeTable("ks", "tbl", ("pk",), columns={"bucket": "int"}))
    rows = [
        vector_row((i,), vecs[i].tolist(), 100, filtering=[(100, int(labels[i]))])
        for i in range(len(vecs))
    ]
    db.add_index(FakeIndex(
        metadata=make_vs_metadata(dimensions=vecs.shape[1], filtering_columns=("bucket",)), scan=rows
    ))
    return db


# -- tests/test_ladder_seed.py ---------------------------------------------

N, D, LIMIT = 256, 8, 4
MATCHES = (48, 52, 56, 60)


def ranked_vectors() -> np.ndarray:
    """vecs[i] at angle theta_i from e1, theta monotone in i: cosine rank
    order is index order for the query e1."""
    theta = (np.arange(N) + 1) * (np.pi / 2) / (N + 1)
    out = np.zeros((N, D), dtype=np.float32)
    out[:, 0] = np.cos(theta)
    out[:, 1] = np.sin(theta)
    return out


async def test_legacy_ladder_enters_at_learned_rung():
    labels = np.zeros(N, dtype=np.int64)
    labels[list(MATCHES)] = 7
    service, client = await start(
        labelled_db(ranked_vectors(), labels), Config(monitor_indexes_interval=0.05, engine_kind="sim")
    )
    try:
        await wait_status(client, count=N)
        actor = service.indexes.get_vs(("ks", "idx")).actor
        assert not actor._pipelined, "simulator must take the legacy path"
        engine = actor.engine
        assert isinstance(engine, SimulatorIndex)
        calls: list[int] = []
        inner = engine.search

        def counting_search(queries, k, partitions=None):
            calls.append(k)
            return inner(queries, k, partitions=partitions)

        engine.search = counting_search

        async def filtered_pks():
            resp = await client.post(
                "/api/v1/indexes/ks/idx/ann",
                json={"vector": [1.0] + [0.0] * (D - 1), "limit": LIMIT, "filter": bucket_filter(7)},
            )
            assert resp.status == 200, await resp.text()
            return (await resp.json())["primary_keys"]["pk"]

        # first contact walks the ladder: rungs 1, 4, 16 (3 engine searches)
        pks = await filtered_pks()
        assert pks == list(MATCHES), pks
        assert calls == [LIMIT * 1, LIMIT * 4, LIMIT * 16], calls

        # repeat filter: the learned rung (16) is the entry point
        calls.clear()
        pks = await filtered_pks()
        assert pks == list(MATCHES), pks
        assert calls == [LIMIT * 16], calls
    finally:
        await client.close()
        await service.stop()


async def test_legacy_ladder_exhausted_ends_on_the_exact_terminal():
    """A filter matching one row of 256, the row ranked 200th, exhausts the
    ladder at limit 2 (k 2, 8, 32, 128) and is answered by the terminal's
    exact pass (the simulator has no subset scan: the growing-k search of
    ``_finish_last``)."""
    labels = np.zeros(N, dtype=np.int64)
    labels[200] = 3
    service, client = await start(
        labelled_db(ranked_vectors(), labels), Config(monitor_indexes_interval=0.05, engine_kind="sim")
    )
    try:
        await wait_status(client, count=N)
        actor = service.indexes.get_vs(("ks", "idx")).actor
        resp = await client.post(
            "/api/v1/indexes/ks/idx/ann",
            json={"vector": [1.0] + [0.0] * (D - 1), "limit": 2, "filter": bucket_filter(3)},
        )
        assert resp.status == 200, await resp.text()
        assert (await resp.json())["primary_keys"]["pk"] == [200]
        assert actor._escalations == 4 and actor._exact_fallbacks == 1
        counters = await (await client.get("/api/internals/counters")).json()
        assert counters["vs_index_oversample_escalations"] == 4
        assert counters["vs_index_exact_host_fallbacks"] == 1
    finally:
        await client.close()
        await service.stop()


@pytest.mark.parametrize("engine_kind", ["sim", "auto"])
async def test_ann_many_answers_as_ann(engine_kind):
    """``ann_many`` (the owner's answer to a frontend's ann_batch) gives
    each query what ``ann`` gives it, on the legacy path and the pipelined
    one (the IVF engine)."""
    rng = np.random.default_rng(12)
    vecs = rng.normal(size=(64, 6)).astype(np.float32)
    db = FakeDb()
    db.add_table(FakeTable("ks", "tbl", ("pk",)))
    db.add_index(FakeIndex(
        metadata=make_vs_metadata(dimensions=6),
        scan=[vector_row((i,), vecs[i].tolist(), 100) for i in range(len(vecs))],
    ))
    service, client = await start(db, Config(monitor_indexes_interval=0.05, engine_kind=engine_kind))
    try:
        await wait_status(client, count=len(vecs))
        actor = service.indexes.get_vs(("ks", "idx")).actor
        assert actor._pipelined is (engine_kind == "auto")
        queries = vecs[:20] + 0.01 * rng.normal(size=(20, 6)).astype(np.float32)
        many = await actor.ann_many(queries, 5)
        one = [await actor.ann(q.tolist(), 5) for q in queries]
        assert len(many) == 20
        for m, o in zip(many, one):
            assert [pk.values() for pk, _ in m] == [pk.values() for pk, _ in o]
            np.testing.assert_allclose([d.value for _, d in m], [d.value for _, d in o], rtol=0, atol=1e-6)
        assert [m[0][0].values()[0] for m in many] == list(range(20))
    finally:
        await client.close()
        await service.stop()


# -- tests/test_actor_maintenance_concurrency.py ---------------------------


class SlowSliceEngine(SimulatorIndex):
    """Simulator engine + a maintain_pending API whose one pending slice
    blocks until the test releases it."""

    maintain_modify_safe = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.slice_release = threading.Event()
        self.slice_running = threading.Event()
        self.pending_kinds: list[str] = ["kmeans"]
        self.slices_run: list[str] = []

    def maintain_pending(self):
        return self.pending_kinds[0] if self.pending_kinds else None

    def maintain(self, budget=None):
        if not self.pending_kinds:
            return False
        kind = self.pending_kinds.pop(0)
        self.slices_run.append(kind)
        if kind == "kmeans":
            self.slice_running.set()
            assert self.slice_release.wait(20), "slice never released"
        return True


def _ops(table, slot, millis):
    return table.upsert(
        KEY,
        PrimaryKey.from_values((slot,)),
        (
            Timestamped(
                Timestamp.from_millis(millis),
                DbIndexedValue.vector(np.random.default_rng(slot).normal(size=8).tolist()),
            ),
        ),
    )


async def _serve(engine_cls):
    md = make_vs_metadata(dimensions=8)
    table = Table(md)
    actor = VsIndexActor(md, table, engine_kind="sim", device=CPU)
    actor.engine = engine_cls(8)
    actor._pipelined = hasattr(actor.engine, "search_begin")
    actor.start()
    return actor, table


async def test_modify_applies_during_concurrent_slice():
    actor, table = await _serve(SlowSliceEngine)
    eng = actor.engine
    try:
        actor.apply_operations(_ops(table, 0, 100))
        deadline = time.time() + 10
        while await actor.count() < 1:
            assert time.time() < deadline
            await asyncio.sleep(0.01)
        await asyncio.to_thread(eng.slice_running.wait, 10)
        assert eng.slice_running.is_set()
        # a modify arriving mid-slice must land without waiting for it
        actor.apply_operations(_ops(table, 1, 200))
        deadline = time.time() + 5
        try:
            while await actor.count() < 2:
                assert time.time() < deadline, "modify starved behind an in-flight build slice"
                await asyncio.sleep(0.01)
        finally:
            eng.slice_release.set()
        assert eng.slices_run == ["kmeans"]
    finally:
        eng.slice_release.set()
        await actor.stop()


async def test_start_dispatches_despite_queued_modifies_which_wait():
    """A due `start` dispatches while the modify queue is busy, and the
    modify application then waits for the slice."""

    class SlowStartEngine(SlowSliceEngine):
        def maintain(self, budget=None):
            if not self.pending_kinds:
                return False
            kind = self.pending_kinds.pop(0)
            self.slices_run.append(kind)
            if kind == "start":
                self.slice_running.set()
                assert self.slice_release.wait(20), "slice never released"
            return True

    actor, table = await _serve(SlowStartEngine)
    eng = actor.engine
    eng.pending_kinds = ["start"]
    try:
        await asyncio.to_thread(eng.slice_running.wait, 10)
        assert eng.slices_run == ["start"]
        actor.apply_operations(_ops(table, 0, 100))
        await asyncio.sleep(0.4)
        assert await actor.count() == 0, "modify applied during start"
        assert actor.backlog > 0
        eng.slice_release.set()
        deadline = time.time() + 10
        while await actor.count() < 1:
            assert time.time() < deadline
            await asyncio.sleep(0.01)
    finally:
        eng.slice_release.set()
        await actor.stop()


async def test_unsafe_engine_serializes_modifies():
    class UnsafeEngine(SlowSliceEngine):
        maintain_modify_safe = False

    actor, table = await _serve(UnsafeEngine)
    eng = actor.engine
    try:
        await asyncio.to_thread(eng.slice_running.wait, 10)
        assert eng.slice_running.is_set()
        actor.apply_operations(_ops(table, 0, 100))
        await asyncio.sleep(0.4)
        assert await actor.count() == 0, "unsafe engine applied mid-slice"
        eng.slice_release.set()
        deadline = time.time() + 10
        while await actor.count() < 1:
            assert time.time() < deadline
            await asyncio.sleep(0.01)
    finally:
        eng.slice_release.set()
        await actor.stop()


async def test_reenter_runs_exclusively_like_modify():
    """Post-swap `reenter` chunks run in the exclusive (drained-pipeline)
    slot, never beside a modify application."""

    class ReenterEngine(SlowSliceEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.pending_kinds = ["reenter"]

        def maintain(self, budget=None):
            if not self.pending_kinds:
                return False
            kind = self.pending_kinds.pop(0)
            self.slices_run.append(kind)
            if kind == "reenter":
                self.slice_running.set()
                assert self.slice_release.wait(20), "slice never released"
            return True

    actor, table = await _serve(ReenterEngine)
    eng = actor.engine
    try:
        actor.apply_operations(_ops(table, 0, 100))
        deadline = time.time() + 10
        while await actor.count() < 1:
            assert time.time() < deadline
            await asyncio.sleep(0.01)
        await asyncio.to_thread(eng.slice_running.wait, 10)
        assert eng.slice_running.is_set()
        actor.apply_operations(_ops(table, 1, 200))
        await asyncio.sleep(0.3)
        # the engine's count, not the actor's (which waits behind the slice)
        assert actor.engine.size == 1, "modify applied concurrently with a reenter slice"
        eng.slice_release.set()
        deadline = time.time() + 5
        while await actor.count() < 2:
            assert time.time() < deadline, "modify never applied after slice"
            await asyncio.sleep(0.01)
        assert eng.slices_run == ["reenter"]
    finally:
        eng.slice_release.set()
        await actor.stop()


# -- tests/test_validator_index_modify.py ----------------------------------


def _rows(n: int, seed: int):
    vecs = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return [vector_row((i,), vecs[i].tolist(), 100) for i in range(n)]


async def test_version_only_change_with_simulator_keeps_index():
    """alter_index_simulator: when only the version changed (same
    parameters), the running index is kept: no teardown, no rescan."""
    db = FakeDb()
    db.add_table(FakeTable("ks", "tbl", ("pk",)))
    md = make_vs_metadata(dimensions=3)
    db.add_index(FakeIndex(metadata=md, scan=_rows(10, 3)))
    service, client = await start(db, Config(monitor_indexes_interval=0.05, alter_index_simulator=True))
    try:
        await wait_status(client, count=10)
        entry_before = service.indexes.get_vs(KEY)

        bumped = make_vs_metadata(dimensions=3, version=IndexVersion(uuid.uuid1()))
        assert bumped.discard_version() == md.discard_version()
        # the new scan would yield 25 rows: it must not run
        db.add_index(FakeIndex(metadata=bumped, scan=_rows(25, 4)))

        for _ in range(10):  # several discovery ticks
            await asyncio.sleep(0.06)
        d = await wait_status(client, count=10)
        assert d["count"] == 10
        assert service.indexes.get_vs(KEY) is entry_before
    finally:
        await client.close()
        await service.stop()


# -- the host engines' settings --------------------------------------------


async def test_usearch_simulator_setting_serves(monkeypatch):
    """VECTOR_STORE_USEARCH_SIMULATOR gives every index the simulator with
    the configured delays; self-queries answer distance 0."""
    monkeypatch.setenv("VECTOR_STORE_USEARCH_SIMULATOR", "2ms:0ms:0ms")
    config = load_config()
    config.monitor_indexes_interval = 0.05
    assert config.usearch_simulator == "2ms:0ms:0ms"
    db = FakeDb()
    db.add_table(FakeTable("ks", "tbl", ("pk",)))
    db.add_index(FakeIndex(metadata=make_vs_metadata(dimensions=3), scan=_rows(20, 8)))
    service, client = await start(db, config)
    try:
        await wait_status(client, count=20)
        engine = service.indexes.get_vs(KEY).actor.engine
        assert isinstance(engine, SimulatorIndex) and engine.search_delay == pytest.approx(0.002)
        vecs = np.random.default_rng(8).normal(size=(20, 3)).astype(np.float32)
        resp = await client.post("/api/v1/indexes/ks/idx/ann", json={"vector": vecs[5].tolist(), "limit": 2})
        assert resp.status == 200, await resp.text()
        data = await resp.json()
        assert data["primary_keys"]["pk"][0] == 5 and abs(data["distances"][0]) <= 1e-6
    finally:
        await client.close()
        await service.stop()


def _mock_in_thread():
    """The mock OpenSearch server on a loop of its own thread (the engine's
    HTTP calls block the service's loop); returns (mock, url, stop)."""
    mock = MockOpenSearch()
    loop = asyncio.new_event_loop()
    ready = threading.Event()
    holder = {}

    def run():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(mock.app)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        holder["port"] = site._server.sockets[0].getsockname()[1]
        ready.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())
        loop.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert ready.wait(10)

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        assert not thread.is_alive()

    return mock, f"http://127.0.0.1:{holder['port']}", stop


async def test_opensearch_uri_setting_serves(monkeypatch):
    """VECTOR_STORE_OPENSEARCH_URI keeps the index in the (mock) OpenSearch
    cluster: rows are bulk-indexed there and searches answer from it."""
    mock, url, stop_mock = _mock_in_thread()
    try:
        monkeypatch.setenv("VECTOR_STORE_OPENSEARCH_URI", url)
        config = load_config()
        config.monitor_indexes_interval = 0.05
        db = FakeDb()
        db.add_table(FakeTable("ks", "tbl", ("pk",)))
        db.add_index(FakeIndex(metadata=make_vs_metadata(dimensions=3), scan=_rows(12, 9)))
        service, client = await start(db, config)
        try:
            await wait_status(client, count=12)
            assert isinstance(service.indexes.get_vs(KEY).actor.engine, OpenSearchIndex)
            assert len(mock.indices["ks-idx"]["docs"]) == 12
            vecs = np.random.default_rng(9).normal(size=(12, 3)).astype(np.float32)
            resp = await client.post("/api/v1/indexes/ks/idx/ann", json={"vector": vecs[4].tolist(), "limit": 3})
            assert resp.status == 200, await resp.text()
            data = await resp.json()
            assert data["primary_keys"]["pk"][0] == 4 and abs(data["distances"][0]) <= 1e-5
        finally:
            await client.close()
            await service.stop()
    finally:
        stop_mock()
