"""The bootstrapped heap kept out of the collector's full passes
(``vector_store_tpu_torch/utils/heap.py``), on the CPU through the
in-process service.

A bootstrap through the fake feed runs no full collection between the
scan's start and SERVING and leaves the index frozen, with the freezes in
``GET /api/internals/counters``; stopping the last service unfreezes, so a
stopped service's engine can be collected; nothing freezes once an index
serves, so a cycle alive across a second index's scan or an IVF swap is
collected while the service runs; a second service keeps the first's
frozen state until it stops too; and the answers are those of a service
that never freezes.
"""

import asyncio
import gc
import socket
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
aiohttp = pytest.importorskip("aiohttp")

import vector_store_tpu_torch.db.fake as fake  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex  # noqa: E402
from vector_store_tpu_torch.service.config import Config  # noqa: E402
from vector_store_tpu_torch.utils import heap  # noqa: E402

CPU = torch.device("cpu")
DIMS = 16


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def add_index(db, n: int, seed: int, index: str = "idx", table: str = "tbl") -> np.ndarray:
    """An index of ``n`` random rows in the fake feed; its rows."""
    vecs = np.random.default_rng(seed).normal(size=(n, DIMS)).astype(np.float32)
    db.add_table(fake.FakeTable("ks", table, ("pk",)))
    md = fake.make_vs_metadata(index=index, table=table, dimensions=DIMS)
    db.add_index(fake.FakeIndex(metadata=md, scan=lambda: (fake.vector_row((i,), vecs[i], 100) for i in range(n))))
    return vecs


async def served(n: int, seed: int = 5):
    """The port's service over ``n`` rows fed by the fake scan, once its
    actor has applied them all: (service, root URL, rows)."""
    from vector_store_tpu_torch.run import serve

    db = fake.FakeDb()
    vecs = add_index(db, n, seed)
    port = free_port()
    service = await serve(db, Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.05), device=CPU)
    await applied(service, n)
    return service, f"http://127.0.0.1:{port}", vecs


async def applied(service, n: int, index: str = "idx", timeout: float = 120.0) -> None:
    """Until the index is SERVING, its engine holds ``n`` rows and the
    scan's last freeze is made."""
    from vector_store_tpu_torch.service.node_state import IndexStatus

    deadline = time.monotonic() + timeout
    while True:
        entry = service.indexes.get_vs(("ks", index))
        if (entry is not None and entry.status is IndexStatus.SERVING
                and entry.actor.engine.size == n and not heap._scans):
            return
        assert time.monotonic() < deadline, "the bootstrap never settled"
        await asyncio.sleep(0.02)


def frozen(obj) -> bool:
    """``obj`` is in the permanent generation: tracked, and in none of the
    three the collector walks."""
    return gc.is_tracked(obj) and not any(o is obj for o in gc.get_objects())


async def answers(root: str, queries: np.ndarray) -> list:
    async with aiohttp.ClientSession() as http:
        out = []
        for q in queries:
            body = {"vector": [float(x) for x in q], "limit": 10}
            async with http.post(f"{root}/api/v1/indexes/ks/idx/ann", json=body) as resp:
                assert resp.status == 200, await resp.text()
                out.append(await resp.json())
        return out


async def test_bootstrap_runs_no_full_collection_and_stays_frozen():
    n = 50_000
    full = []

    def probe(phase, info):
        # a full collection while the scan is open and nothing serves
        if phase == "start" and info["generation"] == 2 and heap._scans and not heap._served:
            full.append(info)

    callbacks = list(gc.callbacks)
    gc.callbacks.append(probe)
    try:
        service, root, vecs = await served(n)
    finally:
        gc.callbacks.remove(probe)
    try:
        assert full == []
        assert gc.callbacks == callbacks  # the scan's hook went with the scan
        async with aiohttp.ClientSession() as http:
            async with http.get(f"{root}/api/internals/counters") as resp:
                counters = await resp.json()
        assert counters["host-gc-freezes"] > 0
        assert counters["host-gc-frozen-objects"] >= 5 * n
        assert gc.get_freeze_count() >= 5 * n
        table = service.indexes.get_vs(("ks", "idx")).actor.table
        assert frozen(table)
        got = await answers(root, vecs[:3])
        assert [a["primary_keys"]["pk"][0] for a in got] == [0, 1, 2]
    finally:
        await service.stop()


async def test_stop_unfreezes_and_frees_the_engine():
    before = gc.get_freeze_count()
    service, _, _ = await served(5_000)
    engine = weakref.ref(service.indexes.get_vs(("ks", "idx")).actor.engine)
    assert gc.get_freeze_count() > before
    await service.stop()
    del service
    # the interpreter may start with objects of its own frozen, which
    # ``gc.unfreeze()`` releases too
    assert gc.get_freeze_count() <= before
    gc.collect()
    assert engine() is None


class Cycle:
    """A tracked object in a reference cycle of its own."""

    def __init__(self) -> None:
        self.me = self


async def test_scan_added_while_serving_freezes_nothing():
    service, root, vecs = await served(3_000)
    try:
        freezes, callbacks = heap._freezes, list(gc.callbacks)
        cycle = Cycle()
        ref = weakref.ref(cycle)
        add_index(service.db, 20_000, seed=7, index="idx2", table="tbl2")
        await applied(service, 20_000, index="idx2")
        assert heap._freezes == freezes and gc.callbacks == callbacks
        assert not frozen(service.indexes.get_vs(("ks", "idx2")).actor.table)
        del cycle
        gc.collect()
        assert ref() is None  # not held frozen while the service runs
        got = await answers(root, vecs[:2])
        assert [a["primary_keys"]["pk"][0] for a in got] == [0, 1]
    finally:
        await service.stop()


def test_hook_goes_when_any_index_serves():
    service, a, b, fts = object(), object(), object(), object()
    heap.acquire(service)
    try:
        heap.scan_started(a)
        heap.scan_started(b)
        assert heap._on_gc in gc.callbacks
        heap.scan_finished(fts)  # an FTS index, say, finished first and serves
        assert heap._on_gc not in gc.callbacks
        cycle = Cycle()
        alive = weakref.ref(cycle)
        freezes = heap._freezes
        gc.collect(1)
        heap.scan_finished(a)
        heap.scan_applied(a)  # another index serves: no last freeze either
        assert heap._freezes == freezes and not frozen(cycle)
        del cycle
        gc.collect()
        assert alive() is None
    finally:
        heap.release(service)
    assert heap._on_gc not in gc.callbacks and not heap._scans and not heap._served


async def test_swap_leaves_no_reference_to_the_old_main_region():
    rng = np.random.default_rng(3)
    service, _, _ = await served(3_000)
    try:
        idx = IvfDeviceIndex(
            DIMS, space_type=SpaceType.EUCLIDEAN, quantization=Quantization.F32, device=CPU,
            initial_capacity=4096, min_build=1024, kmeans_block=1024, nprobe=16, kmeans_iters=4,
        )
        freezes = heap._freezes
        cycle = Cycle()
        alive = weakref.ref(cycle)
        idx.upsert_batch(np.arange(4096), np.full(4096, 5, np.int32), rng.normal(size=(4096, DIMS)).astype(np.float32))
        idx.maintain()  # the first build's swap
        old = [weakref.ref(t) for t in (idx.main_vecs, idx.main_a, idx.main_b, idx.main_pos2slot, idx.centroids)]
        idx.upsert_batch(np.arange(4096, 8192), np.full(4096, 5, np.int32),
                         rng.normal(size=(4096, DIMS)).astype(np.float32))
        assert idx.maintain()
        assert heap._freezes == freezes and not frozen(idx.main_vecs)
        del cycle
        gc.collect()
        assert [r() for r in old] == [None] * len(old)
        assert alive() is None
        res = idx.search(rng.normal(size=(4, DIMS)).astype(np.float32), 5)
        assert all(r.slots.size == 5 for r in res)
    finally:
        await service.stop()


async def test_second_service_keeps_the_frozen_state_until_it_stops():
    before = gc.get_freeze_count()
    first, _, _ = await served(3_000, seed=1)
    freezes = heap._freezes
    table = first.indexes.get_vs(("ks", "idx")).actor.table
    engine = weakref.ref(first.indexes.get_vs(("ks", "idx")).actor.engine)
    second, root, vecs = await served(3_000, seed=2)
    assert heap._freezes == freezes  # the first service serves
    await first.stop()
    del first
    assert frozen(table) and heap._froze
    got = await answers(root, vecs[:2])
    assert [a["primary_keys"]["pk"][0] for a in got] == [0, 1]
    await second.stop()
    assert not heap._froze and gc.get_freeze_count() <= before
    assert not frozen(table)
    del table
    gc.collect()
    assert engine() is None


async def test_answers_match_a_service_that_never_freezes(monkeypatch):
    n = 20_000
    queries = np.random.default_rng(9).normal(size=(16, DIMS)).astype(np.float32)
    service, root, _ = await served(n)
    try:
        assert heap._freezes > 0 and heap._froze
        engaged = await answers(root, queries)
    finally:
        await service.stop()
    # the service as it was before freezing: no service ever registers
    monkeypatch.setattr(heap, "acquire", lambda token: None)
    freezes = heap._freezes
    service, root, _ = await served(n)
    try:
        assert heap._freezes == freezes and not heap._froze
        plain = await answers(root, queries)
    finally:
        await service.stop()
    assert engaged == plain
