"""The port's program spans (``vector_store_tpu_torch/utils/spans.py``) on
the CPU, through the in-process service where a request is needed. Spans
are read where the program keeps them: hotpath's registry.

Off, nothing is recorded and nothing is installed. On, one ANN request
adds one ``http.parse``, ``actor.queue_wait``, ``actor.wake`` and
``http.encode``, inside the client's round trip; a filtered request that
climbs the post-filter ladder waits once a pass; a window's waits are
added once, from its start; the IVF engine's ``search_collect`` holds
``ivf.pull``; a built I8 engine's search adds ``ivf.queries``,
``ivf.delta_begin`` and ``ivf.rescore`` once each, and
``ivf.rescore_numpy`` only where the native rescore gives nothing; a
collection gives ``host.gc.gen<n>``, even one that starts inside
hotpath's lock; an idle loop gives ``loop.select``; threads
recording at once lose no span; ``start()`` and ``stop()`` are
idempotent; the hooks follow hotpath's switch (at the next ANN request,
or when a service is built while it is on); a malformed body is still
refused; spans reach ``GET /api/internals/hotpath``.
"""

import asyncio
import gc
import json
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
aiohttp = pytest.importorskip("aiohttp")

import vector_store_tpu_torch.db.fake as fake  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex  # noqa: E402
from vector_store_tpu_torch.service.config import Config  # noqa: E402
from vector_store_tpu_torch.utils import hotpath, spans  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
N, DIMS = 100, 3
REQUEST_SPANS = ("http.parse", "actor.queue_wait", "actor.wake", "http.encode")


@pytest.fixture
def rec():
    """Recording off before and after each test."""
    spans.stop()
    yield
    spans.stop()


def settled() -> dict:
    """``hotpath.stats()`` once spans kept aside (closed while its lock was
    held) are added: any span added adds them first."""
    spans.add("test.settle", 1, 0)
    return hotpath.stats()


def added(before: dict, after: dict, name: str) -> tuple[int, float]:
    """Calls and total ms that ``name`` gained between two readings."""
    b = before.get(name, {"calls": 0, "total_ms": 0.0})
    a = after.get(name, {"calls": 0, "total_ms": 0.0})
    return a["calls"] - b["calls"], a["total_ms"] - b["total_ms"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def served(labels=None):
    """The port's service on the CPU over N seeded rows (a ``bucket``
    filtering column where ``labels`` are given), once SERVING."""
    from vector_store_tpu_torch.run import serve

    vecs = np.random.default_rng(5).normal(size=(N, DIMS)).astype(np.float32)
    db = fake.FakeDb()
    if labels is None:
        db.add_table(fake.FakeTable("ks", "tbl", ("pk",)))
        rows = [fake.vector_row((i,), vecs[i].tolist(), 100) for i in range(N)]
        md = fake.make_vs_metadata(dimensions=DIMS)
    else:
        db.add_table(fake.FakeTable("ks", "tbl", ("pk",), columns={"bucket": "int"}))
        rows = [fake.vector_row((i,), vecs[i].tolist(), 100, filtering=[(100, int(labels[i]))]) for i in range(N)]
        md = fake.make_vs_metadata(dimensions=DIMS, filtering_columns=("bucket",))
    db.add_index(fake.FakeIndex(metadata=md, scan=rows))
    port = free_port()
    service = await serve(db, Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.05),
                          device=torch.device("cpu"))
    root = f"http://127.0.0.1:{port}"
    async with aiohttp.ClientSession() as http:
        deadline = time.monotonic() + 30
        while True:
            async with http.get(f"{root}/api/v1/indexes/ks/idx/status") as resp:
                body = await resp.json() if resp.status == 200 else {}
            if body.get("status") == "SERVING" and body.get("count") == N:
                break
            assert time.monotonic() < deadline, "the index never reached SERVING"
            await asyncio.sleep(0.05)
    return service, root, vecs


async def ann(root, vector, limit=3, filter_=None, http=None):
    body = {"vector": [float(x) for x in vector], "limit": limit}
    if filter_ is not None:
        body["filter"] = filter_
    if http is None:
        async with aiohttp.ClientSession() as http:
            return await ann(root, vector, limit, filter_, http)
    async with http.post(f"{root}/api/v1/indexes/ks/idx/ann", json=body) as resp:
        assert resp.status == 200, await resp.text()
        return await resp.json()


async def test_off_records_and_installs_nothing(rec):
    callbacks = list(gc.callbacks)
    selector = asyncio.get_running_loop()._selector
    service, root, vecs = await served()
    try:
        before = hotpath.stats()
        got = await ann(root, vecs[7])
        assert got["primary_keys"]["pk"][0] == 7
        spans.record("test.off", 0, 1)
        with spans.span("test.off"):
            pass
        assert hotpath.stats() == before
    finally:
        await service.stop()
    assert gc.callbacks == callbacks and "select" not in selector.__dict__
    assert spans.span("http.parse") is spans.span("ivf.pull")  # the one shared no-op
    assert spans.now() == 0


async def test_one_request_adds_each_span_once(rec):
    service, root, vecs = await served()
    try:
        async with aiohttp.ClientSession() as http:
            await ann(root, vecs[10], http=http)  # the connection, outside the round trip
            spans.start()
            before = settled()
            t0 = time.perf_counter_ns()
            await ann(root, vecs[11], http=http)
            t1 = time.perf_counter_ns()
            after = settled()
            spans.stop()
    finally:
        await service.stop()
    got = {n: added(before, after, n) for n in REQUEST_SPANS}
    assert all(calls == 1 and ms >= 0 for calls, ms in got.values()), got
    # parse, the wait, the wake and the encode follow one another inside
    # the client's round trip
    assert sum(ms for _, ms in got.values()) <= (t1 - t0) / 1e6


async def test_filtered_request_waits_once_a_pass(rec):
    """A filter matching 10% of the rows climbs the post-filter ladder: each
    requeue is one more wait for a window, and the answer wakes it once."""
    labels = np.arange(N) % 10 == 0
    service, root, vecs = await served(labels)
    actor = service.indexes.get_vs(("ks", "idx")).actor
    try:
        spans.start()
        before = settled()
        climbed = actor._escalations
        got = await ann(root, vecs[20] + 0.01, 5, {
            "restrictions": [{"type": "==", "lhs": "bucket", "rhs": 1}], "allow_filtering": True})
        climbed = actor._escalations - climbed
        after = settled()
        spans.stop()
    finally:
        await service.stop()
    assert all(pk % 10 == 0 for pk in got["primary_keys"]["pk"])
    assert climbed >= 1 and added(before, after, "actor.queue_wait")[0] == 1 + climbed
    assert added(before, after, "actor.wake")[0] == 1


def test_window_waits_added_once_from_its_start(rec):
    """A window's requests add their waits to its start in one go; a request
    stamped while not recording (0) and a window begun while not recording
    add nothing."""
    from vector_store_tpu_torch.service.vs_index import _record_queue_waits, _stamped

    reqs = [SimpleNamespace(t_submit=t) for t in (100, 0, 250, 400)]
    hotpath.enable()
    before = settled()
    _record_queue_waits([reqs[:2], reqs[2:]], 1_000)
    _record_queue_waits([reqs], 0)
    after = settled()
    hotpath.disable()
    calls, ms = added(before, after, "actor.queue_wait")
    assert calls == 3 and ms == pytest.approx((900 + 750 + 600) / 1e6)
    assert _stamped(len, [1, 2]) == (0, 2)  # off: no stamp
    hotpath.enable()
    t0 = time.perf_counter_ns()
    t, n = _stamped(len, [1, 2])
    hotpath.disable()
    assert n == 2 and t0 <= t <= time.perf_counter_ns()


def test_ivf_pull_inside_search_collect(rec):
    rng = np.random.default_rng(3)
    d, n = 8, 256
    idx = IvfDeviceIndex(d, space_type=SpaceType.EUCLIDEAN, quantization=Quantization.F32,
                         device=torch.device("cpu"), initial_capacity=512)
    idx.upsert_batch(np.arange(n), np.full(n, 5, np.int32), rng.normal(size=(n, d)).astype(np.float32))
    pending = idx.search_begin(rng.normal(size=(4, d)).astype(np.float32), 5)
    hotpath.enable()
    before = settled()
    t0 = time.perf_counter_ns()
    results = idx.search_collect(pending)
    t1 = time.perf_counter_ns()
    after = settled()
    hotpath.disable()
    assert len(results) == 4
    calls, ms = added(before, after, "ivf.pull")
    _, collect_ms = added(before, after, "ivf.IvfDeviceIndex.search_collect")
    assert calls == 1 and 0 <= ms <= collect_ms <= (t1 - t0) / 1e6


I8_SPANS = ("ivf.queries", "ivf.delta_begin", "ivf.rescore")


def built_i8(monkeypatch, n=1024, extra=64, d=64):
    """A cosine I8 IVF engine whose main region is built over n rows, with
    ``extra`` rows written after the build in its lossy delta."""
    import vector_store_tpu_torch.engine.ivf as ivf

    monkeypatch.setattr(ivf, "DELTA_MARGIN", 4096)  # the CPU scans the delta's whole capacity
    rng = np.random.default_rng(4)
    idx = IvfDeviceIndex(d, space_type=SpaceType.COSINE, quantization=Quantization.I8,
                         device=torch.device("cpu"), min_build=n, initial_capacity=2048)
    idx.upsert_batch(np.arange(n), np.ones(n, np.int32), rng.normal(size=(n, d)).astype(np.float32))
    assert idx.maintain() and idx.main_vecs is not None
    idx.upsert_batch(np.arange(n, n + extra), np.ones(extra, np.int32),
                     rng.normal(size=(extra, d)).astype(np.float32))
    return idx, rng.normal(size=(8, d)).astype(np.float32)


def test_i8_ivf_window_records_its_spans_once(rec, monkeypatch):
    """One search of a built I8 engine (a window's ``search_begin`` and
    ``search_collect``) adds ``ivf.queries``, ``ivf.delta_begin`` and
    ``ivf.rescore`` once each while recording, each inside the call that
    holds it, and nothing while off."""
    idx, queries = built_i8(monkeypatch)
    before = settled()
    assert len(idx.search(queries, 5)) == 8
    off = settled()
    hotpath.enable()
    pending = idx.search_begin(queries, 5)
    assert len(idx.search_collect(pending)) == 8
    after = settled()
    hotpath.disable()
    for name in I8_SPANS:
        assert added(before, off, name) == (0, 0.0), name
    _, begin_ms = added(off, after, "ivf.IvfDeviceIndex.search_begin")
    _, collect_ms = added(off, after, "ivf.IvfDeviceIndex.search_collect")
    got = {name: added(off, after, name) for name in I8_SPANS}
    assert all(calls == 1 for calls, _ in got.values()), got
    assert got["ivf.queries"][1] + got["ivf.delta_begin"][1] <= begin_ms
    assert got["ivf.rescore"][1] <= collect_ms
    assert added(off, after, "ivf.rescore_numpy") == (0, 0.0)


@pytest.mark.parametrize("native", [True, False])
def test_rescore_numpy_only_without_native(rec, monkeypatch, native):
    """``ivf.rescore_numpy`` marks the NumPy gather, taken only where
    ``native_rescore`` gives nothing; the distances agree either way."""
    import vector_store_tpu_torch.engine.rescore as rescore

    idx, queries = built_i8(monkeypatch)
    want = [r.distances for r in idx.search(queries, 5)]
    if native:
        def stub(vecs, ids, q, space):  # a native result, as the library gives it
            v = vecs[np.maximum(ids, 0)]
            return (0.5 * ((q[:, None, :] - v) ** 2).sum(-1)).astype(np.float32)
    else:
        def stub(vecs, ids, q, space):
            return None
    monkeypatch.setattr(rescore, "native_rescore", stub)
    before = settled()
    hotpath.enable()
    got = idx.search(queries, 5)
    after = settled()
    hotpath.disable()
    assert added(before, after, "ivf.rescore_numpy")[0] == (0 if native else 1)
    assert added(before, after, "ivf.rescore")[0] == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.distances, w, atol=1e-5)


def test_collection_records_host_gc(rec):
    spans.start()
    before = settled()
    gc.collect()
    # a collection that starts while hotpath's lock is held (in this thread)
    # is kept aside, never waited on, and added by the next span
    with hotpath._LOCK:
        gc.collect(1)
    assert added(before, hotpath.stats(), "host.gc.gen2")[0] >= 1
    assert added(before, hotpath.stats(), "host.gc.gen1")[0] == 0
    assert added(before, settled(), "host.gc.gen1")[0] >= 1


async def test_idle_loop_records_select(rec):
    spans.start()
    before = settled()
    await asyncio.sleep(0.05)
    after = settled()
    spans.stop()
    assert added(before, after, "loop.select")[1] >= 40


def test_record_adds_only_while_recording(rec):
    before = settled()
    hotpath.enable()
    for i in range(3):
        spans.record("test.rec", 10 * i, 10 * i + 5)
    with spans.span("test.block"):
        time.sleep(0.002)
    hotpath.disable()
    spans.record("test.rec", 0, 1000)
    with spans.span("test.block"):
        pass
    after = settled()
    assert added(before, after, "test.rec") == (3, pytest.approx(15 / 1e6))
    calls, ms = added(before, after, "test.block")
    assert calls == 1 and ms >= 2


def test_threads_lose_no_span(rec):
    """Threads recording at once, with collections among them (whose spans
    may be kept aside), lose no span from the registry."""
    import threading

    threads, each = 16, 1500
    before = settled()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    spans.start()
    try:
        def work(i):
            for j in range(each):
                with spans.span("test.stress"):
                    if j % 500 == i:
                        gc.collect(0)

        pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
        spans.stop()
    after = settled()
    assert added(before, after, "test.stress")[0] == threads * each
    assert sum(added(before, after, n)[0] for n in spans.GC_SPANS) >= threads


async def test_start_stop_idempotent(rec):
    callbacks = list(gc.callbacks)
    selector = asyncio.get_running_loop()._selector
    spans.start()
    wrapped = selector.__dict__["select"]
    spans.start()
    assert selector.__dict__["select"] is wrapped and len(gc.callbacks) == len(callbacks) + 1
    assert spans.recording()
    spans.stop()
    spans.stop()
    assert not spans.recording() and gc.callbacks == callbacks and "select" not in selector.__dict__


async def test_hooks_follow_hotpaths_switch(rec):
    """Switched through hotpath alone, the next ANN request installs the
    hooks and, once hotpath is off again, removes them."""
    callbacks = list(gc.callbacks)
    selector = asyncio.get_running_loop()._selector
    service, root, vecs = await served()
    try:
        before = settled()
        hotpath.enable()
        await ann(root, vecs[3])
        assert "select" in selector.__dict__ and len(gc.callbacks) == len(callbacks) + 1
        hotpath.disable()
        after = settled()
        await ann(root, vecs[4])
        assert "select" not in selector.__dict__ and gc.callbacks == callbacks
    finally:
        await service.stop()
    for name in REQUEST_SPANS + ("loop.select",):
        assert added(before, after, name)[0] >= 1, name


async def test_service_built_while_measuring_hooks_at_once(rec):
    """With hotpath on when the service is built (VECTOR_STORE_HOTPATH=1),
    the loop and the collector are hooked before any ANN request."""
    selector = asyncio.get_running_loop()._selector
    hotpath.enable()
    service, _, _ = await served()
    try:
        assert "select" in selector.__dict__
    finally:
        await service.stop()
    spans.stop()
    assert "select" not in selector.__dict__


async def test_malformed_body_refused_while_recording(rec):
    """The route reads the body before its parse span: a body that is no
    JSON is refused as before, recording or not."""
    service, root, _ = await served()
    try:
        async with aiohttp.ClientSession() as http:
            for on in (False, True):
                if on:
                    spans.start()
                before = settled()
                async with http.post(f"{root}/api/v1/indexes/ks/idx/ann", data=b"{not json") as resp:
                    assert (resp.status, await resp.text()) == (400, "malformed JSON body")
                assert added(before, settled(), "http.parse")[0] == int(on)
        spans.stop()
    finally:
        await service.stop()


async def test_spans_in_internals_hotpath(rec):
    service, root, vecs = await served()
    try:
        spans.start()
        await ann(root, vecs[1])
        async with aiohttp.ClientSession() as http:
            async with http.get(f"{root}/api/internals/hotpath") as resp:
                stats = json.loads(await resp.text())
        spans.stop()
    finally:
        await service.stop()
    for name in REQUEST_SPANS + ("loop.select", "ivf.IvfDeviceIndex.search_collect"):
        assert stats[name]["calls"] >= 1 and stats[name]["total_ms"] >= 0, name


def test_spans_load_no_torch():
    """Frontends of serve_scaled import no torch and no numpy: nor does
    this module."""
    code = ("import sys, vector_store_tpu_torch.utils.spans; "
            "print(sorted(m for m in ('torch', 'numpy') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
