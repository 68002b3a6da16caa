"""Twins of the reference's wire fault suites: auth, timeouts and reconnect
(tests/test_validator_auth.py, test_validator_timeouts.py,
test_reconnect.py). Each case runs on the JAX package and on the port:
its CqlSession, ScyllaDb, CdcReaderPair and fake CQL server, and, where the
reference case serves, its service (the port's run.build_service on
torch.device("cpu")) (tests/torch_wire_twins.py).

| reference case | port test |
|---|---|
| auth::test_no_credentials_stays_connecting | test_no_credentials_stays_connecting |
| auth::test_wrong_credentials_stays_connecting | test_wrong_credentials_stays_connecting |
| auth::test_granted_credentials_serves | test_granted_credentials_serves |
| timeouts::test_stalled_startup_times_out_then_recovers | test_stalled_startup_times_out_then_recovers |
| timeouts::test_stalled_query_times_out_without_blocking_other_streams | test_stalled_query_times_out_without_blocking_other_streams |
| timeouts::test_stalled_scan_retries_after_timeout | test_stalled_scan_retries_after_timeout |
| reconnect::TestSessionReconnect::test_drop_all_then_resume | test_drop_all_then_resume |
| reconnect::TestSessionReconnect::test_refused_connections_retry_until_accepted | test_refused_connections_retry_until_accepted |
| reconnect::TestSessionReconnect::test_prepared_statements_survive_reconnect | test_prepared_statements_survive_reconnect |
| reconnect::TestScanRetry::test_mid_scan_failure_retries_and_completes | test_mid_scan_failure_retries_and_completes |
| reconnect::TestCdcRecovery::test_cdc_errors_then_resume | test_cdc_errors_then_resume |
| reconnect::TestHighAvailability::test_two_replicas_one_dies | test_two_replicas_one_dies |

These cases depend on timing, so the twins compare outcomes, not times:
the node status sequence, connection and failure outcomes, the rows
delivered, final counts and progress, and the answers after recovery are
equal on both sides (torch_service_twins.assert_same: keys, statuses and
texts exactly, distances within 1e-6 * (1 + |x|)). Every twin is bounded
by 60 s; the reconnect interval is 0.05 s on both sides, as the
reference's fixture sets it.
"""

import asyncio
import math
import struct
import time

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("aiohttp")

from aiohttp.test_utils import TestServer  # noqa: E402

from torch_service_twins import assert_same  # noqa: E402
from torch_wire_twins import JAX, PORT, WireService, post_json, schema_handler, twin  # noqa: E402

ROWS = [(i, [math.cos(i), math.sin(i), 0.0], 1_000_000) for i in range(5)]
CREDS = ("cassandra", "sekrit")


@pytest.fixture(autouse=True)
def fast_reconnect(monkeypatch):
    for side in (JAX, PORT):
        monkeypatch.setattr(side.session_mod, "RECONNECT_INTERVAL", 0.05)


async def until(cond, timeout: float = 10.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline
        await asyncio.sleep(0.05)


# -- auth ---------------------------------------------------------------------------


async def test_no_credentials_stays_connecting():
    async def case(side):
        async with WireService(side, schema_handler(side, rows=ROWS), require_auth=CREDS) as ws:
            await until(lambda: ws.session.connect_failures >= 2)
            status = ws.service.node_state.get_status().name
            return {"status": status, "http": await (await ws.http.get("/api/v1/status")).json()}

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == {"status": "CONNECTING_TO_DB", "http": "CONNECTING_TO_DB"}


async def test_wrong_credentials_stays_connecting():
    async def case(side):
        handler = schema_handler(side, rows=ROWS)
        async with WireService(side, handler, require_auth=CREDS, username="cassandra", password="wrong") as ws:
            await until(lambda: ws.session.connect_failures >= 2)
            return ws.service.node_state.get_status().name

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == "CONNECTING_TO_DB"


async def test_granted_credentials_serves():
    async def case(side):
        handler = schema_handler(side, rows=ROWS)
        async with WireService(side, handler, require_auth=CREDS, username=CREDS[0], password=CREDS[1]) as ws:
            await ws.wait_serving()
            await ws.wait_index_count(("ks", "idx"), 5)
            return await post_json(ws.http, "/api/v1/indexes/ks/idx/ann", {"vector": ROWS[3][1], "limit": 1})

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port[0] == 200 and port[1]["primary_keys"]["pk"] == [3]


# -- timeouts -----------------------------------------------------------------------


async def test_stalled_startup_times_out_then_recovers():
    def cfg(server):
        server.stall_startup = True

    async def case(side):
        handler = schema_handler(side, rows=ROWS)
        async with WireService(side, handler, configure_server=cfg, connect_timeout=0.5) as ws:
            await until(lambda: ws.session.connect_failures >= 2, 15)
            stalled = ws.service.node_state.get_status().name
            ws.server.stall_startup = False
            await ws.wait_serving()
            await ws.wait_index_count(("ks", "idx"), 5)
            return {"stalled": stalled, "recovered": ws.service.node_state.get_status().name,
                    "count": await ws.service.indexes.get_vs(("ks", "idx")).actor.count()}

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == {"stalled": "CONNECTING_TO_DB", "recovered": "SERVING", "count": 5}


async def test_stalled_query_times_out_without_blocking_other_streams():
    async def case(side):
        t, ct = side.testing, side.ct

        def handler(cql, values, paging):
            return t.CannedResult(columns=[t.FakeColumn("key", ct.T_VARCHAR)], rows=[("local",)])

        server = t.FakeCqlServer(handler)
        server.stall_predicate = lambda cql: "SLOW" in cql
        await server.start()
        session = side.session_mod.CqlSession(f"127.0.0.1:{server.port}", request_timeout=0.5)
        session.start()
        try:
            slow = asyncio.ensure_future(session.query("SELECT SLOW FROM t"))
            fast = (await asyncio.wait_for(session.query("SELECT key FROM system.local"), 5)).one()
            try:
                await slow
                error = None
            except side.mod("db.cql.connection").CqlError as e:
                error = e.message
            after = (await asyncio.wait_for(session.query("SELECT key FROM system.local"), 5)).one()
            return {"fast": list(fast), "error": error, "after": list(after)}
        finally:
            await session.stop()
            await server.stop()

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["fast"] == ["local"] and port["after"] == ["local"] and "timed out" in port["error"]


async def test_stalled_scan_retries_after_timeout():
    async def case(side):
        state = {"stalls": 1}

        def cfg(server):
            def stall(cql):
                if "BYPASS CACHE" in cql and state["stalls"] > 0:
                    state["stalls"] -= 1
                    return True
                return False

            server.stall_predicate = stall

        handler = schema_handler(side, rows=ROWS)
        async with WireService(side, handler, configure_server=cfg, request_timeout=0.5) as ws:
            await ws.wait_serving(timeout=30)
            await ws.wait_index_count(("ks", "idx"), 5)
            return {"stalls_left": state["stalls"],
                    "count": await ws.service.indexes.get_vs(("ks", "idx")).actor.count()}

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == {"stalls_left": 0, "count": 5}


# -- reconnect ----------------------------------------------------------------------


def ping_handler(side):
    t, ct = side.testing, side.ct

    def handler(cql, values, paging):
        if "system.local" in cql:
            return t.CannedResult(columns=[t.FakeColumn("key", ct.T_VARCHAR)], rows=[("local",)])
        return None

    return handler


async def test_drop_all_then_resume():
    async def case(side):
        server = side.testing.FakeCqlServer(ping_handler(side))
        await server.start()
        session = side.session_mod.CqlSession(f"127.0.0.1:{server.port}")
        session.start()
        try:
            first = (await session.query("SELECT key FROM system.local")).one()
            reconnects = session.reconnects
            server.drop_all_connections()
            await until(lambda: session.reconnects > reconnects)
            second = (await session.query("SELECT key FROM system.local")).one()
            return [list(first), list(second)]
        finally:
            await session.stop()
            await server.stop()

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == [["local"], ["local"]]


async def test_refused_connections_retry_until_accepted():
    async def case(side):
        server = side.testing.FakeCqlServer(ping_handler(side))
        server.refuse_connections = True
        await server.start()
        session = side.session_mod.CqlSession(f"127.0.0.1:{server.port}")
        session.start()
        try:
            await until(lambda: session.connect_failures >= 2)
            connected = session.is_connected
            server.refuse_connections = False
            rs = await asyncio.wait_for(session.query("SELECT key FROM system.local"), 10)
            return {"connected_while_refused": connected, "after": list(rs.one())}
        finally:
            await session.stop()
            await server.stop()

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == {"connected_while_refused": False, "after": ["local"]}


async def test_prepared_statements_survive_reconnect():
    async def case(side):
        server = side.testing.FakeCqlServer(ping_handler(side))
        await server.start()
        session = side.session_mod.CqlSession(f"127.0.0.1:{server.port}")
        session.start()
        try:
            first = (await session.execute_prepared("SELECT key FROM system.local")).one()
            server.drop_all_connections()
            await asyncio.sleep(0.2)
            second = (await asyncio.wait_for(session.execute_prepared("SELECT key FROM system.local"), 10)).one()
            return [list(first), list(second)]
        finally:
            await session.stop()
            await server.stop()

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == [["local"], ["local"]]


async def test_mid_scan_failure_retries_and_completes():
    async def case(side):
        t, ct = side.testing, side.ct
        md = side.fake.make_vs_metadata(dimensions=2)
        fail_remaining = [2]
        scan_cols = [t.FakeColumn("pk", ct.T_INT), t.FakeColumn("emb", ct.T_VECTOR, vector_dim=2),
                     t.FakeColumn("wt", ct.T_BIGINT)]

        def handler(cql, values, paging):
            if "system.local" in cql and "tokens" in cql:
                return t.CannedResult(columns=[t.FakeColumn("tokens", ct.T_SET, sub_type_id=ct.T_VARCHAR)],
                                      rows=[(["0"],)])
            if "system.peers" in cql and "tokens" in cql:
                return t.CannedResult(columns=[t.FakeColumn("tokens", ct.T_SET, sub_type_id=ct.T_VARCHAR)], rows=[])
            if "BYPASS CACHE" in cql:
                if struct.unpack("!q", values[0])[0] <= 0:
                    if fail_remaining[0] > 0:
                        fail_remaining[0] -= 1
                        raise RuntimeError("simulated range failure")
                    return t.CannedResult(columns=scan_cols, rows=[(3, [0.5, 0.5], 1_000_000)])
                return t.CannedResult(columns=scan_cols, rows=[])
            if "_scylla_cdc_log" in cql or "cdc_generation" in cql:
                return t.CannedResult(columns=[t.FakeColumn("cdc$time", ct.T_TIMEUUID)], rows=[])
            return None

        server = t.FakeCqlServer(handler)
        await server.start()
        session = side.session_mod.CqlSession(f"127.0.0.1:{server.port}")
        session.start()
        dbi = side.scylla.ScyllaDb(session).get_db_index(md)
        finished = asyncio.Event()
        try:
            dbi.start(lambda: None, finished.set)
            row, marker = await asyncio.wait_for(dbi.feed.get(), 15)
            failures_left = fail_remaining[0]
            marker.complete()
            await asyncio.wait_for(finished.wait(), 10)
            return {"pk": list(row.primary_key.values()), "failures_left": failures_left,
                    "progress": dbi.full_scan_progress().percentage}
        finally:
            await dbi.stop()
            await session.stop()
            await server.stop()

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == {"pk": [3], "failures_left": 0, "progress": 100.0}


async def test_cdc_errors_then_resume():
    async def case(side):
        t, ct, scylla = side.testing, side.ct, side.scylla
        md = side.fake.make_vs_metadata(dimensions=2, primary_key_columns=("pk",))
        stamp = scylla._min_timeuuid(time.time() - 1.0)
        fail_remaining = [2]

        def handler(cql, values, paging):
            if "_scylla_cdc_log" in cql:
                if fail_remaining[0] > 0:
                    fail_remaining[0] -= 1
                    raise RuntimeError("simulated cdc failure")
                return t.CannedResult(
                    columns=[t.FakeColumn("cdc$time", ct.T_TIMEUUID), t.FakeColumn("cdc$operation", ct.T_TINYINT),
                             t.FakeColumn("pk", ct.T_INT)],
                    rows=[(stamp, scylla.CDC_OP_INSERT, 11)],
                )
            if "SELECT" in cql and "tbl" in cql:
                return t.CannedResult(
                    columns=[t.FakeColumn("emb", ct.T_VECTOR, vector_dim=2), t.FakeColumn("wt", ct.T_BIGINT)],
                    rows=[([1.0, 1.0], 1_000_000)],
                )
            return None

        server = t.FakeCqlServer(handler)
        await server.start()
        session = side.session_mod.CqlSession(f"127.0.0.1:{server.port}")
        session.start()
        db = scylla.ScyllaDb(session, cdc_fine_safety_interval=0.0, cdc_fine_sleep_interval=0.05)
        feed: asyncio.Queue = asyncio.Queue()
        pair = scylla.CdcReaderPair(db, md, feed)
        task = asyncio.get_running_loop().create_task(pair._reader("fine", 0.0, 0.05))
        try:
            row, _ = await asyncio.wait_for(feed.get(), 20)
            values = [[float(x) for x in v.value.value] for v in row.operation.values]
            return {"pk": list(row.primary_key.values()), "failures_left": fail_remaining[0], "vector": values}
        finally:
            pair._stopped = True
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
            await session.stop()
            await server.stop()

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == {"pk": [11], "failures_left": 0, "vector": [[1.0, 1.0]]}


async def test_two_replicas_one_dies():
    vecs = np.random.default_rng(3).normal(size=(20, 4)).astype(np.float32)

    async def case(side):
        f = side.fake

        async def make_replica():
            db = f.FakeDb()
            db.add_table(f.FakeTable("ks", "tbl", ("pk",)))
            rows = [f.vector_row((i,), vecs[i].tolist(), 100) for i in range(20)]
            db.add_index(f.FakeIndex(metadata=f.make_vs_metadata(dimensions=4), scan=rows))
            service = await side.build(db)
            server = TestServer(service.app)
            await server.start_server()
            return service, server

        s1, h1 = await make_replica()
        s2, h2 = await make_replica()
        try:
            serving = side.node_state.IndexStatus.SERVING
            for svc in (s1, s2):
                deadline = time.time() + 15
                while svc.node_state.get_status() is not side.node_state.NodeStatus.SERVING:
                    assert time.time() < deadline
                    await asyncio.sleep(0.05)
                entry = svc.indexes.get_vs(("ks", "idx"))
                while entry.status is not serving or await entry.actor.count() < 20:
                    assert time.time() < deadline
                    svc.engine.update_entries()
                    await asyncio.sleep(0.05)
            urls = [f"http://127.0.0.1:{h1.port}", f"http://127.0.0.1:{h2.port}"]

            async def failover_ann(vector, limit):
                last = None
                for url in urls:
                    try:
                        async with side.vector_client(url) as c:
                            res = await c.ann("ks", "idx", vector, limit=limit)
                            return {"pk": res.primary_keys["pk"], "distances": list(res.distances)}
                    except Exception as e:
                        last = e
                raise last

            both = await failover_ann(vecs[5].tolist(), 2)
            await h1.close()
            await s1.stop()
            survivor = await failover_ann(vecs[5].tolist(), 2)
            return {"both": both, "survivor": survivor}
        finally:
            await h2.close()
            await s2.stop()

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["both"]["pk"][0] == 5 and port["survivor"]["pk"][0] == 5
