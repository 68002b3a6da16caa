"""Twins of tests/test_integration_service.py: the whole service in process
over FakeDb (discovery, full scan, serving, ANN over HTTP, status and
info routes, metrics, FTS), each case run on the JAX service and on the
port's (run.build_service on torch.device("cpu"): run.py, http/routes.py,
http/server.py, http/openapi.py, http/swagger_ui.py, service/engine.py,
service/monitor_indexes.py, service/node_state.py, service/metrics.py,
service/internals.py, service/fts_index.py).

| reference case | port test |
|---|---|
| TestLifecycle::test_startup_to_serving | test_startup_to_serving |
| TestLifecycle::test_list_indexes | test_list_indexes |
| TestLifecycle::test_info_routes | test_info_routes |
| TestLifecycle::test_unknown_index_404 | test_unknown_index_404 |
| TestLifecycle::test_index_dropped | test_index_dropped |
| TestAnnSearch::test_ann_returns_nearest | test_ann_returns_nearest |
| TestAnnSearch::test_ann_wrong_dimensions_400 | test_ann_wrong_dimensions_400 |
| TestAnnSearch::test_ann_malformed_400 | test_ann_malformed_400 |
| TestAnnSearch::test_not_ready_503 | test_not_ready_503 |
| TestCdcUpdates::test_cdc_upsert_and_delete | test_cdc_upsert_and_delete |
| TestFilteredAnn::test_filtered_search | test_filtered_search |
| TestMetrics::test_metrics_exposed | test_metrics_exposed |
| TestMetrics::test_metrics_protobuf_negotiation | test_metrics_protobuf_negotiation |
| TestMetrics::test_swagger_ui_page | test_swagger_ui_page |
| TestMetrics::test_internals_counters | test_internals_counters |
| TestCoexistingIndexes::test_independent_indexes | test_independent_indexes |
| TestFtsIntegration::test_bm25_over_http | test_bm25_over_http |

Each twin runs the reference case's steps on both services, each over
its own package's FakeDb seeded with the same rows, and keeps the case's
assertions on the port's run. Tolerance: the two runs' statuses, primary
keys, counts, index listings and documents are equal; distances,
similarity and BM25 scores within 1e-6 * (1 + |x|), plus 1e-6 times the
rows' largest squared norm (below the IVF build the JAX engine reports its
delta's f32 device distances, the port the f32 host mirror's). Every twin
is bounded by 60 s (tests/torch_service_twins.py), the reference's own
waits inside it.
"""

import asyncio
import uuid

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("aiohttp")

from torch_service_twins import (  # noqa: E402
    assert_same,
    norm2,
    request,
    stop,
    twin,
    wait_for,
    wait_serving,
)


def simple_db(side, vecs, filtering=(), partitioning=None):
    db = side.fake.FakeDb()
    db.add_table(side.fake.FakeTable("ks", "tbl", ("pk",)))
    md = side.fake.make_vs_metadata(dimensions=vecs.shape[1], filtering_columns=filtering, partitioning=partitioning)
    rows = [side.fake.vector_row((i,), vecs[i].tolist(), 100) for i in range(len(vecs))]
    db.add_index(side.fake.FakeIndex(metadata=md, scan=rows))
    return db


def rows(n, dims, seed=11):
    return np.random.default_rng(seed).normal(size=(n, dims)).astype(np.float32)


# -- TestLifecycle -------------------------------------------------------------------


async def test_startup_to_serving():
    vecs = rows(50, 8)

    async def case(side):
        service, client = await side.start(simple_db(side, vecs))
        try:
            await wait_serving(client, "ks", "idx")
            status = await request(client, "GET", "/api/v1/status")
            # index adds apply asynchronously after SERVING: poll the count
            deadline = asyncio.get_event_loop().time() + 10
            while True:
                _, data = await request(client, "GET", "/api/v1/indexes/ks/idx/status")
                if data["count"] == 50:
                    break
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.05)
            return {"status": status, "index": data}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["status"] == (200, "SERVING")
    assert port["index"]["build_progress"] == 100.0


async def test_list_indexes():
    vecs = rows(50, 8)

    async def case(side):
        service, client = await side.start(simple_db(side, vecs))
        try:
            await wait_serving(client, "ks", "idx")
            return await request(client, "GET", "/api/v1/indexes")
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    status, data = port
    assert status == 200 and len(data) == 1
    assert data[0]["keyspace"] == "ks"
    assert data[0]["options"]["type"] == "vector"
    assert data[0]["options"]["dimensions"] == 8
    assert data[0]["options"]["maximum_node_connections"] == 16


async def test_info_routes():
    vecs = rows(50, 8)

    async def case(side):
        service, client = await side.start(simple_db(side, vecs))
        try:
            await wait_serving(client, "ks", "idx")
            _, info = await request(client, "GET", "/api/v1/info")
            index = await request(client, "GET", "/api/v1/indexes/ks/idx")
            _, doc = await request(client, "GET", "/api-docs/openapi.json")
            return {"service": info["service"], "index": index, "doc": doc}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)  # the whole OpenAPI document included
    assert port["service"] == "scylla-vector-store"
    assert port["index"][1]["options"]["similarity_function"] == "COSINE"
    assert port["doc"]["info"]["version"] == "3.0.0"
    assert "/api/v1/indexes/{keyspace}/{index}/ann" in port["doc"]["paths"]


async def test_unknown_index_404():
    vecs = rows(50, 8)

    async def case(side):
        service, client = await side.start(simple_db(side, vecs))
        try:
            return [
                await request(client, "GET", "/api/v1/indexes/ks/nope/status"),
                await request(client, "POST", "/api/v1/indexes/ks/nope/ann", json={"vector": [0.0] * 8}),
            ]
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert [status for status, _ in port] == [404, 404]


async def test_index_dropped():
    vecs = rows(50, 8)

    async def case(side):
        db = simple_db(side, vecs)
        service, client = await side.start(db)
        try:
            await wait_serving(client, "ks", "idx")
            db.drop_index(("ks", "idx"))
            await wait_for(lambda: service.indexes.get_vs(("ks", "idx")) is None)
            return await request(client, "GET", "/api/v1/indexes/ks/idx/status")
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port[0] == 404


# -- TestAnnSearch ---------------------------------------------------------------------


async def test_ann_returns_nearest():
    vecs = rows(40, 8)

    async def case(side):
        service, client = await side.start(simple_db(side, vecs))
        try:
            await wait_serving(client, "ks", "idx")
            return await request(
                client, "POST", "/api/v1/indexes/ks/idx/ann", json={"vector": vecs[7].tolist(), "limit": 3}
            )
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax, norm2(vecs))
    status, data = port
    assert status == 200
    assert data["primary_keys"]["pk"][0] == 7
    assert len(data["distances"]) == 3
    assert len(data["similarity_scores"]) == 3
    assert data["distances"][0] == pytest.approx(0.0, abs=1e-3)
    assert data["similarity_scores"][0] == pytest.approx(1.0, abs=1e-3)


async def test_ann_wrong_dimensions_400():
    vecs = rows(50, 8)

    async def case(side):
        service, client = await side.start(simple_db(side, vecs))
        try:
            await wait_serving(client, "ks", "idx")
            return await request(client, "POST", "/api/v1/indexes/ks/idx/ann", json={"vector": [0.0] * 5})
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port[0] == 400


async def test_ann_malformed_400():
    vecs = rows(50, 8)

    async def case(side):
        service, client = await side.start(simple_db(side, vecs))
        try:
            await wait_serving(client, "ks", "idx")
            return [
                await request(client, "POST", "/api/v1/indexes/ks/idx/ann", json={}),
                await request(
                    client, "POST", "/api/v1/indexes/ks/idx/ann", json={"vector": [0.0] * 8, "limit": 0}
                ),
            ]
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert [status for status, _ in port] == [400, 400]


async def test_not_ready_503():
    async def case(side):
        db = side.fake.FakeDb()
        db.add_table(side.fake.FakeTable("ks", "tbl", ("pk",)))
        md = side.fake.make_vs_metadata(dimensions=4)
        db.add_index(side.fake.FakeIndex(metadata=md, scan=[], pending=True))
        service, client = await side.start(db)
        try:
            await wait_for(lambda: service.indexes.get_vs(md.key) is not None)
            building = await request(client, "POST", "/api/v1/indexes/ks/idx/ann", json={"vector": [0.0] * 4})
            # release and serve
            db.release_scan(md.key)
            await wait_serving(client, "ks", "idx")
            served = await request(client, "POST", "/api/v1/indexes/ks/idx/ann", json={"vector": [0.0] * 4})
            return {"building": building, "served": served}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    status, reason = port["building"]
    assert status == 503
    assert reason["reason"] in ("NODE_BOOTSTRAPPING", "INDEX_BUILDING")
    assert port["served"][0] == 200


# -- TestCdcUpdates ----------------------------------------------------------------------


async def test_cdc_upsert_and_delete():
    vecs = rows(10, 4)
    far = [9.0, 9.0, 9.0, 9.0]

    async def case(side):
        db = simple_db(side, vecs)
        service, client = await side.start(db)
        try:
            await wait_serving(client, "ks", "idx")
            dbi = db.db_indexes[("ks", "idx")]
            # insert a new far-away vector via CDC
            await dbi.push_cdc(side.fake.vector_row((100,), far, 200))

            async def found():
                _, data = await request(client, "POST", "/api/v1/indexes/ks/idx/ann", json={"vector": far, "limit": 1})
                return data["primary_keys"]["pk"] == [100]

            deadline = asyncio.get_event_loop().time() + 10
            while not await found():
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.05)
            inserted = await request(client, "POST", "/api/v1/indexes/ks/idx/ann", json={"vector": far, "limit": 3})
            # delete it again
            await dbi.push_cdc(side.fake.delete_row((100,), 300))
            deadline = asyncio.get_event_loop().time() + 10
            while await found():
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.05)
            deleted = await request(client, "POST", "/api/v1/indexes/ks/idx/ann", json={"vector": far, "limit": 3})
            return {"inserted": inserted, "deleted": deleted}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax, norm2(np.vstack([vecs, far])))
    assert port["inserted"][1]["primary_keys"]["pk"][0] == 100
    assert 100 not in port["deleted"][1]["primary_keys"]["pk"]


# -- TestFilteredAnn ----------------------------------------------------------------------


async def test_filtered_search():
    dims = 4
    vecs = rows(20, dims, seed=12)

    async def case(side):
        rows_ = [side.fake.vector_row((i,), vecs[i].tolist(), 100, filtering=[(100, i % 2)]) for i in range(20)]
        db = side.fake.FakeDb()
        db.add_table(side.fake.FakeTable("ks", "tbl", ("pk",)))
        md = side.fake.make_vs_metadata(dimensions=dims, filtering_columns=("flag",))
        db.add_index(side.fake.FakeIndex(metadata=md, scan=rows_))
        service, client = await side.start(db)
        try:
            await wait_serving(client, "ks", "idx")
            flt = {"restrictions": [{"type": "==", "lhs": "flag", "rhs": 1}], "allow_filtering": True}
            allowed = await request(
                client, "POST", "/api/v1/indexes/ks/idx/ann",
                json={"vector": vecs[0].tolist(), "limit": 5, "filter": flt},
            )
            # without allow_filtering -> 400
            flt["allow_filtering"] = False
            refused = await request(
                client, "POST", "/api/v1/indexes/ks/idx/ann",
                json={"vector": vecs[0].tolist(), "limit": 5, "filter": flt},
            )
            return {"allowed": allowed, "refused": refused}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax, norm2(vecs))
    status, data = port["allowed"]
    assert status == 200
    assert all(pk % 2 == 1 for pk in data["primary_keys"]["pk"])
    assert port["refused"][0] == 400


# -- TestMetrics ----------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


async def test_metrics_exposed():
    vecs = rows(5, 4)

    async def case(side):
        service, client = await side.start(simple_db(side, vecs))
        try:
            await wait_serving(client, "ks", "idx")
            await client.post("/api/v1/indexes/ks/idx/ann", json={"vector": [0.0] * 4})
            resp = await client.get("/metrics")
            text = await resp.text()
            return {
                "status": resp.status,
                "latency": "request_latency_seconds_bucket" in text,
                "size": 'index_size{keyspace="ks",index_name="idx"} 5' in text,
                "modified": "index_modified" in text,
                "families": sorted(line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")),
            }
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["latency"] and port["size"] and port["modified"]


async def test_metrics_protobuf_negotiation():
    """Accept: application/vnd.google.protobuf -> varint-delimited
    MetricFamily stream (httproutes.rs:577-613)."""
    vecs = rows(5, 4)

    async def case(side):
        service, client = await side.start(simple_db(side, vecs))
        try:
            await wait_serving(client, "ks", "idx")
            await client.post("/api/v1/indexes/ks/idx/ann", json={"vector": [0.0] * 4})
            resp = await client.get(
                "/metrics",
                headers={
                    "Accept": "application/vnd.google.protobuf; "
                    "proto=io.prometheus.client.MetricFamily; encoding=delimited"
                },
            )
            body = await resp.read()
            # walk the varint-delimited stream and pull family names (field
            # 1, wire type 2 is always the first field emitted)
            names = []
            i = 0
            while i < len(body):
                msg_len, i = _read_varint(body, i)
                msg = body[i : i + msg_len]
                i += msg_len
                assert msg[0] == (1 << 3) | 2  # field 1, length-delimited
                name_len, j = _read_varint(msg, 1)
                names.append(msg[j : j + name_len].decode())
            text = await client.get("/metrics")
            return {
                "status": resp.status,
                "type": resp.headers["Content-Type"].split(";")[0],
                "names": sorted(names),
                "text_type": "text/plain" in text.headers["Content-Type"],
            }
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["status"] == 200
    assert port["type"] == "application/vnd.google.protobuf"
    assert "request_latency_seconds" in port["names"]
    assert "index_size" in port["names"]
    # text format still served without the Accept header
    assert port["text_type"]


async def test_swagger_ui_page():
    """/swagger-ui serves the interactive docs page (httproutes.rs:160-166)."""
    vecs = rows(5, 4)

    async def case(side):
        service, client = await side.start(simple_db(side, vecs))
        try:
            page = await request(client, "GET", "/swagger-ui/")
            resp = await client.get("/swagger-ui", allow_redirects=False)
            return {"page": page, "redirect": resp.status}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["page"][0] == 200
    assert "/api-docs/openapi.json" in port["page"][1]
    assert port["redirect"] == 302


async def test_internals_counters():
    vecs = rows(5, 4)

    async def case(side):
        service, client = await side.start(simple_db(side, vecs))
        try:
            service.internals.increment("test-counter", 3)
            return await request(client, "GET", "/api/internals/counters")
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    # the port adds the heap's two counters (utils/heap) and the exact
    # scans' two (run.py), which the JAX package has not
    status, counters = port
    heap_keys = {k for k in counters if k.startswith("host-gc-")}
    assert heap_keys == {"host-gc-freezes", "host-gc-frozen-objects"}
    scan_keys = {k for k in counters if k.startswith("flat-scan-")}
    assert scan_keys == {"flat-scan-rows", "flat-scan-capacity-rows"}
    port_only = heap_keys | scan_keys
    assert_same((status, {k: v for k, v in counters.items() if k not in port_only}), jax)
    assert counters["test-counter"] == 3


# -- TestCoexistingIndexes ----------------------------------------------------------------------


async def test_independent_indexes():
    """Multiple indexes over different tables serve independently
    (validator coexisting_indexes parity)."""
    rng = np.random.default_rng(13)
    v1 = rng.normal(size=(10, 4)).astype(np.float32)
    v2 = rng.normal(size=(10, 6)).astype(np.float32)

    async def case(side):
        fake = side.fake
        db = fake.FakeDb()
        db.add_table(fake.FakeTable("ks", "t1", ("pk",)))
        db.add_table(fake.FakeTable("ks", "t2", ("pk",)))
        db.add_index(fake.FakeIndex(
            metadata=fake.make_vs_metadata(index="i1", table="t1", dimensions=4),
            scan=[fake.vector_row((i,), v1[i].tolist(), 100) for i in range(10)],
        ))
        db.add_index(fake.FakeIndex(
            metadata=fake.make_vs_metadata(index="i2", table="t2", dimensions=6),
            scan=[fake.vector_row((i,), v2[i].tolist(), 100) for i in range(10)],
        ))
        service, client = await side.start(db)
        try:
            await wait_serving(client, "ks", "i1")
            await wait_serving(client, "ks", "i2")
            out = {
                "r1": await request(client, "POST", "/api/v1/indexes/ks/i1/ann", json={"vector": v1[3].tolist(), "limit": 1}),
                "r2": await request(client, "POST", "/api/v1/indexes/ks/i2/ann", json={"vector": v2[7].tolist(), "limit": 1}),
                # dimensions are per-index
                "bad": (await request(client, "POST", "/api/v1/indexes/ks/i1/ann", json={"vector": v2[0].tolist(), "limit": 1}))[0],
            }
            # dropping one leaves the other serving
            db.drop_index(("ks", "i1"))
            await wait_for(lambda: service.indexes.get_vs(("ks", "i1")) is None)
            out["after_drop"] = await request(
                client, "POST", "/api/v1/indexes/ks/i2/ann", json={"vector": v2[7].tolist(), "limit": 1}
            )
            return out
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax, max(norm2(v1), norm2(v2)))
    assert port["r1"][1]["primary_keys"]["pk"] == [3]
    assert port["r2"][1]["primary_keys"]["pk"] == [7]
    assert port["bad"] == 400
    assert port["after_drop"][0] == 200


# -- TestFtsIntegration -----------------------------------------------------------------------------


async def test_bm25_over_http():
    """FTS index end-to-end: scan docs, serve BM25 (integration fts.rs
    parity)."""
    version = uuid.uuid1()

    async def case(side):
        types, fake = side.types, side.fake
        db = fake.FakeDb()
        db.add_table(fake.FakeTable("ks", "docs", ("pk",)))
        md = types.IndexMetadata(
            keyspace_name="ks",
            index_name="fts",
            table_name="docs",
            primary_key_columns=("pk",),
            partition_key_count=1,
            target_columns=("body",),
            partitioning=types.DbIndexPartitioning.global_(),
            filtering_columns=(),
            version=types.IndexVersion(version),
            fts_options=types.IndexOptionsFts(),
        )
        docs = [
            fake.document_row((1,), "the quick brown fox", 100),
            fake.document_row((2,), "lazy dogs sleep", 100),
            fake.document_row((3,), "quick quick foxes", 100),
        ]
        db.add_index(fake.FakeIndex(metadata=md, scan=docs))
        service, client = await side.start(db)
        try:
            await wait_serving(client, "ks", "fts")
            _, status = await request(client, "GET", "/api/v1/indexes/ks/fts/status")
            bm25 = await request(client, "POST", "/api/v1/indexes/ks/fts/bm25", json={"query": "quick fox", "limit": 2})
            _, idxs = await request(client, "GET", "/api/v1/indexes")
            # CDC document update
            await db.db_indexes[("ks", "fts")].push_cdc(fake.document_row((9,), "zebras gallop quickly", 200))
            deadline = asyncio.get_event_loop().time() + 10
            while True:
                cdc = await request(client, "POST", "/api/v1/indexes/ks/fts/bm25", json={"query": "zebras", "limit": 1})
                if cdc[0] == 200 and cdc[1]["primary_keys"]["pk"] == [9]:
                    break
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.05)
            return {"count": status["count"], "bm25": bm25, "indexes": idxs, "cdc": cdc}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    # the count right after SERVING depends on commit batching (the
    # reference accepts 3 or 0): compared apart
    assert port.pop("count") in (0, 3) and jax.pop("count") in (0, 3)
    assert_same(port, jax)
    status, data = port["bm25"]
    assert status == 200
    assert 1 in data["primary_keys"]["pk"]
    assert len(data["scores"]) == len(data["primary_keys"]["pk"])
    # listed with fulltext options
    fts = [i for i in port["indexes"] if i["index"] == "fts"]
    assert fts and fts[0]["options"]["type"] == "fulltext"
    assert port["cdc"][1]["primary_keys"]["pk"] == [9]
