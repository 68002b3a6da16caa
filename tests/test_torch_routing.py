"""Twins of tests/test_routing.py: the query routing matrix (indexes over
the same keyspace, table and target column form a routing group, and a
request is served by its best-scoring member; service/indexes.py, with
the filters of core/filters.py), each case run on the JAX service and on
the port's (run.build_service on torch.device("cpu")).

| reference case | port test |
|---|---|
| TestRouting::test_partition_eq_routes_to_local | test_partition_eq_routes_to_local |
| TestRouting::test_unfiltered_routes_to_global | test_unfiltered_routes_to_global |
| TestRouting::test_local_only_unfiltered_400 | test_local_only_unfiltered_400 |
| TestRouting::test_global_filter_needs_allow_filtering | test_global_filter_needs_allow_filtering |
| TestRouting::test_uncovered_filter_column_rejected | test_uncovered_filter_column_rejected |
| TestRouting::test_version_tie_break | test_version_tie_break |
| TestTypedFilters::test_type_mismatch_400 | test_type_mismatch_400 |

Tolerance: statuses, error texts, primary keys and the routing counters
(``ann-served-request--<ks>--<index>``) equal; distances within
1e-6 * (1 + |d|) plus 1e-6 times the rows' largest squared norm. The
local route runs the partition scan's plain version on the port (12 rows
in 3 partitions: every partition within one lane group, so its group
minimum is exact). Each twin is bounded by 60 s.
"""

import asyncio
import uuid

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("aiohttp")

from torch_service_twins import assert_same, norm2, request, stop, twin  # noqa: E402

DIMS = 4
VECS = np.random.default_rng(77).normal(size=(12, DIMS)).astype(np.float32)
NORM2 = norm2(VECS)


async def wait_serving(client, names, timeout=15.0):
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        ok = True
        for name in names:
            resp = await client.get(f"/api/v1/indexes/ks/{name}/status")
            if resp.status != 200 or (await resp.json())["status"] != "SERVING":
                ok = False
        if ok:
            return
        assert asyncio.get_event_loop().time() < deadline
        await asyncio.sleep(0.05)


def rows(fake, parts=3):
    """Rows with a filtering/partition column 'region' cycling 0..parts-1."""
    return [fake.vector_row((i,), VECS[i].tolist(), 100, filtering=[(100, i % parts)]) for i in range(len(VECS))]


def db_with(side, global_=True, local=True, filtering=("region",)):
    fake = side.fake
    db = fake.FakeDb()
    db.add_table(fake.FakeTable("ks", "tbl", ("pk",)))
    scan = rows(fake)
    if global_:
        db.add_index(fake.FakeIndex(
            metadata=fake.make_vs_metadata(index="g_idx", dimensions=DIMS, filtering_columns=filtering),
            scan=list(scan),
        ))
    if local:
        db.add_index(fake.FakeIndex(
            metadata=fake.make_vs_metadata(
                index="l_idx", dimensions=DIMS, filtering_columns=(),
                partitioning=side.types.DbIndexPartitioning.local(("region",)),
            ),
            scan=list(scan),
        ))
    return db


def eq_region(v, allow=False):
    return {"restrictions": [{"type": "==", "lhs": "region", "rhs": v}], "allow_filtering": allow}


def served(service, index):
    return service.internals.counters().get(f"ann-served-request--ks--{index}", 0)


async def ann(client, index, limit, **extra):
    return await request(
        client, "POST", f"/api/v1/indexes/ks/{index}/ann", json={"vector": VECS[0].tolist(), "limit": limit, **extra}
    )


async def test_partition_eq_routes_to_local():
    """A request addressed to the GLOBAL index whose filter pins the local
    index's partition column routes to the local index: no ALLOW
    FILTERING needed (local covers the column)."""

    async def case(side):
        service, client = await side.start(db_with(side))
        try:
            await wait_serving(client, ["g_idx", "l_idx"])
            resp = await ann(client, "g_idx", 5, filter=eq_region(0))
            return {"resp": resp, "local": served(service, "l_idx"), "global": served(service, "g_idx")}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax, NORM2)
    status, data = port["resp"]
    assert status == 200, data
    assert all(pk % 3 == 0 for pk in data["primary_keys"]["pk"])
    assert port["local"] >= 1


async def test_unfiltered_routes_to_global():
    async def case(side):
        service, client = await side.start(db_with(side))
        try:
            await wait_serving(client, ["g_idx", "l_idx"])
            resp = await ann(client, "l_idx", 3)
            return {"resp": resp, "local": served(service, "l_idx"), "global": served(service, "g_idx")}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax, NORM2)
    assert port["resp"][0] == 200
    assert port["global"] >= 1


async def test_local_only_unfiltered_400():
    async def case(side):
        service, client = await side.start(db_with(side, global_=False))
        try:
            await wait_serving(client, ["l_idx"])
            return await ann(client, "l_idx", 3)
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port[0] == 400
    assert "Global ANN query is not supported" in port[1]


async def test_global_filter_needs_allow_filtering():
    async def case(side):
        service, client = await side.start(db_with(side, local=False))
        try:
            await wait_serving(client, ["g_idx"])
            return [
                await ann(client, "g_idx", 3, filter=eq_region(0, allow=False)),
                await ann(client, "g_idx", 3, filter=eq_region(0, allow=True)),
            ]
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax, NORM2)
    assert port[0][0] == 400
    assert "ALLOW FILTERING" in port[0][1]
    assert port[1][0] == 200


async def test_uncovered_filter_column_rejected():
    async def case(side):
        service, client = await side.start(db_with(side, local=False, filtering=()))  # no filtering columns
        try:
            await wait_serving(client, ["g_idx"])
            return await ann(client, "g_idx", 3, filter=eq_region(0, allow=True))
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port[0] == 400


async def test_version_tie_break():
    """Two identical global indexes: the newest version serves."""
    old_v = uuid.uuid1()
    await asyncio.sleep(0.01)
    new_v = uuid.uuid1()

    async def case(side):
        fake = side.fake
        db = fake.FakeDb()
        db.add_table(fake.FakeTable("ks", "tbl", ("pk",)))
        scan = rows(fake)
        for name, version in (("old", old_v), ("new", new_v)):
            db.add_index(fake.FakeIndex(
                metadata=fake.make_vs_metadata(index=name, dimensions=DIMS, version=side.types.IndexVersion(version)),
                scan=list(scan),
            ))
        service, client = await side.start(db)
        try:
            await wait_serving(client, ["old", "new"])
            resp = await ann(client, "old", 1)
            return {"resp": resp, "new": served(service, "new"), "old": served(service, "old")}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax, NORM2)
    assert port["resp"][0] == 200
    assert port["new"] >= 1


async def test_type_mismatch_400():
    """Filter values are converted against the base table's column types;
    mismatches 400 like the reference's typed JSON conversion."""

    async def case(side):
        fake = side.fake
        db = fake.FakeDb()
        db.add_table(fake.FakeTable("ks", "tbl", ("pk",), columns={"region": "int", "name": "text"}))
        db.add_index(fake.FakeIndex(
            metadata=fake.make_vs_metadata(index="g_idx", dimensions=DIMS, filtering_columns=("region", "name")),
            scan=rows(fake),
        ))
        service, client = await side.start(db)
        try:
            await wait_serving(client, ["g_idx"])
            flt = {"restrictions": [{"type": "==", "lhs": "region", "rhs": "zero"}], "allow_filtering": True}
            wrong = await ann(client, "g_idx", 3, filter=flt)  # a string for an int column
            flt["restrictions"][0]["rhs"] = 1
            right = await ann(client, "g_idx", 3, filter=flt)
            return {"wrong": wrong, "right": right}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax, NORM2)
    assert port["wrong"][0] == 400
    assert "expects int" in port["wrong"][1]
    assert port["right"][0] == 200
