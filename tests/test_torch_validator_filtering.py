"""The filtered-ANN validator matrix, served by the port.

Twin of tests/test_validator_filtering.py: its 22 scenarios (global-index
pk/ck restrictions, filtering columns on global and local indexes, local
partition restrictions, timestamp filtering columns, and the ALLOW
FILTERING 400s) driven over HTTP through
vector_store_tpu_torch.run.build_service on torch.device("cpu"), each
asserting the returned keys. Only the imports and the device differ from
the JAX package's file: the port's FakeDb, Config and enums, and the
kernels' plain versions.

Data shape: a (pk, ck) compound primary key, 4 partitions x 5 clustering
rows, vectors v = [pk, ck, 0, 0].
"""

import asyncio

import pytest

torch = pytest.importorskip("torch")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

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

DIMS = 4
N_PK, N_CK = 4, 5


def grid_vec(pk: int, ck: int) -> list[float]:
    return [float(pk), float(ck), 0.0, 0.0]


def make_db(
    filtering=(),
    partitioning=None,
    columns=None,
    flag_of=None,
):
    """4 partitions x 5 clustering rows; optional filtering column values
    via flag_of(pk, ck)."""
    db = FakeDb()
    db.add_table(
        FakeTable("ks", "tbl", ("pk", "ck"), columns=dict(columns or {}))
    )
    rows = []
    for pk in range(N_PK):
        for ck in range(N_CK):
            f = [(100, flag_of(pk, ck))] if flag_of else []
            rows.append(vector_row((pk, ck), grid_vec(pk, ck), 100, filtering=f))
    md = make_vs_metadata(
        dimensions=DIMS,
        primary_key_columns=("pk", "ck"),
        partition_key_count=1,
        filtering_columns=tuple(filtering),
        partitioning=partitioning,
    )
    db.add_index(FakeIndex(metadata=md, scan=rows))
    return db


async def start(db):
    service = await build_service(
        db, Config(monitor_indexes_interval=0.05), device=torch.device("cpu")
    )
    client = TestClient(TestServer(service.app))
    await client.start_server()
    deadline = asyncio.get_event_loop().time() + 30
    while True:
        resp = await client.get("/api/v1/indexes/ks/idx/status")
        if resp.status == 200:
            d = await resp.json()
            if d["status"] == "SERVING" and d["count"] == N_PK * N_CK:
                break
        assert asyncio.get_event_loop().time() < deadline
        await asyncio.sleep(0.05)
    return service, client


async def ann(client, vector, limit, restrictions=None, allow_filtering=True):
    body = {"vector": vector, "limit": limit}
    if restrictions is not None:
        body["filter"] = {
            "restrictions": restrictions,
            "allow_filtering": allow_filtering,
        }
    return await client.post("/api/v1/indexes/ks/idx/ann", json=body)


async def ann_keys(client, vector, limit, restrictions, allow_filtering=True):
    resp = await ann(client, vector, limit, restrictions, allow_filtering)
    assert resp.status == 200, await resp.text()
    data = await resp.json()
    pks = data["primary_keys"]["pk"]
    cks = data["primary_keys"]["ck"]
    return set(zip(pks, cks))


def run(coro):
    async def wrapper(db, fn):
        service, client = await start(db)
        try:
            await fn(client)
        finally:
            await client.close()
            await service.stop()

    return wrapper


class TestGlobalIndexFiltering:
    """filtering.rs:42-585 — pk/ck restrictions on a global index."""

    async def test_filter_by_partition_key_eq(self):
        # filtering.rs:42 — WHERE pk = 1 returns exactly partition 1's rows
        service, client = await start(make_db())
        try:
            keys = await ann_keys(
                client, grid_vec(1, 0), 20, [{"type": "==", "lhs": "pk", "rhs": 1}]
            )
            assert keys == {(1, ck) for ck in range(N_CK)}
        finally:
            await client.close()
            await service.stop()

    async def test_filter_by_partition_key_in(self):
        # filtering.rs:114 — WHERE pk IN (0, 2)
        service, client = await start(make_db())
        try:
            keys = await ann_keys(
                client,
                grid_vec(1, 0),
                20,
                [{"type": "IN", "lhs": "pk", "rhs": [0, 2]}],
            )
            assert keys == {(p, c) for p in (0, 2) for c in range(N_CK)}
        finally:
            await client.close()
            await service.stop()

    async def test_filter_by_clustering_key_lt(self):
        # filtering.rs:183 — WHERE ck < 3 (all partitions)
        service, client = await start(make_db())
        try:
            keys = await ann_keys(
                client, grid_vec(0, 0), 20, [{"type": "<", "lhs": "ck", "rhs": 3}]
            )
            assert keys == {(p, c) for p in range(N_PK) for c in range(3)}
        finally:
            await client.close()
            await service.stop()

    async def test_filter_by_clustering_key_gt(self):
        # filtering.rs:250 — WHERE ck > 2
        service, client = await start(make_db())
        try:
            keys = await ann_keys(
                client, grid_vec(0, 4), 20, [{"type": ">", "lhs": "ck", "rhs": 2}]
            )
            assert keys == {(p, c) for p in range(N_PK) for c in (3, 4)}
        finally:
            await client.close()
            await service.stop()

    async def test_filter_by_clustering_key_range(self):
        # filtering.rs:317 — WHERE ck > 0 AND ck <= 3
        service, client = await start(make_db())
        try:
            keys = await ann_keys(
                client,
                grid_vec(0, 2),
                20,
                [
                    {"type": ">", "lhs": "ck", "rhs": 0},
                    {"type": "<=", "lhs": "ck", "rhs": 3},
                ],
            )
            assert keys == {(p, c) for p in range(N_PK) for c in (1, 2, 3)}
        finally:
            await client.close()
            await service.stop()

    async def test_filter_by_pk_and_ck(self):
        # filtering.rs:385 — WHERE pk = 2 AND ck >= 3
        service, client = await start(make_db())
        try:
            keys = await ann_keys(
                client,
                grid_vec(2, 3),
                20,
                [
                    {"type": "==", "lhs": "pk", "rhs": 2},
                    {"type": ">=", "lhs": "ck", "rhs": 3},
                ],
            )
            assert keys == {(2, 3), (2, 4)}
        finally:
            await client.close()
            await service.stop()

    async def test_filter_tuple_eq_on_pk_ck(self):
        # the reference Restriction surface includes tuple forms
        # (lib.rs:509-558); (pk, ck) == (1, 2) pins one row
        service, client = await start(make_db())
        try:
            keys = await ann_keys(
                client,
                grid_vec(1, 2),
                20,
                [{"type": "()==()", "lhs": ["pk", "ck"], "rhs": [1, 2]}],
            )
            assert keys == {(1, 2)}
        finally:
            await client.close()
            await service.stop()

    async def test_no_results_when_nothing_matches(self):
        # filtering.rs:459 — a filter matching nothing returns 200 + empty
        service, client = await start(make_db())
        try:
            keys = await ann_keys(
                client, grid_vec(0, 0), 20, [{"type": "==", "lhs": "pk", "rhs": 99}]
            )
            assert keys == set()
        finally:
            await client.close()
            await service.stop()

    async def test_filter_by_vector_column_rejected(self):
        # filtering.rs:528 — WHERE on the vector column itself is a 400
        # (the target column is never in the coverable set)
        service, client = await start(make_db())
        try:
            resp = await ann(
                client,
                grid_vec(0, 0),
                5,
                [{"type": "==", "lhs": "emb", "rhs": [1.0, 0.0, 0.0, 0.0]}],
            )
            assert resp.status == 400
        finally:
            await client.close()
            await service.stop()


class TestFilteringColumns:
    """filtering.rs:587-757 — declared filtering columns, global + local."""

    async def test_global_index_filter_by_filtering_column(self):
        # filtering.rs:587 — flag = pk % 2; WHERE flag = 1
        db = make_db(filtering=("flag",), flag_of=lambda pk, ck: pk % 2)
        service, client = await start(db)
        try:
            keys = await ann_keys(
                client, grid_vec(1, 0), 20, [{"type": "==", "lhs": "flag", "rhs": 1}]
            )
            assert keys == {(p, c) for p in (1, 3) for c in range(N_CK)}
        finally:
            await client.close()
            await service.stop()

    async def test_local_index_filter_by_filtering_column(self):
        # filtering.rs:677 — local index: partition eq + filtering column
        db = make_db(
            filtering=("flag",),
            partitioning=DbIndexPartitioning.local(("pk",)),
            flag_of=lambda pk, ck: ck % 2,
        )
        service, client = await start(db)
        try:
            keys = await ann_keys(
                client,
                grid_vec(2, 0),
                20,
                [
                    {"type": "==", "lhs": "pk", "rhs": 2},
                    {"type": "==", "lhs": "flag", "rhs": 0},
                ],
            )
            assert keys == {(2, c) for c in (0, 2, 4)}
        finally:
            await client.close()
            await service.stop()


class TestLocalIndexFiltering:
    """filtering.rs:758-1145 — local (per-partition) index scenarios."""

    async def test_local_filter_by_partition_key_eq(self):
        # filtering.rs:758
        db = make_db(partitioning=DbIndexPartitioning.local(("pk",)))
        service, client = await start(db)
        try:
            keys = await ann_keys(
                client, grid_vec(3, 0), 20, [{"type": "==", "lhs": "pk", "rhs": 3}]
            )
            assert keys == {(3, c) for c in range(N_CK)}
        finally:
            await client.close()
            await service.stop()

    async def test_local_filter_by_clustering_key_range(self):
        # filtering.rs:834 — partition eq + ck range
        db = make_db(partitioning=DbIndexPartitioning.local(("pk",)))
        service, client = await start(db)
        try:
            keys = await ann_keys(
                client,
                grid_vec(1, 2),
                20,
                [
                    {"type": "==", "lhs": "pk", "rhs": 1},
                    {"type": ">=", "lhs": "ck", "rhs": 1},
                    {"type": "<", "lhs": "ck", "rhs": 4},
                ],
            )
            assert keys == {(1, 1), (1, 2), (1, 3)}
        finally:
            await client.close()
            await service.stop()

    async def test_local_no_results_when_nothing_matches(self):
        # filtering.rs:902 — unknown partition -> 200 + empty
        db = make_db(partitioning=DbIndexPartitioning.local(("pk",)))
        service, client = await start(db)
        try:
            keys = await ann_keys(
                client, grid_vec(0, 0), 20, [{"type": "==", "lhs": "pk", "rhs": 42}]
            )
            assert keys == set()
        finally:
            await client.close()
            await service.stop()

    async def test_local_partition_plus_filtering_column(self):
        # filtering.rs:971 — pk eq + filtering restriction compose
        db = make_db(
            filtering=("flag",),
            partitioning=DbIndexPartitioning.local(("pk",)),
            flag_of=lambda pk, ck: 1 if ck >= 3 else 0,
        )
        service, client = await start(db)
        try:
            keys = await ann_keys(
                client,
                grid_vec(0, 4),
                20,
                [
                    {"type": "==", "lhs": "pk", "rhs": 0},
                    {"type": "==", "lhs": "flag", "rhs": 1},
                ],
            )
            assert keys == {(0, 3), (0, 4)}
        finally:
            await client.close()
            await service.stop()

    async def test_global_ann_on_local_only_index_fails(self):
        # filtering.rs:1086 — no pk restriction + only a local index -> 400
        db = make_db(partitioning=DbIndexPartitioning.local(("pk",)))
        service, client = await start(db)
        try:
            resp = await ann(client, grid_vec(0, 0), 5)
            assert resp.status == 400
            text = await resp.text()
            assert "Global ANN" in text or "not supported" in text
        finally:
            await client.close()
            await service.stop()


class TestTimestampFilters:
    """filtering.rs:1147-1280 — timestamp-typed filtering columns."""

    TS_MS = 1_700_000_000_000  # epoch millis

    def _db(self, partitioning=None):
        import datetime

        def flag_of(pk, ck):
            return datetime.datetime.fromtimestamp(
                (self.TS_MS + pk * 1000) / 1e3, tz=datetime.timezone.utc
            )

        return make_db(
            filtering=("ts",),
            partitioning=partitioning,
            columns={"ts": "timestamp"},
            flag_of=flag_of,
        )

    async def test_global_ann_with_timestamp_eq_filter(self):
        # filtering.rs:1147 — ts == epoch-millis of partition 1's rows
        service, client = await start(self._db())
        try:
            keys = await ann_keys(
                client,
                grid_vec(1, 0),
                20,
                [{"type": "==", "lhs": "ts", "rhs": self.TS_MS + 1000}],
            )
            assert keys == {(1, c) for c in range(N_CK)}
        finally:
            await client.close()
            await service.stop()

    async def test_local_ann_with_timestamp_gte_filter(self):
        # filtering.rs:1211 — local index, ts >= threshold
        service, client = await start(
            self._db(partitioning=DbIndexPartitioning.local(("pk",)))
        )
        try:
            keys = await ann_keys(
                client,
                grid_vec(2, 0),
                20,
                [
                    {"type": "==", "lhs": "pk", "rhs": 2},
                    {"type": ">=", "lhs": "ts", "rhs": self.TS_MS + 2000},
                ],
            )
            assert keys == {(2, c) for c in range(N_CK)}
            # and a threshold above partition 2's stamp matches nothing
            keys = await ann_keys(
                client,
                grid_vec(2, 0),
                20,
                [
                    {"type": "==", "lhs": "pk", "rhs": 2},
                    {"type": ">=", "lhs": "ts", "rhs": self.TS_MS + 3000},
                ],
            )
            assert keys == set()
        finally:
            await client.close()
            await service.stop()


class TestAllowFilteringSemantics:
    """filtering.rs:1282-1374 — ALLOW FILTERING 400 semantics."""

    async def test_ck_only_requires_allow_filtering(self):
        # filtering.rs:1282 — ck-only filter: 400 without ALLOW FILTERING,
        # rows with it
        service, client = await start(make_db())
        try:
            resp = await ann(
                client,
                grid_vec(0, 1),
                20,
                [{"type": "==", "lhs": "ck", "rhs": 1}],
                allow_filtering=False,
            )
            assert resp.status == 400
            keys = await ann_keys(
                client,
                grid_vec(0, 1),
                20,
                [{"type": "==", "lhs": "ck", "rhs": 1}],
                allow_filtering=True,
            )
            assert keys == {(p, 1) for p in range(N_PK)}
        finally:
            await client.close()
            await service.stop()

    async def test_non_coverable_column_rejected_without_allow_filtering(self):
        # filtering.rs:1328 — a column outside pk/partition/filtering set
        service, client = await start(make_db())
        try:
            resp = await ann(
                client,
                grid_vec(0, 0),
                5,
                [{"type": "==", "lhs": "c", "rhs": 1}],
                allow_filtering=False,
            )
            assert resp.status == 400
        finally:
            await client.close()
            await service.stop()

    async def test_non_coverable_column_rejected_with_allow_filtering(self):
        # filtering.rs:1351 — ALLOW FILTERING does NOT rescue an
        # uncoverable column (no index can serve it)
        service, client = await start(make_db())
        try:
            resp = await ann(
                client,
                grid_vec(0, 0),
                5,
                [{"type": "==", "lhs": "c", "rhs": 1}],
                allow_filtering=True,
            )
            assert resp.status == 400
        finally:
            await client.close()
            await service.stop()

    async def test_pk_eq_requires_allow_filtering_on_global(self):
        # the reference requires ALLOW FILTERING for every filtered ANN on
        # a global index (needs_filtering > 0, httproutes.rs 400 path)
        service, client = await start(make_db())
        try:
            resp = await ann(
                client,
                grid_vec(1, 0),
                5,
                [{"type": "==", "lhs": "pk", "rhs": 1}],
                allow_filtering=False,
            )
            assert resp.status == 400
        finally:
            await client.close()
            await service.stop()
