"""Twins of the reference's validator suites for crud, similarity functions,
serde, coexisting indexes and index_modify (tests/test_validator_crud.py,
test_validator_similarity.py, test_validator_serde.py,
test_validator_coexisting.py, test_validator_index_modify.py): each case
runs on the JAX service and on the port's (run.build_service on
torch.device("cpu")), over its own package's FakeDb, or over its own CQL
client and fake CQL server where the reference case goes through the wire
(tests/torch_wire_twins.py).

| reference case | port test |
|---|---|
| crud::test_create_drop_create_cycle | test_create_drop_create_cycle |
| crud::test_create_drop_multiple_indexes | test_create_drop_multiple_indexes |
| crud::test_null_vector_is_not_indexed | test_null_vector_is_not_indexed |
| crud::test_global_add_remove_multiple_add | test_global_add_remove_multiple_add |
| similarity::test_euclidean_distances | test_space_distances[EUCLIDEAN] |
| similarity::test_cosine_distances | test_space_distances[COSINE] |
| similarity::test_dot_product_distances | test_space_distances[DOT_PRODUCT] |
| similarity::test_default_is_cosine | test_default_is_cosine |
| similarity::test_lowercase_option_parses_through_wire | test_lowercase_option_parses_through_wire |
| serde::test_all_types_filter_roundtrip | test_all_types_filter_roundtrip |
| serde::test_varint_filter_big_magnitudes | test_varint_filter_big_magnitudes |
| serde::test_decimal_filter_cross_representation | test_decimal_filter_cross_representation |
| serde::test_type_mismatch_rejected | test_type_mismatch_rejected |
| coexisting::test_vector_and_fts_coexist_and_drop_independently | test_vector_and_fts_coexist_and_drop_independently |
| coexisting::test_two_vector_indexes_same_table | test_two_vector_indexes_same_table |
| index_modify::test_param_change_rebuilds_index | test_param_change_rebuilds_index |
| index_modify::test_drop_and_recreate | test_drop_and_recreate |

index_modify::test_version_only_change_with_simulator_keeps_index is
twinned in tests/test_torch_actor_legacy.py. Each twin runs the reference
case's steps on both services and keeps its assertions on the port's
run. Tolerance: statuses, primary keys, counts, index listings, options
and texts are equal; distances and similarity scores within 1e-6 * (1 +
|x|) (torch_service_twins.assert_same). Where the reference's rows tie
(test_space_distances), the answer compares as a map from key to its
distance and similarity: either package orders equal distances its own
way. Every twin is bounded by 60 s.
"""

import asyncio
import math
import uuid as _uuid
from decimal import Decimal

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("aiohttp")

from torch_service_twins import assert_same  # noqa: E402
from torch_wire_twins import WireService, post_json, schema_handler, twin, wait_json  # noqa: E402

ROWS = [(i, [math.cos(i), math.sin(i), 0.0]) for i in range(4)]


async def stop(service, client):
    await client.close()
    await service.stop()


def counted(n):
    return lambda s: s["count"] == n and s["status"] == "SERVING"


def index_names(lst):
    return {e["index"] for e in lst}


# -- crud ---------------------------------------------------------------------------


async def test_create_drop_create_cycle():
    async def case(side):
        f = side.fake
        db = f.FakeDb()
        db.add_table(f.FakeTable("ks", "tbl", ("pk",)))
        rows = [f.vector_row((pk,), v, 100) for pk, v in ROWS]
        service, client = await side.start(db)
        try:
            await wait_json(client, "/api/v1/indexes", lambda lst: lst == [])
            cycles = []
            for _ in range(2):
                db.add_index(f.FakeIndex(metadata=f.make_vs_metadata(index="idx"), scan=list(rows)))
                await wait_json(client, "/api/v1/indexes/ks/idx/status", counted(4))
                found = await post_json(client, "/api/v1/indexes/ks/idx/ann", {"vector": ROWS[1][1], "limit": 1})
                db.drop_index(("ks", "idx"))
                await wait_json(client, "/api/v1/indexes", lambda lst: lst == [])
                status = (await client.get("/api/v1/indexes/ks/idx/status")).status
                gone = (await post_json(client, "/api/v1/indexes/ks/idx/ann", {"vector": ROWS[1][1], "limit": 1}))[0]
                cycles.append({"ann": found, "status_after_drop": status, "ann_after_drop": gone})
            return cycles
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    for cycle in port:
        assert cycle["ann"][0] == 200 and cycle["ann"][1]["primary_keys"]["pk"] == [1]
        assert cycle["status_after_drop"] == 404 and cycle["ann_after_drop"] == 404


async def test_create_drop_multiple_indexes():
    names = ["i0", "i1", "i2"]

    async def case(side):
        f = side.fake
        db = f.FakeDb()
        db.add_table(f.FakeTable("ks", "tbl", ("pk",)))
        service, client = await side.start(db)
        try:
            for j, name in enumerate(names):
                db.add_index(f.FakeIndex(
                    metadata=f.make_vs_metadata(index=name, target_column=f"emb{j}"),
                    scan=[f.vector_row((pk,), v, 100) for pk, v in ROWS],
                ))
            listed = [sorted(index_names(await wait_json(
                client, "/api/v1/indexes", lambda lst: index_names(lst) == set(names))))]
            counts = [(await wait_json(client, f"/api/v1/indexes/ks/{n}/status", counted(4)))["count"] for n in names]
            remaining = set(names)
            for name in names:
                db.drop_index(("ks", name))
                remaining.discard(name)
                lst = await wait_json(client, "/api/v1/indexes", lambda lst, want=frozenset(remaining): index_names(lst) == want)
                listed.append(sorted(index_names(lst)))
            return {"listed": listed, "counts": counts}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["listed"] == [names, ["i1", "i2"], ["i2"], []] and port["counts"] == [4, 4, 4]


async def test_null_vector_is_not_indexed():
    async def case(side):
        f = side.fake
        db = f.FakeDb()
        db.add_table(f.FakeTable("ks", "tbl", ("pk",)))
        rows = [f.vector_row((pk,), v, 100) for pk, v in ROWS] + [f.vector_row((9,), None, 100)]
        db.add_index(f.FakeIndex(metadata=f.make_vs_metadata(index="idx"), scan=rows))
        service, client = await side.start(db)
        try:
            await wait_json(client, "/api/v1/indexes/ks/idx/status", counted(4))
            before = await post_json(client, "/api/v1/indexes/ks/idx/ann", {"vector": ROWS[0][1], "limit": 10})
            await db.db_indexes[("ks", "idx")].push_cdc(f.vector_row((1,), None, 200))
            st = await wait_json(client, "/api/v1/indexes/ks/idx/status", lambda s: s["count"] == 3)
            after = await post_json(client, "/api/v1/indexes/ks/idx/ann", {"vector": ROWS[1][1], "limit": 10})
            return {"before": before, "count_after": st["count"], "after": after}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert 9 not in port["before"][1]["primary_keys"]["pk"]
    assert port["count_after"] == 3 and 1 not in port["after"][1]["primary_keys"]["pk"]


async def test_global_add_remove_multiple_add():
    v_a, v_b = [0.0, 0.0, 1.0], [0.0, 0.6, 0.8]

    async def case(side):
        f = side.fake
        db = f.FakeDb()
        db.add_table(f.FakeTable("ks", "tbl", ("pk",)))
        db.add_index(f.FakeIndex(metadata=f.make_vs_metadata(index="idx"),
                                 scan=[f.vector_row((pk,), v, 100) for pk, v in ROWS]))
        service, client = await side.start(db)
        try:
            await wait_json(client, "/api/v1/indexes/ks/idx/status", counted(4))
            dbi = db.db_indexes[("ks", "idx")]
            await dbi.push_cdc(f.vector_row((7,), v_a, 200))
            await dbi.push_cdc(f.delete_row((7,), 300))
            await dbi.push_cdc(f.vector_row((7,), v_a, 400))
            await dbi.push_cdc(f.vector_row((7,), v_b, 500))
            st = await wait_json(client, "/api/v1/indexes/ks/idx/status", lambda s: s["count"] == 5)
            deadline = asyncio.get_event_loop().time() + 10
            while True:
                status, data = await post_json(client, "/api/v1/indexes/ks/idx/ann", {"vector": v_b, "limit": 1})
                if data.get("primary_keys", {}).get("pk") == [7] and data["distances"][0] < 1e-4:
                    return {"count": st["count"], "ann": (status, data)}
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.05)
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["count"] == 5 and port["ann"][1]["primary_keys"]["pk"] == [7]


# -- similarity functions -----------------------------------------------------------

VECS = {0: [1.0, 0.0, 0.0], 1: [0.0, 1.0, 0.0], 2: [1.0, 1.0, 0.0], 3: [2.0, 0.0, 0.0]}


async def serve_space(side, space):
    f = side.fake
    db = f.FakeDb()
    db.add_table(f.FakeTable("ks", "tbl", ("pk",)))
    rows = [f.vector_row((pk,), v, 100) for pk, v in VECS.items()]
    db.add_index(f.FakeIndex(metadata=f.make_vs_metadata(dimensions=3, space_type=space), scan=rows))
    service, client = await side.start(db)
    await wait_json(client, "/api/v1/indexes/ks/idx/status", counted(len(VECS)))
    return service, client


@pytest.mark.parametrize("space", ["EUCLIDEAN", "COSINE", "DOT_PRODUCT"])
async def test_space_distances(space):
    async def case(side):
        service, client = await serve_space(side, side.types.SpaceType[space])
        try:
            status, data = await post_json(client, "/api/v1/indexes/ks/idx/ann", {"vector": [1.0, 0.0, 0.0], "limit": 4})
            # rows 2 and 3 tie under EUCLIDEAN, rows 0 and 3 under COSINE:
            # their order is either package's own, so the answer compares
            # as a map from key to (distance, similarity)
            keys = data["primary_keys"]["pk"]
            return {"status": status, "first": data["distances"][0],
                    "by_pk": {pk: [d, s] for pk, d, s in zip(keys, data["distances"], data["similarity_scores"])},
                    "keys": keys}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same({k: v for k, v in port.items() if k != "keys"}, {k: v for k, v in jax.items() if k != "keys"})
    assert port["status"] == 200
    data = {"primary_keys": {"pk": port["keys"]}}
    by_pk = {pk: d for pk, (d, _) in port["by_pk"].items()}
    sim = {pk: s for pk, (_, s) in port["by_pk"].items()}
    if space == "EUCLIDEAN":  # squared L2, similarity 1 / (1 + d)
        assert by_pk == pytest.approx({0: 0.0, 1: 2.0, 2: 1.0, 3: 1.0}, abs=1e-4)
        assert data["primary_keys"]["pk"][0] == 0 and sim[1] == pytest.approx(1.0 / 3.0, abs=1e-4)
    elif space == "COSINE":  # similarity (2 - d) / 2
        assert by_pk == pytest.approx({0: 0.0, 1: 1.0, 2: 1 - math.sqrt(0.5), 3: 0.0}, abs=1e-4)
        assert sim[1] == pytest.approx(0.5, abs=1e-4)
    else:  # d = 1 - q.v; the largest dot wins
        assert by_pk[0] == pytest.approx(0.0, abs=1e-4) and by_pk[1] == pytest.approx(1.0, abs=1e-4)
        assert by_pk[3] == pytest.approx(-1.0, abs=1e-4) and data["primary_keys"]["pk"][0] == 3


async def test_default_is_cosine():
    async def case(side):
        default = side.types.SpaceType.default()
        service, client = await serve_space(side, default)
        try:
            info = await (await client.get("/api/v1/indexes/ks/idx")).json()
            return {"default": default.name, "similarity_function": info["options"]["similarity_function"]}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == {"default": "COSINE", "similarity_function": "COSINE"}


async def test_lowercase_option_parses_through_wire():
    rows = [(i, [math.cos(i), math.sin(i), 0.0], 1_000_000) for i in range(4)]

    async def case(side):
        handler = schema_handler(side, rows=rows, index_options={"similarity_function": "euclidean"})
        async with WireService(side, handler) as ws:
            await ws.wait_serving()
            await ws.wait_index_count(("ks", "idx"), 4)
            info = await (await ws.http.get("/api/v1/indexes/ks/idx")).json()
            found = await post_json(ws.http, "/api/v1/indexes/ks/idx/ann", {"vector": rows[2][1], "limit": 1})
            return {"similarity_function": info["options"]["similarity_function"], "ann": found}

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["similarity_function"] == "EUCLIDEAN"
    assert port["ann"][1]["primary_keys"]["pk"] == [2] and port["ann"][1]["distances"][0] == pytest.approx(0.0, abs=1e-4)


# -- serde --------------------------------------------------------------------------

U1 = _uuid.UUID("11111111-2222-3333-4444-555555555555")
U2 = _uuid.UUID("99999999-8888-7777-6666-555555555555")
COLUMNS = {"i": "int", "big": "varint", "dec": "decimal", "f": "double", "t": "text", "u": "uuid", "flag": "boolean"}
TYPED = {
    0: (7, 2**70, "1.50", 1.5, "alpha", str(U1), True),
    1: (8, -(2**70), "-0.25", -0.25, "beta", str(U2), False),
    2: (7, 123, "42", 42.0, "alpha", str(U1), False),
}


async def serve_typed(side):
    f = side.fake
    db = f.FakeDb()
    db.add_table(f.FakeTable("ks", "tbl", ("pk",), columns=dict(COLUMNS)))
    rows = []
    for pk, vals in TYPED.items():
        conv = [Decimal(v) if t == "decimal" else _uuid.UUID(v) if t == "uuid" else v
                for t, v in zip(COLUMNS.values(), vals)]
        rows.append(f.vector_row((pk,), [math.cos(pk), math.sin(pk), 0.0], 100, filtering=[(100, c) for c in conv]))
    db.add_index(f.FakeIndex(metadata=f.make_vs_metadata(dimensions=3, filtering_columns=tuple(COLUMNS)), scan=rows))
    service, client = await side.start(db)
    await wait_json(client, "/api/v1/indexes/ks/idx/status", counted(len(TYPED)))
    return service, client


def serde_twin(cases):
    """Each restriction list through filtered ANN on both services:
    [(status, sorted keys or the error text)]."""

    async def case(side):
        service, client = await serve_typed(side)
        try:
            out = []
            for restrictions in cases:
                status, body = await post_json(client, "/api/v1/indexes/ks/idx/ann", {
                    "vector": [1.0, 0.0, 0.0], "limit": 10,
                    "filter": {"restrictions": restrictions, "allow_filtering": True}})
                out.append((status, sorted(body["primary_keys"]["pk"]) if status == 200 else body))
            return out
        finally:
            await stop(service, client)

    return twin(case)


async def test_all_types_filter_roundtrip():
    cases = [
        ([{"type": "==", "lhs": "i", "rhs": 7}], [0, 2]),
        ([{"type": "==", "lhs": "t", "rhs": "beta"}], [1]),
        ([{"type": "==", "lhs": "u", "rhs": str(U1)}], [0, 2]),
        ([{"type": "==", "lhs": "flag", "rhs": True}], [0]),
        ([{"type": "<", "lhs": "f", "rhs": 0}], [1]),
        ([{"type": "==", "lhs": "i", "rhs": 7}, {"type": "==", "lhs": "flag", "rhs": False}], [2]),
        ([{"type": "IN", "lhs": "t", "rhs": ["alpha", "beta"]}], [0, 1, 2]),
    ]
    jax, port = await serde_twin([r for r, _ in cases])
    assert_same(port, jax)
    assert port == [(200, want) for _, want in cases]


async def test_varint_filter_big_magnitudes():
    cases = [[{"type": ">", "lhs": "big", "rhs": 2**69}], [{"type": "<", "lhs": "big", "rhs": 0}],
             [{"type": "==", "lhs": "big", "rhs": 2**70}]]
    jax, port = await serde_twin(cases)
    assert_same(port, jax)
    assert port == [(200, [0]), (200, [1]), (200, [0])]


async def test_decimal_filter_cross_representation():
    cases = [[{"type": "==", "lhs": "dec", "rhs": 1.5}], [{"type": "==", "lhs": "dec", "rhs": 42}],
             [{"type": ">=", "lhs": "dec", "rhs": 0}]]
    jax, port = await serde_twin(cases)
    assert_same(port, jax)
    assert port == [(200, [0]), (200, [2]), (200, [0, 2])]


async def test_type_mismatch_rejected():
    cases = [[{"type": "==", "lhs": "i", "rhs": "seven"}], [{"type": "==", "lhs": "t", "rhs": 5}],
             [{"type": "==", "lhs": "flag", "rhs": "yes"}], [{"type": "==", "lhs": "u", "rhs": "not-a-uuid"}]]
    jax, port = await serde_twin(cases)
    assert_same(port, jax)
    assert [status for status, _ in port] == [400] * 4


# -- coexisting indexes -------------------------------------------------------------

CO_ROWS = [(i, [math.cos(i), math.sin(i), 0.0]) for i in range(6)]
DOCS = ["quick brown fox", "lazy dog", "fox hunts dog", "quiet fox", "dog", "birds"]


def fts_metadata(side, index="fts", table="tbl"):
    t = side.types
    return t.IndexMetadata(
        keyspace_name="ks", index_name=index, table_name=table, primary_key_columns=("pk",), partition_key_count=1,
        target_columns=("body",), partitioning=t.DbIndexPartitioning.global_(), filtering_columns=(),
        version=t.IndexVersion(_uuid.uuid1()), fts_options=t.IndexOptionsFts(),
    )


async def test_vector_and_fts_coexist_and_drop_independently():
    async def case(side):
        f = side.fake
        db = f.FakeDb()
        db.add_table(f.FakeTable("ks", "tbl", ("pk",)))
        db.add_index(f.FakeIndex(metadata=f.make_vs_metadata(index="vec"),
                                 scan=[f.vector_row((pk,), v, 100) for pk, v in CO_ROWS]))
        db.add_index(f.FakeIndex(metadata=fts_metadata(side),
                                 scan=[f.document_row((i,), DOCS[i], 100) for i in range(len(DOCS))]))
        service, client = await side.start(db)
        try:
            await wait_json(client, "/api/v1/indexes", lambda lst: index_names(lst) == {"vec", "fts"})
            await wait_json(client, "/api/v1/indexes/ks/vec/status", counted(6))
            await wait_json(client, "/api/v1/indexes/ks/fts/status", counted(6))
            out = {
                "ann": await post_json(client, "/api/v1/indexes/ks/vec/ann", {"vector": CO_ROWS[3][1], "limit": 1}),
                "bm25": await post_json(client, "/api/v1/indexes/ks/fts/bm25", {"query": "fox", "limit": 10}),
                "ann_on_fts": (await post_json(client, "/api/v1/indexes/ks/fts/ann",
                                               {"vector": CO_ROWS[3][1], "limit": 1}))[0],
                "bm25_on_vec": (await post_json(client, "/api/v1/indexes/ks/vec/bm25",
                                                {"query": "fox", "limit": 10}))[0],
            }
            db.drop_index(("ks", "vec"))
            await wait_json(client, "/api/v1/indexes", lambda lst: index_names(lst) == {"fts"})
            out["bm25_after"] = await post_json(client, "/api/v1/indexes/ks/fts/bm25", {"query": "dog", "limit": 10})
            out["ann_after"] = (await post_json(client, "/api/v1/indexes/ks/vec/ann",
                                                {"vector": CO_ROWS[3][1], "limit": 1}))[0]
            return out
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["ann"][0] == 200 and port["ann"][1]["primary_keys"]["pk"] == [3]
    assert port["bm25"][0] == 200 and set(port["bm25"][1]["primary_keys"]["pk"]) == {0, 2, 3}
    assert port["ann_on_fts"] in (400, 404) and port["bm25_on_vec"] in (400, 404)
    assert set(port["bm25_after"][1]["primary_keys"]["pk"]) == {1, 2, 4} and port["ann_after"] == 404


async def test_two_vector_indexes_same_table():
    async def case(side):
        f = side.fake
        db = f.FakeDb()
        db.add_table(f.FakeTable("ks", "tbl", ("pk",)))
        db.add_index(f.FakeIndex(metadata=f.make_vs_metadata(index="ia", target_column="emb_a"),
                                 scan=[f.vector_row((pk,), v, 100) for pk, v in CO_ROWS]))
        db.add_index(f.FakeIndex(metadata=f.make_vs_metadata(index="ib", target_column="emb_b"),
                                 scan=[f.vector_row((pk,), [v[1], v[0], 1.0], 100) for pk, v in CO_ROWS]))
        service, client = await side.start(db)
        try:
            await wait_json(client, "/api/v1/indexes", lambda lst: index_names(lst) == {"ia", "ib"})
            await wait_json(client, "/api/v1/indexes/ks/ia/status", counted(6))
            await wait_json(client, "/api/v1/indexes/ks/ib/status", counted(6))
            qb = [CO_ROWS[2][1][1], CO_ROWS[2][1][0], 1.0]
            return [await post_json(client, "/api/v1/indexes/ks/ia/ann", {"vector": CO_ROWS[2][1], "limit": 1}),
                    await post_json(client, "/api/v1/indexes/ks/ib/ann", {"vector": qb, "limit": 1})]
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert [body["primary_keys"]["pk"] for _, body in port] == [[2], [2]]


# -- index_modify -------------------------------------------------------------------


def modify_rows(side, n: int, seed: int):
    import numpy as np

    vecs = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return [side.fake.vector_row((i,), vecs[i].tolist(), 100) for i in range(n)]


async def test_param_change_rebuilds_index():
    async def case(side):
        f, t = side.fake, side.types
        key = t.IndexKey("ks", "idx")
        db = f.FakeDb()
        db.add_table(f.FakeTable("ks", "tbl", ("pk",)))
        db.add_index(f.FakeIndex(metadata=f.make_vs_metadata(dimensions=3), scan=modify_rows(side, 12, 1)))
        service, client = await side.start(db)
        try:
            before = (await wait_json(client, "/api/v1/indexes/ks/idx/status", counted(12)))["count"]
            old_entry = service.indexes.get_vs(key)
            altered = f.make_vs_metadata(dimensions=3, expansion_search=t.ExpansionSearch(128),
                                         version=t.IndexVersion(_uuid.uuid1()))
            db.add_index(f.FakeIndex(metadata=altered, scan=modify_rows(side, 20, 2)))
            after = (await wait_json(client, "/api/v1/indexes/ks/idx/status", counted(20)))["count"]
            entry = service.indexes.get_vs(key)
            return {"counts": [before, after], "new_entry": entry is not old_entry,
                    "expansion_search": int(entry.metadata.vs_options.expansion_search),
                    "version_is_new": entry.metadata.version == altered.version}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == {"counts": [12, 20], "new_entry": True, "expansion_search": 128, "version_is_new": True}


async def test_drop_and_recreate():
    async def case(side):
        f, t = side.fake, side.types
        key = t.IndexKey("ks", "idx")
        db = f.FakeDb()
        db.add_table(f.FakeTable("ks", "tbl", ("pk",)))
        db.add_index(f.FakeIndex(metadata=f.make_vs_metadata(dimensions=3), scan=modify_rows(side, 8, 5)))
        service, client = await side.start(db)
        try:
            before = (await wait_json(client, "/api/v1/indexes/ks/idx/status", counted(8)))["count"]
            db.drop_index(key)
            deadline = asyncio.get_event_loop().time() + 10
            while service.indexes.get_vs(key) is not None:
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.05)
            dropped = (await post_json(client, "/api/v1/indexes/ks/idx/ann", {"vector": [1.0, 0.0, 0.0], "limit": 1}))[0]
            db.add_index(f.FakeIndex(metadata=f.make_vs_metadata(dimensions=3, version=t.IndexVersion(_uuid.uuid1())),
                                     scan=modify_rows(side, 16, 6)))
            after = (await wait_json(client, "/api/v1/indexes/ks/idx/status", counted(16)))["count"]
            return {"counts": [before, after], "ann_after_drop": dropped}
        finally:
            await stop(service, client)

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == {"counts": [8, 16], "ann_after_drop": 404}
