"""Twins of the reference's Alternator end-to-end suite
(tests/test_alternator_e2e.py): discovery -> full scan -> ANN serving over
an ``alternator_`` keyspace (attributes read from the ':attrs' map, vector
blobs with type tags 4 = JSON array and 5 = big-endian f32s, dimensions
from index options) and CDC over that dialect. Each case runs on the JAX
service and on the port's (run.build_service on torch.device("cpu")), each
over its own package's CqlSession, ScyllaDb and fake CQL server, serving
the reference's query texts with its own types (tests/torch_wire_twins.py).

| reference case | port test |
|---|---|
| TestAlternatorEndToEnd::test_discovery_scan_and_ann | test_discovery_scan_and_ann |
| TestAlternatorCdc::test_cdc_insert_update_delete_on_attrs_rows | test_cdc_insert_update_delete_on_attrs_rows |
| TestAlternatorCdc::test_unrelated_attribute_update_does_not_deindex | test_unrelated_attribute_update_does_not_deindex |
| TestAlternatorCdc::test_vector_attribute_removal_deindexes | test_vector_attribute_removal_deindexes |
| TestAlternatorCdc::test_wrong_dimension_vectors_never_index | test_wrong_dimension_vectors_never_index |
| TestAlternatorCdc::test_batch_write_mixed_validity | test_batch_write_mixed_validity |
| TestAlternatorTableLifecycle::test_index_deleted_via_update_table_is_dropped | test_index_deleted_via_update_table_is_dropped |
| TestAlternatorTableLifecycle::test_bad_dimension_option_skips_only_that_index | test_bad_dimension_option_skips_only_that_index |
| TestAlternatorTableLifecycle::test_boundary_dimension_one | test_boundary_dimension_one |
| TestAlternatorTableLifecycle::test_bad_blob_tag_rows_are_skipped | test_bad_blob_tag_rows_are_skipped |
| TestAlternatorReadSideSemantics::test_update_item_vector_element_operations | test_update_item_vector_element_operations |
| TestAlternatorReadSideSemantics::test_batch_write_puts_and_deletes_in_one_batch | test_batch_write_puts_and_deletes_in_one_batch |
| TestAlternatorReadSideSemantics::test_ttl_expiry_cdc_delete_removes_then_reput_reindexes | test_ttl_expiry_cdc_delete_removes_then_reput_reindexes |
| TestAlternatorReadSideSemantics::test_lwt_write_flow_indexes_and_updates | test_lwt_write_flow_indexes_and_updates |

Each twin runs the reference case's steps on both services and keeps its
assertions on the port's run. Tolerance: primary keys, counts, statuses
and node states are equal; distances within 1e-6 * (1 + |x|)
(torch_service_twins.assert_same). An answer whose rows tie (the unit
vectors' equal distances) compares as a map from key to distance: each
package orders equal distances its own way. Every twin is bounded by 60 s.
"""

import asyncio
import json
import struct
import time
import uuid

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("aiohttp")

from aiohttp.test_utils import TestServer  # noqa: E402

from torch_service_twins import assert_same  # noqa: E402
from torch_wire_twins import twin  # noqa: E402

KS = "alternator_items"
TBL = "items"
DIMS = 3
VECS = {"a": [1.0, 0.0, 0.0], "b": [0.0, 1.0, 0.0], "c": [0.0, 0.0, 1.0]}


def blob_f32(vec):
    """Alternator attribute blob, type tag 5: big-endian f32 array."""
    return bytes([5]) + struct.pack(f"!{len(vec)}f", *vec)


def blob_json(vec):
    """Type tag 4: JSON array."""
    return bytes([4]) + json.dumps(vec).encode()


def index_options(dimension=str(DIMS)):
    return {"class_name": "vector_index", "target": json.dumps({"tc": "v"}), "dimension": dimension}


def make_handler(side, dimension=str(DIMS), state=None):
    """The reference's make_handler (``state`` None: the three static rows)
    and make_live_handler (``state``: {"rows": {p: (blob, writetime)},
    "cdc": [(timeuuid, op, p)], optional "index_present"}) on ``side``."""
    t, ct = side.testing, side.ct
    schema_version = uuid.uuid4()
    idx_options = index_options(dimension)
    scan_cols = [t.FakeColumn("p", ct.T_VARCHAR), t.FakeColumn("v", ct.T_BLOB), t.FakeColumn("wt", ct.T_BIGINT)]
    index_cols = [t.FakeColumn("keyspace_name", ct.T_VARCHAR), t.FakeColumn("index_name", ct.T_VARCHAR),
                  t.FakeColumn("table_name", ct.T_VARCHAR), t.FakeColumn("options", ct.T_MAP)]

    def static_rows():
        return [("a", blob_f32(VECS["a"]), 1_000_000), ("b", blob_f32(VECS["b"]), 1_000_000),
                ("c", blob_json(VECS["c"]), 1_000_000)]

    def handler(cql, values, paging):
        if state is not None:
            if "cdc$operation" in cql and "SELECT" in cql:
                rows, state["cdc"] = state["cdc"], []
                return t.CannedResult(
                    columns=[t.FakeColumn("cdc$time", ct.T_TIMEUUID), t.FakeColumn("cdc$operation", ct.T_TINYINT),
                             t.FakeColumn("p", ct.T_VARCHAR)],
                    rows=rows,
                )
            if 'WHERE "p" = ?' in cql and "BYPASS" not in cql:
                entry = state["rows"].get(values[0].decode())
                return t.CannedResult(columns=[t.FakeColumn("v", ct.T_BLOB), t.FakeColumn("wt", ct.T_BIGINT)],
                                      rows=[] if entry is None else [entry])
            if "kind = 'CUSTOM'" in cql and not state.get("index_present", True):
                return t.CannedResult(columns=index_cols, rows=[])
        if "system.group0_history" in cql:
            return t.CannedResult(columns=[t.FakeColumn("state_id", ct.T_TIMEUUID)], rows=[(uuid.uuid1(),)])
        if "schema_version" in cql:
            return t.CannedResult(columns=[t.FakeColumn("schema_version", ct.T_UUID)],
                                  rows=[(schema_version,)] if "system.local" in cql else [])
        if "FROM system_schema.indexes" in cql:
            if "kind = 'CUSTOM'" in cql:
                return t.CannedResult(columns=index_cols, rows=[(KS, "idx", TBL, dict(idx_options))])
            if "table_name" in cql and "options" in cql:
                return t.CannedResult(columns=[t.FakeColumn("table_name", ct.T_VARCHAR),
                                               t.FakeColumn("options", ct.T_MAP)], rows=[(TBL, dict(idx_options))])
            if "options" in cql:
                return t.CannedResult(columns=[t.FakeColumn("options", ct.T_MAP)], rows=[(dict(idx_options),)])
            return t.CannedResult(columns=[t.FakeColumn("table_name", ct.T_VARCHAR)], rows=[(TBL,)])
        if "FROM system_schema.columns" in cql:
            table = values[1].decode("utf-8", "replace") if values and len(values) >= 2 and values[1] else None
            cols = [t.FakeColumn("column_name", ct.T_VARCHAR), t.FakeColumn("kind", ct.T_VARCHAR),
                    t.FakeColumn("position", ct.T_INT), t.FakeColumn("type", ct.T_VARCHAR)]
            if table and "_scylla_cdc_log" in table:
                return t.CannedResult(columns=cols, rows=[("cdc$stream_id", "partition_key", 0, "blob"),
                                                          ("cdc$time", "clustering", 0, "timeuuid"),
                                                          ("p", "regular", -1, "text")])
            return t.CannedResult(columns=cols, rows=[("p", "partition_key", 0, "text"),
                                                      (":attrs", "regular", -1, "map<text, blob>")])
        if "tokens" in cql:
            return t.CannedResult(columns=[t.FakeColumn("tokens", ct.T_SET, sub_type_id=ct.T_VARCHAR)],
                                  rows=[(["0"],)] if "system.local" in cql else [])
        if "BYPASS CACHE" in cql:
            assert '":attrs"' in cql and "writetime" in cql, cql
            if struct.unpack("!q", values[0])[0] > 0:
                return t.CannedResult(columns=scan_cols, rows=[])
            rows = static_rows() if state is None else [(p, b, w) for p, (b, w) in state["rows"].items()]
            return t.CannedResult(columns=scan_cols, rows=rows)
        if "_scylla_cdc_log" in cql or "cdc_generation" in cql or "cdc_streams" in cql:
            return t.CannedResult(columns=[t.FakeColumn("cdc$time", ct.T_TIMEUUID)], rows=[])
        return None

    return handler


class Alternator:
    """The reference's _boot_alternator / _teardown / _wait_count on a side."""

    def __init__(self, side, handler, fine_cdc=True):
        self.side, self.handler, self.fine_cdc = side, handler, fine_cdc

    async def __aenter__(self):
        side = self.side
        self.server = side.testing.FakeCqlServer(self.handler)
        await self.server.start()
        self.session = side.session_mod.CqlSession(f"127.0.0.1:{self.server.port}")
        self.session.start()
        kw = {"cdc_fine_safety_interval": 0.0, "cdc_fine_sleep_interval": 0.05} if self.fine_cdc else {}
        self.service = await side.build(side.scylla.ScyllaDb(self.session, **kw))
        self.http = TestServer(self.service.app)
        await self.http.start_server()
        self.url = f"http://127.0.0.1:{self.http.port}"
        return self

    async def __aexit__(self, *exc):
        await self.http.close()
        await self.service.stop()
        await self.session.stop()
        await self.server.stop()

    async def wait_count(self, n, deadline_s=20):
        serving = self.side.node_state.IndexStatus.SERVING
        deadline = time.time() + deadline_s
        while True:
            entry = self.service.indexes.get_vs((KS, "idx"))
            if entry is not None and entry.status is serving and await entry.actor.count() == n:
                return n
            assert time.time() < deadline, entry and (entry.status, await entry.actor.count())
            self.service.engine.update_entries()
            await asyncio.sleep(0.05)

    async def ann(self, vector, limit):
        async with self.side.vector_client(self.url) as client:
            res = await client.ann(KS, "idx", vector, limit=limit)
            return {"p": res.primary_keys["p"], "distances": list(res.distances)}

    async def ann_map(self, vector, limit):
        """The answer as a map from key to distance: keys at equal distances
        come in either package's own order."""
        res = await self.ann(vector, limit)
        return dict(zip(res["p"], res["distances"]))

    async def ann_until(self, vector, p, timeout=10):
        """Until ``p`` answers ``vector`` first within 1e-3."""
        deadline = time.time() + timeout
        while True:
            res = await self.ann(vector, 1)
            if res["p"] == [p] and res["distances"][0] < 1e-3:
                return res
            assert time.time() < deadline
            await asyncio.sleep(0.05)


def live_state(**rows):
    return {"rows": dict(rows), "cdc": []}


def cdc(state, op, p):
    state["cdc"].append((uuid.uuid1(), op, p))


# -- discovery, scan, ANN -----------------------------------------------------------


async def test_discovery_scan_and_ann():
    async def case(side):
        async with Alternator(side, make_handler(side), fine_cdc=False) as alt:
            deadline = time.time() + 20
            while alt.service.node_state.get_status() is not side.node_state.NodeStatus.SERVING:
                assert time.time() < deadline
                await asyncio.sleep(0.05)
            dims = int(alt.service.indexes.get_vs((KS, "idx")).metadata.vs_options.dimensions)
            await alt.wait_count(3)
            return {"dims": dims, "answers": {name: await alt.ann(vec, 1) for name, vec in VECS.items()}}

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["dims"] == DIMS and all(port["answers"][name]["p"] == [name] for name in VECS)


# -- CDC over the ':attrs' dialect --------------------------------------------------


async def test_cdc_insert_update_delete_on_attrs_rows():
    async def case(side):
        s = side.scylla
        state = live_state(a=(blob_f32(VECS["a"]), 1_000_000), b=(blob_f32(VECS["b"]), 1_000_000),
                           c=(blob_json(VECS["c"]), 1_000_000))
        async with Alternator(side, make_handler(side, state=state)) as alt:
            out = {"start": await alt.wait_count(3)}
            vd = [0.5, 0.5, 0.0]
            state["rows"]["d"] = (blob_f32(vd), 2_000_000)
            cdc(state, s.CDC_OP_INSERT, "d")
            out["after_insert"] = await alt.wait_count(4)
            out["insert"] = await alt.ann(vd, 1)
            vb2 = [0.1, 0.9, 0.1]
            state["rows"]["b"] = (blob_json(vb2), 3_000_000)
            cdc(state, s.CDC_OP_UPDATE, "b")
            out["update"] = await alt.ann_until(vb2, "b")
            del state["rows"]["a"]
            cdc(state, s.CDC_OP_ROW_DELETE, "a")
            out["after_delete"] = await alt.wait_count(3)
            out["deleted"] = await alt.ann_map(VECS["a"], 3)
            cdc(state, s.CDC_OP_INSERT, "zz")  # its read-back finds no row: a delete
            await asyncio.sleep(0.5)
            out["after_missing"] = await alt.wait_count(3)
            return out

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["insert"]["p"] == ["d"] and "a" not in port["deleted"]
    assert [port[k] for k in ("start", "after_insert", "after_delete", "after_missing")] == [3, 4, 3, 3]


async def test_unrelated_attribute_update_does_not_deindex():
    async def case(side):
        s = side.scylla
        state = live_state(a=(blob_f32(VECS["a"]), 1_000_000), b=(blob_f32(VECS["b"]), 1_000_000),
                           c=(blob_json(VECS["c"]), 1_000_000))
        async with Alternator(side, make_handler(side, state=state)) as alt:
            await alt.wait_count(3)
            cdc(state, s.CDC_OP_UPDATE, "a")  # an unrelated attribute: the row unchanged
            state["rows"]["d"] = (blob_f32([0.5, 0.5, 0.0]), 2_000_000)
            cdc(state, s.CDC_OP_INSERT, "d")  # the ordering barrier behind it
            return {"count": await alt.wait_count(4), "a": await alt.ann(VECS["a"], 1)}

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["count"] == 4 and port["a"]["p"] == ["a"] and port["a"]["distances"][0] < 1e-3


async def test_vector_attribute_removal_deindexes():
    async def case(side):
        state = live_state(a=(blob_f32(VECS["a"]), 1_000_000), b=(blob_f32(VECS["b"]), 1_000_000))
        async with Alternator(side, make_handler(side, state=state)) as alt:
            await alt.wait_count(2)
            state["rows"]["b"] = (None, None)  # the item stays, its vector attribute is gone
            cdc(state, side.scylla.CDC_OP_UPDATE, "b")
            return {"count": await alt.wait_count(1), "b": await alt.ann(VECS["b"], 2)}

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["count"] == 1 and port["b"]["p"] == ["a"]


async def test_wrong_dimension_vectors_never_index():
    async def case(side):
        state = live_state(a=(blob_f32(VECS["a"]), 1_000_000), short=(blob_f32([1.0, 0.0]), 1_000_000),
                           long=(blob_f32([1.0, 0.0, 0.0, 0.0]), 1_000_000), b=(blob_f32(VECS["b"]), 1_000_000))
        async with Alternator(side, make_handler(side, state=state)) as alt:
            out = {"start": await alt.wait_count(2), "scan": await alt.ann(VECS["a"], 4)}
            state["rows"]["a"] = (blob_f32([9.9] * 7), 2_000_000)
            cdc(state, side.scylla.CDC_OP_UPDATE, "a")
            out["after"] = await alt.wait_count(1)
            out["a"] = await alt.ann(VECS["a"], 2)
            return out

    jax, port = await twin(case)
    assert_same(port, jax)
    assert set(port["scan"]["p"]) == {"a", "b"} and port["after"] == 1 and port["a"]["p"] == ["b"]


async def test_batch_write_mixed_validity():
    vd, ve = [0.5, 0.5, 0.0], [0.0, 0.5, 0.5]

    async def case(side):
        s = side.scylla
        state = live_state(a=(blob_f32(VECS["a"]), 1_000_000))
        async with Alternator(side, make_handler(side, state=state)) as alt:
            await alt.wait_count(1)
            state["rows"].update(d=(blob_f32(vd), 2_000_000), bad=(bytes([9]) + b"junk", 2_000_000),
                                 e=(blob_json(ve), 2_000_000))
            for p in ("d", "bad", "e"):
                cdc(state, s.CDC_OP_INSERT, p)
            return {"count": await alt.wait_count(3), "d": await alt.ann(vd, 1), "e": await alt.ann(ve, 1)}

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["count"] == 3 and port["d"]["p"] == ["d"] and port["e"]["p"] == ["e"]


# -- table lifecycle ----------------------------------------------------------------


async def test_index_deleted_via_update_table_is_dropped():
    async def case(side):
        state = live_state(a=(blob_f32(VECS["a"]), 1_000_000), b=(blob_f32(VECS["b"]), 1_000_000))
        async with Alternator(side, make_handler(side, state=state)) as alt:
            await alt.wait_count(2)
            state["index_present"] = False
            deadline = time.time() + 10
            while alt.service.indexes.get_vs((KS, "idx")) is not None:
                assert time.time() < deadline
                await asyncio.sleep(0.05)
            import aiohttp

            async with aiohttp.ClientSession() as s:
                async with s.post(f"{alt.url}/api/v1/indexes/{KS}/idx/ann",
                                  json={"vector": VECS["a"], "limit": 1}) as resp:
                    return resp.status

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == 404


async def test_bad_dimension_option_skips_only_that_index():
    async def case(side):
        t, ct = side.testing, side.ct
        base = make_handler(side)
        bad = index_options("oops")

        def handler(cql, values, paging):
            if "FROM system_schema.indexes" in cql and "kind = 'CUSTOM'" in cql:
                return t.CannedResult(
                    columns=[t.FakeColumn("keyspace_name", ct.T_VARCHAR), t.FakeColumn("index_name", ct.T_VARCHAR),
                             t.FakeColumn("table_name", ct.T_VARCHAR), t.FakeColumn("options", ct.T_MAP)],
                    rows=[(KS, "badidx", TBL, dict(bad)), (KS, "idx", TBL, index_options())],
                )
            if "FROM system_schema.indexes" in cql and values and len(values) >= 2:
                if values[1].decode("utf-8", "replace") == "badidx":
                    if "table_name" in cql and "options" in cql:
                        return t.CannedResult(columns=[t.FakeColumn("table_name", ct.T_VARCHAR),
                                                       t.FakeColumn("options", ct.T_MAP)], rows=[(TBL, dict(bad))])
                    if "options" in cql:
                        return t.CannedResult(columns=[t.FakeColumn("options", ct.T_MAP)], rows=[(dict(bad),)])
                    return t.CannedResult(columns=[t.FakeColumn("table_name", ct.T_VARCHAR)], rows=[(TBL,)])
            return base(cql, values, paging)

        async with Alternator(side, handler, fine_cdc=False) as alt:
            count = await alt.wait_count(3)
            return {"count": count, "badidx_served": alt.service.indexes.get_vs((KS, "badidx")) is not None,
                    "node": alt.service.node_state.get_status().name}

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == {"count": 3, "badidx_served": False, "node": "SERVING"}


async def test_boundary_dimension_one():
    async def case(side):
        state = live_state(lo=(blob_f32([-1.0]), 1_000_000), hi=(blob_f32([1.0]), 1_000_000))
        async with Alternator(side, make_handler(side, dimension="1", state=state)) as alt:
            return {"count": await alt.wait_count(2), "hi": await alt.ann([0.9], 1)}

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["count"] == 2 and port["hi"]["p"] == ["hi"]


async def test_bad_blob_tag_rows_are_skipped():
    async def case(side):
        state = live_state(a=(blob_f32(VECS["a"]), 1_000_000), bad=(bytes([9]) + b"garbage", 1_000_000),
                           b=(blob_f32(VECS["b"]), 1_000_000))
        async with Alternator(side, make_handler(side, state=state)) as alt:
            return {"count": await alt.wait_count(2), "a": await alt.ann(VECS["a"], 2)}

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["count"] == 2 and "bad" not in port["a"]["p"]


# -- read-side semantics ------------------------------------------------------------


async def test_update_item_vector_element_operations():
    va2, va3 = [1.0, 0.0, 0.8], [0.0, 0.0, 0.8]

    async def case(side):
        state = live_state(a=(blob_f32(VECS["a"]), 1_000_000), b=(blob_f32(VECS["b"]), 1_000_000))
        async with Alternator(side, make_handler(side, state=state)) as alt:
            await alt.wait_count(2)
            state["rows"]["a"] = (blob_f32(va2), 2_000_000)  # SET vec[2] = 0.8
            cdc(state, side.scylla.CDC_OP_UPDATE, "a")
            out = {"updated": await alt.ann_until(va2, "a"), "old": await alt.ann(VECS["a"], 1)}
            state["rows"]["a"] = (blob_f32(va3), 3_000_000)  # SET vec[0] = 0
            cdc(state, side.scylla.CDC_OP_UPDATE, "a")
            out["updated_again"] = await alt.ann_until(va3, "a")
            return out

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["old"]["p"] == ["a"] and port["old"]["distances"][0] > 1e-3


async def test_batch_write_puts_and_deletes_in_one_batch():
    vd, ve = [0.5, 0.5, 0.0], [0.0, 0.5, 0.5]

    async def case(side):
        s = side.scylla
        state = live_state(a=(blob_f32(VECS["a"]), 1_000_000), b=(blob_f32(VECS["b"]), 1_000_000),
                           c=(blob_json(VECS["c"]), 1_000_000))
        async with Alternator(side, make_handler(side, state=state)) as alt:
            await alt.wait_count(3)
            state["rows"].update(d=(blob_f32(vd), 2_000_000), e=(blob_f32(ve), 2_000_000))
            del state["rows"]["a"]
            cdc(state, s.CDC_OP_INSERT, "d")
            cdc(state, s.CDC_OP_INSERT, "e")
            cdc(state, s.CDC_OP_ROW_DELETE, "a")
            return {"count": await alt.wait_count(4), "d": await alt.ann(vd, 1), "e": await alt.ann(ve, 1),
                    "a": await alt.ann_map(VECS["a"], 4)}

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["count"] == 4 and port["d"]["p"] == ["d"] and port["e"]["p"] == ["e"]
    assert "a" not in port["a"]


async def test_ttl_expiry_cdc_delete_removes_then_reput_reindexes():
    vc2 = [0.2, 0.2, 0.9]

    async def case(side):
        s = side.scylla
        state = live_state(a=(blob_f32(VECS["a"]), 1_000_000), b=(blob_f32(VECS["b"]), 1_000_000),
                           c=(blob_json(VECS["c"]), 1_000_000))
        async with Alternator(side, make_handler(side, state=state)) as alt:
            await alt.wait_count(3)
            del state["rows"]["c"]  # the TTL fires: a CDC delete
            cdc(state, s.CDC_OP_ROW_DELETE, "c")
            out = {"expired": await alt.wait_count(2), "c": await alt.ann_map(VECS["c"], 3)}
            # the re-put is newer than the tombstone's real-clock timestamp
            state["rows"]["c"] = (blob_f32(vc2), int(time.time() * 1e6) + 10_000_000)
            cdc(state, s.CDC_OP_INSERT, "c")
            out["reput"] = await alt.wait_count(3)
            out["c2"] = await alt.ann(vc2, 1)
            return out

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["expired"] == 2 and set(port["c"]) == {"a", "b"}
    assert port["reput"] == 3 and port["c2"]["p"] == ["c"] and port["c2"]["distances"][0] < 1e-3


async def test_lwt_write_flow_indexes_and_updates():
    va, vb, va2 = [1.0, 2.0, 4.0], [4.0, 2.0, 1.0], [9.0, 9.0, 9.0]

    async def case(side):
        s = side.scylla
        state = live_state()
        async with Alternator(side, make_handler(side, state=state)) as alt:
            await alt.wait_count(0)
            state["rows"]["item-a"] = (blob_f32(va), 1_000_000)
            cdc(state, s.CDC_OP_INSERT, "item-a")
            state["rows"]["item-b"] = (blob_f32(vb), 1_000_001)
            cdc(state, s.CDC_OP_INSERT, "item-b")
            out = {"put": await alt.wait_count(2)}
            del state["rows"]["item-b"]
            cdc(state, s.CDC_OP_ROW_DELETE, "item-b")
            out["deleted"] = await alt.wait_count(1)
            out["b"] = await alt.ann(vb, 2)
            state["rows"]["item-a"] = (blob_f32(va2), 1_000_002)
            cdc(state, s.CDC_OP_UPDATE, "item-a")
            out["updated"] = await alt.ann_until(va2, "item-a")
            return out

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["put"] == 2 and port["deleted"] == 1 and port["b"]["p"] == ["item-a"]
