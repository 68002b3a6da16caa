"""Shared helpers of the twins of the reference's wire and validator suites
(tests/test_validator_*.py, test_https_mtls.py, test_reconnect.py,
test_alternator_e2e.py): one case runs on the JAX service and on the
port's (vector_store_tpu_torch.run.build_service on torch.device("cpu")),
each side over its own package's CQL client (CqlSession, ScyllaDb, the
CDC readers), fake CQL server and FakeDb, and the two runs' observations
are compared with torch_service_twins.assert_same.

``WireSide`` hands a case its own package's modules; ``schema_handler``
serves the query texts of tests/validator_common.py::make_schema_handler
with the side's own ``types``, ``FakeColumn`` and ``CannedResult``, so
nothing typed by the JAX package crosses into the port.
"""

import asyncio
import importlib
import json
import struct
import time
import uuid
from dataclasses import dataclass
from types import ModuleType

from aiohttp.test_utils import TestClient, TestServer

from torch_service_twins import CPU, TWIN_TIMEOUT_S

KS = "ks"
TBL = "tbl"
DIMS = 3


@dataclass(frozen=True)
class WireSide:
    """One package's wire stack, service and fakes."""

    name: str
    pkg: str

    def mod(self, path: str) -> ModuleType:
        return importlib.import_module(f"{self.pkg}.{path}")

    @property
    def ct(self):
        return self.mod("db.cql.types")

    @property
    def testing(self):
        return self.mod("db.cql.testing")

    @property
    def session_mod(self):
        return self.mod("db.cql.session")

    @property
    def scylla(self):
        return self.mod("db.scylla")

    @property
    def fake(self):
        return self.mod("db.fake")

    @property
    def types(self):
        return self.mod("core.types")

    @property
    def node_state(self):
        return self.mod("service.node_state")

    @property
    def run(self):
        return self.mod("run")

    def config(self, **kw):
        return self.mod("service.config").Config(**kw)

    async def build(self, db, config=None):
        config = config or self.config(monitor_indexes_interval=0.05)
        if self.name == "jax":
            return await self.run.build_service(db, config)
        return await self.run.build_service(db, config, device=CPU)

    async def serve(self, db, config):
        if self.name == "jax":
            return await self.run.serve(db, config)
        return await self.run.serve(db, config, device=CPU)

    async def start(self, db, config=None):
        """The service over ``db`` on a test server: (service, client)."""
        service = await self.build(db, config)
        client = TestClient(TestServer(service.app))
        await client.start_server()
        return service, client

    def vector_client(self, url: str):
        return self.mod("client").VectorStoreClient(url)


JAX = WireSide("jax", "vector_store_tpu")
PORT = WireSide("port", "vector_store_tpu_torch")


async def twin(case, timeout: float = TWIN_TIMEOUT_S):
    """Run ``case`` on the JAX side, then on the port's, together within
    ``timeout`` seconds; returns (jax observations, port observations)."""

    async def both():
        return await case(JAX), await case(PORT)

    return await asyncio.wait_for(both(), timeout)


def schema_handler(side: WireSide, rows=None, index_options=None, indexes=None):
    """tests/validator_common.py::make_schema_handler on ``side``'s types:
    the system tables of keyspace ks / table tbl with a custom vector index
    ``idx`` on column ``emb`` (vector<float, 3>); ``rows`` are (pk, vector,
    writetime_micros) full-scan rows, all in the range that holds token 0."""
    ct, CannedResult, FakeColumn = side.ct, side.testing.CannedResult, side.testing.FakeColumn
    schema_version = uuid.uuid4()
    scan_rows = rows if rows is not None else []

    def options_for(name: str) -> dict:
        base = {"class_name": "vector_index", "target": json.dumps({"tc": "emb"})}
        base.update(index_options or {})
        return base

    index_list = indexes if indexes is not None else [("idx", TBL, options_for("idx"))]

    def handler(cql, values, paging):
        if "system.group0_history" in cql:
            return CannedResult(columns=[FakeColumn("state_id", ct.T_TIMEUUID)], rows=[(uuid.uuid1(),)])
        if "schema_version" in cql:
            return CannedResult(
                columns=[FakeColumn("schema_version", ct.T_UUID)],
                rows=[(schema_version,)] if "system.local" in cql else [],
            )
        if "FROM system_schema.indexes" in cql:
            if "kind = 'CUSTOM'" in cql:
                return CannedResult(
                    columns=[
                        FakeColumn("keyspace_name", ct.T_VARCHAR),
                        FakeColumn("index_name", ct.T_VARCHAR),
                        FakeColumn("table_name", ct.T_VARCHAR),
                        FakeColumn("options", ct.T_MAP),
                    ],
                    rows=[(KS, name, tbl, opts) for name, tbl, opts in index_list],
                )
            want_index = None
            if values and len(values) >= 2 and values[1] is not None:
                want_index = values[1].decode("utf-8", "replace")
            name, tbl, opts = next((e for e in index_list if e[0] == want_index), index_list[0])
            if "table_name" in cql and "options" in cql:
                return CannedResult(
                    columns=[FakeColumn("table_name", ct.T_VARCHAR), FakeColumn("options", ct.T_MAP)],
                    rows=[(tbl, opts)],
                )
            if "options" in cql:
                return CannedResult(columns=[FakeColumn("options", ct.T_MAP)], rows=[(opts,)])
            return CannedResult(columns=[FakeColumn("table_name", ct.T_VARCHAR)], rows=[(tbl,)])
        if "FROM system_schema.columns" in cql:
            table = None
            if values and len(values) >= 2 and values[1] is not None:
                table = values[1].decode("utf-8", "replace")
            cols = [
                FakeColumn("column_name", ct.T_VARCHAR),
                FakeColumn("kind", ct.T_VARCHAR),
                FakeColumn("position", ct.T_INT),
                FakeColumn("type", ct.T_VARCHAR),
            ]
            if table and "_scylla_cdc_log" in table:
                return CannedResult(
                    columns=cols,
                    rows=[
                        ("cdc$stream_id", "partition_key", 0, "blob"),
                        ("cdc$time", "clustering", 0, "timeuuid"),
                        ("pk", "regular", -1, "int"),
                    ],
                )
            if "column_name = ?" in cql:
                return CannedResult(columns=[FakeColumn("type", ct.T_VARCHAR)], rows=[(f"vector<float, {DIMS}>",)])
            return CannedResult(
                columns=cols,
                rows=[("pk", "partition_key", 0, "int"), ("emb", "regular", -1, f"vector<float, {DIMS}>")],
            )
        if "tokens" in cql:
            return CannedResult(
                columns=[FakeColumn("tokens", ct.T_SET, sub_type_id=ct.T_VARCHAR)],
                rows=[(["0"],)] if "system.local" in cql else [],
            )
        if "BYPASS CACHE" in cql:
            lo = struct.unpack("!q", values[0])[0]
            cols = [
                FakeColumn("pk", ct.T_INT),
                FakeColumn("emb", ct.T_VECTOR, vector_dim=DIMS),
                FakeColumn("wt", ct.T_BIGINT),
            ]
            if lo > 0:
                return CannedResult(columns=cols, rows=[])
            return CannedResult(columns=cols, rows=[(pk, vec, wt) for pk, vec, wt in scan_rows])
        if "_scylla_cdc_log" in cql or "cdc_generation" in cql or "cdc_streams" in cql:
            return CannedResult(columns=[FakeColumn("cdc$time", ct.T_TIMEUUID)], rows=[])
        return None

    return handler


class WireService:
    """tests/validator_common.py::WireService on ``side``: fake CQL server +
    CqlSession + ScyllaDb + service + HTTP test client."""

    def __init__(self, side: WireSide, handler, config=None, require_auth=None, **session_kw):
        self.side = side
        self.handler = handler
        self.config = config or side.config(monitor_indexes_interval=0.05)
        self.require_auth = require_auth
        self.configure_server = session_kw.pop("configure_server", None)
        self.session_kw = session_kw
        self.server = self.session = self.service = self.http = None

    async def __aenter__(self):
        side = self.side
        self.server = side.testing.FakeCqlServer(self.handler, require_auth=self.require_auth)
        if self.configure_server is not None:
            self.configure_server(self.server)
        await self.server.start()
        self.session = side.session_mod.CqlSession(f"127.0.0.1:{self.server.port}", **self.session_kw)
        self.session.start()
        db = side.scylla.ScyllaDb(self.session, cdc_fine_safety_interval=0.0, cdc_fine_sleep_interval=0.05)
        self.service = await side.build(db, self.config)
        self.http = TestClient(TestServer(self.service.app))
        await self.http.start_server()
        return self

    async def __aexit__(self, *exc):
        if self.http:
            await self.http.close()
        if self.service:
            await self.service.stop()
        if self.session:
            await self.session.stop()
        if self.server:
            await self.server.stop()

    async def wait_serving(self, timeout: float = 20.0) -> None:
        serving = self.side.node_state.NodeStatus.SERVING
        deadline = time.time() + timeout
        while self.service.node_state.get_status() is not serving:
            assert time.time() < deadline, f"node stuck in {self.service.node_state.get_status()}"
            await asyncio.sleep(0.05)

    async def wait_index_count(self, key, n: int, timeout: float = 20.0) -> None:
        serving = self.side.node_state.IndexStatus.SERVING
        deadline = time.time() + timeout
        while True:
            entry = self.service.indexes.get_vs(key)
            if entry is not None and await entry.actor.count() >= n and entry.status is serving:
                return
            assert time.time() < deadline
            self.service.engine.update_entries()
            await asyncio.sleep(0.05)


async def wait_json(client, path: str, pred, timeout: float = 20.0):
    """Until GET ``path`` answers 200 with a body ``pred`` holds for."""
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        resp = await client.get(path)
        if resp.status == 200:
            body = await resp.json()
            if pred(body):
                return body
        assert asyncio.get_event_loop().time() < deadline, (path, resp.status)
        await asyncio.sleep(0.05)


async def post_json(client, path: str, body: dict):
    """(status, JSON body or text) of a POST."""
    resp = await client.post(path, json=body)
    text = await resp.text()
    try:
        return resp.status, json.loads(text)
    except ValueError:
        return resp.status, text
