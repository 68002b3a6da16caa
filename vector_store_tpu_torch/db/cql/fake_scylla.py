"""A fake ScyllaDB node on the CQL wire: one keyspace, one table and one
vector index, for driving the service as it is deployed (``run.main``:
``CqlSession`` with auth, ``ScyllaDb`` schema discovery, the parallel
token-range full scan, the two CDC readers and their base-row reads)
without a cluster.

The node answers every query text ``db/scylla.py`` sends:

- ``system.group0_history``, the schema versions, ``system_schema.indexes``
  and ``system_schema.columns`` for ``ks.tbl`` with ``pk bigint`` and
  ``emb vector<float, d>`` under a custom ``vector_index`` (default
  options: COSINE, F32, global), and the CDC log table's columns;
- ``system.local`` with TOKENS ring tokens and an empty ``system.peers``;
- the full scan (``range_scan_query``): the rows whose synthetic token
  (a splitmix64 hash of the key) lies in [lo, hi], in token order, paged at
  the page size the client asks for (or at ``page_rows``, if smaller: a
  node's own page limit) through ``paging_state``. Rows are
  encoded once, when the node is made, as the wire's cells in token order,
  so a page is one slice of bytes;
- the CDC generation and stream tables (one generation of STREAMS
  streams) and the log table, read a stream and a time window at a time;
- the base-row read that follows a CDC row (``request_query``).

``write`` upserts a row and appends its CDC log entry (a timeuuid of the
real clock, on the key's stream). A write of a stored key updates its
scanned cells in place; keys added later are answered by base reads and
the CDC log only, not by later scans.

``node_process`` runs a node in a process of its own (started with the
``spawn`` method), driven through a ``multiprocessing`` pipe.
"""

from __future__ import annotations

import asyncio
import datetime
import json
import struct
import time
import uuid

import numpy as np

from vector_store_tpu_torch.db.cql import frame as fr
from vector_store_tpu_torch.db.cql import types as ct
from vector_store_tpu_torch.db.cql.frame import Reader, Writer
from vector_store_tpu_torch.db.cql.testing import (
    CannedResult,
    FakeColumn,
    FakeCqlServer,
    encode_rows,
    encode_void,
)

KEYSPACE, TABLE, INDEX, COLUMN = "ks", "tbl", "idx", "emb"
TOKENS, STREAMS = 16, 4  # ring tokens of system.local; CDC streams of the one generation
# cdc$operation codes (db/scylla.py)
CDC_OP_UPDATE, CDC_OP_INSERT = 1, 2
SCAN_WRITETIME = 1_000_000  # micros: every scanned row's writetime

_U64 = np.uint64


def token_of(keys: np.ndarray) -> np.ndarray:
    """Synthetic partition tokens: splitmix64 of the key, as int64."""
    z = keys.astype(np.uint64) + _U64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
    return (z ^ (z >> _U64(31))).view(np.int64)


class ScyllaNode:
    """The node's data and its answers; ``respond`` is the handler."""

    def __init__(self, vectors: np.ndarray, page_rows: int | None = None) -> None:
        n, d = vectors.shape
        self.n, self.dims = n, d
        self.schema_version = uuid.uuid4()
        self.state_id = uuid.uuid1()
        edges = np.linspace(-(2.0**63), 2.0**63, TOKENS + 2)[1:-1]
        self.ring = [str(int(t)) for t in edges]
        self.streams = [struct.pack(">QQ", 0x5CD1, i) for i in range(STREAMS)]
        self.generation = datetime.datetime.fromtimestamp(
            int(time.time()) - 3600, tz=datetime.timezone.utc
        )
        self.page_rows = page_rows
        self.log: list[tuple[uuid.UUID, int, int]] = []  # (cdc$time, op, pk)
        self.added: dict[int, tuple[np.ndarray, int]] = {}  # keys >= n
        self.pages = 0
        self.rows_served = 0

        keys = np.arange(n, dtype=np.int64)
        toks = token_of(keys)
        order = np.argsort(toks, kind="stable")
        self.tokens = toks[order]
        self.slot = np.empty(n, dtype=np.int64)  # key -> its cell row in token order
        self.slot[order] = keys
        # the wire's cells of (pk bigint, emb vector<float, d>, writetime
        # bigint), each a 4-byte length and its bytes, in token order
        self.cells = np.empty(
            n,
            dtype=[("l0", ">i4"), ("pk", ">i8"), ("l1", ">i4"), ("emb", ">f4", (d,)),
                   ("l2", ">i4"), ("wt", ">i8")],
        )
        self.cells["l0"], self.cells["l1"], self.cells["l2"] = 8, 4 * d, 8
        self.cells["pk"] = order
        self.cells["emb"] = vectors[order]
        self.cells["wt"] = SCAN_WRITETIME
        self.scan_columns = [
            FakeColumn("pk", ct.T_BIGINT),
            FakeColumn(COLUMN, ct.T_VECTOR, vector_dim=d),
            FakeColumn("wt", ct.T_BIGINT),
        ]

    # -- writes ---------------------------------------------------------------

    def write(self, pk: int, vector, writetime: int | None = None) -> None:
        """Upsert ``pk``'s vector (at ``writetime`` micros, by default now)
        and log it: an INSERT for a new key, an UPDATE for a stored one."""
        wt = int(time.time() * 1e6) if writetime is None else writetime
        vec = np.asarray(vector, dtype=np.float32)
        if 0 <= pk < self.n:
            i = self.slot[pk]
            self.cells["emb"][i], self.cells["wt"][i] = vec, wt
            op = CDC_OP_UPDATE
        else:
            op = CDC_OP_UPDATE if pk in self.added else CDC_OP_INSERT
            self.added[pk] = (vec, wt)
        self.log.append((uuid.uuid1(), op, pk))

    def current(self, pk: int) -> tuple[np.ndarray, int] | None:
        if 0 <= pk < self.n:
            i = self.slot[pk]
            return self.cells["emb"][i].astype(np.float32), int(self.cells["wt"][i])
        return self.added.get(pk)

    # -- answers --------------------------------------------------------------

    def respond(self, cql: str, values: list, paging: bytes | None, page_size: int | None) -> bytes:
        """The RESULT body answering one query."""
        if "BYPASS CACHE" in cql:
            return self._scan(values, paging, page_size)
        if "_scylla_cdc_log" in cql and "cdc$operation" in cql:
            return encode_rows(self._log_rows(values))
        result = self._schema(cql, values)
        if result is None and 'WHERE "pk" = ?' in cql:
            result = self._base_row(values)
        return encode_void() if result is None else encode_rows(result)

    def _scan(self, values: list, paging: bytes | None, page_size: int | None) -> bytes:
        # the paging state is the next row's place in token order
        lo, hi = (struct.unpack("!q", v)[0] for v in values[:2])
        start = int(np.searchsorted(self.tokens, lo, "left"))
        end = int(np.searchsorted(self.tokens, hi, "right"))
        if paging is not None:
            start = max(start, struct.unpack("!q", paging)[0])
        limit = min((p for p in (page_size, self.page_rows) if p), default=None)
        stop = end if limit is None else min(end, start + limit)
        more = struct.pack("!q", stop) if stop < end else None
        # the rows metadata with no rows: its last 4 bytes are the row count
        head = encode_rows(CannedResult(self.scan_columns, [], more))[:-4]
        self.pages += 1
        self.rows_served += stop - start
        return head + struct.pack("!i", stop - start) + self.cells[start:stop].tobytes()

    def _log_rows(self, values: list) -> CannedResult:
        sid = bytes(values[0])
        t0, t1 = (uuid.UUID(bytes=bytes(v)).time for v in values[1:3])
        k = self.streams.index(sid) if sid in self.streams else -1
        rows = [(t, op, pk) for t, op, pk in self.log if t0 < t.time < t1 and pk % STREAMS == k]
        return CannedResult(
            columns=[
                FakeColumn("cdc$time", ct.T_TIMEUUID),
                FakeColumn("cdc$operation", ct.T_TINYINT),
                FakeColumn("pk", ct.T_BIGINT),
            ],
            rows=rows,
        )

    def _base_row(self, values: list) -> CannedResult:
        if len(values[0]) != 8:  # as Scylla: a bigint is bound as 8 bytes
            raise ValueError(f"Expected 8 or 0 byte long ({len(values[0])})")
        pk = struct.unpack("!q", values[0])[0]
        found = self.current(pk)
        return CannedResult(
            columns=[FakeColumn(COLUMN, ct.T_VECTOR, vector_dim=self.dims), FakeColumn("wt", ct.T_BIGINT)],
            rows=[] if found is None else [found],
        )

    @staticmethod
    def _index_options() -> dict:
        return {"class_name": "vector_index", "target": json.dumps({"tc": COLUMN})}

    def _schema(self, cql: str, values: list) -> CannedResult | None:
        text = ct.T_VARCHAR
        if "system.group0_history" in cql:
            return CannedResult([FakeColumn("state_id", ct.T_TIMEUUID)], [(self.state_id,)])
        if "schema_version" in cql:
            local = "system.local" in cql
            return CannedResult([FakeColumn("schema_version", ct.T_UUID)], [(self.schema_version,)] if local else [])
        if "FROM system_schema.indexes" in cql:
            if "kind = 'CUSTOM'" in cql:
                cols = ["keyspace_name", "index_name", "table_name"]
                return CannedResult(
                    [FakeColumn(c, text) for c in cols] + [FakeColumn("options", ct.T_MAP)],
                    [(KEYSPACE, INDEX, TABLE, self._index_options())],
                )
            # bound (keyspace, index) or (keyspace, table, index)
            name = values[-1].decode() if values and len(values) >= 2 and values[-1] is not None else None
            if name != INDEX:
                return CannedResult([FakeColumn("table_name", text)], [])
            if "table_name" in cql and "options" in cql:
                return CannedResult(
                    [FakeColumn("table_name", text), FakeColumn("options", ct.T_MAP)],
                    [(TABLE, self._index_options())],
                )
            if "options" in cql:
                return CannedResult([FakeColumn("options", ct.T_MAP)], [(self._index_options(),)])
            return CannedResult([FakeColumn("table_name", text)], [(TABLE,)])
        if "FROM system_schema.columns" in cql:
            table = values[1].decode() if values and len(values) >= 2 and values[1] is not None else None
            vector_type = f"vector<float, {self.dims}>"
            if "column_name = ?" in cql:
                return CannedResult([FakeColumn("type", text)], [(vector_type,)])
            cols = [FakeColumn("column_name", text), FakeColumn("kind", text),
                    FakeColumn("position", ct.T_INT), FakeColumn("type", text)]
            if table == f"{TABLE}_scylla_cdc_log":
                rows = [("cdc$stream_id", "partition_key", 0, "blob"), ("cdc$time", "clustering", 0, "timeuuid"),
                        ("cdc$operation", "regular", -1, "tinyint"), ("pk", "regular", -1, "bigint")]
            elif table == TABLE:
                rows = [("pk", "partition_key", 0, "bigint"), (COLUMN, "regular", -1, vector_type)]
            else:
                rows = []
            return CannedResult(cols, rows)
        if "tokens" in cql and "system." in cql:
            local = "system.local" in cql
            return CannedResult(
                [FakeColumn("tokens", ct.T_SET, sub_type_id=text)], [(self.ring,)] if local else []
            )
        if "cdc_generation_timestamps" in cql:
            return CannedResult([FakeColumn("time", ct.T_TIMESTAMP)], [(self.generation,)])
        if "cdc_streams_descriptions_v2" in cql:
            return CannedResult(
                [FakeColumn("streams", ct.T_SET, sub_type_id=ct.T_BLOB)], [(list(self.streams),)]
            )
        return None


def node_server(base: type) -> type:
    """A subclass of ``base`` (a ``FakeCqlServer`` class) that answers
    every query with a ``ScyllaNode``."""

    class NodeServer(base):
        def __init__(self, node: ScyllaNode, require_auth: tuple[str, str] | None = None) -> None:
            super().__init__(lambda *_: None, require_auth=require_auth)
            self.node = node
            self._page_size: int | None = None

        def _read_params(self, r: Reader):
            r.short()  # consistency
            flags = r.byte()
            values = [r.bytes_value() for _ in range(r.short())] if flags & 0x01 else []
            # read and answered with no await between: the page size of the
            # query being answered
            self._page_size = r.int_() if flags & 0x04 else None
            paging = r.bytes_value() if flags & 0x08 else None
            return values, paging

        def _respond(self, send, cql: str, values, paging) -> None:
            try:
                body = self.node.respond(cql, values, paging, self._page_size)
            except Exception as e:  # a handler error -> a server error frame
                send(fr.OP_ERROR, Writer().int_(0x0000).string(str(e)).bytes_())
                return
            send(fr.OP_RESULT, body)

    return NodeServer


ScyllaNodeServer = node_server(FakeCqlServer)


def node_process(conn, require_auth: tuple[str, str] | None) -> None:
    """A node in a process of its own, driven through ``conn`` (one end of a
    ``multiprocessing.Pipe``). It first receives ``(n, d)`` and then the
    rows' float32 bytes, in messages of whole rows, answers ``("port",
    port)`` once it listens, then serves one command a message until
    ``("stop",)``: ``("write", pk, vector)``, ``("drop",)`` (sever every
    connection) and ``("stats",)``; each is answered with a tuple."""
    asyncio.run(_node_main(conn, require_auth))


async def _node_main(conn, require_auth) -> None:
    n, d = conn.recv()
    vectors = np.empty((n, d), dtype=np.float32)
    lo = 0
    while lo < n:
        block = np.frombuffer(conn.recv_bytes(), dtype=np.float32).reshape(-1, d)
        vectors[lo : lo + len(block)] = block
        lo += len(block)
    server = ScyllaNodeServer(ScyllaNode(vectors), require_auth=require_auth)
    del vectors
    await server.start()
    conn.send(("port", server.port))
    loop = asyncio.get_running_loop()
    done = asyncio.Event()

    def on_message() -> None:
        node = server.node
        while conn.poll():
            cmd = conn.recv()
            if cmd[0] == "write":
                node.write(cmd[1], cmd[2])
                conn.send(("ok",))
            elif cmd[0] == "drop":
                live = len(server._writers)
                server.drop_all_connections()
                conn.send(("dropped", live))
            elif cmd[0] == "stats":
                conn.send(("stats", {"pages": node.pages, "rows_served": node.rows_served}))
            else:
                done.set()
                return

    loop.add_reader(conn.fileno(), on_message)
    await done.wait()
    loop.remove_reader(conn.fileno())
    await server.stop()
    conn.send(("stopped",))
