"""In-process fake CQL server for driver tests: speaks enough of protocol
v4 to exercise STARTUP/auth, QUERY, PREPARE/EXECUTE, paging, and errors.
Handlers map query text to canned result sets.
"""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass, field
from typing import Callable, Optional

from vector_store_tpu_torch.db.cql import frame as fr
from vector_store_tpu_torch.db.cql.frame import Reader, Writer
from vector_store_tpu_torch.db.cql import types as ct

# encoders for server-side row values, keyed by type id


def _enc(tid: int, v):
    if v is None:
        return None
    if tid in (ct.T_ASCII, ct.T_VARCHAR):
        return v.encode("utf-8")
    if tid == ct.T_BLOB:
        return bytes(v)
    if tid == ct.T_BOOLEAN:
        return b"\x01" if v else b"\x00"
    if tid == ct.T_INT:
        return struct.pack("!i", v)
    if tid == ct.T_BIGINT:
        return struct.pack("!q", v)
    if tid == ct.T_FLOAT:
        return struct.pack("!f", v)
    if tid == ct.T_DOUBLE:
        return struct.pack("!d", v)
    if tid == ct.T_SMALLINT:
        return struct.pack("!h", v)
    if tid == ct.T_TINYINT:
        return struct.pack("!b", v)
    if tid in (ct.T_UUID, ct.T_TIMEUUID):
        return v.bytes
    if tid == ct.T_TIMESTAMP:
        return struct.pack("!q", int(v.timestamp() * 1e3))
    if tid == ct.T_VARINT:
        n = max(1, (v.bit_length() + 8) // 8)
        return v.to_bytes(n, "big", signed=True)
    if tid == ct.T_VECTOR:
        return struct.pack(f"!{len(v)}f", *v)
    if tid == ct.T_SET or tid == ct.T_LIST:
        raise NotImplementedError
    raise NotImplementedError(f"fake server cannot encode type 0x{tid:04x}")


@dataclass
class FakeColumn:
    name: str
    type_id: int
    vector_dim: int = 0
    elem_type_id: int = ct.T_FLOAT
    # for list/set columns in tests
    sub_type_id: int | None = None


@dataclass
class CannedResult:
    columns: list[FakeColumn]
    rows: list[tuple]
    paging_state: bytes | None = None


def _write_type(w: Writer, col: FakeColumn) -> None:
    if col.type_id == ct.T_VECTOR:
        # Scylla reports vector as a custom class
        w.short(ct.T_CUSTOM)
        elem = {ct.T_FLOAT: "FloatType"}[col.elem_type_id]
        w.string(
            "org.apache.cassandra.db.marshal.VectorType"
            f"(org.apache.cassandra.db.marshal.{elem}, {col.vector_dim})"
        )
    elif col.type_id in (ct.T_LIST, ct.T_SET):
        w.short(col.type_id)
        w.short(col.sub_type_id or ct.T_VARCHAR)
    elif col.type_id == ct.T_MAP:
        w.short(ct.T_MAP)
        w.short(ct.T_VARCHAR)
        w.short(ct.T_VARCHAR)
    else:
        w.short(col.type_id)


def encode_rows(result: CannedResult) -> bytes:
    w = Writer()
    w.int_(fr.RESULT_ROWS)
    flags = 0x0001  # global table spec
    if result.paging_state is not None:
        flags |= 0x0002
    w.int_(flags)
    w.int_(len(result.columns))
    if result.paging_state is not None:
        w.bytes_value(result.paging_state)
    w.string("ks")
    w.string("tbl")
    for col in result.columns:
        w.string(col.name)
        _write_type(w, col)
    w.int_(len(result.rows))
    for row in result.rows:
        for col, v in zip(result.columns, row):
            if col.type_id in (ct.T_LIST, ct.T_SET) and v is not None:
                inner = Writer()
                inner.int_(len(v))
                for item in v:
                    inner.bytes_value(_enc(col.sub_type_id or ct.T_VARCHAR, item))
                w.bytes_value(inner.bytes_())
            elif col.type_id == ct.T_MAP and v is not None:
                inner = Writer()
                inner.int_(len(v))
                for mk, mv in v.items():
                    inner.bytes_value(_enc(ct.T_VARCHAR, mk))
                    inner.bytes_value(_enc(ct.T_VARCHAR, mv))
                w.bytes_value(inner.bytes_())
            else:
                w.bytes_value(_enc(col.type_id, v))
    return w.bytes_()


def encode_void() -> bytes:
    return Writer().int_(fr.RESULT_VOID).bytes_()


class FakeCqlServer:
    """Handler receives (query_text, values_bytes: list[bytes|None],
    paging_state) and returns CannedResult | None (None -> Void)."""

    def __init__(
        self,
        handler: Callable[[str, list, Optional[bytes]], Optional[CannedResult]],
        require_auth: tuple[str, str] | None = None,
    ) -> None:
        self.handler = handler
        self.require_auth = require_auth
        self._server: asyncio.base_events.Server | None = None
        self._prepared: dict[bytes, str] = {}
        self._next_id = 0
        self.port = 0
        self.queries: list[str] = []
        # fault-injection knobs (validator reconnect.rs / firewall parity)
        self.refuse_connections = False  # close new connections immediately
        self.connections_accepted = 0
        self._writers: set[asyncio.StreamWriter] = set()
        # accept the TCP connection but never answer STARTUP (validator
        # connection_timeout.rs: handshake must time out client-side)
        self.stall_startup = False
        # queries matching this predicate get NO response — their stream
        # hangs while other streams keep flowing (validator db_timeout.rs:
        # a slow query must not stop CDC)
        self.stall_predicate = None  # Callable[[str], bool] | None

    def drop_all_connections(self) -> None:
        """Sever every live connection (the validator's firewall cut)."""
        for w in list(self._writers):
            try:
                w.close()
            except Exception:
                pass
        self._writers.clear()

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._client, "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            # Python 3.12 wait_closed() waits for every client handler;
            # sever lingering connections so stop() can't hang on one
            self.drop_all_connections()
            await self._server.wait_closed()

    async def _client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        if self.refuse_connections:
            writer.close()
            return
        self.connections_accepted += 1
        self._writers.add(writer)
        authed = self.require_auth is None
        try:
            while True:
                header = await reader.readexactly(9)
                _, flags, stream, opcode, length = fr.decode_header(header)
                body = await reader.readexactly(length) if length else b""

                def send(op: int, payload: bytes) -> None:
                    writer.write(
                        fr.encode_frame(op, stream, payload, version=fr.VERSION_RESPONSE)
                    )

                if opcode == fr.OP_STARTUP:
                    if self.stall_startup:
                        continue  # leave the client hanging
                    if self.require_auth:
                        send(
                            fr.OP_AUTHENTICATE,
                            Writer()
                            .string("org.apache.cassandra.auth.PasswordAuthenticator")
                            .bytes_(),
                        )
                    else:
                        send(fr.OP_READY, b"")
                elif opcode == fr.OP_AUTH_RESPONSE:
                    r = Reader(body)
                    token = r.bytes_value() or b""
                    parts = token.split(b"\x00")
                    user, pwd = parts[1].decode(), parts[2].decode()
                    if (user, pwd) == self.require_auth:
                        authed = True
                        send(fr.OP_AUTH_SUCCESS, Writer().bytes_value(None).bytes_())
                    else:
                        send(
                            fr.OP_ERROR,
                            Writer().int_(0x0100).string("bad credentials").bytes_(),
                        )
                elif opcode == fr.OP_OPTIONS:
                    send(fr.OP_SUPPORTED, Writer().short(0).bytes_())
                elif opcode == fr.OP_QUERY:
                    r = Reader(body)
                    cql = r.long_string()
                    values, paging = self._read_params(r)
                    self.queries.append(cql)
                    if self.stall_predicate and self.stall_predicate(cql):
                        continue  # no response on this stream
                    self._respond(send, cql, values, paging)
                elif opcode == fr.OP_PREPARE:
                    r = Reader(body)
                    cql = r.long_string()
                    pid = struct.pack("!I", self._next_id)
                    self._next_id += 1
                    self._prepared[pid] = cql
                    w = Writer()
                    w.int_(fr.RESULT_PREPARED)
                    w.short_bytes(pid)
                    # bind metadata: no columns, no pk
                    w.int_(0)
                    w.int_(0)
                    w.int_(0)
                    # result metadata: no metadata flag
                    w.int_(0x0004)
                    w.int_(0)
                    send(fr.OP_RESULT, w.bytes_())
                elif opcode == fr.OP_EXECUTE:
                    r = Reader(body)
                    pid = r.short_bytes()
                    cql = self._prepared.get(pid, "")
                    values, paging = self._read_params(r)
                    self.queries.append(cql)
                    if self.stall_predicate and self.stall_predicate(cql):
                        continue  # no response on this stream
                    self._respond(send, cql, values, paging)
                elif opcode == fr.OP_REGISTER:
                    send(fr.OP_READY, b"")
                else:
                    send(
                        fr.OP_ERROR,
                        Writer().int_(0x000A).string("unsupported opcode").bytes_(),
                    )
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    @staticmethod
    def _read_params(r: Reader):
        consistency = r.short()
        flags = r.byte()
        values: list = []
        if flags & 0x01:
            n = r.short()
            values = [r.bytes_value() for _ in range(n)]
        if flags & 0x04:
            r.int_()
        paging = r.bytes_value() if flags & 0x08 else None
        return values, paging

    def _respond(self, send, cql: str, values, paging) -> None:
        try:
            result = self.handler(cql, values, paging)
        except Exception as e:  # handler error -> server error frame
            send(fr.OP_ERROR, Writer().int_(0x0000).string(str(e)).bytes_())
            return
        if result is None:
            send(fr.OP_RESULT, encode_void())
        else:
            send(fr.OP_RESULT, encode_rows(result))
