"""Asyncio CQL connection with stream multiplexing.

One TCP connection carries up to 32k concurrent requests identified by
stream ids; responses complete per-stream futures. Handles STARTUP,
SASL/PLAIN auth, QUERY/PREPARE/EXECUTE, paging, and TLS.
"""

from __future__ import annotations

import asyncio
import logging
import ssl as ssl_mod
from dataclasses import dataclass, field
from typing import Optional

from vector_store_tpu_torch.db.cql import frame as fr
from vector_store_tpu_torch.db.cql.frame import Reader, Writer
from vector_store_tpu_torch.db.cql.types import CqlType, decode_value, encode_bind, read_type

logger = logging.getLogger(__name__)

MAX_STREAMS = 2048


class CqlError(Exception):
    def __init__(self, code: int, message: str) -> None:
        super().__init__(f"CQL error 0x{code:04x}: {message}")
        self.code = code
        self.message = message


@dataclass
class Columns:
    names: list[str]
    types: list[CqlType]


@dataclass
class ResultSet:
    columns: Columns | None
    rows: list[tuple]
    paging_state: bytes | None = None

    def __iter__(self):
        return iter(self.rows)

    def one(self):
        return self.rows[0] if self.rows else None

    def named_rows(self) -> list[dict]:
        assert self.columns is not None
        return [dict(zip(self.columns.names, row)) for row in self.rows]


@dataclass
class Prepared:
    id: bytes
    result_columns: Columns | None


class CqlConnection:
    def __init__(self, host: str, port: int) -> None:
        self.host = host
        self.port = port
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._free_streams: list[int] = list(range(1, MAX_STREAMS))
        self._read_task: asyncio.Task | None = None
        self.closed = asyncio.Event()

    # -- lifecycle ------------------------------------------------------------

    async def connect(
        self,
        username: str | None = None,
        password: str | None = None,
        ssl: ssl_mod.SSLContext | None = None,
        timeout: float = 10.0,
    ) -> None:
        self._reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port, ssl=ssl), timeout
        )
        self._read_task = asyncio.get_running_loop().create_task(self._read_loop())
        try:
            # the timeout covers the whole STARTUP/AUTH exchange, not just
            # the TCP connect: a server that accepts the socket but never
            # answers STARTUP must fail the attempt so the session's
            # reconnect loop keeps retrying (reference connection_timeout,
            # db.rs create_session / validator connection_timeout.rs)
            await asyncio.wait_for(
                self._handshake(username, password), timeout
            )
        except asyncio.TimeoutError:
            await self.close()
            raise ConnectionError("CQL startup handshake timed out")

    async def _handshake(
        self, username: str | None, password: str | None
    ) -> None:
        body = Writer().string_map({"CQL_VERSION": "3.0.0"}).bytes_()
        opcode, resp = await self._request(fr.OP_STARTUP, body)
        if opcode == fr.OP_AUTHENTICATE:
            token = b"\x00" + (username or "").encode() + b"\x00" + (password or "").encode()
            body = Writer().bytes_value(token).bytes_()
            opcode, resp = await self._request(fr.OP_AUTH_RESPONSE, body)
            if opcode not in (fr.OP_AUTH_SUCCESS, fr.OP_READY):
                raise CqlError(0, f"authentication failed (opcode {opcode})")
        elif opcode != fr.OP_READY:
            raise CqlError(0, f"unexpected startup response opcode {opcode}")

    async def close(self) -> None:
        if self._read_task:
            self._read_task.cancel()
            try:
                await self._read_task
            except (asyncio.CancelledError, Exception):
                pass
        if self._writer:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:
                pass
        self.closed.set()

    # -- I/O --------------------------------------------------------------------

    async def _read_loop(self) -> None:
        try:
            assert self._reader is not None
            while True:
                header = await self._reader.readexactly(9)
                _, flags, stream, opcode, length = fr.decode_header(header)
                body = await self._reader.readexactly(length) if length else b""
                fut = self._pending.pop(stream, None)
                if fut is not None and not fut.done():
                    fut.set_result((opcode, body))
                    self._free_streams.append(stream)
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError) as e:
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError(f"connection lost: {e}"))
            self._pending.clear()
            self.closed.set()

    async def _request(
        self, opcode: int, body: bytes, timeout: float | None = None
    ) -> tuple[int, bytes]:
        if self._writer is None or self.closed.is_set():
            raise ConnectionError("connection closed")
        if not self._free_streams:
            raise ConnectionError("no free CQL streams")
        stream = self._free_streams.pop()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[stream] = fut
        self._writer.write(fr.encode_frame(opcode, stream, body))
        await self._writer.drain()
        if timeout is not None:
            try:
                # shield: a late response must still complete the future so
                # the read loop returns the stream id to the pool — the
                # stream stays reserved until the server answers or the
                # connection dies (reference client-side request timeout;
                # other streams keep flowing, validator db_timeout.rs)
                op, resp = await asyncio.wait_for(
                    asyncio.shield(fut), timeout
                )
            except asyncio.TimeoutError:
                raise CqlError(0x1001, f"client request timed out after {timeout}s")
        else:
            op, resp = await fut
        if op == fr.OP_ERROR:
            r = Reader(resp)
            code = r.int_()
            message = r.string()
            raise CqlError(code, message)
        return op, resp

    # -- queries ----------------------------------------------------------------

    @staticmethod
    def _query_params(
        values: list | None,
        consistency: int,
        page_size: int | None,
        paging_state: bytes | None,
    ) -> bytes:
        w = Writer()
        w.short(consistency)
        flags = 0
        if values:
            flags |= 0x01
        if page_size:
            flags |= 0x04
        if paging_state:
            flags |= 0x08
        w.byte(flags)
        if values:
            w.short(len(values))
            for v in values:
                w.bytes_value(encode_bind(v))
        if page_size:
            w.int_(page_size)
        if paging_state:
            w.bytes_value(paging_state)
        return w.bytes_()

    async def query(
        self,
        cql: str,
        values: list | None = None,
        consistency: int = fr.CL_LOCAL_ONE,
        page_size: int | None = None,
        paging_state: bytes | None = None,
        timeout: float | None = None,
    ) -> ResultSet:
        w = Writer().long_string(cql)
        w.raw(self._query_params(values, consistency, page_size, paging_state))
        opcode, body = await self._request(fr.OP_QUERY, w.bytes_(), timeout=timeout)
        return self._parse_result(opcode, body)

    async def prepare(self, cql: str) -> Prepared:
        body = Writer().long_string(cql).bytes_()
        opcode, resp = await self._request(fr.OP_PREPARE, body)
        r = Reader(resp)
        kind = r.int_()
        if kind != fr.RESULT_PREPARED:
            raise CqlError(0, f"unexpected result kind for PREPARE: {kind}")
        pid = r.short_bytes()
        # bind metadata (v4: flags, col count, pk count + indices, specs)
        flags = r.int_()
        cols = r.int_()
        pk_count = r.int_()
        for _ in range(pk_count):
            r.short()
        self._skip_col_specs(r, flags, cols)
        result_columns = self._read_metadata(r)
        return Prepared(id=pid, result_columns=result_columns)

    async def execute(
        self,
        prepared: Prepared,
        values: list | None = None,
        consistency: int = fr.CL_LOCAL_ONE,
        page_size: int | None = None,
        paging_state: bytes | None = None,
        timeout: float | None = None,
    ) -> ResultSet:
        w = Writer().short_bytes(prepared.id)
        w.raw(self._query_params(values, consistency, page_size, paging_state))
        opcode, body = await self._request(fr.OP_EXECUTE, w.bytes_(), timeout=timeout)
        rs = self._parse_result(opcode, body)
        if rs.columns is None and prepared.result_columns is not None:
            rs.columns = prepared.result_columns
        return rs

    # -- result parsing ----------------------------------------------------------

    @staticmethod
    def _skip_col_specs(r: Reader, flags: int, cols: int) -> None:
        global_spec = bool(flags & 0x0001)
        if global_spec:
            r.string()
            r.string()
        for _ in range(cols):
            if not global_spec:
                r.string()
                r.string()
            r.string()
            read_type(r)

    @staticmethod
    def _read_metadata(r: Reader) -> Columns | None:
        flags = r.int_()
        cols = r.int_()
        paging = r.bytes_value() if flags & 0x0002 else None
        if flags & 0x0004:  # no metadata
            return None
        global_spec = bool(flags & 0x0001)
        if global_spec:
            r.string()
            r.string()
        names = []
        types = []
        for _ in range(cols):
            if not global_spec:
                r.string()
                r.string()
            names.append(r.string())
            types.append(read_type(r))
        cols_obj = Columns(names, types)
        cols_obj._paging = paging  # type: ignore[attr-defined]
        return cols_obj

    def _parse_result(self, opcode: int, body: bytes) -> ResultSet:
        if opcode != fr.OP_RESULT:
            raise CqlError(0, f"unexpected opcode {opcode}")
        r = Reader(body)
        kind = r.int_()
        if kind in (fr.RESULT_VOID, fr.RESULT_SET_KEYSPACE, fr.RESULT_SCHEMA_CHANGE):
            return ResultSet(columns=None, rows=[])
        if kind != fr.RESULT_ROWS:
            return ResultSet(columns=None, rows=[])
        flags = r.int_()
        cols = r.int_()
        paging = r.bytes_value() if flags & 0x0002 else None
        columns: Columns | None = None
        if not (flags & 0x0004):
            global_spec = bool(flags & 0x0001)
            if global_spec:
                r.string()
                r.string()
            names = []
            types = []
            for _ in range(cols):
                if not global_spec:
                    r.string()
                    r.string()
                names.append(r.string())
                types.append(read_type(r))
            columns = Columns(names, types)
        nrows = r.int_()
        rows = []
        if columns is not None:
            for _ in range(nrows):
                rows.append(
                    tuple(
                        decode_value(columns.types[c], r.bytes_value())
                        for c in range(cols)
                    )
                )
        else:
            for _ in range(nrows):
                rows.append(tuple(r.bytes_value() for _ in range(cols)))
        return ResultSet(columns=columns, rows=rows, paging_state=paging)
