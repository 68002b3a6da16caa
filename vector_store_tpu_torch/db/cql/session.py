"""CQL session: connection ownership + reconnect loop.

Parity with the reference's db.rs session actor: a 1s reconnect timer keeps
one live connection (re-established on error), consumers observe the
current session through an awaitable handle, and a CDC/conn error triggers
teardown + reconnect (db.rs:258-367).
"""

from __future__ import annotations

import asyncio
import logging
import ssl as ssl_mod
from typing import Optional

from vector_store_tpu_torch.db.cql.connection import CqlConnection, Prepared, ResultSet

logger = logging.getLogger(__name__)

RECONNECT_INTERVAL = 1.0


class CqlSession:
    def __init__(
        self,
        uri: str,
        username: str | None = None,
        password: str | None = None,
        ssl: ssl_mod.SSLContext | None = None,
        on_connect=None,  # async callback(conn)
        on_disconnect=None,
        connect_timeout: float = 10.0,
        request_timeout: float | None = 30.0,
    ) -> None:
        host, _, port = uri.rpartition(":")
        self.host = host or uri
        self.port = int(port) if port else 9042
        self.username = username
        self.password = password
        self.ssl = ssl
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        self.on_connect = on_connect
        self.on_disconnect = on_disconnect
        self._conn: CqlConnection | None = None
        self._connected = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._stopped = False
        self.connect_failures = 0
        self.reconnects = 0
        self._prepared: dict[str, Prepared] = {}

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stopped = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        if self._conn:
            await self._conn.close()

    @property
    def is_connected(self) -> bool:
        return self._conn is not None and not self._conn.closed.is_set()

    async def connection(self, timeout: float = 30.0) -> CqlConnection:
        await asyncio.wait_for(self._connected.wait(), timeout)
        assert self._conn is not None
        return self._conn

    async def _run(self) -> None:
        while not self._stopped:
            if not self.is_connected:
                self._connected.clear()
                self._prepared.clear()
                conn = None
                try:
                    conn = CqlConnection(self.host, self.port)
                    await conn.connect(
                        username=self.username,
                        password=self.password,
                        ssl=self.ssl,
                        timeout=self.connect_timeout,
                    )
                    self._conn = conn
                    self._connected.set()
                    self.reconnects += 1
                    logger.info("CQL session established to %s:%d", self.host, self.port)
                    if self.on_connect:
                        await self.on_connect(conn)
                except Exception as e:
                    self.connect_failures += 1
                    logger.debug("CQL connect failed: %s", e)
                    # a failed handshake (auth rejection, stalled STARTUP)
                    # must not leak the half-open socket: the server would
                    # see a live connection forever
                    if conn is not None:
                        try:
                            await conn.close()
                        except Exception:
                            pass
            else:
                # liveness: the read loop flags closure via the event
                if self._conn is not None and self._conn.closed.is_set():
                    logger.warning("CQL session lost; reconnecting")
                    self._connected.clear()
                    if self.on_disconnect:
                        await self.on_disconnect()
            await asyncio.sleep(RECONNECT_INTERVAL)

    # -- convenience -------------------------------------------------------------

    async def query(self, cql: str, values: list | None = None, **kw) -> ResultSet:
        conn = await self.connection()
        kw.setdefault("timeout", self.request_timeout)
        return await conn.query(cql, values, **kw)

    async def execute_prepared(
        self, cql: str, values: list | None = None, **kw
    ) -> ResultSet:
        conn = await self.connection()
        prep = self._prepared.get(cql)
        if prep is None:
            prep = await conn.prepare(cql)
            self._prepared[cql] = prep
        kw.setdefault("timeout", self.request_timeout)
        return await conn.execute(prep, values, **kw)
