"""Owner-process IPC: a binary unix-socket protocol between the HTTP
frontend processes of ``run.serve_scaled`` and the owner process, which
holds the device engines.

Counterpart of vector_store_tpu/service/ipc.py. One Python event loop doing
HTTP and JSON caps serving at a few hundred requests a second; the
frontends (http/frontend.py) do that work in processes of their own and
send each search here over persistent unix sockets, so the owner's cost of
a request is a pickle and an actor dispatch.

Every command answers what the owner's in-process route answers for the
same request: the handlers call the routes' ``*_answer`` functions
(http/routes.py) and turn their ``(status, body)`` into a reply, a result
or ``{"error": status, "message": ...}`` (``"reason"`` for a 503), which
the frontend turns into the same HTTP response.

Framing: 4-byte big-endian length + pickle (protocol 5). Vectors travel as
raw float32 bytes inside the payload. Only the owner's own frontends reach
the socket (``serve_scaled`` puts it in a private 0700 directory, 0600).
"""

from __future__ import annotations

import asyncio
import logging
import pickle
import struct

import numpy as np

from vector_store_tpu_torch.core.distance import similarity_score
from vector_store_tpu_torch.core.types import IndexKey

logger = logging.getLogger(__name__)

_LEN = struct.Struct("!I")


async def read_msg(reader: asyncio.StreamReader):
    header = await reader.readexactly(4)
    (n,) = _LEN.unpack(header)
    return pickle.loads(await reader.readexactly(n))


def write_msg(writer: asyncio.StreamWriter, obj) -> None:
    payload = pickle.dumps(obj, protocol=5)
    writer.write(_LEN.pack(len(payload)) + payload)


def _error(status: int, body) -> dict:
    """The reply for a non-200 answer, as the frontend reads it."""
    if status == 503:
        return {"error": 503, "reason": body}
    return {"error": status, "message": body}


class OwnerIpcServer:
    """Runs inside the service (owner) process; executes frontend commands
    against the live registry and actors."""

    def __init__(self, service, path: str) -> None:
        # the routes hold the device stack: imported by the owner only (a
        # frontend imports this module for IpcClient)
        from vector_store_tpu_torch.http import routes

        self.routes = routes
        self.service = service
        self.path = path
        self._server: asyncio.AbstractServer | None = None
        self._tasks: set[asyncio.Task] = set()

    @property
    def state(self):
        """The routes' AppState of the owner's service."""
        return self.service.app["state"]

    async def start(self) -> None:
        self._server = await asyncio.start_unix_server(self._client, path=self.path)

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        for task in list(self._tasks):
            task.cancel()

    async def _client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                req_id, cmd, args = await read_msg(reader)
                # each command runs on its own, so one slow search does not
                # hold up the connection
                task = asyncio.get_running_loop().create_task(
                    self._dispatch(writer, req_id, cmd, args)
                )
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except Exception:
            logger.exception("ipc server connection loop failed")
        finally:
            writer.close()

    async def _dispatch(self, writer, req_id, cmd, args) -> None:
        try:
            result = await self._execute(cmd, args)
            write_msg(writer, (req_id, None, result))
        except Exception as e:  # error travels back as (type, message)
            logger.exception("ipc command %s failed", cmd)
            write_msg(writer, (req_id, f"{type(e).__name__}: {e}", None))
        try:
            await writer.drain()
        except (ConnectionError, RuntimeError):
            pass

    def _ann_reply(self, pk_columns, result) -> tuple:
        """(keys, distances, similarities) of one ANN answer; ValueError for
        a key whose arity is not the columns' (the route answers it with
        500)."""
        keys = self.routes.key_values(pk_columns, [pk for pk, _ in result])
        return keys, [d.value for _, d in result], [similarity_score(d) for _, d in result]

    async def _execute(self, cmd: str, args):
        from vector_store_tpu_torch.service.node_state import node_status_http

        routes, st = self.routes, self.state
        if cmd == "status":
            return node_status_http(st.node_state.get_status())
        if cmd == "info":
            return routes.info_answer(st)
        if cmd == "metrics_text":
            return st.metrics.expose_text()
        if cmd == "counters":
            return st.internals.counters()
        if cmd == "indexes_list":
            return routes.indexes_answer(st)
        if cmd == "index_status":
            status, body = await routes.index_status_answer(st, args["keyspace"], args["index"])
            return body if status == 200 else _error(status, body)
        if cmd == "ann":
            return await self._ann(args)
        if cmd == "ann_batch":
            return await self._ann_batch(args)
        if cmd == "bm25":
            return await self._bm25(args)
        raise ValueError(f"unknown ipc command {cmd}")

    async def _ann(self, args):
        """One ANN request, filtered or not (routes.ann_answer)."""
        vector = np.frombuffer(args["vector"], dtype=np.float32)
        status, body = await self.routes.ann_answer(
            self.state, args["keyspace"], args["index"], vector, args["limit"], args.get("filter")
        )
        if status != 200:
            return _error(status, body)
        pk_columns, result = body
        try:
            keys, distances, similarities = self._ann_reply(pk_columns, result)
        except ValueError as e:
            return _error(500, str(e))
        return {"pk_columns": pk_columns, "keys": keys, "distances": distances, "similarities": similarities}

    async def _ann_batch(self, args):
        """n unfiltered queries of one index and limit in one message:
        routing and metrics run once, the queries go to the actor together
        (``ann_many``) and the answers travel back in one pickle. Each
        answer is what routes.ann_answer gives the same query."""
        st = self.state
        ks, ix, n = args["keyspace"], args["index"], args["n"]
        vectors = np.frombuffer(args["vectors"], dtype=np.float32).reshape(n, args["dims"])
        timer = st.metrics.latency.with_labels(ks, ix).start_timer()
        try:
            best = st.indexes.best_index(IndexKey(ks, ix), [], [])
            unservable = self.routes.unservable_answer(st, ks, ix, best)
            if unservable is not None:
                return _error(*unservable)
            st.internals.increment(f"ann-served-request--{best.key.keyspace}--{best.key.index}", n)
            entry = best.entry
            try:
                results = await entry.actor.ann_many(vectors, args["limit"])
            except self.routes.DimensionMismatch as e:
                return _error(400, str(e))
            except Exception as e:
                logger.exception("ann_batch failed")
                return _error(500, f"index.ann request error: {e}")
        finally:
            timer.observe_duration()
        pk_columns = entry.metadata.primary_key_columns
        try:
            return {"pk_columns": pk_columns, "results": [self._ann_reply(pk_columns, res) for res in results]}
        except ValueError as e:
            return _error(500, str(e))

    async def _bm25(self, args):
        status, body = await self.routes.bm25_answer(
            self.state, args["keyspace"], args["index"], args["query"], args["limit"]
        )
        if status != 200:
            return _error(status, body)
        pk_columns, keys, scores = body
        try:
            return {"pk_columns": pk_columns, "keys": self.routes.key_values(pk_columns, keys), "scores": scores}
        except ValueError as e:
            return _error(500, str(e))


class IpcClient:
    """Persistent connection pool used by frontend workers."""

    def __init__(self, path: str, pool: int = 4) -> None:
        self.path = path
        self.pool_size = pool
        self._conns: list[tuple[asyncio.StreamReader, asyncio.StreamWriter]] = []
        self._readers: list[asyncio.Task] = []
        self._pending: dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._rr = 0
        self._lock = asyncio.Lock()

    async def connect(self) -> None:
        for _ in range(self.pool_size):
            reader, writer = await asyncio.open_unix_connection(self.path)
            self._conns.append((reader, writer))
            self._readers.append(asyncio.get_running_loop().create_task(self._read_loop(reader)))

    async def close(self) -> None:
        for _, writer in self._conns:
            writer.close()

    def _fail_pending(self, exc: Exception) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                req_id, err, result = await read_msg(reader)
                fut = self._pending.pop(req_id, None)
                if fut and not fut.done():
                    if err is not None:
                        fut.set_exception(RuntimeError(err))
                    else:
                        fut.set_result(result)
        except (asyncio.IncompleteReadError, ConnectionError):
            logger.warning("ipc client reader: connection to owner lost")
            self._fail_pending(ConnectionError("ipc connection lost"))
        except Exception:
            logger.exception("ipc client reader failed")
            self._fail_pending(ConnectionError("ipc reader error"))

    async def call(self, cmd: str, args) -> object:
        async with self._lock:
            self._next_id += 1
            req_id = self._next_id
            self._rr = (self._rr + 1) % len(self._conns)
            _, writer = self._conns[self._rr]
            fut = asyncio.get_running_loop().create_future()
            self._pending[req_id] = fut
            write_msg(writer, (req_id, cmd, args))
            await writer.drain()
        return await fut
