"""HTTP frontend worker: owns HTTP/JSON parsing in its own process and
forwards to the device-owner process over the binary IPC (service/ipc.py).

N workers bind the same port via SO_REUSEPORT, so HTTP+JSON throughput
scales with cores while the single owner process keeps exclusive device
ownership (one process per TPU chip is a hard requirement).
"""

from __future__ import annotations

import asyncio
import logging
import socket

import numpy as np
from aiohttp import web

from vector_store_tpu_torch.core.distance import saturate_f32
from vector_store_tpu_torch.core.types import MAX_LIMIT
from vector_store_tpu_torch.service.ipc import IpcClient

logger = logging.getLogger(__name__)


def _json(data, status=200) -> web.Response:
    return web.json_response(data, status=status)


def _err(status: int, msg: str) -> web.Response:
    return web.Response(status=status, text=msg, content_type="application/json")


def _maybe_error(result) -> web.Response | None:
    if isinstance(result, dict) and "error" in result:
        code = result["error"]
        if code == 503:
            return _json(result["reason"], status=503)
        return _err(code, result.get("message", ""))
    return None


def _to_json(v):
    # local copy of routes._to_json: frontend workers must NOT import the
    # routes module (it pulls in jax via the engine; one process per TPU
    # chip is a hard requirement)
    import datetime
    import decimal
    import uuid as _uuid

    if isinstance(v, float):
        return saturate_f32(v)
    if isinstance(v, _uuid.UUID):
        return str(v)
    if isinstance(v, decimal.Decimal):
        return str(v)
    if isinstance(v, bytes):
        return v.hex()
    if isinstance(v, datetime.datetime):
        return v.isoformat()
    if isinstance(v, (datetime.date, datetime.time)):
        return v.isoformat()
    if isinstance(v, tuple):
        return [_to_json(x) for x in v]
    return v


def _collect_pks(pk_columns, keys):
    out = {c: [] for c in pk_columns}
    for values in keys:
        for c, v in zip(pk_columns, values):
            out[c].append(_to_json(v))
    return out


class _AnnBatcher:
    """Coalesces concurrent unfiltered ANN requests for the same
    (index, limit) into one IPC message: flush at BATCH_MAX or after
    WINDOW seconds, whichever first."""

    BATCH_MAX = 128
    WINDOW = 0.002

    def __init__(self, ipc: IpcClient) -> None:
        self.ipc = ipc
        self._pending: dict[tuple, list] = {}  # key -> [(vec_bytes, future)]
        self._timers: dict[tuple, asyncio.TimerHandle] = {}

    async def submit(self, keyspace: str, index: str, vector: list, limit: int):
        key = (keyspace, index, limit, len(vector))
        fut = asyncio.get_running_loop().create_future()
        bucket = self._pending.setdefault(key, [])
        bucket.append((np.asarray(vector, dtype=np.float32).tobytes(), fut))
        if len(bucket) >= self.BATCH_MAX:
            self._flush(key)
        elif key not in self._timers:
            self._timers[key] = asyncio.get_running_loop().call_later(
                self.WINDOW, self._flush, key
            )
        return await fut

    def _flush(self, key: tuple) -> None:
        bucket = self._pending.pop(key, None)
        timer = self._timers.pop(key, None)
        if timer is not None:
            timer.cancel()
        if not bucket:
            return
        asyncio.get_running_loop().create_task(self._send(key, bucket))

    async def _send(self, key: tuple, bucket: list) -> None:
        keyspace, index, limit, dims = key
        try:
            result = await self.ipc.call(
                "ann_batch",
                {
                    "keyspace": keyspace,
                    "index": index,
                    "vectors": b"".join(vb for vb, _ in bucket),
                    "n": len(bucket),
                    "dims": dims,
                    "limit": limit,
                },
            )
        except Exception as e:
            for _, fut in bucket:
                if not fut.done():
                    fut.set_exception(e)
            return
        if isinstance(result, dict) and "error" in result:
            for _, fut in bucket:
                if not fut.done():
                    fut.set_result(result)
            return
        pk_columns = result["pk_columns"]
        for (_, fut), (keys, dists, sims) in zip(bucket, result["results"]):
            if not fut.done():
                fut.set_result(
                    {
                        "pk_columns": pk_columns,
                        "keys": keys,
                        "distances": dists,
                        "similarities": sims,
                    }
                )


class Frontend:
    def __init__(self, ipc: IpcClient, batch_ipc: bool | None = None) -> None:
        self.ipc = ipc
        # IPC-level coalescing is the default (VECTOR_STORE_FRONTEND_BATCH=0
        # to disable). The round-1 "sporadic 500s under TPU load" were the
        # owner's per-batch result pulls hitting the relay's pathological
        # sequential-pull mode and timing out; the actor now aggregates
        # pulls (engine.collect_many), which removed the stalls.
        import os

        if batch_ipc is None:
            batch_ipc = os.environ.get("VECTOR_STORE_FRONTEND_BATCH", "1") != "0"
        self.batch_ipc = batch_ipc
        self.batcher = _AnnBatcher(ipc) if batch_ipc else None

    def build_app(self) -> web.Application:
        app = web.Application(client_max_size=64 * 1024 * 1024)
        app.router.add_get("/api/v1/indexes", self.get_indexes)
        app.router.add_get(
            "/api/v1/indexes/{keyspace}/{index}/status", self.get_index_status
        )
        app.router.add_post("/api/v1/indexes/{keyspace}/{index}/ann", self.post_ann)
        app.router.add_post("/api/v1/indexes/{keyspace}/{index}/bm25", self.post_bm25)
        app.router.add_get("/api/v1/info", self.get_info)
        app.router.add_get("/api/v1/status", self.get_status)
        app.router.add_get("/metrics", self.get_metrics)
        app.router.add_get("/api/internals/counters", self.get_counters)
        return app

    async def get_status(self, request):
        return _json(await self.ipc.call("status", {}))

    async def get_info(self, request):
        return _json(await self.ipc.call("info", {}))

    async def get_indexes(self, request):
        return _json(await self.ipc.call("indexes_list", {}))

    async def get_metrics(self, request):
        text = await self.ipc.call("metrics_text", {})
        return web.Response(text=text, content_type="text/plain", charset="utf-8")

    async def get_counters(self, request):
        return _json(await self.ipc.call("counters", {}))

    async def get_index_status(self, request):
        result = await self.ipc.call(
            "index_status",
            {
                "keyspace": request.match_info["keyspace"],
                "index": request.match_info["index"],
            },
        )
        resp = _maybe_error(result)
        return resp if resp is not None else _json(result)

    async def post_ann(self, request):
        try:
            return await self._post_ann(request)
        except Exception as e:
            logger.exception("post_ann failed in frontend")
            return _err(500, f"frontend error: {type(e).__name__}: {e}")

    async def _post_ann(self, request):
        try:
            body = await request.json()
        except Exception:
            return _err(400, "malformed JSON body")
        vector = body.get("vector")
        if not isinstance(vector, list) or not all(
            isinstance(x, (int, float)) and not isinstance(x, bool) for x in vector
        ):
            return _err(400, "missing or malformed 'vector'")
        limit = body.get("limit", 1)
        if not isinstance(limit, int) or limit < 1 or limit > MAX_LIMIT:
            return _err(400, "invalid 'limit'")
        filter_data = body.get("filter")
        if filter_data is None and self.batcher is not None:
            # hot path: unfiltered searches coalesce into bulk IPC messages
            result = await self.batcher.submit(
                request.match_info["keyspace"],
                request.match_info["index"],
                vector,
                limit,
            )
        else:
            result = await self.ipc.call(
                "ann",
                {
                    "keyspace": request.match_info["keyspace"],
                    "index": request.match_info["index"],
                    "vector": np.asarray(vector, dtype=np.float32).tobytes(),
                    "limit": limit,
                    "filter": filter_data,
                },
            )
        resp = _maybe_error(result)
        if resp is not None:
            return resp
        return _json(
            {
                "primary_keys": _collect_pks(result["pk_columns"], result["keys"]),
                "distances": [saturate_f32(d) for d in result["distances"]],
                "similarity_scores": [saturate_f32(s) for s in result["similarities"]],
            }
        )

    async def post_bm25(self, request):
        try:
            body = await request.json()
        except Exception:
            return _err(400, "malformed JSON body")
        query = body.get("query")
        if not isinstance(query, str):
            return _err(400, "missing or malformed 'query'")
        limit = body.get("limit", 1)
        if not isinstance(limit, int) or limit < 1 or limit > MAX_LIMIT:
            return _err(400, "invalid 'limit'")
        result = await self.ipc.call(
            "bm25",
            {
                "keyspace": request.match_info["keyspace"],
                "index": request.match_info["index"],
                "query": query,
                "limit": limit,
            },
        )
        resp = _maybe_error(result)
        if resp is not None:
            return resp
        return _json(
            {
                "primary_keys": _collect_pks(result["pk_columns"], result["keys"]),
                "scores": result["scores"],
            }
        )


def reuseport_socket(host: str, port: int) -> socket.socket:
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind((host, port))
    return sock


async def run_frontend(ipc_path: str, host: str, port: int) -> web.AppRunner:
    """Start one frontend worker bound with SO_REUSEPORT."""
    ipc = IpcClient(ipc_path)
    await ipc.connect()
    frontend = Frontend(ipc)
    runner = web.AppRunner(frontend.build_app())
    await runner.setup()
    site = web.SockSite(runner, reuseport_socket(host, port))
    await site.start()
    return runner


def frontend_worker_main(ipc_path: str, host: str, port: int) -> None:
    """Entry point for a frontend worker process."""
    import logging as _logging
    import signal

    _logging.basicConfig(level=_logging.WARNING)

    async def main():
        runner = await run_frontend(ipc_path, host, port)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await runner.cleanup()

    asyncio.run(main())
