"""Service wiring (parity with reference lib.rs::run + main.rs).

Counterpart of vector_store_tpu/run.py. Builds every actor — node_state,
internals, memory governor, indexes registry, engine, schema-discovery
monitor, HTTP app — around an injectable Db (a real ScyllaDB session in
production, FakeDb in tests) and one torch device, and runs until stopped.

The device defaults to ``cuda`` and the service refuses to start without
one; tests pass ``torch.device("cpu")``, on which the engines run the
scan kernels' plain PyTorch versions.

    python -m vector_store_tpu_torch.run   # VECTOR_STORE_* configuration

Multi-process serving: ``serve_scaled`` keeps the device, the engines and
ingestion in this (owner) process and spawns frontend processes that bind
the HTTP port with SO_REUSEPORT and forward requests over a unix-socket
IPC (service/ipc.py, http/frontend.py). The frontends never open a CUDA
context. A script that calls it needs an ``if __name__ == "__main__":``
guard, since each spawned frontend imports the script again.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import signal
from dataclasses import dataclass

import torch
from aiohttp import web

from vector_store_tpu_torch.db import Db
from vector_store_tpu_torch.service.config import Config, ConfigManager, load_config
from vector_store_tpu_torch.service.indexes import Indexes
from vector_store_tpu_torch.service.internals import Internals
from vector_store_tpu_torch.service.metrics import Metrics
from vector_store_tpu_torch.service.node_state import NodeState
from vector_store_tpu_torch.http.routes import AppState, build_app
from vector_store_tpu_torch.service.engine import Engine
from vector_store_tpu_torch.service.memory import MemoryGovernor
from vector_store_tpu_torch.service.monitor_indexes import MonitorIndexes

logger = logging.getLogger(__name__)


@dataclass
class Service:
    config: Config
    db: Db
    device: torch.device
    node_state: NodeState
    internals: Internals
    memory: MemoryGovernor
    metrics: Metrics
    indexes: Indexes
    engine: Engine
    monitor_indexes: MonitorIndexes
    app: web.Application
    http_server: object | None = None  # http.server.HttpServer when bound

    async def stop(self) -> None:
        await self.monitor_indexes.stop()
        await self.engine.stop()
        await self.memory.stop()
        task = getattr(self, "_conn_watch", None)
        if task is not None:
            task.cancel()
        session = getattr(self.db, "session", None)
        if session is not None and hasattr(session, "stop"):
            await session.stop()
        if self.http_server is not None:
            await self.http_server.stop()


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The engines' device: ``cuda`` unless given; a CUDA device must exist."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the service serves from an NVIDIA GPU "
            "(pass device=torch.device('cpu') to run the plain PyTorch path)"
        )
    return device


def make_scylla_db(config: Config, metrics=None, internals=None):
    """Production data plane: pure-python CQL v4 session (reconnect loop,
    auth, TLS) + ScyllaDB schema/scan/CDC client, both reused from the JAX
    package (reference db.rs:258-367 session actor)."""
    import ssl as ssl_mod

    from vector_store_tpu_torch.db.cql.session import CqlSession
    from vector_store_tpu_torch.db.scylla import ScyllaDb

    password = None
    if config.scylladb_password_file:
        with open(config.scylladb_password_file) as f:
            password = f.read().strip()
    ssl_ctx = None
    if config.scylladb_certificate_file:
        ssl_ctx = ssl_mod.create_default_context(cafile=config.scylladb_certificate_file)
        ssl_ctx.check_hostname = False
    session = CqlSession(
        config.scylladb_uri,
        username=config.scylladb_username,
        password=password,
        ssl=ssl_ctx,
    )
    session.start()
    return ScyllaDb(
        session,
        cdc_safety_interval=config.cdc_safety_interval,
        cdc_sleep_interval=config.cdc_sleep_interval,
        cdc_fine_safety_interval=config.cdc_fine_safety_interval,
        cdc_fine_sleep_interval=config.cdc_fine_sleep_interval,
        metrics=metrics,
        internals=internals,
    )


async def build_service(
    db: Db, config: Config | None = None, device: torch.device | str | None = None
) -> Service:
    config = config or load_config()
    device = resolve_device(device)

    node_state = NodeState()
    internals = Internals()
    memory = MemoryGovernor(device, limit_bytes=config.memory_limit)
    metrics = Metrics()
    indexes = Indexes()

    from vector_store_tpu_torch.service.worker import Worker

    worker = Worker(threads=config.threads)
    worker.install_as_default(asyncio.get_running_loop())

    # the host engines, chosen by their own settings (reference
    # usearch_simulator / opensearch_addr)
    engine_kind = config.engine_kind
    if config.usearch_simulator:
        engine_kind = f"sim:{config.usearch_simulator}"
    elif config.opensearch_uri:
        engine_kind = f"opensearch:{config.opensearch_uri}"
    engine = Engine(
        db,
        indexes,
        node_state,
        memory=memory,
        metrics=metrics,
        internals=internals,
        engine_kind=engine_kind,
        device=device,
    )
    monitor = MonitorIndexes(
        db,
        engine,
        node_state,
        interval=config.monitor_indexes_interval,
        alter_index_simulator=config.alter_index_simulator,
    )

    state = AppState(
        indexes,
        node_state,
        metrics,
        internals,
        engine=engine,
        use_tls=config.use_tls,
    )
    app = build_app(state)

    node_state.connecting_to_db()
    session = getattr(db, "session", None)
    conn_watch = None
    if session is not None and hasattr(session, "_connected"):
        # real CQL session: CONNECTING_TO_DB until the session handshake lands
        async def _watch_connected() -> None:
            await session._connected.wait()
            node_state.connected_to_db()

        conn_watch = asyncio.get_running_loop().create_task(_watch_connected())
    else:
        node_state.connected_to_db()

    memory.start()
    engine.start()
    monitor.start()

    service = Service(
        config=config,
        db=db,
        device=device,
        node_state=node_state,
        internals=internals,
        memory=memory,
        metrics=metrics,
        indexes=indexes,
        engine=engine,
        monitor_indexes=monitor,
        app=app,
    )
    service._conn_watch = conn_watch
    return service


async def serve(
    db: Db, config: Config | None = None, device: torch.device | str | None = None
) -> Service:
    """Build the service AND bind the HTTP listener(s): plain or TLS main
    endpoint plus the optional mTLS endpoint (http/server.py)."""
    from vector_store_tpu_torch.http.server import HttpServer

    service = await build_service(db, config, device)
    http_server = HttpServer(service.app, service.config)
    await http_server.start()
    service.http_server = http_server
    return service


@contextlib.contextmanager
def gpus_hidden():
    """Processes started inside see no GPU (``CUDA_VISIBLE_DEVICES`` empty);
    this process's environment is restored after."""
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved


async def serve_scaled(
    db: Db,
    config: Config | None = None,
    workers: int = 4,
    ipc_path: str | None = None,
    device: torch.device | str | None = None,
) -> Service:
    """Multi-process serving: this (owner) process keeps the device, the
    engines, ingestion and the IPC endpoint; ``workers`` spawned frontend
    processes bind the HTTP port with SO_REUSEPORT, do all HTTP/JSON work
    and forward searches over unix sockets, which lifts the one-loop Python
    HTTP ceiling. ``service.frontends`` holds the worker processes;
    ``service.stop()`` ends them, then the IPC server, then the service."""
    import multiprocessing
    import shutil
    import tempfile

    from vector_store_tpu_torch.http.frontend import frontend_worker_main
    from vector_store_tpu_torch.service.ipc import OwnerIpcServer

    service = await build_service(db, config, device)
    cfg = service.config
    ipc_dir = None
    if ipc_path is None:
        # a private directory (mkdtemp is 0700 and race-free): the frames
        # are pickles, so no other local user may reach the socket
        ipc_dir = tempfile.mkdtemp(prefix="vst-ipc-")
        ipc_path = os.path.join(ipc_dir, "owner.sock")
    ipc_server = OwnerIpcServer(service, ipc_path)
    await ipc_server.start()
    os.chmod(ipc_path, 0o600)
    service.ipc_server = ipc_server  # type: ignore[attr-defined]

    # spawn, never fork: the owner holds a CUDA context and threads. The
    # frontends see no GPU, so none of them opens a context (each would
    # cost device memory and start-up time)
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=frontend_worker_main, args=(ipc_path, cfg.host, cfg.port), daemon=True)
        for _ in range(workers)
    ]
    with gpus_hidden():
        for p in procs:
            p.start()
    service.frontends = procs  # type: ignore[attr-defined]

    orig_stop = service.stop

    async def stop() -> None:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(timeout=5)
        await ipc_server.stop()
        if ipc_dir is not None:
            shutil.rmtree(ipc_dir, ignore_errors=True)
        elif os.path.exists(ipc_path):
            os.unlink(ipc_path)
        await orig_stop()

    service.stop = stop  # type: ignore[method-assign]
    logger.info("scaled serving: %d frontend workers on %s", workers, cfg.uri)
    return service


async def main() -> None:
    # clap-parity: the only CLI flag is --version (reference main.rs:20-22)
    import sys

    import vector_store_tpu_torch

    if "--version" in sys.argv:
        print(f"{vector_store_tpu_torch.SERVICE_NAME} {vector_store_tpu_torch.__version__}")
        return
    logging.basicConfig(level=logging.INFO)
    config_manager = ConfigManager()
    config_manager.install_sighup()
    config = config_manager.config

    # VECTOR_STORE_FAKE_DB=true boots the in-memory fake instead of a
    # ScyllaDB cluster (demos / tests without a cluster)
    if os.environ.get("VECTOR_STORE_FAKE_DB", "").lower() == "true":
        from vector_store_tpu_torch.db.fake import FakeDb

        db = FakeDb()
    else:
        db = make_scylla_db(config)
    service = await serve(db, config)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await service.stop()


if __name__ == "__main__":
    asyncio.run(main())
