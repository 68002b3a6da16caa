"""HTTP server lifecycle (reference httpserver.rs): bind with exponential
retry backoff, graceful shutdown, dual endpoints (plain/TLS main + optional
mTLS), and restart on config changes (URI or TLS material).
"""

from __future__ import annotations

import asyncio
import logging
import ssl as ssl_mod
from dataclasses import dataclass
from typing import Optional

from aiohttp import web

from vector_store_tpu_torch.service.config import Config
from vector_store_tpu_torch.service.file_monitor import FileMonitor

logger = logging.getLogger(__name__)

BIND_RETRY_INITIAL = 0.5
BIND_RETRY_MAX = 30.0
SHUTDOWN_GRACE = 10.0


def build_tls_context(cert_path: str, key_path: str, client_ca: str | None = None) -> ssl_mod.SSLContext:
    """Server TLS context; with client_ca set, client certificates are
    required (mTLS, reference tls.rs WebPKI client verifier)."""
    ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    if client_ca:
        ctx.load_verify_locations(cafile=client_ca)
        ctx.verify_mode = ssl_mod.CERT_REQUIRED
    return ctx


@dataclass
class RunningServer:
    runner: web.AppRunner
    site: web.TCPSite
    host: str
    port: int

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def shutdown(self) -> None:
        try:
            await asyncio.wait_for(self.runner.cleanup(), SHUTDOWN_GRACE)
        except asyncio.TimeoutError:
            logger.warning("graceful shutdown timed out")


async def spawn_server_with_retry(
    app: web.Application,
    host: str,
    port: int,
    ssl_ctx: ssl_mod.SSLContext | None = None,
    max_attempts: int | None = None,
) -> RunningServer:
    backoff = BIND_RETRY_INITIAL
    attempt = 0
    while True:
        attempt += 1
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, host, port, ssl_context=ssl_ctx)
        try:
            await site.start()
            real_port = port
            for sock_site in runner.sites:
                server = getattr(sock_site, "_server", None)
                if server and server.sockets:
                    real_port = server.sockets[0].getsockname()[1]
            logger.info("listening on %s:%d%s", host, real_port, " (TLS)" if ssl_ctx else "")
            return RunningServer(runner=runner, site=site, host=host, port=real_port)
        except OSError as e:
            await runner.cleanup()
            if max_attempts is not None and attempt >= max_attempts:
                raise
            logger.warning("bind %s:%d failed (%s); retrying in %.1fs", host, port, e, backoff)
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, BIND_RETRY_MAX)


class HttpServer:
    """Owns the main (and optional mTLS) listeners; restarts them when the
    config or the TLS certificate files change."""

    def __init__(self, app: web.Application, config: Config) -> None:
        self.app = app
        self.config = config
        self.main: RunningServer | None = None
        self.mtls: RunningServer | None = None
        self._cert_monitor: FileMonitor | None = None
        self._reload_lock = asyncio.Lock()

    async def start(self) -> None:
        await self._spawn_all()
        cfg = self.config
        cert_files = [p for p in (cfg.tls_cert_path, cfg.tls_key_path, cfg.mtls_ca_cert_path) if p]
        if cert_files:
            self._cert_monitor = FileMonitor(
                cert_files,
                lambda: asyncio.get_running_loop().create_task(self.reload()),
                interval=cfg.tls_file_check_interval,
            )
            self._cert_monitor.start()

    async def _spawn_all(self) -> None:
        cfg = self.config
        ssl_ctx = None
        if cfg.use_tls:
            ssl_ctx = build_tls_context(cfg.tls_cert_path, cfg.tls_key_path)
        # an ephemeral (":0") URI must keep its ACTUAL port across reloads:
        # cert rotation re-binds the listener, and clients expect the
        # address to survive (the reference re-binds the configured port)
        port = cfg.port
        if port == 0 and getattr(self, "_last_main_port", None):
            port = self._last_main_port
        self.main = await spawn_server_with_retry(self.app, cfg.host, port, ssl_ctx)
        self._last_main_port = self.main.port
        if cfg.mtls_ca_cert_path and cfg.use_tls:
            mtls_ctx = build_tls_context(
                cfg.tls_cert_path, cfg.tls_key_path, client_ca=cfg.mtls_ca_cert_path
            )
            host, _, mport = cfg.mtls_uri.rpartition(":")
            mport = int(mport)
            if mport == 0 and getattr(self, "_last_mtls_port", None):
                mport = self._last_mtls_port
            self.mtls = await spawn_server_with_retry(self.app, host, mport, mtls_ctx)
            self._last_mtls_port = self.mtls.port

    async def reload(self) -> None:
        """Tear down and re-bind (config change or cert rotation,
        httpserver.rs:194-230)."""
        async with self._reload_lock:
            logger.info("reloading HTTP server")
            await self.stop_listeners()
            await self._spawn_all()

    async def handle_config_change(self, old: Config, new: Config) -> None:
        relevant = (
            old.uri != new.uri
            or old.mtls_uri != new.mtls_uri
            or old.tls_cert_path != new.tls_cert_path
            or old.tls_key_path != new.tls_key_path
            or old.mtls_ca_cert_path != new.mtls_ca_cert_path
        )
        self.config = new
        if relevant:
            await self.reload()

    async def stop_listeners(self) -> None:
        if self.main:
            await self.main.shutdown()
            self.main = None
        if self.mtls:
            await self.mtls.shutdown()
            self.mtls = None

    async def stop(self) -> None:
        if self._cert_monitor:
            await self._cert_monitor.stop()
        await self.stop_listeners()
