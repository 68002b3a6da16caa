"""Content-hash file change detection (reference file_monitor.rs): used for
TLS certificate rotation — certs are re-checked periodically by hashing the
file contents, so in-place rewrites and symlink flips are both caught."""

from __future__ import annotations

import asyncio
import hashlib
import logging
from typing import Callable

logger = logging.getLogger(__name__)

DEFAULT_INTERVAL = 30.0


def content_hash(path: str) -> bytes | None:
    try:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).digest()
    except OSError:
        return None


class FileMonitor:
    def __init__(
        self,
        paths: list[str],
        on_change: Callable[[], None],
        interval: float = DEFAULT_INTERVAL,
    ) -> None:
        self.paths = paths
        self.on_change = on_change
        self.interval = interval
        self._hashes = {p: content_hash(p) for p in paths}
        self._task: asyncio.Task | None = None
        self._stopped = False

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

    def check(self) -> bool:
        changed = False
        for p in self.paths:
            h = content_hash(p)
            if h != self._hashes.get(p):
                self._hashes[p] = h
                changed = True
        return changed

    async def _run(self) -> None:
        while not self._stopped:
            await asyncio.sleep(self.interval)
            if self.check():
                logger.info("monitored file content changed: %s", self.paths)
                try:
                    self.on_change()
                except Exception:
                    logger.exception("file change callback failed")
