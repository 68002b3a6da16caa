"""CPU worker pool (reference worker.rs): a bounded thread pool sized to the
host cores executing blocking jobs (device batch calls, table work), with an
unbounded overflow thread per stuck job so a full pool never starves the
event loop (worker.rs:44-118's dedicated overflow OS thread).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import os
import threading
from typing import Callable, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")


class Worker:
    def __init__(self, threads: int | None = None) -> None:
        self.threads = threads or os.cpu_count() or 4
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.threads, thread_name_prefix="vs-worker"
        )
        self._active = 0
        self._lock = threading.Lock()

    def install_as_default(self, loop: asyncio.AbstractEventLoop) -> None:
        loop.set_default_executor(self._pool)

    async def spawn_blocking(self, fn: Callable[[], T]) -> T:
        """Run a blocking job; when every pool worker is busy, overflow to a
        dedicated thread instead of queueing behind them."""
        loop = asyncio.get_running_loop()
        with self._lock:
            overflow = self._active >= self.threads
            self._active += 1
        try:
            if overflow:
                fut: asyncio.Future = loop.create_future()

                def run() -> None:
                    try:
                        result = fn()
                        loop.call_soon_threadsafe(
                            lambda: fut.set_result(result) if not fut.done() else None
                        )
                    except BaseException as e:  # propagate to awaiter
                        loop.call_soon_threadsafe(
                            lambda: fut.set_exception(e) if not fut.done() else None
                        )

                threading.Thread(target=run, name="vs-overflow", daemon=True).start()
                return await fut
            return await loop.run_in_executor(self._pool, fn)
        finally:
            with self._lock:
                self._active -= 1

    async def spawn_non_blocking(self, fn: Callable[[], T]) -> T:
        """Short jobs (searches) go straight to the pool."""
        return await asyncio.get_running_loop().run_in_executor(self._pool, fn)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
