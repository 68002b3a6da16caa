"""Memory governor (reference memory.rs): computes an allocation budget from
available system memory (cgroup-aware) and a configured limit, publishing
Can/Cannot to the index actors. Adds are dropped under pressure rather than
OOMing the process; ScyllaDB remains the source of truth.

limit = min(config_limit, available - max(1% of total, 200 MB))
(memory.rs:23-25,149-159)

On this architecture the binding resource is usually device memory, not
host RAM: index engines register here and report their device-tensor
footprint (engine.device_bytes), and allocation is denied when the sum
approaches the device budget. The budget is the engine device's total
memory as torch.cuda.mem_get_info reports it, less a reserve, overridable
via VECTOR_STORE_DEVICE_MEMORY_LIMIT; a CPU device has none (the host RAM
governor covers it).
"""

from __future__ import annotations

import asyncio
import logging
import os
import weakref

import torch

logger = logging.getLogger(__name__)

RESERVE_FRACTION = 0.01
RESERVE_MIN_BYTES = 200 * 1024 * 1024
CHECK_INTERVAL = 1.0
# headroom for transient buffers (rebuild snapshots, scan candidates)
DEVICE_RESERVE_FRACTION = 0.10


def detect_device_budget(device: torch.device) -> int | None:
    """Device memory budget in bytes, or None for the CPU."""
    env = os.environ.get("VECTOR_STORE_DEVICE_MEMORY_LIMIT")
    if env:
        return int(env)
    if device.type != "cuda":
        return None  # host RAM governor already covers it
    _free, total = torch.cuda.mem_get_info(device)
    return total - int(total * DEVICE_RESERVE_FRACTION)


def _read_meminfo() -> tuple[int, int]:
    """(total_bytes, available_bytes) from /proc/meminfo."""
    total = avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                total = int(line.split()[1]) * 1024
            elif line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    return total, avail


def _cgroup_limit() -> int | None:
    for path in ("/sys/fs/cgroup/memory.max", "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            raw = open(path).read().strip()
            if raw != "max":
                v = int(raw)
                if v < 1 << 60:
                    return v
        except (OSError, ValueError):
            continue
    return None


def _cgroup_current() -> int | None:
    for path in ("/sys/fs/cgroup/memory.current", "/sys/fs/cgroup/memory/memory.usage_in_bytes"):
        try:
            return int(open(path).read().strip())
        except (OSError, ValueError):
            continue
    return None


class MemoryGovernor:
    def __init__(
        self,
        device: torch.device,
        limit_bytes: int | None = None,
        device_limit_bytes: int | None = None,
    ) -> None:
        self.config_limit = limit_bytes
        self.device_limit = (
            device_limit_bytes
            if device_limit_bytes is not None
            else detect_device_budget(device)
        )
        self.can_allocate = True
        self._engines: list[weakref.ref] = []
        self._task: asyncio.Task | None = None
        self._stopped = False
        self.check()

    def register_engine(self, engine) -> None:
        """Track a device index engine's memory footprint (engine must expose
        device_bytes). Dead refs are pruned on check."""
        self._engines.append(weakref.ref(engine))

    def device_bytes_used(self) -> int:
        total = 0
        live: list[weakref.ref] = []
        for ref in self._engines:
            eng = ref()
            if eng is None:
                continue
            live.append(ref)
            try:
                total += int(eng.device_bytes)
            except Exception:
                pass
        self._engines = live
        return total

    def host_bytes_used(self) -> int:
        """Sum of registered engines' host-RAM mirrors (engine.host_bytes).
        The meminfo-based budget already sees this memory as used; explicit
        attribution lets the config limit bind on what the indexes actually
        hold even when MemAvailable lags (page cache churn), and makes the
        host tier observable."""
        total = 0
        for ref in self._engines:
            eng = ref()
            if eng is None:
                continue
            try:
                total += int(getattr(eng, "host_bytes", 0))
            except Exception:
                pass
        return total

    def check(self) -> bool:
        try:
            total, avail = _read_meminfo()
            cg_limit = _cgroup_limit()
            cg_cur = _cgroup_current()
            if cg_limit is not None and cg_cur is not None:
                total = min(total, cg_limit)
                avail = min(avail, cg_limit - cg_cur)
            reserve = max(int(total * RESERVE_FRACTION), RESERVE_MIN_BYTES)
            budget = avail - reserve
            if self.config_limit is not None:
                used = max(total - avail, self.host_bytes_used())
                budget = min(budget, self.config_limit - used)
            ok = budget > 0
            if ok and self.device_limit is not None and self._engines:
                ok = self.device_bytes_used() < self.device_limit
            self.can_allocate = ok
        except OSError:
            logger.warning("memory governor: failed to read memory info")
            self.can_allocate = True
        return self.can_allocate

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

    async def _run(self) -> None:
        while not self._stopped:
            await asyncio.sleep(CHECK_INTERVAL)
            was = self.can_allocate
            now = self.check()
            if was and not now:
                logger.warning("memory limit reached: new vectors will be dropped")
            elif now and not was:
                logger.info("memory pressure relieved: accepting vectors again")
