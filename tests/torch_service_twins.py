"""Shared helpers of the twins of the reference's in-process service
suites (tests/test_integration_service.py, test_ivf_service.py,
test_routing.py, test_streaming_load.py): one case runs on the JAX
service and on the port's (vector_store_tpu_torch.run.build_service on
torch.device("cpu")), each over its own package's FakeDb seeded with the
same rows, and the two runs' observations are compared.

Each side hands a case its own package's ``types`` and ``fake`` modules
and its Config: nothing typed by the JAX package crosses into the port.
"""

import asyncio
import json
from dataclasses import dataclass
from types import ModuleType
from typing import Any, Awaitable, Callable

import numpy as np
import torch
from aiohttp.test_utils import TestClient, TestServer

import vector_store_tpu.core.types as jax_types
import vector_store_tpu.db.fake as jax_fake
import vector_store_tpu.service.config as jax_config
import vector_store_tpu_torch.core.types as port_types
import vector_store_tpu_torch.db.fake as port_fake
import vector_store_tpu_torch.service.config as port_config

CPU = torch.device("cpu")
# a twin's own bound: a hang fails its test, not the suite's time limit
TWIN_TIMEOUT_S = 60.0


@dataclass(frozen=True)
class Side:
    name: str
    types: ModuleType
    fake: ModuleType
    config_cls: type

    async def build(self, db, **config_kwargs):
        config = self.config_cls(monitor_indexes_interval=0.05, **config_kwargs)
        if self.name == "jax":
            from vector_store_tpu.run import build_service

            return await build_service(db, config)
        from vector_store_tpu_torch.run import build_service

        return await build_service(db, config, device=CPU)

    async def start(self, db, **config_kwargs):
        """The service over ``db`` on a test server: (service, client)."""
        service = await self.build(db, **config_kwargs)
        client = TestClient(TestServer(service.app))
        await client.start_server()
        return service, client


JAX = Side("jax", jax_types, jax_fake, jax_config.Config)
PORT = Side("port", port_types, port_fake, port_config.Config)


async def stop(service, client) -> None:
    await client.close()
    await service.stop()


async def twin(case: Callable[[Side], Awaitable[Any]], timeout: float = TWIN_TIMEOUT_S):
    """Run ``case`` on the JAX side, then on the port's, together within
    ``timeout`` seconds; returns (jax observations, port observations)."""

    async def both():
        return await case(JAX), await case(PORT)

    return await asyncio.wait_for(both(), timeout)


def assert_same(port: Any, jax: Any, norm2: float = 0.0, path: str = "") -> None:
    """Observations equal: keys, statuses, texts exactly; floats within
    1e-6 * (1 + |x|) + 1e-6 * norm2 (the rows' largest squared norm: below
    a build the JAX engine reports its delta's f32 device distances, the
    port the f32 host mirror's)."""
    if isinstance(jax, dict):
        assert isinstance(port, dict) and set(port) == set(jax), (path, port, jax)
        for key in jax:
            assert_same(port[key], jax[key], norm2, f"{path}.{key}")
    elif isinstance(jax, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(jax), (path, port, jax)
        for i, (p, j) in enumerate(zip(port, jax)):
            assert_same(p, j, norm2, f"{path}[{i}]")
    elif isinstance(jax, float) and not isinstance(jax, bool):
        assert abs(port - jax) <= 1e-6 * (1 + abs(jax)) + 1e-6 * norm2, (path, port, jax)
    else:
        assert port == jax, (path, port, jax)


async def request(client, method: str, path: str, **kw) -> tuple[int, Any]:
    """(status, JSON body, or the text of a body that is not JSON)."""
    async with client.request(method, path, **kw) as resp:
        text = await resp.text()
        try:
            return resp.status, json.loads(text)
        except ValueError:
            return resp.status, text


async def wait_for(fn, timeout=10.0, interval=0.02):
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        result = fn() if not asyncio.iscoroutinefunction(fn) else await fn()
        if result:
            return result
        if asyncio.get_event_loop().time() > deadline:
            raise TimeoutError("condition not met")
        await asyncio.sleep(interval)


async def wait_serving(client, ks, idx, timeout=15.0, count=None):
    """Until the index is SERVING (with ``count`` rows, if given)."""

    async def check():
        resp = await client.get(f"/api/v1/indexes/{ks}/{idx}/status")
        if resp.status != 200:
            return False
        data = await resp.json()
        return data["status"] == "SERVING" and (count is None or data["count"] == count)

    deadline = asyncio.get_event_loop().time() + timeout
    while not await check():
        if asyncio.get_event_loop().time() > deadline:
            raise TimeoutError("index never became SERVING")
        await asyncio.sleep(0.05)


def norm2(vecs) -> float:
    return float((np.asarray(vecs, np.float32) ** 2).sum(-1).max())
