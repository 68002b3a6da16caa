"""Twins of the reference's HTTPS / mTLS suites (tests/test_https_mtls.py and
tests/test_validator_tls_reload.py): each case runs on the JAX service and
on the port's (run.serve on torch.device("cpu"), bound to real sockets),
each over its own package's FakeDb, with certificates made by the
reference's own helper (test_https_mtls.make_cert).

| reference case | port test |
|---|---|
| test_https_mtls::TestHttps::test_https_endpoint | test_https_endpoint |
| test_https_mtls::TestHttps::test_mtls_endpoint_requires_client_cert | test_mtls_endpoint_requires_client_cert |
| test_https_mtls::TestBindRetry::test_retry_then_success | test_retry_then_success |
| test_validator_tls_reload::test_cert_rotation_reloads_listener | test_cert_rotation_reloads_listener |

Each side gets certificates of its own (the rotation compares each side's
listener with its own serials). Tolerance: statuses, bodies and the
outcome of every handshake (refused, accepted, the presented serial
matching the expected one) are equal on both sides. Every twin is bounded
by 60 s.
"""

import asyncio
import shutil
import socket
import ssl

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
aiohttp = pytest.importorskip("aiohttp")
pytest.importorskip("cryptography")

from aiohttp import web  # noqa: E402

from test_https_mtls import make_cert  # noqa: E402
from test_validator_tls_reload import _serial_over_tls  # noqa: E402
from torch_service_twins import assert_same  # noqa: E402
from torch_wire_twins import twin  # noqa: E402


def seeded_db(side):
    f = side.fake
    db = f.FakeDb()
    db.add_table(f.FakeTable("ks", "tbl", ("pk",)))
    rows = [f.vector_row((i,), [float(i), 0.0, 0.0], 100) for i in range(5)]
    db.add_index(f.FakeIndex(metadata=f.make_vs_metadata(dimensions=3), scan=rows))
    return db


async def wait_serving(side, service, timeout=10.0):
    deadline = asyncio.get_event_loop().time() + timeout
    while service.node_state.get_status() is not side.node_state.NodeStatus.SERVING:
        assert asyncio.get_event_loop().time() < deadline
        await asyncio.sleep(0.05)


async def test_https_endpoint(tmp_path):
    async def case(side):
        d = tmp_path / side.name
        d.mkdir()
        cert = make_cert(d, "localhost")
        config = side.config(uri="127.0.0.1:0", tls_cert_path=cert["cert_path"], tls_key_path=cert["key_path"],
                             monitor_indexes_interval=0.05)
        service = await side.serve(seeded_db(side), config)
        try:
            await wait_serving(side, service)
            port = service.http_server.main.port
            ctx = ssl.create_default_context(cafile=cert["cert_path"])
            async with aiohttp.ClientSession() as http:
                resp = await http.get(f"https://localhost:{port}/api/v1/status", ssl=ctx)
                return [resp.status, await resp.json()]
        finally:
            await service.stop()

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == [200, "SERVING"]


async def test_mtls_endpoint_requires_client_cert(tmp_path):
    async def case(side):
        d = tmp_path / side.name
        d.mkdir()
        ca = make_cert(d, "testca")
        server_cert = make_cert(d, "localhost", ca=ca)
        client_cert = make_cert(d, "client", ca=ca)
        config = side.config(uri="127.0.0.1:0", mtls_uri="127.0.0.1:0", tls_cert_path=server_cert["cert_path"],
                             tls_key_path=server_cert["key_path"], mtls_ca_cert_path=ca["cert_path"],
                             monitor_indexes_interval=0.05)
        service = await side.serve(seeded_db(side), config)
        try:
            await wait_serving(side, service)
            url = f"https://localhost:{service.http_server.mtls.port}/api/v1/status"
            try:
                async with aiohttp.ClientSession() as http:
                    await http.get(url, ssl=ssl.create_default_context(cafile=ca["cert_path"]))
                refused = False
            except aiohttp.ClientError:
                refused = True
            mctx = ssl.create_default_context(cafile=ca["cert_path"])
            mctx.load_cert_chain(client_cert["cert_path"], client_cert["key_path"])
            async with aiohttp.ClientSession() as http:
                resp = await http.get(url, ssl=mctx)
                return {"no_certificate_refused": refused, "with_certificate": resp.status}
        finally:
            await service.stop()

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == {"no_certificate_refused": True, "with_certificate": 200}


async def test_retry_then_success():
    async def case(side):
        spawn_server_with_retry = side.mod("http.server").spawn_server_with_retry
        blocker = socket.socket()
        blocker.bind(("127.0.0.1", 0))
        blocker.listen(1)
        port = blocker.getsockname()[1]

        async def release():
            await asyncio.sleep(0.8)
            blocker.close()

        rel = asyncio.get_running_loop().create_task(release())
        server = await spawn_server_with_retry(web.Application(), "127.0.0.1", port)
        await rel
        try:
            return server.port == port
        finally:
            await server.shutdown()

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port is True


async def test_cert_rotation_reloads_listener(tmp_path):
    async def case(side):
        d = tmp_path / side.name
        d.mkdir()
        cert_v1 = make_cert(d, "localhost")
        config = side.config(uri="127.0.0.1:0", tls_cert_path=cert_v1["cert_path"], tls_key_path=cert_v1["key_path"],
                             monitor_indexes_interval=0.05, tls_file_check_interval=0.1)
        service = await side.serve(seeded_db(side), config)
        try:
            await wait_serving(side, service)
            port = service.http_server.main.port
            out = {"serves_v1": await _serial_over_tls(port) == cert_v1["cert"].serial_number}
            v1_ctx = ssl.create_default_context(cafile=cert_v1["cert_path"])
            async with aiohttp.ClientSession() as http:
                out["v1_status"] = (await http.get(f"https://localhost:{port}/api/v1/status", ssl=v1_ctx)).status
            fresh = make_cert(d, "localhost-v2")
            shutil.copy(fresh["cert_path"], cert_v1["cert_path"])
            shutil.copy(fresh["key_path"], cert_v1["key_path"])
            deadline = asyncio.get_event_loop().time() + 15
            while True:
                try:
                    serial = await _serial_over_tls(port)
                except (ConnectionError, OSError, ssl.SSLError):
                    await asyncio.sleep(0.1)
                    continue
                if serial == fresh["cert"].serial_number:
                    break
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.1)
            out["serves_v2"] = True
            v2_ctx = ssl.create_default_context(cafile=fresh["cert_path"])
            async with aiohttp.ClientSession() as http:
                out["v2_status"] = (await http.get(f"https://localhost:{port}/api/v1/status", ssl=v2_ctx)).status
            try:
                async with aiohttp.ClientSession() as http:
                    await http.get(f"https://localhost:{port}/api/v1/status", ssl=v1_ctx)
                out["v1_rejected"] = False
            except aiohttp.ClientError:
                out["v1_rejected"] = True
            return out
        finally:
            await service.stop()

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port == {"serves_v1": True, "v1_status": 200, "serves_v2": True, "v2_status": 200, "v1_rejected": True}
