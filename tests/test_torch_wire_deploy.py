"""The deployed path of chip_smoke.py phase 17 on the CPU, small: the fake
ScyllaDB node (vector_store_tpu_torch/db/cql/fake_scylla.py) over 4,096 x
128 rows with 16 ring tokens (17 scan ranges) and a node page limit of 100
rows, so every range pages through ``paging_state``; the service built as
run.main builds it (ConfigManager from the VECTOR_STORE_* variables of
chip_smoke.wire_env, run.make_scylla_db with the node's username and
password file, run.serve with HTTPS and the mTLS endpoint, certificates
from chip_smoke.make_certs), on torch.device("cpu"), with the IVF engine's
min_build lowered so the main region builds (as
tests/test_torch_ivf_service.py lowers it).

test_deployed_path runs the path on the JAX service and on the port's,
each over its own package's fake CQL server answering from a node over
the same rows, and holds: every row served by the scan once (the node's
count of rows sent, the index's count); self-queries first at distance 0
over HTTPS; the mTLS endpoint refusing a client with no certificate and
answering one with its certificate; a CDC insert and a CDC update of a
stored row found first at distance 0; a CDC insert found after every CQL
connection was dropped and the session reconnected. Tolerance: counts,
keys and statuses equal on both sides, distances within 1e-6 * (1 + |x|)
(torch_service_twins.assert_same). Bounded by 60 s.

test_entry_point_refuses_cpu: ``python -m vector_store_tpu_torch.run`` on a
host with no CUDA device exits non-zero with the "no CUDA device" error;
it never falls back to the CPU.

test_int_binds_as_bigint_on_both_sides holds the fault both CQL clients share
(ROADMAP queue 3): a Python int is bound as 8 bytes, which the node, as
Scylla, accepts for its bigint key and would refuse for an int column.
"""

import asyncio
import contextlib
import os
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
aiohttp = pytest.importorskip("aiohttp")
pytest.importorskip("cryptography")

import chip_smoke  # noqa: E402
from torch_service_twins import assert_same  # noqa: E402
from torch_wire_twins import JAX, PORT, twin  # noqa: E402
from vector_store_tpu_torch.db.cql.fake_scylla import ScyllaNode, node_server  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
N, DIMS = 4096, 128
PAGE_ROWS = 100
KEY = ("ks", "idx")


def free_port() -> int:
    return chip_smoke.free_port()


async def found_first(client, base: str, pk: int, vector, timeout: float = 30.0):
    """(key, distance) of the first answer once ``pk`` is found first."""
    deadline = time.time() + timeout
    while True:
        async with client.post(f"{base}/ann", json={"vector": [float(x) for x in vector], "limit": 3}) as resp:
            body = await resp.json()
        if resp.status == 200 and body["primary_keys"]["pk"][:1] == [pk]:
            return [pk, body["distances"][0]]
        assert time.time() < deadline, body
        await asyncio.sleep(0.05)


async def test_deployed_path(tmp_path):
    rng = np.random.default_rng(17)
    rows = chip_smoke.clustered_rows(rng, N)
    new = chip_smoke.clustered_rows(rng, 3)
    certs = chip_smoke.make_certs(str(tmp_path))
    password_file = chip_smoke.write_password(str(tmp_path))

    async def case(side):
        node = ScyllaNode(rows, page_rows=PAGE_ROWS)
        server = node_server(side.testing.FakeCqlServer)(node, require_auth=chip_smoke.WIRE_CREDENTIALS)
        await server.start()
        http_port, mtls_port = free_port(), free_port()
        env = chip_smoke.wire_env(server.port, http_port, mtls_port, certs, password_file)
        service = None
        try:
            with chip_smoke.environment(env):
                config = side.mod("service.config").ConfigManager().config
                db = side.run.make_scylla_db(config)
                service = await side.serve(db, config)
            base = f"https://127.0.0.1:{http_port}/api/v1/indexes/ks/idx"
            connector = aiohttp.TCPConnector(ssl=chip_smoke.tls_client(certs))
            async with aiohttp.ClientSession(connector=connector) as http:
                deadline = time.time() + 30
                while True:
                    with contextlib.suppress(aiohttp.ClientError):
                        async with http.get(f"{base}/status") as resp:
                            if resp.status == 200 and (await resp.json())["count"] == N:
                                break
                    assert time.time() < deadline
                    await asyncio.sleep(0.05)
                out = {"rows_served": node.rows_served, "paged": node.pages > 17,
                       "node": service.node_state.get_status().name}

                actor = service.indexes.get_vs(side.types.IndexKey(*KEY)).actor
                engine = actor.engine
                engine.min_build, engine.kmeans_block = 1024, 512
                if side.name == "jax":
                    engine.interpret = True
                while engine.main_vecs is None:
                    assert time.time() < deadline + 30
                    actor._modify_event.set()
                    await asyncio.sleep(0.1)
                out["ivf_built"] = engine.nlist > 0
                out["self"] = [await found_first(http, base, int(i), rows[i]) for i in (0, 7, 1234, N - 1)]

                mtls = f"https://127.0.0.1:{mtls_port}/api/v1/status"
                try:
                    async with aiohttp.ClientSession() as bare:
                        await bare.get(mtls, ssl=chip_smoke.tls_client(certs))
                    out["mtls_no_certificate"] = "answered"
                except aiohttp.ClientError:
                    out["mtls_no_certificate"] = "refused"
                async with aiohttp.ClientSession() as signed:
                    async with signed.get(mtls, ssl=chip_smoke.tls_client(certs, with_client_cert=True)) as resp:
                        out["mtls_with_certificate"] = resp.status

                node.write(N, new[0])
                out["cdc_insert"] = await found_first(http, base, N, new[0])
                node.write(5, new[1])
                out["cdc_update"] = await found_first(http, base, 5, new[1])
                reconnects = db.session.reconnects
                server.drop_all_connections()
                node.write(N + 1, new[2])
                out["after_drop"] = await found_first(http, base, N + 1, new[2])
                out["reconnected"] = db.session.reconnects > reconnects
                async with http.get(f"{base}/status") as resp:
                    out["count"] = (await resp.json())["count"]
            return out
        finally:
            if service is not None:
                await service.stop()
            await server.stop()

    jax, port = await twin(case)
    assert_same(port, jax)
    assert port["rows_served"] == N and port["paged"] and port["node"] == "SERVING" and port["ivf_built"]
    assert all(abs(d) <= 1e-6 for _, d in port["self"])
    assert port["mtls_no_certificate"] == "refused" and port["mtls_with_certificate"] == 200
    for key in ("cdc_insert", "cdc_update", "after_drop"):
        assert abs(port[key][1]) <= 1e-6, (key, port[key])
    assert port["reconnected"] and port["count"] == N + 2


def test_entry_point_refuses_cpu():
    env = {k: v for k, v in os.environ.items() if not k.startswith("VECTOR_STORE_")}
    env["VECTOR_STORE_SCYLLADB_URI"] = f"127.0.0.1:{free_port()}"
    env["VECTOR_STORE_URI"] = f"127.0.0.1:{free_port()}"
    out = subprocess.run([sys.executable, "-m", "vector_store_tpu_torch.run"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr[-2000:]


def test_int_binds_as_bigint_on_both_sides():
    base_row = 'SELECT "emb", writetime("emb") FROM "ks"."tbl" WHERE "pk" = ?'
    node = ScyllaNode(np.eye(4, 3, dtype=np.float32))
    for side in (JAX, PORT):
        ct = side.ct
        assert len(ct.encode_bind(1)) == 8 and len(ct.encode_bind(ct.Int32(1))) == 4
        assert node.respond(base_row, [ct.encode_bind(1)], None, None)  # a bigint key: found
        with pytest.raises(ValueError, match="Expected 8"):
            node.respond(base_row, [ct.encode_bind(ct.Int32(1))], None, None)
    assert struct.unpack("!q", PORT.ct.encode_bind(1)) == (1,)
