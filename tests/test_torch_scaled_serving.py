"""The port's multi-process serving: ``run.serve_scaled`` keeps the engines
in this (owner) process and spawns SO_REUSEPORT HTTP frontends that
forward requests over the owner IPC (service/ipc.py, http/frontend.py).

Twins of tests/test_scaled_serving.py (end to end; the IPC batching path)
on ``torch.device("cpu")`` with two workers; a parity case holding the
frontends' answers (both batching modes) to the port's in-process service
for the same rows and requests, errors, a filtered request, an index the
port cannot serve and ``/api/v1/info`` included; and a case that reads
each frontend's environment: the workers see no GPU.
"""

import asyncio
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
aiohttp = pytest.importorskip("aiohttp")

import vector_store_tpu_torch  # noqa: E402
from vector_store_tpu_torch.db.fake import FakeDb, FakeIndex, FakeTable, make_vs_metadata, vector_row  # noqa: E402
from vector_store_tpu_torch.run import serve, serve_scaled  # noqa: E402
from vector_store_tpu_torch.service.config import Config  # noqa: E402
from vector_store_tpu_torch.service.node_state import IndexStatus  # noqa: E402

CPU = torch.device("cpu")
RNG = np.random.default_rng(202)
WORKERS = 2


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def seeded_db(vecs, labels=None, **md_kwargs) -> FakeDb:
    """One global index over ``vecs``; with ``labels``, a filtering column
    ``bucket`` (row i holds labels[i])."""
    db = FakeDb()
    if labels is None:
        db.add_table(FakeTable("ks", "tbl", ("pk",)))
        rows = [vector_row((i,), vecs[i].tolist(), 100) for i in range(len(vecs))]
    else:
        db.add_table(FakeTable("ks", "tbl", ("pk",), columns={"bucket": "int"}))
        rows = [
            vector_row((i,), vecs[i].tolist(), 100, filtering=[(100, int(labels[i]))])
            for i in range(len(vecs))
        ]
        md_kwargs["filtering_columns"] = ("bucket",)
    db.add_index(FakeIndex(metadata=make_vs_metadata(dimensions=vecs.shape[1], **md_kwargs), scan=rows))
    return db


async def wait_serving(http, url, n, timeout=60):
    """Until the frontends (or the in-process server) answer SERVING at n rows."""
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        try:
            resp = await http.get(f"{url}/api/v1/indexes/ks/idx/status")
            if resp.status == 200:
                data = await resp.json()
                if data["status"] == "SERVING" and data["count"] == n:
                    return
        except aiohttp.ClientError:
            pass
        assert asyncio.get_event_loop().time() < deadline
        await asyncio.sleep(0.1)


async def test_scaled_serving_end_to_end():
    n, dims = 40, 8
    vecs = RNG.normal(size=(n, dims)).astype(np.float32)
    port = free_port()
    config = Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.05)
    service = await serve_scaled(seeded_db(vecs), config, workers=WORKERS, device=CPU)
    try:
        url = f"http://127.0.0.1:{port}"
        async with aiohttp.ClientSession() as http:
            await wait_serving(http, url, n, timeout=30)

            # node + service info through the frontends
            assert await (await http.get(f"{url}/api/v1/status")).json() == "SERVING"
            info = await (await http.get(f"{url}/api/v1/info")).json()
            assert info["service"] == "scylla-vector-store"

            # concurrent correctness across workers
            async def one(i):
                resp = await http.post(
                    f"{url}/api/v1/indexes/ks/idx/ann",
                    json={"vector": vecs[i % n].tolist(), "limit": 3},
                )
                assert resp.status == 200
                data = await resp.json()
                assert data["primary_keys"]["pk"][0] == i % n
                assert len(data["distances"]) == 3

            await asyncio.gather(*(one(i) for i in range(80)))

            # error paths travel through the IPC too
            resp = await http.post(f"{url}/api/v1/indexes/ks/nope/ann", json={"vector": [0.0] * dims})
            assert resp.status == 404
            resp = await http.post(f"{url}/api/v1/indexes/ks/idx/ann", json={"vector": [0.0] * 3})
            assert resp.status == 400

            # metrics come from the owner
            text = await (await http.get(f"{url}/metrics")).text()
            assert "request_latency_seconds" in text
    finally:
        await service.stop()
    assert all(not p.is_alive() for p in service.frontends)


async def test_scaled_serving_with_ipc_batching(monkeypatch):
    """The IPC batching path (VECTOR_STORE_FRONTEND_BATCH=1): 120
    concurrent requests coalesce into ann_batch messages."""
    monkeypatch.setenv("VECTOR_STORE_FRONTEND_BATCH", "1")
    n, dims = 30, 8
    vecs = RNG.normal(size=(n, dims)).astype(np.float32)
    port = free_port()
    service = await serve_scaled(
        seeded_db(vecs), Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.05),
        workers=WORKERS, device=CPU,
    )
    try:
        url = f"http://127.0.0.1:{port}"
        async with aiohttp.ClientSession() as http:
            await wait_serving(http, url, n, timeout=30)

            async def one(i):
                resp = await http.post(
                    f"{url}/api/v1/indexes/ks/idx/ann",
                    json={"vector": vecs[i % n].tolist(), "limit": 2},
                )
                assert resp.status == 200, await resp.text()
                data = await resp.json()
                assert data["primary_keys"]["pk"][0] == i % n

            await asyncio.gather(*(one(i) for i in range(120)))
    finally:
        await service.stop()


async def _answers(http, url, requests) -> list:
    """(status, body) of each request, the body parsed when it is JSON."""
    async def one(path, body):
        if body is None:
            resp = await http.get(f"{url}{path}")
        else:
            resp = await http.post(f"{url}{path}", json=body)
        text = await resp.text()
        try:
            return resp.status, await resp.json(content_type=None)
        except ValueError:
            return resp.status, text

    return await asyncio.gather(*(one(path, body) for path, body in requests))


def _same(got, want) -> None:
    """Equal answers: the same statuses, keys and order; distances and
    similarity scores within 1e-6; any other body equal."""
    assert len(got) == len(want)
    for (gs, gb), (ws, wb) in zip(got, want):
        assert gs == ws, (gs, gb, ws, wb)
        if isinstance(wb, dict) and "distances" in wb:
            assert gb["primary_keys"] == wb["primary_keys"]
            for field in ("distances", "similarity_scores"):
                np.testing.assert_allclose(gb[field], wb[field], rtol=0, atol=1e-6)
        else:
            assert gb == wb, (gb, wb)


@pytest.mark.parametrize("batch", ["1", "0"], ids=["frontend-batch", "no-frontend-batch"])
async def test_frontends_answer_as_the_in_process_service(batch, monkeypatch):
    """The same rows and requests through serve_scaled's frontends (with
    and without VECTOR_STORE_FRONTEND_BATCH) and through the port's
    in-process service answer alike: keys in the same order, distances
    within 1e-6, the same errors; /api/v1/info, a filtered request, the
    index list and status too, and a second index under an engine the
    port does not serve (the actor's NotImplementedError reaches the
    client as the same 500)."""
    monkeypatch.setenv("VECTOR_STORE_FRONTEND_BATCH", batch)
    n, dims = 48, 8
    rng = np.random.default_rng(31)
    vecs = rng.normal(size=(n, dims)).astype(np.float32)
    labels = rng.integers(0, 3, size=n)
    queries = vecs[rng.integers(0, n, size=24)] + 0.05 * rng.normal(size=(24, dims)).astype(np.float32)
    ann = "/api/v1/indexes/ks/idx/ann"
    requests = [(ann, {"vector": q.tolist(), "limit": 5}) for q in queries]
    requests += [(ann, {"vector": vecs[i].tolist(), "limit": 3}) for i in (0, 7, 19)]
    requests += [
        (ann, {"vector": queries[0].tolist(), "limit": 4,
               "filter": {"restrictions": [{"type": "==", "lhs": "bucket", "rhs": 2}], "allow_filtering": True}}),
        (ann, {"vector": queries[1].tolist(), "limit": 4,
               "filter": {"restrictions": [{"type": "==", "lhs": "bucket", "rhs": 1}], "allow_filtering": False}}),
        ("/api/v1/indexes/ks/nope/ann", {"vector": [0.0] * dims, "limit": 1}),
        (ann, {"vector": [0.0] * 3, "limit": 1}),
        (ann, {"vector": [1.0] * dims, "limit": 0}),
        ("/api/v1/info", None),
        ("/api/v1/status", None),
        ("/api/v1/indexes/ks/idx/status", None),
        ("/api/v1/indexes/ks/nope/status", None),
    ]

    async def run(start):
        port = free_port()
        config = Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.05)
        service = await start(seeded_db(vecs, labels), config)
        try:
            url = f"http://127.0.0.1:{port}"
            async with aiohttp.ClientSession() as http:
                await wait_serving(http, url, n)
                answers = await _answers(http, url, requests)
                answers += await _answers(http, url, [("/api/v1/indexes", None)])
            return answers, service
        finally:
            await service.stop()

    want, _ = await run(lambda db, config: serve(db, config, device=CPU))
    got, scaled = await run(lambda db, config: serve_scaled(db, config, workers=WORKERS, device=CPU))
    _same(got, want)
    info = want[len(requests) - 4][1]
    assert info == {"engine": "vector-store-tpu", "service": vector_store_tpu_torch.SERVICE_NAME,
                    "version": vector_store_tpu_torch.__version__}
    filtered = want[len(queries) + 3]
    assert filtered[0] == 200 and all(labels[pk] == 2 for pk in filtered[1]["primary_keys"]["pk"])
    assert [status for status, _ in want[len(queries) + 4 : len(queries) + 7]] == [400, 404, 400]
    assert want[len(queries)][1]["primary_keys"]["pk"][0] == 0

    # an index the port cannot serve answers the same 500 through the IPC
    async def unsupported(start):
        port = free_port()
        config = Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.05, engine_kind="ivf-sharded")
        service = await start(seeded_db(vecs[:4]), config)
        try:
            url = f"http://127.0.0.1:{port}"
            async with aiohttp.ClientSession() as http:
                deadline = asyncio.get_event_loop().time() + 60
                while (entry := service.indexes.get_vs(("ks", "idx"))) is None or (
                    entry.status is not IndexStatus.SERVING
                ):
                    assert asyncio.get_event_loop().time() < deadline
                    await asyncio.sleep(0.05)
                while True:  # until a frontend answers
                    try:
                        return await _answers(http, url, [
                            (ann, {"vector": vecs[0].tolist(), "limit": 1}),
                            ("/api/v1/indexes/ks/idx/status", None),
                        ])
                    except aiohttp.ClientError:
                        assert asyncio.get_event_loop().time() < deadline
                        await asyncio.sleep(0.1)
        finally:
            await service.stop()

    want = await unsupported(lambda db, config: serve(db, config, device=CPU))
    got = await unsupported(lambda db, config: serve_scaled(db, config, workers=1, device=CPU))
    assert [status for status, _ in want] == [500, 500] and "not ported yet" in want[0][1]
    _same(got, want)
    assert all(not p.is_alive() for p in scaled.frontends)


async def test_frontends_see_no_gpu(monkeypatch):
    """Each frontend process is spawned with CUDA_VISIBLE_DEVICES set empty
    (no frontend may open a CUDA context), and the owner's environment is
    as it was."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    vecs = RNG.normal(size=(8, 4)).astype(np.float32)
    port = free_port()
    service = await serve_scaled(
        seeded_db(vecs), Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.05),
        workers=WORKERS, device=CPU,
    )
    try:
        assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"
        assert len(service.frontends) == WORKERS
        for proc in service.frontends:
            assert proc.is_alive() and proc.pid != os.getpid()
            with open(f"/proc/{proc.pid}/environ", "rb") as f:
                env = dict(
                    item.split(b"=", 1) for item in f.read().split(b"\0") if b"=" in item
                )
            assert env[b"CUDA_VISIBLE_DEVICES"] == b""
        async with aiohttp.ClientSession() as http:
            await wait_serving(http, f"http://127.0.0.1:{port}", len(vecs), timeout=30)
    finally:
        await service.stop()
    assert all(not p.is_alive() for p in service.frontends)
    assert not os.path.exists(service.ipc_server.path)
