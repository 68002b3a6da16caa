"""In-process pipeline benchmark.

Reference counterpart: `crates/vector-store/benches/pipeline.rs` — a
criterion bench that runs the WHOLE service in one process against the
`db_basic` fake (no ScyllaDB, no network socket; pipeline.rs:5-8 includes
the integration fake, requests go through the in-proc test client) and
measures ingest + query throughput of the host pipeline with a
`BENCHES_CONCURRENCY` knob (pipeline.rs:74-100).

Here (the port's counterpart of the JAX package's benchkit/pipeline.py):
FakeDb scan feed -> monitor_items -> Table -> index engine, queried
through the in-process aiohttp app (no socket). Runs on the CPU as well as
the GPU (``run(device)``; the engines run the kernels' plain PyTorch
versions on the CPU), so it isolates the HOST pipeline cost (actor hops,
table LWW, JSON, routing) from the device kernels, which is what the
reference's bench isolates (their engine cost is in-process C++).

Phases:
  ingest : N rows through the full-scan path to SERVING  -> rows/s
  query  : closed-loop concurrent ANN POSTs              -> QPS, p50/p99 ms
  mixed  : same query load under continuous CDC upserts  -> QPS, upserts/s

Env knobs (names mirror the reference where one exists):
  BENCHES_CONCURRENCY  concurrent closed-loop clients (default 16)
  PIPELINE_N           rows to ingest (default 20_000)
  PIPELINE_D           vector dimensions (default 64)
  PIPELINE_SECONDS     measurement window per phase (default 10)
  BENCH_DEVICE         the engines' device (default cuda; cpu)

Prints ONE JSON line with every number (the repo's artifact convention).
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time

import numpy as np


async def _wait_serving(client, n: int, deadline_s: float = 300.0) -> float:
    t0 = time.monotonic()
    while True:
        resp = await client.get("/api/v1/indexes/ks/idx/status")
        if resp.status == 200:
            d = await resp.json()
            if d["status"] == "SERVING" and d["count"] == n:
                return time.monotonic() - t0
        if time.monotonic() - t0 > deadline_s:
            raise TimeoutError(f"not SERVING after {deadline_s}s")
        await asyncio.sleep(0.05)


async def _query_phase(
    client, dims: int, concurrency: int, seconds: float, rng
) -> dict:
    """Closed-loop clients; per-request latency collected for percentiles."""
    stop = time.monotonic() + seconds
    lat: list[float] = []
    errors = []
    # pre-generate query payloads so JSON encoding of the vector (a real
    # cost the reference also pays) is inside the loop but numpy isn't
    payloads = [
        {"vector": rng.normal(size=dims).astype(np.float32).tolist(), "limit": 10}
        for _ in range(256)
    ]

    async def worker(wid: int) -> None:
        i = wid
        while time.monotonic() < stop:
            t0 = time.monotonic()
            resp = await client.post(
                "/api/v1/indexes/ks/idx/ann", json=payloads[i % 256]
            )
            if resp.status != 200:
                errors.append(resp.status)
            else:
                await resp.json()
            lat.append(time.monotonic() - t0)
            i += concurrency

    t0 = time.monotonic()
    await asyncio.gather(*(worker(w) for w in range(concurrency)))
    dt = time.monotonic() - t0
    lat_ms = np.asarray(lat) * 1e3
    return {
        "qps": round(len(lat) / dt, 1),
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 2),
        "p99_ms": round(float(np.percentile(lat_ms, 99)), 2),
        "errors": len(errors),
    }


async def run(device=None) -> dict:
    from vector_store_tpu_torch.benchkit.common import bench_device
    from vector_store_tpu_torch.db.fake import (
        FakeDb,
        FakeIndex,
        FakeTable,
        make_vs_metadata,
        vector_row,
    )
    from vector_store_tpu_torch.run import build_service
    from vector_store_tpu_torch.service.config import Config

    from aiohttp.test_utils import TestClient, TestServer

    device = bench_device(device)
    n = int(os.environ.get("PIPELINE_N", 20_000))
    dims = int(os.environ.get("PIPELINE_D", 64))
    concurrency = int(os.environ.get("BENCHES_CONCURRENCY", 16))
    seconds = float(os.environ.get("PIPELINE_SECONDS", 10))
    rng = np.random.default_rng(42)

    out: dict = {
        "bench": "pipeline",
        "n": n,
        "d": dims,
        "concurrency": concurrency,
    }

    db = FakeDb()
    db.add_table(FakeTable("ks", "tbl", ("pk",)))
    base = rng.normal(size=(n, dims)).astype(np.float32)
    rows = [vector_row((i,), base[i].tolist(), 100) for i in range(n)]
    db.add_index(FakeIndex(metadata=make_vs_metadata(dimensions=dims), scan=rows))

    service = await build_service(db, Config(monitor_indexes_interval=0.05), device=device)
    client = TestClient(TestServer(service.app))
    await client.start_server()
    try:
        # ── ingest: full scan -> table -> engine, to SERVING ──
        ingest_s = await _wait_serving(client, n)
        out["ingest_seconds"] = round(ingest_s, 2)
        out["ingest_rows_per_sec"] = round(n / ingest_s, 1)

        # warm the query path: a concurrent burst so the actor's batch
        # WINDOW shapes compile too (sequential posts only warm batch=1;
        # the measured phase dispatches windows of up to `concurrency`)
        warm = {"vector": base[0].tolist(), "limit": 10}
        for _ in range(3):
            await asyncio.gather(
                *(
                    client.post("/api/v1/indexes/ks/idx/ann", json=warm)
                    for _ in range(concurrency)
                )
            )

        # ── query: closed-loop concurrent ANN ──
        out["query"] = await _query_phase(client, dims, concurrency, seconds, rng)

        # ── mixed: same load while CDC upserts stream in ──
        dbi = db.db_indexes[("ks", "idx")]
        stop_writer = asyncio.Event()
        upserts = 0

        # paced writer: an unpaced closed loop starves the query side of
        # the event loop and measures writer saturation, not mixed serving
        rate = float(os.environ.get("PIPELINE_UPSERT_RATE", 500.0))

        async def writer() -> None:
            nonlocal upserts
            ts = 200
            t0 = time.monotonic()
            while not stop_writer.is_set():
                pk = n + (upserts % 10_000)
                vec = rng.normal(size=dims).astype(np.float32)
                await dbi.push_cdc(vector_row((pk,), vec.tolist(), ts))
                ts += 1
                upserts += 1
                lead = upserts / rate - (time.monotonic() - t0)
                if lead > 0:
                    await asyncio.sleep(lead)

        wtask = asyncio.get_running_loop().create_task(writer())
        out["mixed"] = await _query_phase(client, dims, concurrency, seconds, rng)
        stop_writer.set()
        await wtask
        out["mixed"]["upserts_per_sec"] = round(upserts / seconds, 1)
    finally:
        await client.close()
        await service.stop()

    out["platform"] = device.type
    return out


def main() -> None:
    out = asyncio.run(run())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
