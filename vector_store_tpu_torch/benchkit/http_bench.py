"""Full-service HTTP throughput at 1M rows on the GPU, through the port's
``run.serve_scaled`` (the counterpart of the JAX package's
benchkit/http_bench.py).

The engine-loop numbers (benchkit/headline.py) measure the engine; this
bench measures the path users hit: real sockets -> aiohttp frontend
processes -> binary IPC -> owner actor -> IVF engine, at 1M rows, and
attributes the ceiling by peeling the stack one layer at a time:

  inproc     actor.ann_many awaited in the owner process (no IPC, no HTTP)
  ipc-batch  frontend-style bulk IPC: ann_batch messages over unix sockets
  ipc-one    per-request IPC `ann` messages (pickle per request)
  http       real POST /api/v1/indexes/{ks}/{ix}/ann through SO_REUSEPORT
             frontends, closed-loop clients, concurrency-swept

Each point records QPS + client-observed p50/p99 and per-process CPU
seconds (owner / frontends / clients, from /proc/<pid>/stat): the
clients, the frontends and the owner share the host's cores, and the
attribution table says where they go. The reference's tokio server
(httpserver.rs) spreads the same work over many cores; its in-process
pipeline bench is benches/pipeline.rs.

The client processes are spawned with no GPU visible (run.gpus_hidden);
this module imports no torch, so a spawned client that imports it to
find its entry point loads none either.

Usage: python -m vector_store_tpu_torch.benchkit.scale http-1000k
Env: SCALE_N, HTTP_BENCH_SECONDS (15; each point's clients warm up for
3 s, or as long as they measure if that is shorter), HTTP_WORKERS (2),
HTTP_CLIENTS (2), BENCH_DEVICE (cuda unless set).
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import sys
import time

import numpy as np

KS, IX = "ks", "idx"


# --------------------------------------------------------------------------
# client processes (spawned; they import no torch)
# --------------------------------------------------------------------------


def _cpu_seconds(pid: int) -> float:
    """utime+stime of one process, seconds."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            parts = f.read().split(b") ", 1)[1].split()
        return (int(parts[11]) + int(parts[12])) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def _http_client_main(
    host: str,
    port: int,
    conc: int,
    warm_s: float,
    dur_s: float,
    d: int,
    seed: int,
    out_path: str,
) -> None:
    """Closed-loop HTTP/1.1 client: `conc` persistent connections, each
    sending one POST ann at a time from a pre-serialized body pool. Raw
    asyncio streams (no aiohttp) keep client CPU minimal — on a one-core
    host every client cycle is stolen from the server."""
    rng = np.random.default_rng(seed)
    bodies = []
    path = f"/api/v1/indexes/{KS}/{IX}/ann".encode()
    for _ in range(256):
        vec = rng.normal(size=d).astype(np.float32)
        body = json.dumps(
            {"vector": [round(float(x), 4) for x in vec], "limit": 10},
            separators=(",", ":"),
        ).encode()
        req = (
            b"POST " + path + b" HTTP/1.1\r\n"
            b"Host: bench\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: " + str(len(body)).encode() + b"\r\n"
            b"\r\n" + body
        )
        bodies.append(req)

    lat: list[float] = []
    count = [0]
    errors = [0]

    async def read_response(reader: asyncio.StreamReader) -> int:
        status = await reader.readline()
        code = int(status.split(b" ", 2)[1])
        clen = 0
        chunked = False
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b""):
                break
            low = line.lower()
            if low.startswith(b"content-length:"):
                clen = int(line.split(b":", 1)[1])
            elif low.startswith(b"transfer-encoding:") and b"chunked" in low:
                chunked = True
        if chunked:
            while True:
                size = int((await reader.readline()).strip() or b"0", 16)
                await reader.readexactly(size + 2)
                if size == 0:
                    break
        elif clen:
            await reader.readexactly(clen)
        return code

    async def worker(wi: int, stop_at: list[float], measuring: list[bool]):
        reader, writer = await asyncio.open_connection(host, port)
        i = wi
        try:
            while time.perf_counter() < stop_at[0]:
                req = bodies[i % len(bodies)]
                i += 1
                t0 = time.perf_counter()
                writer.write(req)
                await writer.drain()
                code = await read_response(reader)
                dt = time.perf_counter() - t0
                if measuring[0]:
                    if code == 200:
                        lat.append(dt)
                        count[0] += 1
                    else:
                        errors[0] += 1
        finally:
            writer.close()

    async def main():
        measuring = [False]
        stop_at = [time.perf_counter() + warm_s + dur_s + 5]
        tasks = [
            asyncio.create_task(worker(i, stop_at, measuring))
            for i in range(conc)
        ]
        await asyncio.sleep(warm_s)
        with open(out_path + ".start", "w") as f:
            f.write(str(time.time()))
        measuring[0] = True
        t0 = time.perf_counter()
        await asyncio.sleep(dur_s)
        measuring[0] = False
        elapsed = time.perf_counter() - t0
        stop_at[0] = 0.0
        await asyncio.gather(*tasks, return_exceptions=True)
        _write_result(out_path, elapsed)

    def _write_result(path: str, elapsed: float) -> None:
        arr = np.asarray(lat) * 1e3
        res = {
            "count": count[0],
            "errors": errors[0],
            "elapsed": elapsed,
            "cpu_s": _cpu_seconds(os.getpid()),
            "p50_ms": float(np.percentile(arr, 50)) if arr.size else None,
            "p99_ms": float(np.percentile(arr, 99)) if arr.size else None,
        }
        with open(path + ".tmp", "w") as f:
            json.dump(res, f)
        os.replace(path + ".tmp", path)

    asyncio.run(main())


def _ipc_client_main(
    ipc_path: str,
    mode: str,  # "ipc-one" | "ipc-batch"
    conc: int,
    warm_s: float,
    dur_s: float,
    d: int,
    seed: int,
    out_path: str,
) -> None:
    """Client speaking the owner's binary IPC directly (no HTTP layer):
    isolates what the HTTP+JSON hop costs vs the pickle+actor hop."""
    from vector_store_tpu_torch.service.ipc import IpcClient

    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(256, d)).astype(np.float32)
    vec_bytes = [v.tobytes() for v in vecs]
    batch = 128

    lat: list[float] = []
    count = [0]
    errors = [0]

    async def worker(client, wi, stop_at, measuring):
        i = wi
        while time.perf_counter() < stop_at[0]:
            t0 = time.perf_counter()
            try:
                if mode == "ipc-batch":
                    res = await client.call(
                        "ann_batch",
                        {
                            "keyspace": KS,
                            "index": IX,
                            "vectors": b"".join(
                                vec_bytes[(i + j) % 256] for j in range(batch)
                            ),
                            "n": batch,
                            "dims": d,
                            "limit": 10,
                        },
                    )
                    n_ok = batch if "results" in res else 0
                else:
                    res = await client.call(
                        "ann",
                        {
                            "keyspace": KS,
                            "index": IX,
                            "vector": vec_bytes[i % 256],
                            "limit": 10,
                            "filter": None,
                        },
                    )
                    n_ok = 1 if "keys" in res else 0
            except Exception:
                n_ok = 0
            dt = time.perf_counter() - t0
            i += 1
            if measuring[0]:
                if n_ok:
                    lat.append(dt)
                    count[0] += n_ok
                else:
                    errors[0] += 1

    async def main():
        client = IpcClient(ipc_path, pool=4)
        await client.connect()
        measuring = [False]
        stop_at = [time.perf_counter() + warm_s + dur_s + 5]
        tasks = [
            asyncio.create_task(worker(client, i, stop_at, measuring))
            for i in range(conc)
        ]
        await asyncio.sleep(warm_s)
        with open(out_path + ".start", "w") as f:
            f.write(str(time.time()))
        measuring[0] = True
        t0 = time.perf_counter()
        await asyncio.sleep(dur_s)
        measuring[0] = False
        elapsed = time.perf_counter() - t0
        stop_at[0] = 0.0
        await asyncio.gather(*tasks, return_exceptions=True)
        arr = np.asarray(lat) * 1e3
        res = {
            "count": count[0],
            "errors": errors[0],
            "elapsed": elapsed,
            "cpu_s": _cpu_seconds(os.getpid()),
            "p50_ms": float(np.percentile(arr, 50)) if arr.size else None,
            "p99_ms": float(np.percentile(arr, 99)) if arr.size else None,
        }
        with open(out_path + ".tmp", "w") as f:
            json.dump(res, f)
        os.replace(out_path + ".tmp", out_path)

    asyncio.run(main())


# --------------------------------------------------------------------------
# owner-side harness
# --------------------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


async def _spawn_clients(tmp: str, target, args_list: list[tuple]) -> list:
    """Spawn client processes that see no GPU (they never open a CUDA
    context)."""
    import multiprocessing

    from vector_store_tpu_torch.run import gpus_hidden

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=a, daemon=True) for a in args_list]
    with gpus_hidden():
        for p in procs:
            p.start()
    return procs


async def _measure_point(
    label: str,
    tmp: str,
    target,
    args_for,  # out_path -> args tuple
    n_clients: int,
    owner_pid: int,
    frontend_pids: list[int],
    warm_s: float,
    dur_s: float,
) -> dict:
    outs = [os.path.join(tmp, f"{label}-{i}.json") for i in range(n_clients)]
    procs = await _spawn_clients(
        tmp, target, [args_for(o, i) for i, o in enumerate(outs)]
    )
    client_pids = [p.pid for p in procs]
    # wait for all .start markers (clients warmed), then sample CPU
    deadline = time.time() + warm_s + 60
    while not all(os.path.exists(o + ".start") for o in outs):
        await asyncio.sleep(0.05)
        if time.time() > deadline:
            break
    cpu0 = {
        "owner": _cpu_seconds(owner_pid),
        "frontends": sum(_cpu_seconds(p) for p in frontend_pids),
        "clients": sum(_cpu_seconds(p) for p in client_pids),
    }
    t0 = time.time()
    deadline = time.time() + dur_s + 120
    while not all(os.path.exists(o) for o in outs):
        await asyncio.sleep(0.1)
        if time.time() > deadline:
            break
    wall = time.time() - t0
    cpu1 = {
        "owner": _cpu_seconds(owner_pid),
        "frontends": sum(_cpu_seconds(p) for p in frontend_pids),
        "clients": sum(_cpu_seconds(p) for p in client_pids),
    }
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.terminate()
    results = []
    for o in outs:
        try:
            with open(o) as f:
                results.append(json.load(f))
        except OSError:
            pass
    total = sum(r["count"] for r in results)
    elapsed = max((r["elapsed"] for r in results), default=wall)
    p50s = [r["p50_ms"] for r in results if r.get("p50_ms")]
    p99s = [r["p99_ms"] for r in results if r.get("p99_ms")]
    cpu = {k: round(cpu1[k] - cpu0[k], 2) for k in cpu0}
    point = {
        "label": label,
        "qps": round(total / max(elapsed, 1e-9), 1),
        "p50_ms": round(float(np.median(p50s)), 1) if p50s else None,
        "p99_ms": round(float(max(p99s)), 1) if p99s else None,
        "requests": total,
        "errors": sum(r["errors"] for r in results),
        "clients": n_clients,
        "cpu_seconds": cpu,
        "cpu_cores_used": round(sum(cpu.values()) / max(elapsed, 1e-9), 2),
        "wall_seconds": round(elapsed, 1),
    }
    print(f"[http-bench] {json.dumps(point)}", file=sys.stderr, flush=True)
    return point


async def _http_async(n: int, d: int, device=None) -> dict:
    import tempfile

    from vector_store_tpu_torch.core import (
        DbIndexedValue,
        IndexKey,
        PrimaryKey,
        Timestamp,
        Timestamped,
    )
    from vector_store_tpu_torch.core.types import Progress
    from vector_store_tpu_torch.db.fake import FakeDb, make_vs_metadata
    from vector_store_tpu_torch.benchkit.common import bench_device
    from vector_store_tpu_torch.run import serve_scaled
    from vector_store_tpu_torch.service.config import Config
    from vector_store_tpu_torch.service.indexes import VsIndexEntry
    from vector_store_tpu_torch.service.node_state import IndexStatus
    from vector_store_tpu_torch.service.vs_index import VsIndexActor
    from vector_store_tpu_torch.table import Table

    from vector_store_tpu_torch.benchkit import synth

    device = bench_device(device)
    seed = 42
    dur = float(os.environ.get("HTTP_BENCH_SECONDS", 15))
    warm = min(3.0, dur)  # each point's client warm-up
    workers = int(os.environ.get("HTTP_WORKERS", 2))
    n_clients = int(os.environ.get("HTTP_CLIENTS", 2))
    out: dict = {
        "config": f"http-{n // 1000}k",
        "n": n,
        "d": d,
        "quant": "BF16",
        "frontend_workers": workers,
        "host_cores": os.cpu_count(),
    }

    # -- service: owner + SO_REUSEPORT frontends over a fake (empty) DB ----
    port = _free_port()
    config = Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.2)
    service = await serve_scaled(FakeDb(), config, workers=workers, device=device)
    frontend_pids = [p.pid for p in service.frontends]
    owner_pid = os.getpid()
    ipc_path = service.ipc_server.path

    # -- 1M-row index, prebuilt through Table + actor (bench shortcut: the
    # fake-DB full-scan pump feeds one row at a time; ingestion-path
    # throughput is the streaming-actor artifact's job, not this one's) ----
    KEY = IndexKey(KS, IX)
    metadata = make_vs_metadata(dimensions=d)
    out["quant"] = metadata.vs_options.quantization.value  # the index's own (the default F32)
    table = Table(metadata)
    actor = VsIndexActor(
        metadata,
        table,
        metrics=service.metrics,
        internals=service.internals,
        device=device,
    )
    engine = actor.engine
    t_ds = time.time()
    dataset = synth.rows_file_np(seed, n, d, 256)
    out["dataset_gen_seconds"] = round(time.time() - t_ds, 1)
    ts0 = Timestamp.from_millis(100)
    chunk = 131072
    t0 = time.time()
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        rows_host = np.asarray(dataset[lo:hi])
        scan_rows = [
            (
                PrimaryKey.from_values((lo + j,)),
                (
                    Timestamped(
                        ts0, DbIndexedValue.vector(rows_host[j].tolist())
                    ),
                ),
            )
            for j in range(hi - lo)
        ]
        ops = table.upsert_scan(KEY, scan_rows)
        actor._apply_ops_batch(ops)
        print(
            f"[http-bench] ingest {hi}/{n} ({time.time() - t0:.0f}s)",
            file=sys.stderr,
            flush=True,
        )
    out["ingest_seconds"] = round(time.time() - t0, 1)
    t0 = time.time()
    engine.maintain()
    while engine.maintain(budget=1):  # any slice left (post-swap re-entry)
        pass
    out["build_seconds"] = round(time.time() - t0, 1)
    out["nlist"] = getattr(engine, "nlist", None)
    out["nprobe"] = getattr(engine, "nprobe", None)
    print(f"[http-bench] index device_bytes {engine.device_bytes}", file=sys.stderr, flush=True)
    out["engine_note"] = (
        "same engine/params as BENCH (ivf-bf16, seed 42): recall@10 0.95+ "
        "gated there; this artifact measures the serving stack"
    )

    actor.start()
    entry = VsIndexEntry(
        actor=actor,
        monitor=None,
        db_index=None,
        metadata=metadata,
        status=IndexStatus.SERVING,
        progress=Progress.done(),
        table_columns={},
    )
    service.indexes.insert_vs(KEY, entry)

    # wait until the node reports SERVING and a frontend answers
    import aiohttp

    url = f"http://127.0.0.1:{port}"
    async with aiohttp.ClientSession() as http:
        deadline = time.time() + 60
        while True:
            try:
                resp = await http.get(f"{url}/api/v1/indexes/{KS}/{IX}/status")
                if resp.status == 200:
                    data = await resp.json()
                    if data["status"] == "SERVING":
                        break
            except aiohttp.ClientError:
                pass
            if time.time() > deadline:
                raise RuntimeError("service never reached SERVING")
            await asyncio.sleep(0.2)

    tmp = tempfile.mkdtemp(prefix="vst-httpbench-")
    points: list[dict] = []

    # -- point 0: in-process actor ceiling (no IPC, no HTTP) ---------------
    rng = np.random.default_rng(7)
    qpool = rng.normal(size=(4096, d)).astype(np.float32)
    await actor.ann_many(qpool[:1024], 10)  # warm
    lat: list[float] = []
    count = 0
    cpu0 = _cpu_seconds(owner_pid)
    t0 = time.perf_counter()
    qb = 1024
    tasks_n = 4

    async def inproc_worker(w: int, stop_at: float):
        nonlocal count
        i = w
        while time.perf_counter() < stop_at:
            q = qpool[(i * qb) % 4096 : (i * qb) % 4096 + qb]
            if q.shape[0] < qb:
                q = qpool[:qb]
            c0 = time.perf_counter()
            await actor.ann_many(q, 10)
            lat.append(time.perf_counter() - c0)
            count += qb
            i += 1

    stop_at = time.perf_counter() + dur
    await asyncio.gather(*(inproc_worker(w, stop_at) for w in range(tasks_n)))
    elapsed = time.perf_counter() - t0
    arr = np.asarray(lat) * 1e3
    points.append(
        {
            "label": "inproc-actor",
            "qps": round(count / elapsed, 1),
            "p50_ms": round(float(np.percentile(arr, 50)), 1),
            "p99_ms": round(float(np.percentile(arr, 99)), 1),
            "requests": count,
            "batch": qb,
            "cpu_seconds": {"owner": round(_cpu_seconds(owner_pid) - cpu0, 2)},
            "wall_seconds": round(elapsed, 1),
        }
    )
    print(f"[http-bench] {json.dumps(points[-1])}", file=sys.stderr, flush=True)

    # -- point 1: bulk IPC (frontend-batcher shape, no HTTP) ---------------
    points.append(
        await _measure_point(
            "ipc-batch128",
            tmp,
            _ipc_client_main,
            lambda o, i: (ipc_path, "ipc-batch", 4, warm, dur, d, 7 + i, o),
            1,
            owner_pid,
            frontend_pids,
            warm,
            dur,
        )
    )

    # -- point 2: per-request IPC -------------------------------------------
    points.append(
        await _measure_point(
            "ipc-per-request",
            tmp,
            _ipc_client_main,
            lambda o, i: (ipc_path, "ipc-one", 256, warm, dur, d, 11 + i, o),
            1,
            owner_pid,
            frontend_pids,
            warm,
            dur,
        )
    )

    # -- point 3+: full HTTP, concurrency swept ------------------------------
    for conc_total in (64, 256, 1024):
        conc = max(1, conc_total // n_clients)
        points.append(
            await _measure_point(
                f"http-c{conc_total}",
                tmp,
                _http_client_main,
                lambda o, i: ("127.0.0.1", port, conc, warm, dur, d, 23 + i, o),
                n_clients,
                owner_pid,
                frontend_pids,
                warm,
                dur,
            )
        )

    out["points"] = points
    http_pts = [p for p in points if p["label"].startswith("http-")]
    if http_pts:
        best = max(http_pts, key=lambda p: p["qps"])
        out["http_qps"] = best["qps"]
        out["http_p50_ms"] = best["p50_ms"]
        out["http_best_concurrency"] = best["label"]
    for p in points:
        if p["label"] == "inproc-actor":
            out["actor_qps"] = p["qps"]
        elif p["label"] == "ipc-batch128":
            out["ipc_batch_qps"] = p["qps"]
        elif p["label"] == "ipc-per-request":
            out["ipc_per_request_qps"] = p["qps"]
    out["data"] = (
        "synthetic clustered gaussians (SIFT-1M shape) prebuilt through "
        "Table+actor; serving path = real sockets -> frontends -> IPC -> "
        "actor -> IVF engine"
    )
    # the manual entry has no db_index/monitor: detach it before the
    # service's engine teardown walks its registry
    service.indexes.remove(KEY)
    await actor.stop()
    await service.stop()
    return out


def run_http(n: int = 1_000_000, d: int = 128, device=None) -> dict:
    return asyncio.run(_http_async(n, d, device))
