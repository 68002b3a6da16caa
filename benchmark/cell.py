"""One run of one cell: set-up, the measured window, the check.

The program is served as deployed: ``vector_store_tpu_torch.run.serve``
over the program's fake database (``db.fake.FakeDb``) in this process,
its HTTP listener on a free local port. The index is bootstrapped through
the program's own full-scan path (``FakeIndex`` scan, the monitor, the
table, the actor) and is served once the node reports SERVING and the IVF
build has swapped in and settled. Requests come from load-generator
processes (``benchmark/loadgen.py``, no torch) over real sockets; writes
enter the fake database's CDC feed (``FakeDbIndex.push_cdc``) from this
process, at the times the write stream sets.

After the window every answer is judged against the plain reference
(``benchmark/judge.py``), once the program has stopped and its memory is
freed.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import os
import socket
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark import data, judge, loadgen
from benchmark.data import Writes

ROOT = Path(__file__).resolve().parents[1]
KEYSPACE, TABLE, INDEX, PK = "ks", "tbl", "idx", "pk"
BASE_MILLIS = 100
READY_TIMEOUT_S = 600.0
APPLIED_TIMEOUT_S = 60.0


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Cell:
    """A cell as the harness runs it: its configuration file's contents
    (with the limits of the numbers ``correct`` compares), its traffic
    file's, and its per-layer metrics' entries."""

    name: str
    config: dict
    traffic: dict
    per_layer: list[dict] = field(default_factory=list)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class Client:
    """A load-generator process and its pipes."""

    def __init__(self, proc: asyncio.subprocess.Process, out: str) -> None:
        self.proc, self.out = proc, out

    @classmethod
    async def start(cls, settings: dict) -> "Client":
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "benchmark.loadgen", cwd=str(ROOT), env=env,
            stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
        )
        client = cls(proc, settings["out"])
        await client.send(json.dumps(settings))
        return client

    async def send(self, line: str) -> None:
        self.proc.stdin.write(line.encode() + b"\n")
        await self.proc.stdin.drain()

    async def expect(self, word: str, timeout: float) -> str:
        line = (await asyncio.wait_for(self.proc.stdout.readline(), timeout)).decode()
        if not line.startswith(word):
            raise RuntimeError(f"load generator said {line!r}, expected {word!r}")
        return line[len(word):].strip()

    def results(self) -> dict:
        with np.load(self.out) as z:
            return {k: z[k] for k in z.files}

    async def close(self) -> None:
        if self.proc.returncode is None:
            self.proc.kill()
        await self.proc.wait()


class GcPauses:
    """This process's garbage collections by generation, and their total
    seconds, while open (the server's host pauses)."""

    def __init__(self) -> None:
        self.count, self.seconds, self._t = [0, 0, 0], [0.0, 0.0, 0.0], 0.0
        gc.callbacks.append(self._cb)

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.count[info["generation"]] += 1
            self.seconds[info["generation"]] += time.perf_counter() - self._t

    def close(self) -> None:
        gc.callbacks.remove(self._cb)

    def __str__(self) -> str:
        return ", ".join(f"gen{g} {c} ({s * 1e3:.1f} ms)" for g, (c, s) in enumerate(zip(self.count, self.seconds)))


def index_metadata(cfg: dict):
    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.db.fake import make_vs_metadata

    return make_vs_metadata(
        keyspace=KEYSPACE, index=INDEX, table=TABLE, dimensions=cfg["dimensions"],
        primary_key_columns=(PK,), space_type=SpaceType[cfg["space"]],
        quantization=Quantization[cfg["quantization"]],
    )


async def wait_until(cond, what: str, timeout: float, step: float = 0.1) -> None:
    deadline = time.monotonic() + timeout
    while not await cond():
        if time.monotonic() > deadline:
            raise RuntimeError(f"timed out after {timeout:.0f} s waiting for {what}")
        await asyncio.sleep(step)


async def http_status(port: int) -> dict:
    conn = loadgen.Conn("127.0.0.1", port)
    try:
        status, body = await conn.request(
            f"GET /api/v1/indexes/{KEYSPACE}/{INDEX}/status HTTP/1.1\r\nHost: bench\r\n\r\n".encode())
    finally:
        conn.close()
    return json.loads(body) if status == 200 else {}


def write_row(writes: Writes, i: int):
    """Write i as the CDC feed carries it, newer than every base row."""
    from vector_store_tpu_torch.db.fake import delete_row, vector_row

    key, millis = int(writes.key[i]), BASE_MILLIS + 1 + i
    if writes.kind[i] == Writes.DELETE:
        return delete_row((key,), millis)
    return vector_row((key,), writes.vectors[writes.vec[i]], millis)


def live_after(n: int, writes: Writes) -> int:
    """Live rows once every write has applied."""
    kind = writes.kind
    return n + int((kind == Writes.INSERT).sum()) - int((kind == Writes.DELETE).sum())


async def write_loop(dbi, writes: Writes, t0: float) -> list[float]:
    """Push each of the window's writes into the CDC feed at its time;
    return how late each was pushed (seconds)."""
    late = []
    for i in range(writes.times.size):
        t = float(writes.times[i])
        wait = t0 + t - time.monotonic()
        if wait > 0:
            await asyncio.sleep(wait)
        late.append(time.monotonic() - t0 - t)
        await dbi.push_cdc(write_row(writes, i), change_ts=time.time())
    return late


async def check_queries(port: int, codes: np.ndarray, limit: int, conc: int = 32) -> tuple[np.ndarray, np.ndarray]:
    """Send one query per row of ``codes`` over the HTTP route; (keys [q,
    limit] with -1 padding, statuses [q])."""
    reqs = loadgen.request_bytes(f"/api/v1/indexes/{KEYSPACE}/{INDEX}/ann", codes, data.QUERY_DECIMALS, limit)
    rec = loadgen.Records(limit, PK)
    nxt = iter(range(len(reqs)))

    async def worker() -> None:
        conn = loadgen.Conn("127.0.0.1", port)
        try:
            for i in nxt:
                t = time.monotonic()
                status, body = await conn.request(reqs[i])
                rec.add(i, t, t, time.monotonic(), status, body)
        finally:
            conn.close()

    await asyncio.gather(*(worker() for _ in range(conc)))
    rec.rows.sort(key=lambda r: r[0])
    keys = np.full((len(reqs), limit), -1, dtype=np.int64)
    for i, row in enumerate(rec.rows):
        keys[i, : min(limit, len(row[5]))] = row[5][:limit]
    return keys, np.asarray([r[4] for r in rec.rows])


async def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
              t_start: float, keep: bool = False) -> dict:
    """One run: ``correct``, ``attempted``, ``failed``, ``metrics`` (every
    end-to-end metric the cell can give), ``peak`` (device bytes),
    ``checks``, the traced span's readings (``traced``) and, with ``keep``,
    the inputs and answers (``inputs``, for the control)."""
    from vector_store_tpu_torch.run import serve
    from vector_store_tpu_torch.service.config import Config

    cfg, traffic = cell.config, cell.traffic
    n, k = cfg["rows"]["count"], traffic["limit"]
    if device.type == "cuda":
        from vector_store_tpu_torch.ops import kernels

        torch.empty(0, device=device)  # the CUDA context, before its counters are reset
        torch.cuda.reset_peak_memory_stats(device)
        kernels.library()
        log(f"kernels ready ({'built in %.1f s' % kernels.build_seconds if kernels.build_seconds else 'cached'})")

    t = time.perf_counter()
    rows_dev = data.base_rows(cfg, seed, device)
    codes = data.query_codes(cfg, rows_dev, seed)
    rows = rows_dev.cpu().numpy()
    del rows_dev
    qspec = traffic["queries"]
    rng = np.random.default_rng([int(seed), 7])
    writes = None
    if "writes" in traffic:
        writes = data.write_stream(cfg, traffic["writes"], seed, seconds, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"{n} x {cfg['dimensions']} rows, {codes.shape[0]} queries"
        f"{'' if writes is None else f', {writes.times.size} writes'} made in {time.perf_counter() - t:.1f} s")

    from vector_store_tpu_torch.db.fake import FakeDb, FakeIndex, FakeTable, vector_row

    db = FakeDb()
    db.add_table(FakeTable(KEYSPACE, TABLE, (PK,)))
    metadata = index_metadata(cfg)
    db.add_index(FakeIndex(metadata=metadata,
                           scan=lambda: (vector_row((i,), rows[i], BASE_MILLIS) for i in range(n))))
    port = free_port()
    t = time.perf_counter()
    service = await serve(db, Config(uri=f"127.0.0.1:{port}", monitor_indexes_interval=0.1), device=device)
    clients: list[Client] = []
    prober: Client | None = None
    tmp = tempfile.TemporaryDirectory(prefix="bench-")
    result: dict = {}
    try:
        # -- the clients: they connect while the index bootstraps ----------
        tdir = Path(tmp.name)
        np.save(tdir / "codes.npy", codes)
        path = f"/api/v1/indexes/{KEYSPACE}/{INDEX}/ann"
        common = {"host": "127.0.0.1", "port": port, "path": path, "decimals": data.QUERY_DECIMALS,
                  "limit": k, "pk": PK}
        n_proc = qspec["processes"]
        for p in range(n_proc):
            np.save(tdir / f"order{p}.npy", rng.permutation(codes.shape[0]))
            clients.append(await Client.start({**common, "mode": "closed", "codes": str(tdir / "codes.npy"),
                                               "conc": qspec["connections"] // n_proc,
                                               "order": str(tdir / f"order{p}.npy"),
                                               "out": str(tdir / f"q{p}.npz")}))
        if writes is not None and writes.probe.any():
            wspec = traffic["writes"]
            probe_at = np.flatnonzero(writes.probe)
            np.save(tdir / "probe_codes.npy", data.codes_of(torch.from_numpy(writes.vectors[writes.vec[probe_at]])))
            np.save(tdir / "probe_times.npy", writes.times[probe_at])
            np.save(tdir / "probe_keys.npy", writes.key[probe_at])
            prober = await Client.start({**common, "mode": "probe", "codes": str(tdir / "probe_codes.npy"),
                                         "times": str(tdir / "probe_times.npy"),
                                         "keys": str(tdir / "probe_keys.npy"), "poll_s": wspec["probe_poll_ms"] / 1e3,
                                         "grace_s": wspec["grace_s"], "out": str(tdir / "probe.npz")})

        async def counted() -> bool:
            st = await http_status(port)
            return st.get("status") == "SERVING" and st.get("count") == n

        await wait_until(counted, f"{n} rows SERVING", READY_TIMEOUT_S, 0.2)
        ingest_s = time.perf_counter() - t
        actor = service.indexes.get_vs(metadata.key).actor
        engine = actor.engine

        async def settled() -> bool:
            built = getattr(engine, "nlist", 1) > 0 or n < getattr(engine, "min_build", 0)
            return built and engine.maintain_pending() is None

        await wait_until(settled, "the IVF build to swap in and settle", READY_TIMEOUT_S, 0.2)
        log(f"bootstrap {ingest_s:.1f} s ({n / ingest_s:.0f} rows/s), build settled "
            f"{time.perf_counter() - t - ingest_s:.1f} s later: nlist {getattr(engine, 'nlist', None)}, "
            f"main rows {getattr(engine, '_main_rows', None)}, delta {getattr(getattr(engine, '_delta', None), 'size', None)}")
        everyone = clients + ([prober] if prober else [])
        for c in everyone:
            await c.expect("ready", 120)
        warm = traffic["warm_seconds"]
        for c in clients:
            await c.send(f"warm {warm}")
        for c in clients:
            await c.expect("warmed", warm + 120)

        # -- the window ----------------------------------------------------
        from benchmark import tracing

        tracer = None
        if trace:
            tracer = tracing.Tracer(service, actor, metadata, traffic["trace_seconds"])
            tracer.warm()
        t0 = time.monotonic() + 0.5
        setup_s = time.perf_counter() - t_start + 0.5
        pauses = GcPauses()
        for c in everyone:
            await c.send(f"go {t0} {seconds}")
        writer = None
        if writes is not None:
            writer = asyncio.create_task(write_loop(db.db_indexes[metadata.key], writes, t0))
        if tracer is not None:
            await tracer.window(t0, seconds)
        summaries = [json.loads(await c.expect("done", seconds + 300)) for c in clients]
        late = await writer if writer is not None else []
        probe_summary = json.loads(await prober.expect("done", seconds + 300)) if prober else None
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        pauses.close()
        log(f"garbage collections in this process from the window's start: {pauses}")
        for i, s in enumerate(summaries):
            log(f"client {i}: {s}")
        if probe_summary:
            log(f"prober: {probe_summary}")
        if late:
            lt = np.asarray(late) * 1e3
            log(f"writes pushed late by p50 {np.percentile(lt, 50):.2f} / p99 {np.percentile(lt, 99):.2f} / "
                f"max {lt.max():.2f} ms")

        answers = judge.Answers.concat([c.results() for c in clients])
        log(f"answers by second of the window: {judge.timeline(answers, t0, seconds)}")
        fresh = np.load(prober.out + ".fresh.npy") if prober else None
        after = None
        if writes is not None:
            live = live_after(n, writes)

            async def applied() -> bool:
                return engine.size == live and actor.backlog == 0

            with contextlib.suppress(RuntimeError):
                await wait_until(applied, "the window's writes to apply", APPLIED_TIMEOUT_S)
            picks = judge.write_checks(writes, rows, rng, traffic["writes"]["checks"])
            keys, statuses = await check_queries(port, data.codes_of(torch.from_numpy(picks.vectors)), k)
            pool = np.sort(rng.choice(codes.shape[0], size=min(judge.RECALL_QUERIES, codes.shape[0]),
                                      replace=False))
            pool_keys, pool_status = await check_queries(port, codes[pool], k)
            after = judge.AfterWindow(picks, keys, statuses, pool, pool_keys, pool_status)
        traced = tracer.readings() if tracer is not None else None
    finally:
        for c in clients + ([prober] if prober else []):
            await c.close()
        await service.stop()
    del service, db, actor, engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check, after the program has stopped ------------------------------
    t = time.perf_counter()
    verdict = judge.judge(cfg, traffic, rows, codes, writes, answers, after, seconds, t0, device)
    tmp.cleanup()
    log(f"reference and check {time.perf_counter() - t:.1f} s")
    metrics = {"setup_s": {"value": setup_s, "unit": "s"}, **verdict.metrics(fresh, seconds, traffic)}
    log(f"end-to-end readings: {json.dumps({m: v['value'] for m, v in metrics.items()})}")
    result.update(correct=verdict.correct, attempted=verdict.attempted, failed=verdict.failed,
                  metrics=metrics, peak=peak, checks=verdict.checks)
    if traced is not None:
        result["traced"] = traced
    if keep:
        result["inputs"] = {"rows": rows, "codes": codes, "writes": writes, "answers": answers, "seed": seed}
    return result
