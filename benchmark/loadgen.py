"""Load generator: HTTP/1.1 ANN requests over raw asyncio streams.

Run as ``python -m benchmark.loadgen``; it imports no torch (nor anything
of the program), so a client process costs the card nothing and the host
as little as a client can. The parent writes one JSON line of settings
to its standard input, waits for ``ready``, may send ``warm <seconds>``
(a closed loop whose answers are dropped; answered by ``warmed``), then
sends ``go <t0> <seconds>``: ``t0`` is a ``time.monotonic()`` reading,
the start of the window, shared by every process on the host. The
client answers ``done <json>`` once its results are in the ``out`` file.

Modes:
- ``closed``: ``conc`` connections, each sending its next query as soon
  as its answer is in, until the window ends; a request is timed from
  when it was sent.
- ``probe``: from each of ``times`` on, the probe's query is sent every
  ``poll_s`` seconds until an answer returns its ``keys`` entry, or
  ``grace_s`` past the window's end; its freshness is the answer's
  arrival less the due time.

Every request's record goes to the parent (the ``out`` .npz file): the
query, due / sent / done times, the HTTP status, and the keys and
distances of a 200 answer.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time

import numpy as np


def request_bytes(path: str, codes: np.ndarray, decimals: int, limit: int) -> list[bytes]:
    """One POST per row of ``codes`` (int32 [n, d], the query's values
    times 10**decimals), its body ``{"vector": [...], "limit": limit}``."""
    text = np.char.mod(f"%.{decimals}f", codes.astype(np.float64) / 10**decimals)
    head = b"POST " + path.encode() + b" HTTP/1.1\r\nHost: bench\r\nContent-Type: application/json\r\n"
    out = []
    for row in text:
        body = b'{"vector":[' + ",".join(row.tolist()).encode() + b'],"limit":' + str(limit).encode() + b"}"
        out.append(head + b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
    return out


class Conn:
    """One keep-alive HTTP/1.1 connection."""

    def __init__(self, host: str, port: int) -> None:
        self.host, self.port = host, port
        self.reader: asyncio.StreamReader | None = None
        self.writer: asyncio.StreamWriter | None = None

    async def open(self) -> "Conn":
        self.reader, self.writer = await asyncio.open_connection(self.host, self.port)
        return self

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            self.reader = self.writer = None

    async def request(self, req: bytes) -> tuple[int, bytes]:
        """(status, body); status 0 if the connection failed (it is closed,
        and opened again by the next request)."""
        try:
            if self.writer is None:
                await self.open()
            self.writer.write(req)
            await self.writer.drain()
            status = await self.reader.readline()
            code = int(status.split(b" ", 2)[1])
            clen, chunked = 0, False
            while True:
                line = await self.reader.readline()
                if line in (b"\r\n", b""):
                    break
                low = line.lower()
                if low.startswith(b"content-length:"):
                    clen = int(line.split(b":", 1)[1])
                elif low.startswith(b"transfer-encoding:") and b"chunked" in low:
                    chunked = True
            if chunked:
                parts = []
                while True:
                    size = int((await self.reader.readline()).strip() or b"0", 16)
                    parts.append(await self.reader.readexactly(size + 2))
                    if size == 0:
                        break
                return code, b"".join(p[:-2] for p in parts)
            return code, await self.reader.readexactly(clen) if clen else b""
        except (OSError, ValueError, IndexError, asyncio.IncompleteReadError):
            self.close()
            return 0, b""


class Records:
    """Every request's record, in arrival order of the records."""

    def __init__(self, k: int, pk: str) -> None:
        self.k, self.pk = k, pk
        self.rows: list[tuple] = []

    def add(self, qidx: int, due: float, sent: float, done: float, status: int, body: bytes) -> list[int]:
        keys: list[int] = []
        dists: list[float] = []
        if status == 200:
            try:
                answer = json.loads(body)
                keys = [int(x) for x in answer["primary_keys"][self.pk]]
                dists = [float(x) for x in answer["distances"]]
            except (ValueError, KeyError, TypeError):
                status = -1  # a 200 whose body is not an answer
        self.rows.append((qidx, due, sent, done, status, keys, dists))
        return keys

    def save(self, path: str) -> None:
        n, k = len(self.rows), self.k
        keys = np.full((n, k), -1, dtype=np.int64)
        dists = np.full((n, k), np.nan, dtype=np.float32)
        width = np.zeros(n, dtype=np.int32)
        for i, row in enumerate(self.rows):
            m = min(len(row[5]), k)
            width[i] = len(row[5])
            keys[i, :m] = row[5][:m]
            dists[i, : min(len(row[6]), k)] = row[6][:k]
        cols = list(zip(*(r[:5] for r in self.rows))) if n else [[]] * 5
        np.savez(
            path, qidx=np.asarray(cols[0], dtype=np.int64), due=np.asarray(cols[1], dtype=np.float64),
            sent=np.asarray(cols[2], dtype=np.float64), done=np.asarray(cols[3], dtype=np.float64),
            status=np.asarray(cols[4], dtype=np.int32), keys=keys, dists=dists, width=width,
        )


async def closed_loop(conns: list[Conn], reqs: list[bytes], order: np.ndarray, until: float,
                      rec: Records | None) -> None:
    """Each connection sends the next query of ``order`` (cycled) until
    ``until``; ``rec`` None drops the answers (warm-up)."""
    nxt = [0]

    async def worker(conn: Conn) -> None:
        while time.monotonic() < until:
            q = int(order[nxt[0] % order.size])
            nxt[0] += 1
            sent = time.monotonic()
            status, body = await conn.request(reqs[q])
            if rec is not None:
                rec.add(q, sent, sent, time.monotonic(), status, body)

    await asyncio.gather(*(worker(c) for c in conns))


async def probe_loop(host: str, port: int, reqs: list[bytes], keys: np.ndarray, due: np.ndarray,
                     poll_s: float, give_up: float, rec: Records) -> list[tuple[int, float, int]]:
    """For each probe, poll from its due time until its key is answered;
    (probe, freshness seconds or inf, polls) each."""
    out: list[tuple[int, float, int]] = []

    async def one(i: int, key: int, t_due: float) -> None:
        await asyncio.sleep(max(0.0, t_due - time.monotonic()))
        conn = Conn(host, port)
        polls = 0
        try:
            while time.monotonic() < give_up:
                sent = time.monotonic()
                status, body = await conn.request(reqs[i])
                polls += 1
                got = rec.add(i, t_due, sent, time.monotonic(), status, body)
                if key in got:
                    out.append((i, time.monotonic() - t_due, polls))
                    return
                await asyncio.sleep(max(0.0, sent + poll_s - time.monotonic()))
            out.append((i, float("inf"), polls))
        finally:
            conn.close()

    await asyncio.gather(*(one(i, int(k), float(t)) for i, (k, t) in enumerate(zip(keys, due))))
    return out


async def main() -> None:
    loop = asyncio.get_running_loop()
    stdin = asyncio.StreamReader()
    await loop.connect_read_pipe(lambda: asyncio.StreamReaderProtocol(stdin), sys.stdin)
    spec = json.loads(await stdin.readline())
    codes = np.load(spec["codes"])
    reqs = request_bytes(spec["path"], codes, spec["decimals"], spec["limit"])
    host, port, mode = spec["host"], spec["port"], spec["mode"]
    conns = [await Conn(host, port).open() for _ in range(spec.get("conc", 0))]
    rec = Records(spec["limit"], spec["pk"])
    print("ready", flush=True)
    while True:
        word, *args = (await stdin.readline()).decode().split()
        if word == "warm":
            await closed_loop(conns, reqs, np.arange(len(reqs)), time.monotonic() + float(args[0]), None)
            print("warmed", flush=True)
            continue
        t0, seconds = float(args[0]), float(args[1])
        break
    await asyncio.sleep(max(0.0, t0 - time.monotonic()))
    summary: dict = {}
    if mode == "closed":
        await closed_loop(conns, reqs, np.load(spec["order"]), t0 + seconds, rec)
    else:
        found = await probe_loop(host, port, reqs, np.load(spec["keys"]), t0 + np.load(spec["times"]),
                                 spec["poll_s"], t0 + seconds + spec["grace_s"], rec)
        found.sort()
        np.save(spec["out"] + ".fresh.npy", np.asarray([f for _, f, _ in found], dtype=np.float64))
        summary["polls"] = int(sum(p for _, _, p in found))
    for conn in conns:
        conn.close()
    rec.save(spec["out"])
    cpu = os.times()
    summary.update(requests=len(rec.rows), cpu_s=cpu.user + cpu.system)
    print("done " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    asyncio.run(main())
