"""Load-side benchmark commands (parity with the reference benchmark
crate's build-buckets / build-table / build-index / drop-* / delete-rows,
crates/benchmark/src/{main.rs:44-231, db.rs:95-260}): create the canonical
benchmark schema on a cluster, upload dataset vectors with bounded
concurrency, create/drop the custom vector index, and delete rows — all
over the pure-python CQL wire driver.

Schema (db.rs:120-127): table (bucket bigint, id bigint, embedding
vector<float, D>, PRIMARY KEY ((bucket, id))); selectivity buckets assign
each row to the SMALLEST matching fraction of [50%, 20%, 10%, 5%, 2%, 1%,
0.5%, 0.2%, 0.1%] so filtered-search benchmarks can restrict by bucket.
"""

from __future__ import annotations

import asyncio
import json
import sys

import numpy as np

BUCKET_FRACTIONS = [0.5, 0.2, 0.1, 0.05, 0.02, 0.01, 0.005, 0.002, 0.001]
KEYSPACE = "vsbench"
TABLE = "vectors"
INDEX = "vectors_idx"
BUCKET_COL = "bucket"
ID_COL = "id"
VECTOR_COL = "embedding"


def assign_buckets(n: int, seed: int = 0) -> np.ndarray:
    """Per-row bucket index (i8): row i belongs to bucket b iff a uniform
    draw lands under fraction[b]; the SMALLEST matching bucket wins
    (reference build-buckets semantics: nested subsets)."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    out = np.full((n,), -1, dtype=np.int8)
    for b, frac in enumerate(BUCKET_FRACTIONS):  # descending fractions
        out[u < frac] = b
    return out


def build_buckets(data_path: str, out_path: str, seed: int = 0) -> dict:
    from vector_store_tpu_torch.benchkit.data import load_fbin

    base = load_fbin(data_path)
    buckets = assign_buckets(base.shape[0], seed=seed)
    np.save(out_path, buckets)
    hist = {
        f"{frac:.1%}": int((buckets == b).sum())
        for b, frac in enumerate(BUCKET_FRACTIONS)
    }
    return {"rows": int(base.shape[0]), "out": out_path, "buckets": hist}


async def _session(uri: str, username: str | None, password: str | None):
    from vector_store_tpu_torch.db.cql.session import CqlSession

    s = CqlSession(uri, username=username, password=password)
    s.start()
    return s


async def build_table(
    uri: str,
    data_path: str,
    *,
    keyspace: str = KEYSPACE,
    table: str = TABLE,
    replication_factor: int = 1,
    concurrency: int = 64,
    buckets_path: str | None = None,
    data_multiplicity: int = 1,
    username: str | None = None,
    password: str | None = None,
) -> dict:
    from vector_store_tpu_torch.benchkit.data import load_fbin

    base = load_fbin(data_path)
    n, d = base.shape
    buckets = (
        np.load(buckets_path)
        if buckets_path
        else assign_buckets(n)
    )
    session = await _session(uri, username, password)
    try:
        await session.query(
            f"CREATE KEYSPACE IF NOT EXISTS {keyspace} WITH replication = "
            f"{{'class': 'NetworkTopologyStrategy', 'replication_factor': "
            f"'{int(replication_factor)}'}}"
        )
        await session.query(
            f"CREATE TABLE IF NOT EXISTS {keyspace}.{table} ("
            f"{BUCKET_COL} bigint, {ID_COL} bigint, "
            f"{VECTOR_COL} vector<float, {d}>, "
            f"PRIMARY KEY (({BUCKET_COL}, {ID_COL})))"
        )
        insert = (
            f"INSERT INTO {keyspace}.{table} "
            f"({BUCKET_COL}, {ID_COL}, {VECTOR_COL}) VALUES (?, ?, ?)"
        )
        sem = asyncio.Semaphore(concurrency)
        uploaded = 0

        async def one(vid: int, row: np.ndarray) -> None:
            nonlocal uploaded
            async with sem:
                b = int(buckets[vid % n]) if buckets is not None else 255
                await session.execute_prepared(
                    insert, [b, vid, [float(x) for x in row]]
                )
                uploaded += 1
                if uploaded % 100_000 == 0:
                    print(
                        f"[load] uploaded {uploaded}", file=sys.stderr, flush=True
                    )

        total = n * data_multiplicity
        await asyncio.gather(
            *(one(vid, base[vid % n]) for vid in range(total))
        )
        return {"uploaded": total, "dimension": d, "keyspace": keyspace, "table": table}
    finally:
        await session.stop()


async def build_index(
    uri: str,
    *,
    keyspace: str = KEYSPACE,
    table: str = TABLE,
    index: str = INDEX,
    local: bool = False,
    options: str | None = None,
    username: str | None = None,
    password: str | None = None,
) -> dict:
    session = await _session(uri, username, password)
    try:
        local_cols = f"({BUCKET_COL}), " if local else ""
        opts = f" WITH OPTIONS = {options}" if options else ""
        cql = (
            f"CREATE CUSTOM INDEX {index} ON {keyspace}.{table} "
            f"({local_cols}{VECTOR_COL}) USING 'vector_index'{opts}"
        )
        await session.query(cql)
        return {"created": index, "cql": cql}
    finally:
        await session.stop()


async def drop_index(
    uri: str,
    *,
    keyspace: str = KEYSPACE,
    index: str = INDEX,
    username: str | None = None,
    password: str | None = None,
) -> dict:
    session = await _session(uri, username, password)
    try:
        await session.query(f"DROP INDEX IF EXISTS {keyspace}.{index}")
        return {"dropped": index}
    finally:
        await session.stop()


async def drop_table(
    uri: str,
    *,
    keyspace: str = KEYSPACE,
    username: str | None = None,
    password: str | None = None,
) -> dict:
    session = await _session(uri, username, password)
    try:
        await session.query(f"DROP KEYSPACE IF EXISTS {keyspace}")
        return {"dropped": keyspace}
    finally:
        await session.stop()


async def delete_rows(
    uri: str,
    ids: list[int],
    *,
    keyspace: str = KEYSPACE,
    table: str = TABLE,
    concurrency: int = 64,
    buckets_path: str | None = None,
    username: str | None = None,
    password: str | None = None,
) -> dict:
    buckets = np.load(buckets_path) if buckets_path else None
    session = await _session(uri, username, password)
    try:
        delete = (
            f"DELETE FROM {keyspace}.{table} "
            f"WHERE {BUCKET_COL} = ? AND {ID_COL} = ?"
        )
        sem = asyncio.Semaphore(concurrency)

        async def one(vid: int) -> None:
            async with sem:
                b = (
                    int(buckets[vid % len(buckets)])
                    if buckets is not None
                    else 255
                )
                await session.execute_prepared(delete, [b, vid])

        await asyncio.gather(*(one(v) for v in ids))
        return {"deleted": len(ids)}
    finally:
        await session.stop()
