"""Load/benchmark driver (parity with the reference's
crates/benchmark/src/main.rs commands): measures QPS, latency percentiles,
and recall over the HTTP path, with filtered-search selectivity buckets
[50%, 10%, 1%, 0.1%] (main.rs:45-49).

Usage:
    python -m vector_store_tpu_torch.benchkit.harness search-http \
        --url http://127.0.0.1:6080 --keyspace ks --index idx \
        --queries queries.fbin --ground-truth gt.ibin --k 10 --concurrency 64
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np

from vector_store_tpu_torch.benchkit.data import load_fbin, load_ibin
from vector_store_tpu_torch.benchkit.recall import recall_at_k
from vector_store_tpu_torch.client import VectorStoreClient

SELECTIVITY_BUCKETS = [0.5, 0.1, 0.01, 0.001]


async def search_http(
    url: str,
    keyspace: str,
    index: str,
    queries: np.ndarray,
    ground_truth: np.ndarray | None,
    k: int,
    concurrency: int,
    pk_column: str = "pk",
    filter_template=None,
) -> dict:
    latencies: list[float] = []
    returned: list[list] = [None] * len(queries)  # type: ignore[list-item]
    sem = asyncio.Semaphore(concurrency)

    async with VectorStoreClient(url) as client:
        async def one(i: int) -> None:
            async with sem:
                t0 = time.perf_counter()
                res = await client.ann(
                    keyspace,
                    index,
                    queries[i].tolist(),
                    limit=k,
                    filter=filter_template(i) if filter_template else None,
                )
                latencies.append(time.perf_counter() - t0)
                returned[i] = res.primary_keys.get(pk_column, [])

        t_start = time.time()
        await asyncio.gather(*(one(i) for i in range(len(queries))))
        wall = time.time() - t_start

    lat = np.asarray(latencies)
    out = {
        "queries": len(queries),
        "qps": len(queries) / wall,
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p95_ms": float(np.percentile(lat, 95) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
    }
    if ground_truth is not None:
        out["recall_at_k"] = recall_at_k(returned, ground_truth, k)
    return out


async def search_cql(
    uri: str,
    keyspace: str,
    table: str,
    column: str,
    pk_column: str,
    queries: np.ndarray,
    ground_truth: np.ndarray | None,
    k: int,
    concurrency: int,
    username: str | None = None,
    password: str | None = None,
) -> dict:
    """Drive ANN through the CQL path (reference search-cql,
    crates/benchmark/src/main.rs:169-206): `SELECT pk FROM ks.tbl ORDER BY
    col ANN OF ? LIMIT k` against the cluster coordinator, which routes to
    the vector store."""
    from vector_store_tpu_torch.db.cql.session import CqlSession
    from vector_store_tpu_torch.db.scylla import quote_ident

    session = CqlSession(uri, username=username, password=password)
    session.start()
    q = (
        f"SELECT {quote_ident(pk_column)} "
        f"FROM {quote_ident(keyspace)}.{quote_ident(table)} "
        f"ORDER BY {quote_ident(column)} ANN OF ? LIMIT {int(k)}"
    )
    latencies: list[float] = []
    returned: list[list] = [None] * len(queries)  # type: ignore[list-item]
    sem = asyncio.Semaphore(concurrency)

    async def one(i: int) -> None:
        async with sem:
            t0 = time.perf_counter()
            rs = await session.execute_prepared(q, [list(map(float, queries[i]))])
            latencies.append(time.perf_counter() - t0)
            returned[i] = [row[0] for row in rs.rows]

    try:
        t_start = time.time()
        await asyncio.gather(*(one(i) for i in range(len(queries))))
        wall = time.time() - t_start
    finally:
        await session.stop()

    lat = np.asarray(latencies)
    out = {
        "queries": len(queries),
        "qps": len(queries) / wall,
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p95_ms": float(np.percentile(lat, 95) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
    }
    if ground_truth is not None:
        out["recall_at_k"] = recall_at_k(returned, ground_truth, k)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(prog="vector-search-benchmark")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("search-http", help="drive ANN over HTTP, measure QPS/latency/recall")
    p.add_argument("--url", default="http://127.0.0.1:6080")
    p.add_argument("--keyspace", required=True)
    p.add_argument("--index", required=True)
    p.add_argument("--queries", required=True, help=".fbin query file")
    p.add_argument("--ground-truth", help=".ibin ground truth file")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--concurrency", type=int, default=64)
    p.add_argument("--limit-queries", type=int)
    p.add_argument("--pk-column", default="pk")

    c = sub.add_parser(
        "search-cql", help="drive ANN via CQL 'ORDER BY ... ANN OF', measure QPS/latency/recall"
    )
    c.add_argument("--uri", default="127.0.0.1:9042")
    c.add_argument("--keyspace", required=True)
    c.add_argument("--table", required=True)
    c.add_argument("--column", default="emb")
    c.add_argument("--pk-column", default="pk")
    c.add_argument("--queries", required=True, help=".fbin query file")
    c.add_argument("--ground-truth", help=".ibin ground truth file")
    c.add_argument("--k", type=int, default=10)
    c.add_argument("--concurrency", type=int, default=64)
    c.add_argument("--limit-queries", type=int)
    c.add_argument("--username")
    c.add_argument("--password")

    # load-side commands (reference main.rs:44-231)
    b = sub.add_parser("build-buckets", help="assign selectivity buckets for a dataset")
    b.add_argument("--data", required=True, help=".fbin base file")
    b.add_argument("--out", default="buckets.npy")
    b.add_argument("--seed", type=int, default=0)

    t = sub.add_parser("build-table", help="create schema + upload dataset vectors")
    t.add_argument("--uri", default="127.0.0.1:9042")
    t.add_argument("--data", required=True, help=".fbin base file")
    t.add_argument("--keyspace", default="vsbench")
    t.add_argument("--table", default="vectors")
    t.add_argument("--rf", type=int, default=1)
    t.add_argument("--concurrency", type=int, default=64)
    t.add_argument("--buckets", help="buckets.npy from build-buckets")
    t.add_argument("--data-multiplicity", type=int, default=1)
    t.add_argument("--username")
    t.add_argument("--password")

    i = sub.add_parser("build-index", help="CREATE CUSTOM INDEX ... USING 'vector_index'")
    i.add_argument("--uri", default="127.0.0.1:9042")
    i.add_argument("--keyspace", default="vsbench")
    i.add_argument("--table", default="vectors")
    i.add_argument("--index", default="vectors_idx")
    i.add_argument("--local", action="store_true")
    i.add_argument("--options")
    i.add_argument("--username")
    i.add_argument("--password")

    di = sub.add_parser("drop-index")
    di.add_argument("--uri", default="127.0.0.1:9042")
    di.add_argument("--keyspace", default="vsbench")
    di.add_argument("--index", default="vectors_idx")
    di.add_argument("--username")
    di.add_argument("--password")

    dt = sub.add_parser("drop-table")
    dt.add_argument("--uri", default="127.0.0.1:9042")
    dt.add_argument("--keyspace", default="vsbench")
    dt.add_argument("--username")
    dt.add_argument("--password")

    dr = sub.add_parser("delete-rows")
    dr.add_argument("--uri", default="127.0.0.1:9042")
    dr.add_argument("--keyspace", default="vsbench")
    dr.add_argument("--table", default="vectors")
    dr.add_argument("--ids", required=True, help="comma-separated or @file of ids")
    dr.add_argument("--buckets", help="buckets.npy from build-buckets")
    dr.add_argument("--concurrency", type=int, default=64)
    dr.add_argument("--username")
    dr.add_argument("--password")

    args = parser.parse_args()
    if args.command in (
        "build-buckets",
        "build-table",
        "build-index",
        "drop-index",
        "drop-table",
        "delete-rows",
    ):
        from vector_store_tpu_torch.benchkit import load as loadmod

        if args.command == "build-buckets":
            result = loadmod.build_buckets(args.data, args.out, seed=args.seed)
        elif args.command == "build-table":
            result = asyncio.run(
                loadmod.build_table(
                    args.uri,
                    args.data,
                    keyspace=args.keyspace,
                    table=args.table,
                    replication_factor=args.rf,
                    concurrency=args.concurrency,
                    buckets_path=args.buckets,
                    data_multiplicity=args.data_multiplicity,
                    username=args.username,
                    password=args.password,
                )
            )
        elif args.command == "build-index":
            result = asyncio.run(
                loadmod.build_index(
                    args.uri,
                    keyspace=args.keyspace,
                    table=args.table,
                    index=args.index,
                    local=args.local,
                    options=args.options,
                    username=args.username,
                    password=args.password,
                )
            )
        elif args.command == "drop-index":
            result = asyncio.run(
                loadmod.drop_index(
                    args.uri,
                    keyspace=args.keyspace,
                    index=args.index,
                    username=args.username,
                    password=args.password,
                )
            )
        elif args.command == "drop-table":
            result = asyncio.run(
                loadmod.drop_table(
                    args.uri,
                    keyspace=args.keyspace,
                    username=args.username,
                    password=args.password,
                )
            )
        else:
            raw = args.ids
            if raw.startswith("@"):
                with open(raw[1:]) as f:
                    ids = [int(x) for x in f.read().split()]
            else:
                ids = [int(x) for x in raw.split(",")]
            result = asyncio.run(
                loadmod.delete_rows(
                    args.uri,
                    ids,
                    keyspace=args.keyspace,
                    table=args.table,
                    concurrency=args.concurrency,
                    buckets_path=args.buckets,
                    username=args.username,
                    password=args.password,
                )
            )
        print(json.dumps(result))
        return
    if args.command == "search-http":
        queries = load_fbin(args.queries, count=args.limit_queries)
        gt = load_ibin(args.ground_truth) if args.ground_truth else None
        result = asyncio.run(
            search_http(
                args.url,
                args.keyspace,
                args.index,
                queries,
                gt,
                args.k,
                args.concurrency,
                pk_column=args.pk_column,
            )
        )
        print(json.dumps(result))
    elif args.command == "search-cql":
        queries = load_fbin(args.queries, count=args.limit_queries)
        gt = load_ibin(args.ground_truth) if args.ground_truth else None
        result = asyncio.run(
            search_cql(
                args.uri,
                args.keyspace,
                args.table,
                args.column,
                args.pk_column,
                queries,
                gt,
                args.k,
                args.concurrency,
                username=args.username,
                password=args.password,
            )
        )
        print(json.dumps(result))


if __name__ == "__main__":
    main()
