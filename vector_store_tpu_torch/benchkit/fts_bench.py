"""BM25 engine throughput benchmark (host-side; no TPU involved).

The reference's FTS engine is tantivy (crates/vector-store/src/fts_index/
tantivy.rs) — an in-RAM inverted index with commit batching. This measures
our equivalent (C++ core native/fts_native.cpp behind the ctypes binding,
and the pure-python fallback) on the same synthetic corpus so the two
implementations and future changes are comparable: indexing docs/s,
commit cost, and search QPS for the three query shapes the parser
supports (bare terms, +must/-must_not, quoted phrases).

Env knobs: FTS_DOCS (default 100_000), FTS_VOCAB (30_000),
FTS_WORDS_PER_DOC (20), FTS_QUERIES (2_000).
Prints ONE JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _corpus(n_docs: int, vocab: int, words_per_doc: int, rng) -> list[str]:
    """Zipf-ish word frequencies (natural-language-shaped posting lists:
    a few huge stopword-like lists, a long tail of short ones)."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    words = np.array([f"w{i}" for i in range(vocab)])
    lens = rng.poisson(words_per_doc, size=n_docs).clip(3, None)
    docs = []
    for i in range(n_docs):
        docs.append(" ".join(words[rng.choice(vocab, size=lens[i], p=probs)]))
    return docs


def _queries(n: int, vocab: int, rng) -> list[str]:
    qs = []
    for i in range(n):
        # mid-frequency terms (head terms are stopword-like, tail is empty)
        a, b = rng.integers(50, vocab // 4, size=2)
        kind = i % 3
        if kind == 0:
            qs.append(f"w{a} w{b}")
        elif kind == 1:
            qs.append(f"+w{a} -w{b}")
        else:
            qs.append(f'"w{a} w{b}"')
    return qs


def bench_impl(make_index, docs: list[str], queries: list[str], limit: int) -> dict:
    idx = make_index()
    t0 = time.monotonic()
    for i, body in enumerate(docs):
        idx.add_document(i, body)
    t_add = time.monotonic() - t0
    t0 = time.monotonic()
    idx.commit()
    t_commit = time.monotonic() - t0
    t0 = time.monotonic()
    hits = 0
    for q in queries:
        hits += len(idx.search(q, limit))
    t_search = time.monotonic() - t0
    # churn: the CDC steady state is deletes + re-adds against a large
    # committed index (each op touches only its own doc's postings)
    n_churn = min(5_000, len(docs) // 2)
    t0 = time.monotonic()
    for i in range(n_churn):
        idx.delete_document(i)
    idx.commit()
    for i in range(n_churn):
        idx.add_document(i, docs[i])
    idx.commit()
    t_churn = time.monotonic() - t0
    return {
        "index_docs_per_sec": round(len(docs) / (t_add + t_commit), 1),
        "commit_seconds": round(t_commit, 3),
        "search_qps": round(len(queries) / t_search, 1),
        "avg_hits": round(hits / len(queries), 1),
        "churn_ops_per_sec": round(2 * n_churn / t_churn, 1),
        "size_bytes": int(idx.size_bytes()),
    }


def run() -> dict:
    from vector_store_tpu_torch.fts import InvertedIndex
    from vector_store_tpu_torch.fts.native import native_available

    n_docs = int(os.environ.get("FTS_DOCS", 100_000))
    vocab = int(os.environ.get("FTS_VOCAB", 30_000))
    wpd = int(os.environ.get("FTS_WORDS_PER_DOC", 20))
    n_q = int(os.environ.get("FTS_QUERIES", 2_000))
    rng = np.random.default_rng(7)

    docs = _corpus(n_docs, vocab, wpd, rng)
    queries = _queries(n_q, vocab, rng)

    out: dict = {"bench": "fts", "docs": n_docs, "vocab": vocab, "queries": n_q}
    if native_available():
        from vector_store_tpu_torch.fts.native import NativeInvertedIndex

        out["native"] = bench_impl(NativeInvertedIndex, docs, queries, 10)
    out["python"] = bench_impl(InvertedIndex, docs, queries, 10)
    return out


def main() -> None:
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
