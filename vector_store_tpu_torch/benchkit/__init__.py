"""Benchmark harness (parity with the reference's crates/benchmark): dataset
loaders (big-ann fbin/ibin, VectorDBBench parquet), recall@k, and load
drivers measuring QPS/latency/recall with filtered-search selectivity
buckets."""

from vector_store_tpu_torch.benchkit.data import load_fbin, load_ibin, load_parquet, write_fbin, write_ibin
from vector_store_tpu_torch.benchkit.recall import recall_at_k

__all__ = [
    "load_fbin",
    "load_ibin",
    "load_parquet",
    "write_fbin",
    "write_ibin",
    "recall_at_k",
]
