"""Dataset loaders (parity with the reference benchmark crate's
data/fbin.rs and data/mod.rs): big-ann-benchmarks .fbin/.ibin and
VectorDBBench parquet."""

from __future__ import annotations

import struct

import numpy as np


def load_fbin(path: str, start: int = 0, count: int | None = None) -> np.ndarray:
    """big-ann .fbin: i32 n, i32 dim, then n*dim little-endian f32."""
    with open(path, "rb") as f:
        n, dim = struct.unpack("<ii", f.read(8))
        if count is None:
            count = n - start
        count = max(0, min(count, n - start))
        f.seek(8 + start * dim * 4)
        data = np.fromfile(f, dtype="<f4", count=count * dim)
    return data.reshape(count, dim)


def load_ibin(path: str, start: int = 0, count: int | None = None) -> np.ndarray:
    """big-ann .ibin ground truth: i32 n, i32 k, then n*k little-endian i32."""
    with open(path, "rb") as f:
        n, k = struct.unpack("<ii", f.read(8))
        if count is None:
            count = n - start
        count = max(0, min(count, n - start))
        f.seek(8 + start * k * 4)
        data = np.fromfile(f, dtype="<i4", count=count * k)
    return data.reshape(count, k)


def write_fbin(path: str, vectors: np.ndarray) -> None:
    vectors = np.asarray(vectors, dtype="<f4")
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", vectors.shape[0], vectors.shape[1]))
        vectors.tofile(f)


def write_ibin(path: str, ids: np.ndarray) -> None:
    ids = np.asarray(ids, dtype="<i4")
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", ids.shape[0], ids.shape[1]))
        ids.tofile(f)


def load_parquet(path: str, vector_column: str = "emb", id_column: str = "id"):
    """VectorDBBench parquet: returns (ids [n], vectors [n, d])."""
    import pyarrow.parquet as pq

    table = pq.read_table(path, columns=[id_column, vector_column])
    ids = table.column(id_column).to_numpy()
    vecs = np.stack(table.column(vector_column).to_pylist()).astype(np.float32)
    return ids, vecs
