"""The plain reference: exact nearest neighbours and exact distances.

Plain PyTorch (on the run's device) and NumPy; it imports nothing of the
program and reads only the inputs the benchmark made (rows, queries,
writes). Float32 products run with TF32 off (``exact_f32``): the
configurations state F32 ranking, and TF32 is the lower precision that
the control (``benchmark/control.py``) stands for.

Distances follow the service's definitions: euclidean is the squared L2
distance, cosine is ``1 - cos``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.data import Writes

BLOCK_ROWS = 262_144


@contextlib.contextmanager
def exact_f32():
    """Float32 matrix products in full float32 (TF32 off) inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp_min(torch.finfo(x.dtype).tiny)


def block_distances(q: torch.Tensor, v: torch.Tensor, space: str) -> torch.Tensor:
    """[nq, nv] distances of float32 queries and rows, as one matrix
    product (the form a scan computes)."""
    if space == "COSINE":
        return 1.0 - _unit(q) @ _unit(v).T
    return (q * q).sum(1, keepdim=True) - 2.0 * (q @ v.T) + (v * v).sum(1)[None, :]


def exact_top_k(rows: torch.Tensor, queries: torch.Tensor, k: int, space: str,
                distances=block_distances) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k (row ids [q, k] int64, distances [q, k]) of ``queries``
    over ``rows`` (both f32 on one device), a block of rows at a time."""
    best_d = torch.full((queries.shape[0], k), float("inf"), device=queries.device)
    best_i = torch.full((queries.shape[0], k), -1, dtype=torch.int64, device=queries.device)
    with exact_f32():
        for lo in range(0, rows.shape[0], BLOCK_ROWS):
            d = distances(queries, rows[lo : lo + BLOCK_ROWS], space)
            bd, bi = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
            cat_d, cat_i = torch.cat([best_d, bd], 1), torch.cat([best_i, bi + lo], 1)
            best_d, sel = torch.topk(cat_d, k, dim=1, largest=False)
            best_i = torch.gather(cat_i, 1, sel)
    return best_i.cpu().numpy(), best_d.cpu().numpy()


def pair_distances(q: np.ndarray, v: np.ndarray, space: str, device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """Exact distances of queries q [a, d] to rows v [a, k, d], in float64:
    (distance [a, k], scale [a, k]); the scale is the size of the terms a
    float32 scan adds (|q|^2 + |v|^2 for euclidean, 1 for cosine), against
    which a distance's error is measured."""
    qt = torch.from_numpy(q).to(device, torch.float64)
    vt = torch.from_numpy(v).to(device, torch.float64)
    if space == "COSINE":
        qn = qt / qt.norm(dim=1, keepdim=True)
        vn = vt / vt.norm(dim=2, keepdim=True)
        dist = 1.0 - torch.einsum("ad,akd->ak", qn, vn)
        scale = torch.ones_like(dist)
    else:
        dist = ((qt[:, None, :] - vt) ** 2).sum(-1)
        scale = (qt * qt).sum(1, keepdim=True) + (vt * vt).sum(-1)
    return dist.cpu().numpy(), scale.cpu().numpy()


class KeyBook:
    """What the reference knows of every key: the vector it held before the
    window and, for a key the window updates, the one after; whether it is
    live after the window; whether it was ever live."""

    def __init__(self, base: np.ndarray, writes: Writes | None = None) -> None:
        self.base = base
        self.n = base.shape[0]
        self.writes = writes
        empty = np.zeros(0, dtype=np.int64)
        self.inserted = 0
        # updated keys, sorted, with the index into writes.vectors of each
        # one's new vector; deleted keys, sorted
        self.upd_keys, self.upd_vecs, self.del_keys = empty, empty, empty
        if writes is not None:
            self.inserted = int((writes.kind == Writes.INSERT).sum())
            upd = writes.kind == Writes.UPDATE
            order = np.argsort(writes.key[upd])
            self.upd_keys, self.upd_vecs = writes.key[upd][order], writes.vec[upd][order]
            self.del_keys = np.sort(writes.key[writes.kind == Writes.DELETE])

    def ever_live(self, keys: np.ndarray) -> np.ndarray:
        return (keys >= 0) & (keys < self.n + self.inserted)

    def live_after(self, keys: np.ndarray) -> np.ndarray:
        return self.ever_live(keys) & ~np.isin(keys, self.del_keys)

    def vectors(self, keys: np.ndarray, after: bool) -> np.ndarray:
        """The vectors of ever-live ``keys`` [...]: before the window's
        update (``after`` False) or after it. An inserted key has one."""
        flat = keys.ravel()
        out = np.empty((flat.size, self.base.shape[1]), dtype=np.float32)
        base = flat < self.n
        out[base] = self.base[flat[base]]
        if self.writes is not None:
            ins = ~base
            # inserts take vectors 0.. in key order (data.write_stream)
            out[ins] = self.writes.vectors[flat[ins] - self.n]
            if after and self.upd_keys.size:
                at = np.minimum(np.searchsorted(self.upd_keys, flat), self.upd_keys.size - 1)
                hit = self.upd_keys[at] == flat
                out[hit] = self.writes.vectors[self.upd_vecs[at[hit]]]
        return out.reshape(*keys.shape, -1)

    def final_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """(keys [m], vectors [m, d]) of the live set after every write."""
        keys = np.arange(self.n + self.inserted)
        if self.writes is None:
            return keys, self.base
        live = self.live_after(keys)
        return keys[live], self.vectors(keys[live], after=True)
