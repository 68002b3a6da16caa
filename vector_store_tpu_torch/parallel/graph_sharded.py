"""Sharded graph ANN over a 2-D mesh: one independent graph a shard.

Counterpart of vector_store_tpu/parallel/graph_sharded.py. Vector rows
shard over "model"; each shard builds a complete fixed-degree graph over
its own rows (exact kNN within the shard, hash-random bridges, Vamana
alpha-prune, one reverse-edge pass: the recipe of the single-card bulk
build, engine/graph.py). A query runs the lockstep beam search on every
shard, and ``all_gather_model`` plus one exact merge turn the per-shard
top-k into the global top-k: no collective a beam hop.

The global top-k is the union of the per-shard top-k sets, so sharded
recall is at least single-graph recall at equal ef (each shard's graph is
smaller); the price is S beams instead of one.

The per-shard kNN is blocked for the device, [KNN_ROWS] query rows against
[KNN_COLS] column chunks, not the JAX package's row_block x row_block
pairs: the result does not depend on the blocking (ties go to the lower
id, as the JAX merge leaves them). ``row_block`` keeps its meaning for the
reverse pass and for the capacity's alignment.
"""

from __future__ import annotations

import numpy as np
import torch

from vector_store_tpu_torch.core.types import Quantization, SpaceType
from vector_store_tpu_torch.engine.graph import alpha_prune, ava_u32, bulk_reverse, graph_beam_search
from vector_store_tpu_torch.ops.distance import pairwise_distance, prepare_queries, vector_aux
from vector_store_tpu_torch.ops.quantize import padded_dim, quantize_for_storage, storage_dtype
from vector_store_tpu_torch.ops.topk import merge_min_k, stable_min_k
from vector_store_tpu_torch.parallel.sharded import (
    Mesh,
    all_gather_model,
    on_devices,
    row_width,
    sharded_invalidate_rows,
    sharded_upsert_step,
    split_rows,
)

N_ENTRIES = 16
R_RAND = 8  # hash-random bridge candidates a node (NSW long links)
KNN_ROWS, KNN_COLS = 8192, 16384  # the per-shard kNN's query rows x column chunk
INF = float("inf")


def _shard_entries(n_local: int) -> int:
    """Entries a shard: ~2 * sqrt(n), floored at N_ENTRIES."""
    return int(min(512, max(N_ENTRIES, 2 * np.sqrt(max(n_local, 1)))))


def chunk_min_k(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``stable_min_k(d, k)`` (the k smallest of each row by (value,
    position), in that order), through a float ``torch.topk``: its set is
    the stable one unless more than k values tie at or under its k-th,
    and those rows alone take ``stable_min_k``."""
    if k >= d.shape[1]:
        return stable_min_k(d, k)
    vals, sel = torch.topk(d, k, dim=1, largest=False, sorted=True)
    tied = (d <= vals[:, -1:]).sum(dim=1) > k
    sel = torch.sort(sel, dim=1).values  # positions ascending, then a stable sort by value
    vals, order = torch.sort(torch.gather(d, 1, sel), dim=1, stable=True)
    sel = torch.gather(sel, 1, order)
    rows = tied.nonzero()[:, 0]
    if rows.numel():
        vals[rows], sel[rows] = stable_min_k(d[rows], k)
    return vals, sel


def _knn(
    vectors: torch.Tensor, aux: torch.Tensor, valid: torch.Tensor, lo: int, hi: int,
    *, space: SpaceType, quant: Quantization, k_cand: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k_cand nearest live rows (self excluded) of rows [lo, hi) of
    one shard: ([rows, k_cand] distances ascending, ids; inf / -1 pad),
    ties to the lower id."""
    qv, qa = vectors[lo:hi], aux[lo:hi]
    rows = hi - lo
    slots = torch.arange(lo, hi, dtype=torch.int32, device=vectors.device)
    best_d = torch.full((rows, k_cand), INF, dtype=torch.float32, device=vectors.device)
    best_i = torch.full((rows, k_cand), -1, dtype=torch.int32, device=vectors.device)
    for clo in range(0, vectors.shape[0], KNN_COLS):
        chi = min(clo + KNN_COLS, vectors.shape[0])
        d = pairwise_distance(qv, vectors[clo:chi], space, quant, qa, aux[clo:chi])
        ids = torch.arange(clo, chi, dtype=torch.int32, device=vectors.device)
        bad = ~valid[clo:chi][None, :] | (ids[None, :] == slots[:, None])
        # the chunk's own k_cand first (ids ascending within its ties), then
        # the running merge: ties go to the running set, which holds the
        # lower ids
        cd, pos = chunk_min_k(torch.where(bad, INF, d), k_cand)
        best_d, best_i = merge_min_k(best_d, best_i, cd, (clo + pos).to(torch.int32), stable=True)
    return best_d, best_i


def _build_local(
    vectors: torch.Tensor,  # [n_local, Dp] storage dtype
    aux: torch.Tensor,  # [n_local]
    valid: torch.Tensor,  # [n_local] bool
    *,
    space: SpaceType,
    quant: Quantization,
    m: int,
    k_cand: int,
    alpha: float,
    row_block: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's graph: exact kNN within the shard, hash-random bridges,
    alpha-prune, a whole-shard reverse pass -> (adjacency [n_local, m] i32,
    entries [E] i32, -1 pads). A function of the shard's rows alone."""
    n_local = vectors.shape[0]
    dev = vectors.device
    m_bridge = max(2, m // 8)
    m_near = m - m_bridge
    rows_per = n_local // max(n_local // row_block, 1)
    adjacency = torch.empty((n_local, m), dtype=torch.int32, device=dev)
    for lo in range(0, n_local, KNN_ROWS):
        hi = min(lo + KNN_ROWS, n_local)
        best_d, best_i = _knn(vectors, aux, valid, lo, hi, space=space, quant=quant, k_cand=k_cand)
        slots = torch.arange(lo, hi, dtype=torch.int32, device=dev)

        # hash-random bridges across the whole shard (pure-kNN graphs
        # fragment into cluster islands)
        seed = ava_u32(slots.long()[:, None] * R_RAND + torch.arange(R_RAND, device=dev)[None, :])
        rand = (seed % max(n_local, 1)).to(torch.int32)
        rv = vectors[rand.long()].float()  # [rows, R, Dp]
        ra = aux[rand.long()]
        fq = vectors[lo:hi].float()
        dots = torch.einsum("bd,brd->br", fq, rv)
        if space is SpaceType.EUCLIDEAN:
            rd = torch.clamp((fq * fq).sum(-1)[:, None] + (rv * rv).sum(-1) - 2.0 * dots, min=0.0)
        else:
            rd = 1.0 - dots / torch.clamp(aux[lo:hi][:, None] * ra, min=1e-30)
        rd = torch.where((rand == slots[:, None]) | ~valid[rand.long()], INF, rd)

        # near region: alpha-pruned exact kNN; bridge region: the random
        # long links pruned only against each other
        best_d, order = torch.sort(best_d, dim=1, stable=True)
        best_i = torch.gather(best_i, 1, order)
        safe = torch.clamp(best_i, min=0).long()
        near_i, _ = alpha_prune(
            best_i, best_d, vectors[safe], aux[safe], m=m_near, alpha=alpha, space=space, quant=quant
        )
        rd, order = torch.sort(rd, dim=1, stable=True)
        rand = torch.gather(rand, 1, order)
        rsafe = torch.clamp(rand, min=0).long()
        br_i, _ = alpha_prune(
            rand, rd, vectors[rsafe], aux[rsafe], m=m_bridge, alpha=alpha, space=space, quant=quant
        )
        # dead rows get no edges (they would poison the reverse pass)
        adjacency[lo:hi] = torch.where(valid[lo:hi][:, None], torch.cat([near_i, br_i], dim=1), -1)

    near = bulk_reverse(
        adjacency[:, :m_near], vectors, aux, valid, space=space, quant=quant,
        m=m_near, r=m_near, alpha=alpha, max_forced=4, row_block=rows_per,
    )
    adjacency = torch.cat([near, adjacency[:, m_near:]], dim=1)
    # entry points spread over the shard by stride, ~2 sqrt(n) of them
    n_e = _shard_entries(n_local)
    stride = max(n_local // n_e, 1)
    entries = (torch.arange(n_e, dtype=torch.int32, device=dev) * stride) % n_local
    entries = torch.where(valid[entries.long()], entries, -1)
    return adjacency, entries


def sharded_graph_build_step(
    mesh: Mesh, vectors, aux, valid, *, space, quant, m, k_cand, alpha, row_block
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Every shard's graph (adjacency, entries), each on its device."""
    out = [
        _build_local(v, a, ok, space=space, quant=quant, m=m, k_cand=k_cand, alpha=alpha, row_block=row_block)
        for v, a, ok in zip(vectors, aux, valid)
    ]
    return [o[0] for o in out], [o[1] for o in out]


def sharded_graph_search_step(
    mesh: Mesh,
    vectors, aux, valid, epochs, adjacency, entries,
    queries: torch.Tensor,  # [B, Dp] storage dtype (host)
    q_aux: torch.Tensor,  # [B]
    *,
    space: SpaceType,
    quant: Quantization,
    k: int,
    beam_width: int,
    iters: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The beam on every shard, gathered and merged per data row -> host
    (distances [B, k] f32, global ids [B, k] i32, epochs [B, k] i32)."""
    devs = mesh.shard_devices
    per = vectors[0].shape[0]
    out_d, out_i, out_e = [], [], []
    for r, lo, hi in mesh.row_split(queries.shape[0]):
        home = mesh.devices[r][0]
        q_on = on_devices((queries[lo:hi], q_aux[lo:hi]), devs)
        parts = ([], [], [])
        for j, dev in enumerate(devs):
            allow = torch.ones((per,), dtype=torch.bool, device=dev)
            d, i = graph_beam_search(
                vectors[j], aux[j], valid[j], allow, adjacency[j], entries[j], *q_on[dev],
                space=space, quant=quant, k=k, beam_width=beam_width, iters=iters,
                filtered=False, expand=4,
            )
            e = torch.where(i >= 0, epochs[j][torch.clamp(i, min=0).long()], -1)
            parts[0].append(d)
            parts[1].append(torch.where(i >= 0, i + j * per, -1))
            parts[2].append(e)
        all_d, all_i, all_e = (all_gather_model(p, home) for p in parts)
        fin_d, sel = stable_min_k(all_d, k)
        fin_i = torch.gather(all_i, 1, sel)
        out_d.append(fin_d.cpu())
        out_i.append(torch.where(torch.isfinite(fin_d), fin_i, -1).cpu())
        out_e.append(torch.gather(all_e, 1, sel).cpu())
    return torch.cat(out_d).numpy(), torch.cat(out_i).numpy(), torch.cat(out_e).numpy()


class ShardedGraphIndex:
    """Graph ANN index sharded across a mesh: per-shard graphs built shard
    by shard, searched with one beam a shard, merged exactly. Bulk-build
    semantics (load, then serve); the capacity rounds up to a multiple of
    model shards * row_block."""

    def __init__(
        self,
        mesh: Mesh,
        dimensions: int,
        space_type: SpaceType = SpaceType.COSINE,
        quantization: Quantization = Quantization.BF16,
        capacity: int = 1 << 16,
        connectivity: int = 16,
        expansion_add: int = 64,
        expansion_search: int = 64,
        alpha: float = 1.2,
        row_block: int = 512,
    ) -> None:
        self.mesh = mesh
        self.space_type = space_type
        self.quantization = quantization
        self.dimensions = dimensions
        self.dp = padded_dim(dimensions, quantization)
        self.m = int(connectivity)
        self.k_cand = int(expansion_add)
        self.ef = int(expansion_search)
        self.alpha = float(alpha)
        self.row_block = row_block
        model = mesh.shape["model"]
        self.cap_local = -(-capacity // (model * row_block)) * row_block
        self.capacity = self.cap_local * model
        per, devs = self.cap_local, mesh.shard_devices
        dt = storage_dtype(quantization)
        self.vectors = [torch.zeros((per, self.dp), dtype=dt, device=d) for d in devs]
        self.aux = [torch.zeros((per,), dtype=torch.float32, device=d) for d in devs]
        self.valid = [torch.zeros((per,), dtype=torch.bool, device=d) for d in devs]
        self.epochs = [torch.full((per,), -1, dtype=torch.int32, device=d) for d in devs]
        self.adjacency = [torch.full((per, self.m), -1, dtype=torch.int32, device=d) for d in devs]
        self.entries = [torch.full((_shard_entries(per),), -1, dtype=torch.int32, device=d) for d in devs]

    def tensors(self) -> list[torch.Tensor]:
        return self.vectors + self.aux + self.valid + self.epochs + self.adjacency + self.entries

    def load_rows(self, slots: np.ndarray, epochs: np.ndarray, vectors: np.ndarray) -> None:
        """Place rows (slot = global position; owner shard = slot // per)."""
        vals = quantize_for_storage(np.asarray(vectors, np.float32), self.quantization)
        vals = torch.nn.functional.pad(vals, (0, self.dp - vals.shape[-1]))
        new_aux = vector_aux(vals, self.space_type, self.quantization)
        sharded_upsert_step(
            self.mesh, self.vectors, self.aux, self.valid, self.epochs, slots, vals, new_aux, epochs
        )

    def invalidate(self, slots: np.ndarray) -> None:
        """Mark slots dead: the beam still routes through them, results
        skip them (one write a shard)."""
        sharded_invalidate_rows(self.mesh, self.valid, self.cap_local, slots, False)

    def build(self) -> None:
        """Every shard's graph from its rows."""
        self.adjacency, self.entries = sharded_graph_build_step(
            self.mesh, self.vectors, self.aux, self.valid, space=self.space_type, quant=self.quantization,
            m=self.m, k_cand=self.k_cand, alpha=self.alpha, row_block=self.row_block,
        )

    def search(self, queries: np.ndarray, k: int):
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        qs, q_aux = prepare_queries(queries, self.space_type, self.quantization)
        return sharded_graph_search_step(
            self.mesh, self.vectors, self.aux, self.valid, self.epochs, self.adjacency, self.entries,
            qs, q_aux, space=self.space_type, quant=self.quantization, k=k,
            beam_width=self.ef, iters=self.ef,
        )

    def load_state(self, state: dict) -> None:
        """Take a JAX ShardedGraphIndex's global arrays (numpy: vectors,
        aux, valid, epochs, adjacency, entries; the same capacity) and
        split them over this mesh."""
        self.vectors = split_rows(self.mesh, row_width(state["vectors"], self.dp), self.cap_local)
        for name in ("aux", "valid", "epochs", "adjacency"):
            setattr(self, name, split_rows(self.mesh, state[name], self.cap_local))
        n_e = np.asarray(state["entries"]).shape[0] // self.mesh.shape["model"]
        self.entries = split_rows(self.mesh, state["entries"], n_e)
