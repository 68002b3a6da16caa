"""Sharded IVF search over a 2-D mesh: the scale-out of the IVF engine.

Counterpart of vector_store_tpu/parallel/ivf_sharded.py. Layout (mesh
axes ("data", "model"), as parallel/sharded.py):

- clusters shard over "model": each shard owns nlist / model whole
  clusters: their cluster-major rows ``[npos / model, Dp]``, their rank
  coefficients (a, b) and their position -> slot map. Centroids are
  replicated on every shard's device.
- the query batch splits over "data".

Search probes the centroids once a device (they are replicated, so every
shard would find the same ids), translates the global cluster ids to each
shard's local ones (a probe of another shard's cluster parks at the local
sentinel, which the regroup drops), runs kernel 2 (csrc/grouped_scan.cu,
through ``ops/ivf.py::ivf_candidates``) over the shard's clusters, then
``all_gather_model`` collects the per-shard (rank, slot) candidates and an
exact merge with ties to the lower position (``lax.top_k``'s rule) picks
the top-k.

k-means is SPMD: every shard assigns its local rows and contributes
partial centroid sums, joined by ``psum_model`` (data-parallel Lloyd's
iterations). Products take bf16-rounded operands with f32 sums, as the
JAX package's ``preferred_element_type=jnp.float32`` products do; the
final assignment runs on the shards' devices in row blocks, and only the
labels come back to the host.

Upserts after a build land in a sharded flat delta (ShardedFlatIndex) and
merge with the IVF candidates on the host; a rebuild reclusters from the
host vector store (the host is the capacity tier; the database stays the
source of truth).
"""

from __future__ import annotations

import numpy as np
import torch

from vector_store_tpu_torch.core.types import Quantization, SpaceType
from vector_store_tpu_torch.ops.fused_scan import INVALID_BIAS, INVALID_CUTOFF
from vector_store_tpu_torch.ops.ivf import (
    _affinity,
    _bf16,
    choose_budget,
    choose_cmax,
    choose_nlist,
    ivf_candidates,
    ivf_probe,
)
from vector_store_tpu_torch.ops.quantize import padded_dim, quantize_for_storage
from vector_store_tpu_torch.ops.topk import stable_min_k
from vector_store_tpu_torch.parallel.sharded import (
    Mesh,
    ShardedFlatIndex,
    all_gather_model,
    as_tensor,
    on_devices,
    psum_model,
    row_width,
    sharded_invalidate_rows,
    split_rows,
)

# rows a k-means block: the JAX step scanned blocks of 256 rows; a block
# only bounds the [rows, nlist] affinity matrix (the sums are the same up
# to f32 rounding order), so the port takes larger ones
KMEANS_BLOCK = 16384


def sharded_kmeans_step(
    mesh: Mesh,
    x: list[torch.Tensor],  # per shard [n_local, Dp] storage rows
    w: list[torch.Tensor],  # per shard [n_local] f32 weights (0 = padding)
    cent: list[torch.Tensor],  # per shard [nlist, Dp] f32 (replicated)
    *,
    spherical: bool,
) -> list[torch.Tensor]:
    """One SPMD Lloyd iteration: each shard's assignment and partial sums,
    summed over the shards -> new centroids on every shard's device
    (empty clusters keep their centroid)."""
    nlist, dp = cent[0].shape
    sums, counts = [], []
    for xj, wj, cj in zip(x, w, cent):
        s = torch.zeros((nlist, dp), dtype=torch.float32, device=xj.device)
        c = torch.zeros((nlist,), dtype=torch.float32, device=xj.device)
        for lo in range(0, xj.shape[0], KMEANS_BLOCK):
            xb, wb = xj[lo : lo + KMEANS_BLOCK], _bf16(wj[lo : lo + KMEANS_BLOCK])
            lbl = _affinity(xb, cj, spherical).argmax(dim=-1)
            s.index_add_(0, lbl, _bf16(xb) * wb[:, None])
            c.index_add_(0, lbl, wb)
        sums.append(s)
        counts.append(c)
    devs = mesh.shard_devices
    total_s, total_c = psum_model(sums, devs), psum_model(counts, devs)
    out = []
    for s, c, cj in zip(total_s, total_c, cent):
        newc = s / torch.clamp(c, min=1.0)[:, None]
        out.append(torch.where((c > 0.5)[:, None], newc, cj))
    return out


def sharded_assign(x: list[torch.Tensor], cent: list[torch.Tensor], *, spherical: bool) -> np.ndarray:
    """Nearest-centroid labels of every shard's rows, concatenated on the
    host ([sum n_local] i64). The affinity is the JAX build's host formula
    in f32 on each shard's device (TF32 off); ``argmax`` takes the first
    index on ties, as numpy's does."""
    out = []
    for xj, cj in zip(x, cent):
        cf = cj.float()
        if spherical:
            cn = torch.clamp(cf.square().sum(-1).sqrt(), min=1e-20)
        else:
            c2 = cf.square().sum(-1)
        for lo in range(0, xj.shape[0], KMEANS_BLOCK):
            xf = xj[lo : lo + KMEANS_BLOCK].float()
            if spherical:
                aff = (xf @ cf.T) / cn[None, :]
            else:
                aff = (2.0 * xf) @ cf.T - c2[None, :]
            out.append(aff.argmax(dim=-1).cpu())
    return torch.cat(out).numpy().astype(np.int64)


def sharded_ivf_search_step(
    mesh: Mesh,
    vectors: list[torch.Tensor],  # per shard [nlist_local * cmax, Dp]
    paux: list[torch.Tensor],  # per shard [2, nlist_local * cmax] f32 (a, b)
    pos2slot: list[torch.Tensor],  # per shard [nlist_local * cmax] i32
    centroids: list[torch.Tensor],  # per shard [nlist, Dp] f32 (replicated)
    queries: torch.Tensor,  # [B, Dp] (host)
    *,
    k: int,
    nprobe: int,
    s: int,
    cmax: int,
    spherical: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """-> host (rank [B, k] f32 ascending, engine slot [B, k] i32, -1
    empty). Pairs dropped by the slot budget are ignored: each shard owns
    nlist / model clusters, so its per-cluster slot pressure is model
    times lower than the single-card path's at the same S."""
    devs = mesh.shard_devices
    nlist_local = vectors[0].shape[0] // cmax
    out_rank, out_slot = [], []
    for r, lo, hi in mesh.row_split(queries.shape[0]):
        home = mesh.devices[r][0]
        q_on = on_devices((queries[lo:hi],), devs)
        live = {d: torch.ones((hi - lo,), dtype=torch.bool, device=d) for d in q_on}
        # centroids are replicated: one probe a device serves its shards
        probes = {
            d: ivf_probe(centroids[devs.index(d)], q_on[d][0], live[d], nprobe=nprobe, spherical=spherical)
            for d in q_on
        }
        parts_rank, parts_slot = [], []
        for j, dev in enumerate(devs):
            first = j * nlist_local
            local = probes[dev] - first
            local = torch.where((local >= 0) & (local < nlist_local), local, nlist_local)
            q = q_on[dev][0]
            if q.dtype == torch.int8:  # I8 rows scan bf16 queries (exact codes)
                q = q.to(torch.bfloat16)
            rank, pos, _dropped = ivf_candidates(
                vectors[j], paux[j][0], paux[j][1], centroids[j], q, live[dev],
                k=k, nprobe=nprobe, s=s, cmax=cmax, spherical=spherical, probes=local,
            )
            slot = torch.where(pos >= 0, pos2slot[j][torch.clamp(pos, min=0).long()], -1)
            parts_rank.append(torch.where(slot >= 0, rank, INVALID_BIAS))
            parts_slot.append(slot)
        all_rank = all_gather_model(parts_rank, home)
        all_slot = all_gather_model(parts_slot, home)
        best, sel = stable_min_k(all_rank, k)
        slots = torch.gather(all_slot, 1, sel)
        out_rank.append(best.cpu())
        out_slot.append(torch.where(best < INVALID_CUTOFF, slots, -1).cpu())
    return torch.cat(out_rank).numpy(), torch.cat(out_slot).numpy()


def sharded_invalidate_step(
    mesh: Mesh, paux: list[torch.Tensor], pos2slot: list[torch.Tensor], positions: np.ndarray
) -> None:
    """Tombstone the given global cluster-major positions, in place: each
    shard writes the positions it owns (b = INVALID_BIAS, slot -1)."""
    per = pos2slot[0].shape[0]
    sharded_invalidate_rows(mesh, [p[1] for p in paux], per, positions, INVALID_BIAS)
    sharded_invalidate_rows(mesh, pos2slot, per, positions, -1)


class ShardedIvfIndex:
    """IVF index sharded across a mesh: host vector store as the capacity
    tier, clustered device regions rebuilt from it, sharded flat delta for
    post-build upserts."""

    def __init__(
        self,
        mesh: Mesh,
        dimensions: int,
        space_type: SpaceType = SpaceType.COSINE,
        quantization: Quantization = Quantization.BF16,
        nprobe: int = 32,
        headroom: float = 1.6,
        kmeans_iters: int = 8,
        delta_capacity: int = 1 << 17,
        s_boost: int = 8,
    ) -> None:
        self.mesh = mesh
        self.model = mesh.shape["model"]
        self.dimensions = dimensions
        self.space_type = space_type
        self.quantization = quantization
        self.nprobe = nprobe
        # skew headroom over the balanced per-cluster slot estimate: this
        # path cannot re-dispatch dropped pairs, so it buys drop-freedom
        # with budget up front, capped at the per-row batch in search()
        self.s_boost = max(1, int(s_boost))
        self.headroom = headroom
        self.kmeans_iters = kmeans_iters
        self.delta_capacity = delta_capacity
        self.dp = padded_dim(dimensions, quantization)
        self._spherical = space_type is not SpaceType.EUCLIDEAN

        # host capacity tier: slot -> vector/epoch (rebuild source)
        self._vecs_host: dict[int, np.ndarray] = {}
        self._epochs_host: dict[int, int] = {}

        self.main_vecs: list[torch.Tensor] | None = None
        self.main_paux: list[torch.Tensor] | None = None
        self.main_pos2slot: list[torch.Tensor] | None = None
        self.centroids: list[torch.Tensor] | None = None
        self.nlist = 0
        self.cmax = 0
        self._pos_of_slot: dict[int, int] = {}

        self._delta = ShardedFlatIndex(
            mesh, dimensions, space_type=space_type, quantization=quantization, capacity=delta_capacity
        )
        self._delta_pos_of_slot: dict[int, int] = {}
        self._delta_slot_of_pos: dict[int, int] = {}
        self._delta_next = 0

    @property
    def size(self) -> int:
        return len(self._vecs_host)

    @property
    def nlist_local(self) -> int:
        return self.nlist // self.model

    def placed_per_shard(self) -> list[int]:
        """Rows of the main region on each shard."""
        if self.main_pos2slot is None:
            return [0] * self.model
        return [int((p >= 0).sum()) for p in self.main_pos2slot]

    # -- mutation ---------------------------------------------------------------

    def upsert_batch(self, slots: np.ndarray, epochs: np.ndarray, vectors: np.ndarray) -> None:
        slots = np.asarray(slots, dtype=np.int64)
        epochs = np.asarray(epochs, dtype=np.int32)
        vectors = np.asarray(vectors, dtype=np.float32)
        if self.space_type is SpaceType.COSINE:
            vectors = vectors / np.maximum(np.linalg.norm(vectors, axis=-1, keepdims=True), 1e-30)
        stale_main = [self._pos_of_slot.pop(int(s)) for s in slots if int(s) in self._pos_of_slot]
        if stale_main:
            sharded_invalidate_step(self.mesh, self.main_paux, self.main_pos2slot, np.asarray(stale_main))
        for i, s in enumerate(slots):
            s = int(s)
            self._vecs_host[s] = vectors[i]
            self._epochs_host[s] = int(epochs[i])
        # rows serve from the sharded flat delta until the next build folds
        # them into the clustered main region; before the first build it is
        # the whole engine (an exact sharded scan)
        dpos = np.empty((slots.size,), dtype=np.int64)
        for i, s in enumerate(slots):
            s = int(s)
            p = self._delta_pos_of_slot.get(s)
            if p is None:
                p = self._delta_next
                self._delta_next += 1
                self._delta_pos_of_slot[s] = p
                self._delta_slot_of_pos[p] = s
            dpos[i] = p
        if self._delta_next > self._delta.capacity:
            raise RuntimeError("sharded IVF delta full; call build() to recluster")
        self._delta.upsert_batch(dpos, epochs, vectors)

    def remove_batch(self, slots: np.ndarray) -> None:
        gone_main, gone_delta = [], []
        for s in np.asarray(slots, dtype=np.int64):
            s = int(s)
            self._vecs_host.pop(s, None)
            self._epochs_host.pop(s, None)
            p = self._pos_of_slot.pop(s, None)
            if p is not None:
                gone_main.append(p)
            dp_ = self._delta_pos_of_slot.pop(s, None)
            if dp_ is not None:
                self._delta_slot_of_pos.pop(dp_, None)
                gone_delta.append(dp_)
        if gone_delta:
            self._delta.invalidate(np.asarray(gone_delta))
        if gone_main:
            sharded_invalidate_step(self.mesh, self.main_paux, self.main_pos2slot, np.asarray(gone_main))

    # -- build --------------------------------------------------------------------

    def build(self, reserve: int = 0) -> None:
        """(Re)cluster all live vectors into the sharded main region; the
        new delta has room for ``reserve`` rows beside the spill."""
        slots = np.fromiter(self._vecs_host.keys(), dtype=np.int64)
        n = slots.size
        if n == 0:
            return
        nlist = choose_nlist(n)
        # whole clusters a shard
        nlist = max(nlist, self.model)
        nlist = -(-nlist // self.model) * self.model
        cmax = choose_cmax(n, nlist, self.headroom)
        npos = nlist * cmax
        devs = self.mesh.shard_devices

        rows = np.stack([self._vecs_host[int(s)] for s in slots])
        vals = quantize_for_storage(rows, self.quantization)
        vals = torch.nn.functional.pad(vals, (0, self.dp - vals.shape[-1]))

        # SPMD k-means over row-sharded data (padding rows weigh 0)
        block = 256
        n_pad = -(-n // (self.model * block)) * (self.model * block)
        n_local = n_pad // self.model
        x_host = torch.zeros((n_pad, self.dp), dtype=vals.dtype)
        x_host[:n] = vals
        w_host = torch.zeros((n_pad,), dtype=torch.float32)
        w_host[:n] = 1.0
        x = split_rows(self.mesh, x_host, n_local)
        w = split_rows(self.mesh, w_host, n_local)
        # init: nlist rows spread over the live rows (deterministic)
        sel = np.linspace(0, n - 1, nlist).astype(np.int64)
        cent0 = torch.from_numpy(np.ascontiguousarray(rows[sel][:, : self.dp], np.float32))
        cent0 = torch.nn.functional.pad(cent0, (0, self.dp - cent0.shape[1]))
        cent = [cent0.to(d) for d in devs]
        for _ in range(self.kmeans_iters):
            cent = sharded_kmeans_step(self.mesh, x, w, cent, spherical=self._spherical)

        # final assignment on the shards; the layout on the host
        labels = sharded_assign(x, cent, spherical=self._spherical)[:n]
        del x, w
        order = np.argsort(labels, kind="stable")
        ranks = np.arange(n) - np.maximum.accumulate(
            np.where(np.concatenate([[True], labels[order][1:] != labels[order][:-1]]), np.arange(n), 0)
        )
        pos_sorted = labels[order] * cmax + ranks
        fits = ranks < cmax
        pos = np.full((n,), -1, dtype=np.int64)
        pos[order[fits]] = pos_sorted[fits]

        placed = pos >= 0
        at = torch.from_numpy(pos[placed])
        pv = vals[torch.from_numpy(placed)]
        vecs_h = torch.zeros((npos, self.dp), dtype=vals.dtype)
        vecs_h[at] = pv
        paux_h = torch.zeros((2, npos), dtype=torch.float32)
        paux_h[1] = INVALID_BIAS
        if self.space_type is SpaceType.EUCLIDEAN:
            paux_h[0, at] = -2.0
            paux_h[1, at] = pv.double().square().sum(-1).float()
        else:
            paux_h[0, at] = -1.0
            paux_h[1, at] = 0.0
        p2s_h = torch.full((npos,), -1, dtype=torch.int32)
        p2s_h[at] = torch.from_numpy(slots[placed].astype(np.int32))

        per = npos // self.model
        self.main_vecs = split_rows(self.mesh, vecs_h, per)
        self.main_paux = [t.T.contiguous() for t in split_rows(self.mesh, paux_h.T, per)]
        self.main_pos2slot = split_rows(self.mesh, p2s_h, per)
        self.centroids = cent
        self.nlist = nlist
        self.cmax = cmax
        self._pos_of_slot = {int(s): int(p) for s, p in zip(slots[placed], pos[placed])}

        # a fresh delta; unplaced rows spill back through it. It holds at
        # least four times the spill and the reserve together, so they
        # alone never make the next build due (the serving engine rebuilds
        # past 1/2 or 3/4 of it); the JAX index keeps its first capacity
        # and fails the build when the spill outgrows it
        spill = int((~placed).sum())
        self._delta = ShardedFlatIndex(
            self.mesh, self.dimensions, space_type=self.space_type,
            quantization=self.quantization, capacity=max(self.delta_capacity, 4 * (spill + reserve)),
        )
        self._delta_pos_of_slot.clear()
        self._delta_slot_of_pos.clear()
        self._delta_next = 0
        if (~placed).any():
            sp = slots[~placed]
            self.upsert_batch(
                sp, np.asarray([self._epochs_host[int(s)] for s in sp], np.int32), rows[~placed]
            )

    # -- search -------------------------------------------------------------------

    def slot_budget(self, b: int) -> int:
        """Per-cluster query slots S of a batch of b: the JAX package's
        rule on the batch padded to a multiple of max(8 * data, 8) (the
        queries themselves are not padded; S decides which pairs are
        dropped, so it keeps the padded count)."""
        dpar = self.mesh.shape["data"]
        b = b + (-b) % max(dpar * 8, 8)
        nprobe = min(self.nprobe, self.nlist)
        s = choose_budget(b // dpar, nprobe, self.nlist // self.model)
        # capped at a row's batch: a query holds at most one slot a
        # cluster, so S = b / data drops nothing
        return min(s * self.s_boost, max(16, b // dpar))

    def search(self, queries: np.ndarray, k: int):
        """-> (distances [B, k], slots [B, k], epochs [B, k]); -1 slots pad."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if self.space_type is SpaceType.COSINE:
            queries = queries / np.maximum(np.linalg.norm(queries, axis=-1, keepdims=True), 1e-30)
        b_real = queries.shape[0]

        main = None
        if self.main_vecs is not None:
            qs = quantize_for_storage(queries, self.quantization)
            qs = torch.nn.functional.pad(qs, (0, self.dp - qs.shape[-1]))
            rank, slot = sharded_ivf_search_step(
                self.mesh, self.main_vecs, self.main_paux, self.main_pos2slot, self.centroids, qs,
                k=k, nprobe=min(self.nprobe, self.nlist), s=self.slot_budget(b_real), cmax=self.cmax,
                spherical=self._spherical,
            )
            if self.space_type is SpaceType.EUCLIDEAN:
                q2 = (queries.astype(np.float64) ** 2).sum(-1).astype(np.float32)
                dist = rank + q2[:, None]
            else:
                dist = 1.0 + rank
            dist = np.where(slot >= 0, dist, np.inf)
            main = (dist, slot)

        # the delta region (post-build upserts) through the sharded flat scan
        delta = None
        if self._delta_next > 0:
            dd, di, _ = self._delta.search(queries, min(k, self._delta_next))
            dslot = np.full_like(di, -1, dtype=np.int64)
            ok = di >= 0
            dslot[ok] = [self._delta_slot_of_pos.get(int(p), -1) for p in di[ok]]
            dd = np.where(dslot >= 0, dd, np.inf)
            delta = (dd, dslot)

        if main is None and delta is None:
            z = np.zeros((b_real, 0))
            return z, z.astype(np.int64), z.astype(np.int32)
        if delta is None:
            dist, slot = main
        elif main is None:
            dist, slot = delta
        else:
            dist = np.concatenate([main[0], delta[0]], axis=1)
            slot = np.concatenate([main[1], delta[1]], axis=1)
        sel = np.argsort(dist, axis=1)[:, :k]
        dist = np.take_along_axis(dist, sel, axis=1)
        slot = np.take_along_axis(slot, sel, axis=1).astype(np.int64)
        slot = np.where(np.isfinite(dist), slot, -1)
        epochs = np.asarray(
            [[self._epochs_host.get(int(s), -1) for s in row] for row in slot], dtype=np.int32
        ).reshape(slot.shape)
        return dist, slot, epochs

    # -- state ----------------------------------------------------------------------

    def load_state(self, state: dict) -> None:
        """Take a JAX ShardedIvfIndex's state (numpy global arrays and host
        dicts: main_vecs, main_paux (its rows 0-1 are a and b),
        main_pos2slot, centroids, nlist, cmax, the host dicts, and the
        delta's arrays and maps) and split it over this mesh."""
        self.nlist, self.cmax = int(state["nlist"]), int(state["cmax"])
        self._vecs_host = {int(s): np.asarray(v, np.float32) for s, v in state["_vecs_host"].items()}
        self._epochs_host = {int(s): int(e) for s, e in state["_epochs_host"].items()}
        self._pos_of_slot = {int(s): int(p) for s, p in state["_pos_of_slot"].items()}
        if state.get("main_vecs") is None:
            self.main_vecs = self.main_paux = self.main_pos2slot = self.centroids = None
        else:
            npos = self.nlist * self.cmax
            per = npos // self.model
            self.main_vecs = split_rows(self.mesh, row_width(state["main_vecs"], self.dp), per)
            paux = as_tensor(np.asarray(state["main_paux"], np.float32)[:2])
            self.main_paux = [t.T.contiguous() for t in split_rows(self.mesh, paux.T, per)]
            self.main_pos2slot = split_rows(self.mesh, np.asarray(state["main_pos2slot"], np.int32), per)
            cent = row_width(np.asarray(state["centroids"], np.float32), self.dp)
            self.centroids = [cent.to(d) for d in self.mesh.shard_devices]
        self._delta.load_state(state["delta"])
        self._delta_pos_of_slot = {int(s): int(p) for s, p in state["_delta_pos_of_slot"].items()}
        self._delta_slot_of_pos = {int(p): int(s) for p, s in state["_delta_slot_of_pos"].items()}
        self._delta_next = int(state["_delta_next"])
