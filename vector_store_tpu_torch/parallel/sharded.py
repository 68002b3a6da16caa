"""Sharded exact search over a 2-D mesh of devices.

Counterpart of vector_store_tpu/parallel/sharded.py. The JAX package runs
one program on every device of a ("data", "model") mesh (``shard_map``)
and joins the results with ``all_gather`` / ``psum``; here one process
drives every shard in turn, each shard's tensors on its own device, and
two helpers named after those collectives join the results:

- vector rows shard over "model" (each shard holds N / model rows and
  their aux / valid / epoch metadata);
- the query batch splits over "data" (each data row of the mesh takes a
  contiguous share of the batch and gathers on its own first device);
- search: every shard scores its rows against the queries, reduces to a
  local top-k, ``all_gather_model`` collects the per-shard candidates and
  one exact merge yields the global top-k; the winners' epochs come from
  their owning shard (``psum_model``: exactly one shard contributes);
- upsert: a row goes only to its owning shard (slot // rows_per_shard).

The rows of a model shard live once, on the device of the mesh's first
data row; the data rows split the batch only. ``make_mesh`` places shard
i on ``devices[i % len(devices)]``, so S shards run on fewer cards than S
(on one card, every shard shares it), as the JAX package's tests run an
8-way mesh on 8 virtual devices of one CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from vector_store_tpu_torch.core.types import Quantization, SpaceType
from vector_store_tpu_torch.ops.distance import pairwise_distance, prepare_queries, vector_aux
from vector_store_tpu_torch.ops.quantize import padded_dim, quantize_for_storage, storage_dtype
from vector_store_tpu_torch.ops.topk import merge_min_k, min_k

INF = float("inf")


class Mesh:
    """A ("data", "model") grid of torch devices: ``devices[r][j]`` is the
    device of model shard j in data row r; ``shape`` reads as a JAX mesh's
    (``mesh.shape["model"]``)."""

    def __init__(self, devices: list[list[torch.device]]) -> None:
        self.devices = devices
        self.shape = {"data": len(devices), "model": len(devices[0])}

    @property
    def shard_devices(self) -> list[torch.device]:
        """Where each model shard's tensors live."""
        return list(self.devices[0])

    def row_split(self, b: int) -> list[tuple[int, int]]:
        """Each data row's contiguous share [lo, hi) of a batch of b, as
        (row, lo, hi); a row whose share is empty is left out."""
        cuts = np.linspace(0, b, self.shape["data"] + 1).round().astype(int)
        return [(r, int(cuts[r]), int(cuts[r + 1])) for r in range(self.shape["data"]) if cuts[r + 1] > cuts[r]]

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, devices={self.devices})"


def make_mesh(
    n_devices: int | None = None, data: int = 1, devices: list | None = None
) -> Mesh:
    """A mesh of ``n_devices`` shards (default: one a device) over
    ``devices`` (default: every CUDA device), ``data`` rows of n / data
    model shards. Shard i goes on ``devices[i % len(devices)]``."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise RuntimeError("no device for the mesh: pass devices=[torch.device('cpu')] * n on a host without CUDA")
    n = len(devices) if n_devices is None else int(n_devices)
    if n < 1 or n % data != 0:
        raise ValueError(f"{n} devices not divisible by data={data}")
    placed = [devices[i % len(devices)] for i in range(n)]
    model = n // data
    return Mesh([placed[r * model : (r + 1) * model] for r in range(data)])


def all_gather_model(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The per-shard [B, k] candidates side by side on ``device``
    ([B, S * k], shard-major: ``all_gather(..., axis=1, tiled=True)``)."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim=1)


def psum_model(parts: list[torch.Tensor], devices: list[torch.device]) -> list[torch.Tensor]:
    """The sum of the per-shard partials, computed on ``devices[0]`` and
    copied to every device of ``devices`` (``psum`` over "model")."""
    total = parts[0].to(devices[0], non_blocking=True).clone()
    for p in parts[1:]:
        total += p.to(devices[0], non_blocking=True)
    return [total if d == devices[0] else total.to(d, non_blocking=True) for d in devices]


def on_devices(tensors: tuple, devices: list[torch.device]) -> dict:
    """``tensors`` copied once to each distinct device (shards that share
    a device share the copy)."""
    return {d: tuple(t.to(d, non_blocking=True) for t in tensors) for d in dict.fromkeys(devices)}


def shard_rows(per: int, slots: np.ndarray, j: int) -> tuple[np.ndarray, np.ndarray]:
    """(positions in ``slots`` that shard j owns, their local rows)."""
    local = np.asarray(slots, np.int64) - j * per
    mine = np.nonzero((local >= 0) & (local < per))[0]
    return mine, local[mine]


def local_top_k(
    vectors: torch.Tensor,  # [n_local, Dp] one shard's rows
    aux: torch.Tensor,
    valid: torch.Tensor,
    queries: torch.Tensor,  # [B, Dp] on the shard's device
    q_aux: torch.Tensor,
    *,
    space: SpaceType,
    quant: Quantization,
    k: int,
    offset: int,
    block_rows: int,
    n_rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's exact top-k over its first ``n_rows`` rows (the rest
    were never written) in blocks of ``block_rows``: ([B, k] distances
    ascending, [B, k] global ids, -1 where the distance is not finite).
    Ties go to the lower id, as the JAX scan's running ``merge_min_k``
    leaves them."""
    b = queries.shape[0]
    best_d = torch.full((b, k), INF, dtype=torch.float32, device=queries.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=queries.device)
    for lo in range(0, n_rows, block_rows):
        d = pairwise_distance(queries, vectors[lo : lo + block_rows], space, quant, q_aux, aux[lo : lo + block_rows])
        d = torch.where(valid[lo : lo + block_rows][None, :], d, INF)
        ids = offset + lo + torch.arange(d.shape[1], dtype=torch.int32, device=d.device)
        best_d, best_i = merge_min_k(best_d, best_i, d, ids[None, :].expand(b, -1), stable=True)
    return best_d, torch.where(torch.isfinite(best_d), best_i, -1)


def sharded_search_step(
    mesh: Mesh,
    vectors: list[torch.Tensor],
    aux: list[torch.Tensor],
    valid: list[torch.Tensor],
    epochs: list[torch.Tensor],
    queries: torch.Tensor,  # [B, Dp] storage dtype (host or any device)
    q_aux: torch.Tensor,  # [B]
    *,
    space: SpaceType,
    quant: Quantization,
    k: int,
    block_rows: int,
    high: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every shard's local top-k, gathered and merged per data row ->
    host (distances [B, k] f32, ids [B, k] i32, epochs [B, k] i32).
    Positions at or past ``high`` were never written: each shard scans
    its rows below it only (a shard with none gives only empty lanes)."""
    per = vectors[0].shape[0]
    devs = mesh.shard_devices
    high = per * len(devs) if high is None else high
    out_d, out_i, out_e = [], [], []
    for r, lo, hi in mesh.row_split(queries.shape[0]):
        home = mesh.devices[r][0]
        parts_d, parts_i = [], []
        q_on = on_devices((queries[lo:hi], q_aux[lo:hi]), devs)
        for j, dev in enumerate(devs):
            d, i = local_top_k(
                vectors[j], aux[j], valid[j], *q_on[dev], space=space, quant=quant, k=k,
                offset=j * per, block_rows=block_rows, n_rows=min(max(high - j * per, 0), per),
            )
            parts_d.append(d)
            parts_i.append(i)
        fin_d, fin_i = min_k(
            all_gather_model(parts_d, home), all_gather_model(parts_i, home), k, stable=True
        )
        # local epochs cover one shard each: the owner contributes the
        # winner's epoch, every other shard 0
        eloc = []
        for j, dev in enumerate(devs):
            pos = fin_i.to(dev, non_blocking=True).long() - j * per
            mine = (pos >= 0) & (pos < per)
            eloc.append(torch.where(mine, epochs[j][torch.clamp(pos, 0, per - 1)], 0))
        fin_e = psum_model(eloc, [home])[0]
        out_d.append(fin_d.cpu())
        out_i.append(fin_i.cpu())
        out_e.append(torch.where(fin_i >= 0, fin_e, -1).cpu())
    return torch.cat(out_d).numpy(), torch.cat(out_i).numpy(), torch.cat(out_e).numpy()


def sharded_upsert_step(
    mesh: Mesh,
    vectors: list[torch.Tensor],
    aux: list[torch.Tensor],
    valid: list[torch.Tensor],
    epochs: list[torch.Tensor],
    slots: np.ndarray,
    vals: torch.Tensor,  # [n, Dp] storage rows (host)
    new_aux: torch.Tensor,  # [n]
    new_epochs: np.ndarray,
) -> None:
    """Each shard writes the rows it owns (slot // rows_per_shard), in
    place; slots past the capacity are dropped, as the JAX scatter's
    ``mode="drop"`` drops them."""
    per = vectors[0].shape[0]
    new_epochs = torch.from_numpy(np.asarray(new_epochs, np.int32))
    for j, dev in enumerate(mesh.shard_devices):
        mine, local = shard_rows(per, slots, j)
        if mine.size == 0:
            continue
        rows = torch.from_numpy(local).to(dev)
        pick = torch.from_numpy(mine)
        vectors[j][rows] = vals[pick].to(dev)
        aux[j][rows] = new_aux[pick].to(dev)
        epochs[j][rows] = new_epochs[pick].to(dev)
        valid[j][rows] = True


def sharded_invalidate_rows(
    mesh: Mesh, tensors: list[torch.Tensor], per: int, positions: np.ndarray, value
) -> None:
    """Set ``value`` at the given global positions, one indexed write a
    shard (each shard writes the positions it owns)."""
    for j, dev in enumerate(mesh.shard_devices):
        _, local = shard_rows(per, positions, j)
        if local.size:
            tensors[j][torch.from_numpy(local).to(dev)] = value


class ShardedFlatIndex:
    """Flat exact index sharded across a mesh. The capacity rounds up to a
    multiple of (model shards * block_rows)."""

    def __init__(
        self,
        mesh: Mesh,
        dimensions: int,
        space_type: SpaceType = SpaceType.COSINE,
        quantization: Quantization = Quantization.F32,
        capacity: int = 1 << 20,
        block_rows: int = 8192,
    ) -> None:
        self.mesh = mesh
        self.space_type = space_type
        self.quantization = quantization
        self.dimensions = dimensions
        self.dp = padded_dim(dimensions, quantization)
        model = mesh.shape["model"]
        self.per = -(-capacity // (model * block_rows)) * block_rows
        self.capacity = self.per * model
        self.block_rows = block_rows
        dt = storage_dtype(quantization)
        devs = mesh.shard_devices
        self.vectors = [torch.zeros((self.per, self.dp), dtype=dt, device=d) for d in devs]
        self.aux = [torch.zeros((self.per,), dtype=torch.float32, device=d) for d in devs]
        self.valid = [torch.zeros((self.per,), dtype=torch.bool, device=d) for d in devs]
        self.epochs = [torch.full((self.per,), -1, dtype=torch.int32, device=d) for d in devs]
        self.high = 0  # positions at or past it were never written

    def tensors(self) -> list[torch.Tensor]:
        return self.vectors + self.aux + self.valid + self.epochs

    def upsert_batch(self, slots: np.ndarray, epochs: np.ndarray, vectors: np.ndarray) -> None:
        vals = quantize_for_storage(np.asarray(vectors, np.float32), self.quantization)
        vals = torch.nn.functional.pad(vals, (0, self.dp - vals.shape[-1]))
        new_aux = vector_aux(vals, self.space_type, self.quantization)
        sharded_upsert_step(
            self.mesh, self.vectors, self.aux, self.valid, self.epochs, slots, vals, new_aux, epochs
        )
        if len(slots):
            self.high = min(max(self.high, int(np.max(slots)) + 1), self.capacity)

    def invalidate(self, positions: np.ndarray) -> None:
        """Mark the given global positions dead (one write a shard)."""
        sharded_invalidate_rows(self.mesh, self.valid, self.per, positions, False)

    def search(self, queries: np.ndarray, k: int):
        """-> host (distances [B, k], ids [B, k], epochs [B, k]); -1 ids pad."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        qs, q_aux = prepare_queries(queries, self.space_type, self.quantization)
        return sharded_search_step(
            self.mesh, self.vectors, self.aux, self.valid, self.epochs, qs, q_aux,
            space=self.space_type, quant=self.quantization, k=k, block_rows=self.block_rows, high=self.high,
        )

    def load_state(self, state: dict) -> None:
        """Take a JAX ShardedFlatIndex's global arrays (numpy: vectors,
        aux, valid, epochs; the same capacity) and split them over this
        mesh. The JAX rows are padded wider (to 128 lanes); the padding
        columns are zeros and are cut."""
        self.vectors = split_rows(self.mesh, row_width(state["vectors"], self.dp), self.per)
        self.aux, self.valid, self.epochs = (
            split_rows(self.mesh, state[name], self.per) for name in ("aux", "valid", "epochs")
        )
        self.high = self.capacity


def split_rows(mesh: Mesh, array, per: int) -> list[torch.Tensor]:
    """A global [model * per, ...] array (numpy or tensor) as per-shard
    tensors on the shards' devices."""
    t = as_tensor(array)
    if t.shape[0] != per * mesh.shape["model"]:
        raise ValueError(f"{t.shape[0]} rows do not split into {mesh.shape['model']} shards of {per}")
    return [t[j * per : (j + 1) * per].contiguous().to(d) for j, d in enumerate(mesh.shard_devices)]


def as_tensor(array) -> torch.Tensor:
    """A numpy array (bfloat16 ones of ml_dtypes too) or tensor as a CPU
    tensor of the same dtype."""
    if isinstance(array, torch.Tensor):
        return array
    array = np.array(array)  # a writable copy (JAX arrays read as read-only numpy)
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def row_width(array, dp: int) -> torch.Tensor:
    """Storage rows cut (or zero-padded) to ``dp`` columns: the JAX
    package pads rows to 128 lanes, the port to ROW_ALIGN."""
    t = as_tensor(array)
    return torch.nn.functional.pad(t[:, :dp], (0, max(0, dp - t.shape[1])))
