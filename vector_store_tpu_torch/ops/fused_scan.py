"""Fused rank scan (kernel 1) and the exact flat search built on it.

Counterpart of vector_store_tpu/ops/pallas_scan.py. The scan ranks every
stored row for every query by an affine form of the dot product,
r = a * (q . v) + b, with per-row coefficients

    euclidean:   a = -2, b = |v|^2   (true d^2 = r + |q|^2, added host-side)
    cosine:      a = -1, b = 0       (storage is unit-normalized; d = 1 + r)
    dot-product: a = -1, b = 0       (d = 1 + r)

and dead or filtered rows carry b = INVALID_BIAS, so they never win.
For each block of ``block_rows`` rows it keeps, per query and lane
l in [0, 128), the row with the smallest rank among the block's rows at
offsets == l (mod 128), ties going to the smaller row. An exact top-k
over these candidates follows outside the kernel (``rank_search``).

``fused_scan`` takes its plain PyTorch version (``fused_scan_plain``) for
tensors on the CPU, and launches the CUDA kernel (csrc/fused_scan.cu: f32
FMAs on the CUDA cores for F32 rows, tensor-core MMAs with f32
accumulation for F16/BF16 rows, any row length) for tensors on a CUDA
device; there is no other fallback. Unlike the Pallas
kernel's f32 offsets (a Mosaic workaround) the winners come back as int32
absolute rows, and (a, b) are two f32 vectors instead of an [8, cap] side
array.

Group-min is approximate: two true neighbours at the same lane of one
block collide and only one survives (the JAX kernel has the same rule).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from vector_store_tpu_torch.core.types import Quantization, SpaceType
from vector_store_tpu_torch.ops import kernels

LANES = 128
INVALID_BIAS = 1e30  # b for dead rows
INVALID_CUTOFF = 1e29  # rank values at or above this are empty candidates
FLOAT_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def block_rows_for(dp: int) -> int:
    """Rows per candidate block (128 candidates each). Kept at the JAX
    package's values (pallas_block_rows) so the candidate count, and with
    it the lane-collision rate, is the same."""
    if dp <= 256:
        return 16384
    if dp <= 768:
        return 8192
    return 4096


def check_scan_inputs(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    i8_rows: bool = False,
) -> None:
    """The kernels' contract: one device, one float storage dtype shared by
    queries and rows (or, with ``i8_rows``, int8 rows scanned by bf16
    queries), (a, b) f32 per row, contiguous rows padded to a multiple of 8
    elements (16 for int8 rows: the kernels copy 16 bytes at a time)."""
    same_float = queries.dtype == vectors.dtype and queries.dtype in FLOAT_DTYPES
    i8_pair = i8_rows and vectors.dtype == torch.int8 and queries.dtype == torch.bfloat16
    if not (same_float or i8_pair):
        raise TypeError(
            f"queries {queries.dtype} and vectors {vectors.dtype} must share "
            "one of float32/float16/bfloat16"
            + (", or be bfloat16 queries over int8 rows" if i8_rows else "")
        )
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("rank coefficients a and b must be float32")
    devices = {t.device for t in (queries, vectors, a, b)}
    if len(devices) != 1:
        raise ValueError(f"inputs span several devices: {sorted(map(str, devices))}")
    if queries.ndim != 2 or vectors.ndim != 2 or queries.shape[1] != vectors.shape[1]:
        raise ValueError(
            f"queries {tuple(queries.shape)} and vectors {tuple(vectors.shape)} "
            "must be 2-D with one row length"
        )
    if a.shape != (vectors.shape[0],) or b.shape != (vectors.shape[0],):
        raise ValueError("a and b must hold one value per stored row")
    pad = 16 if vectors.dtype == torch.int8 else 8
    if vectors.shape[1] % pad:
        raise ValueError(f"row length {vectors.shape[1]} is not a multiple of {pad}")
    if not all(t.is_contiguous() for t in (queries, vectors, a, b)):
        raise ValueError("scan inputs must be contiguous")


def require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no scan kernel for device {t.device}")


def fused_scan_plain(
    queries: torch.Tensor,  # [B, Dp]
    vectors: torch.Tensor,  # [cap, Dp]
    a: torch.Tensor,  # [cap] f32
    b: torch.Tensor,  # [cap] f32
    block_rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (rank [B, nblk*128] f32,
    row [B, nblk*128] i32)."""
    cap = vectors.shape[0]
    nq = queries.shape[0]
    nblk = cap // block_rows
    rank = a * (queries.float() @ vectors.float().T) + b
    rank, j = rank.view(nq, nblk, block_rows // LANES, LANES).min(dim=2)
    base = torch.arange(nblk, device=vectors.device)[:, None] * block_rows
    row = base + j * LANES + torch.arange(LANES, device=vectors.device)
    return rank.reshape(nq, nblk * LANES), row.to(torch.int32).reshape(nq, -1)


def fused_scan(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    block_rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(query, block, lane) minimum rank and its row; see the module
    docstring. CPU tensors take the plain version, CUDA tensors the
    kernel."""
    check_scan_inputs(queries, vectors, a, b)
    cap, dp = vectors.shape
    if block_rows % LANES or cap % block_rows:
        raise ValueError(
            f"capacity {cap} must be a multiple of block_rows {block_rows}, "
            f"and block_rows of {LANES}"
        )
    if queries.device.type == "cpu":
        return fused_scan_plain(queries, vectors, a, b, block_rows)
    require_cuda(queries)
    nq = queries.shape[0]
    ncand = cap // block_rows * LANES
    rank = torch.empty((nq, ncand), dtype=torch.float32, device=queries.device)
    row = torch.empty((nq, ncand), dtype=torch.int32, device=queries.device)
    if nq:
        kernels.launch(
            "vst_fused_scan",
            [queries, vectors, a, b, rank, row],
            [nq, cap, block_rows, dp, kernels.DTYPE_CODES[queries.dtype]],
        )
        with kernels.count_lock:
            fused_scan.launches += 1
            fused_scan.launches_by[str(queries.dtype).removeprefix("torch.")] += 1
    return rank, row


fused_scan.launches = 0
# storage dtype name -> launches: F32 rows run the kernel's CUDA-core
# instantiation, F16/BF16 rows its tensor-core one
fused_scan.launches_by = collections.Counter()


def rank_search(
    vectors: torch.Tensor,  # [cap, Dp] storage dtype
    a: torch.Tensor,  # [cap] f32
    b: torch.Tensor,  # [cap] f32
    queries: torch.Tensor,  # [B, Dp] storage dtype
    *,
    k: int,
    block_rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan + exact top-k over the candidates (the JAX package's
    pallas_rank_search). Returns (rank [B, k] f32 ascending, row [B, k]
    i32, -1 for empty candidates)."""
    cand_rank, cand_row = fused_scan(queries, vectors, a, b, block_rows)
    kk = min(k, cand_rank.shape[1])
    rank, sel = torch.topk(cand_rank, kk, dim=1, largest=False, sorted=True)
    row = torch.gather(cand_row, 1, sel)
    if kk < k:
        rank = torch.nn.functional.pad(rank, (0, k - kk), value=INVALID_BIAS)
        row = torch.nn.functional.pad(row, (0, k - kk), value=-1)
    return rank, torch.where(rank < INVALID_CUTOFF, row, -1)


def apply_allow_to_paux(b: torch.Tensor, allow: torch.Tensor) -> torch.Tensor:
    """Per-search filter on the bias vector b (paux row 1 in the JAX
    package): bias disallowed rows out of contention."""
    return torch.where(allow, b, INVALID_BIAS)


def paux_coeffs(
    space: SpaceType, vals: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) for stored rows ``vals`` [n, Dp] (storage values, already
    unit-normalized for cosine); |v|^2 is summed in f64."""
    n = vals.shape[0]
    kw = {"dtype": torch.float32, "device": vals.device}
    if space is SpaceType.EUCLIDEAN:
        return torch.full((n,), -2.0, **kw), vals.double().square().sum(-1).float()
    return torch.full((n,), -1.0, **kw), torch.zeros((n,), **kw)


def rank_to_distance(
    space: SpaceType, rank: np.ndarray, q2: np.ndarray | None
) -> np.ndarray:
    """Kernel rank values -> true distances (host-side, winners only);
    q2 = per-query |q|^2 for euclidean."""
    if space is SpaceType.EUCLIDEAN:
        return np.maximum(rank + q2[:, None], 0.0)
    d = 1.0 + rank
    if space is SpaceType.COSINE:
        return np.clip(d, 0.0, 2.0)
    return d


def supports(space: SpaceType, quant: Quantization) -> bool:
    return quant in (
        Quantization.F32,
        Quantization.BF16,
        Quantization.F16,
    ) and space in (SpaceType.EUCLIDEAN, SpaceType.COSINE, SpaceType.DOT_PRODUCT)
