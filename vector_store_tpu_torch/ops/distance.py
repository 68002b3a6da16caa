"""Batched pairwise distances as matrix products.

Counterpart of vector_store_tpu/ops/distance.py:

- EUCLIDEAN: squared L2, d = |q|^2 + |v|^2 - 2 q.v
- COSINE: d = 1 - q.v / (|q| |v|), range [0, 2]
- DOT_PRODUCT: d = 1 - q.v
- HAMMING (and any B1 index, which forces Hamming): rows are packed 8
  bits a byte; d = popcnt(q) + popcnt(v) - 2 (q_bits . v_bits), the
  product taken over the bits unpacked to int8 {0, 1}.

The per-vector auxiliary ("aux") is |v| for COSINE, popcnt(v) for
HAMMING, unused otherwise. Float products run in f32 (F32 storage promises
full f32 distances, so TF32 stays off: see vector_store_tpu_torch/__init__.py).
I8 queries and rows (codes round(127 v)) take an exact integer product, as
the JAX package's int32 dot does, and are scaled by 1/127^2 after it; aux
and norms live in the /127 domain. The Hamming product is an exact integer
too (the JAX package's bf16 {0, 1} product accumulates in f32, exact for
any D < 2^24).
"""

from __future__ import annotations

import numpy as np
import torch

from vector_store_tpu_torch.core.types import Quantization, SpaceType
from vector_store_tpu_torch.ops.quantize import I8_SCALE, padded_dim, quantize_for_storage, unpack_bits

_EPS = 1e-30


def effective_space(space_type: SpaceType, quantization: Quantization) -> SpaceType:
    """B1 indexes always use Hamming (usearch.rs: B1 => Hamming forced)."""
    if quantization is Quantization.B1:
        return SpaceType.HAMMING
    return space_type


def _require_packed(quantization: Quantization) -> None:
    """Hamming distance is defined on packed B1 rows; the JAX package
    fails on any other storage (its bit unpacking shifts float values)."""
    if quantization is not Quantization.B1:
        raise ValueError(f"HAMMING distance needs packed B1 rows, not {quantization.name}")


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each row of bytes: uint8 [..., Db] -> f32 [...]."""
    return unpack_bits(x).sum(-1, dtype=torch.int32).float()


def _values(x: torch.Tensor, quantization: Quantization) -> torch.Tensor:
    """Storage rows as the f32 values they stand for (I8 codes / 127)."""
    if quantization is Quantization.I8:
        return x.float() / I8_SCALE
    return x.float()


def vector_aux(
    x: torch.Tensor, space_type: SpaceType, quantization: Quantization
) -> torch.Tensor:
    """Per-vector auxiliary of the storage rows ``x`` [..., Dp]: |v| for
    cosine (summed in f64; I8 rows in the /127 domain), the popcount of the
    row's bytes for Hamming, zeros otherwise."""
    space = effective_space(space_type, quantization)
    if space is SpaceType.HAMMING:
        return popcount(x.contiguous().view(torch.uint8))
    if space is SpaceType.COSINE:
        v = x.double()
        if quantization is Quantization.I8:
            v = v / I8_SCALE
        return v.square().sum(-1).sqrt().float()
    return torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)


def _int_dot(queries: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """Exact products of I8 codes, [B, Nb] as f32 (the integer sum rounded
    once, as the JAX package's int32 -> f32 cast rounds it).

    A sum of 1536 products of 127^2 passes 2^24, so an f32 product would
    round partial sums. On a CUDA device the product is ``torch._int_mm``
    (int8 x int8 -> int32 on the tensor cores; its shape rules want more
    than 16 query rows and a multiple of 8 output columns, so the operands
    are zero-padded to them); on the CPU an int64 product."""
    if queries.device.type != "cuda":
        return (queries.long() @ block.long().T).float()
    b, n = queries.shape[0], block.shape[0]
    q = torch.nn.functional.pad(queries, (0, 0, 0, max(0, 17 - b)))
    v = torch.nn.functional.pad(block, (0, 0, 0, -n % 8))
    return torch._int_mm(q, v.T)[:b, :n].float()


def _dot(queries: torch.Tensor, block: torch.Tensor, quantization: Quantization) -> torch.Tensor:
    if quantization is Quantization.I8:
        return _int_dot(queries, block) / (I8_SCALE * I8_SCALE)
    return queries.float() @ block.float().T


def _finish(space, dot, q2, v2, q_aux, v_aux):
    if space is SpaceType.DOT_PRODUCT:
        return 1.0 - dot
    if space is SpaceType.COSINE:
        return 1.0 - dot / torch.clamp(q_aux * v_aux, min=_EPS)
    return torch.clamp(q2 + v2 - 2.0 * dot, min=0.0)


def _sq_norm(x: torch.Tensor, quantization: Quantization) -> torch.Tensor:
    return _values(x, quantization).square().sum(-1)


def pairwise_distance(
    queries: torch.Tensor,  # [B, Dp] storage dtype
    block: torch.Tensor,  # [Nb, Dp] storage dtype
    space_type: SpaceType,
    quantization: Quantization,
    q_aux: torch.Tensor,  # [B] f32
    v_aux: torch.Tensor,  # [Nb] f32
) -> torch.Tensor:
    """Distances [B, Nb] f32."""
    space = effective_space(space_type, quantization)
    if space is SpaceType.HAMMING:
        _require_packed(quantization)
        dot = _int_dot(unpack_bits(queries), unpack_bits(block))
        return q_aux[:, None] + v_aux[None, :] - 2.0 * dot
    dot = _dot(queries, block, quantization)
    q2 = v2 = None
    if space is SpaceType.EUCLIDEAN:
        q2 = _sq_norm(queries, quantization)[:, None]
        v2 = _sq_norm(block, quantization)[None, :]
    return _finish(space, dot, q2, v2, q_aux[:, None], v_aux[None, :])


def query_block_distance(
    queries: torch.Tensor,  # [B, Dp] storage dtype
    blocks: torch.Tensor,  # [B, m, Dp] storage dtype (per-query rows)
    space_type: SpaceType,
    quantization: Quantization,
    q_aux: torch.Tensor,  # [B]
    v_aux: torch.Tensor,  # [B, m]
) -> torch.Tensor:
    """Distances [B, m] f32 between each query and its own m rows. I8
    products are summed in f64: exact integers, rounded once to f32. Hamming
    products of unpacked bits sum in f32 (exact below 2^24 bits; TF32 is
    off)."""
    space = effective_space(space_type, quantization)
    if space is SpaceType.HAMMING:
        _require_packed(quantization)
        dot = torch.einsum(
            "bd,bmd->bm", unpack_bits(queries).float(), unpack_bits(blocks).float()
        )
        return q_aux[:, None] + v_aux - 2.0 * dot
    if quantization is Quantization.I8:
        dot = torch.einsum("bd,bmd->bm", queries.double(), blocks.double()).float()
        dot = dot / (I8_SCALE * I8_SCALE)
    else:
        dot = torch.einsum("bd,bmd->bm", queries.float(), blocks.float())
    q2 = v2 = None
    if space is SpaceType.EUCLIDEAN:
        q2 = _sq_norm(queries, quantization)[:, None]
        v2 = _sq_norm(blocks, quantization)
    return _finish(space, dot, q2, v2, q_aux[:, None], v_aux)


def prepare_queries(
    q: np.ndarray, space_type: SpaceType, quantization: Quantization
) -> tuple[torch.Tensor, torch.Tensor]:
    """Host-side query preparation: quantize to the storage dtype, pad to
    the storage row length, compute the per-query aux. Returns CPU tensors
    (queries [B, Dp], q_aux [B])."""
    q = np.asarray(q, dtype=np.float32)
    dp = padded_dim(q.shape[-1], quantization)
    qs = quantize_for_storage(q, quantization)
    pad = dp - qs.shape[-1]
    if pad:
        qs = torch.nn.functional.pad(qs, (0, pad))
    return qs, vector_aux(qs, space_type, quantization)
