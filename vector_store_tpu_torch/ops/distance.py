"""Batched pairwise distances as matrix products.

Counterpart of vector_store_tpu/ops/distance.py for float storage:

- EUCLIDEAN: squared L2, d = |q|^2 + |v|^2 - 2 q.v
- COSINE: d = 1 - q.v / (|q| |v|), range [0, 2]
- DOT_PRODUCT: d = 1 - q.v

The per-vector auxiliary ("aux") is |v| for COSINE and unused otherwise.
Products run in f32 (F32 storage promises full f32 distances, so TF32
stays off: see vector_store_tpu_torch/__init__.py).
"""

from __future__ import annotations

import numpy as np
import torch

from vector_store_tpu.core.types import Quantization, SpaceType
from vector_store_tpu_torch.ops.quantize import padded_dim, quantize_for_storage

_EPS = 1e-30


def effective_space(space_type: SpaceType, quantization: Quantization) -> SpaceType:
    """B1 indexes always use Hamming (usearch.rs: B1 => Hamming forced)."""
    if quantization is Quantization.B1:
        return SpaceType.HAMMING
    return space_type


def _require_float_space(space: SpaceType) -> None:
    if space is SpaceType.HAMMING:
        raise NotImplementedError(
            "Hamming distance is not ported yet (ROADMAP.md, port queue: "
            "B1/Hamming)"
        )


def vector_aux(
    x: torch.Tensor, space_type: SpaceType, quantization: Quantization
) -> torch.Tensor:
    """Per-vector auxiliary of the storage rows ``x`` [..., Dp]: |v| for
    cosine (summed in f64), zeros otherwise."""
    space = effective_space(space_type, quantization)
    _require_float_space(space)
    if space is SpaceType.COSINE:
        return x.double().square().sum(-1).sqrt().float()
    return torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)


def _dot(queries: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    return queries.float() @ block.float().T


def _finish(space, dot, q, v, q_aux, v_aux):
    if space is SpaceType.DOT_PRODUCT:
        return 1.0 - dot
    if space is SpaceType.COSINE:
        return 1.0 - dot / torch.clamp(q_aux * v_aux, min=_EPS)
    q2 = q.float().square().sum(-1)
    v2 = v.float().square().sum(-1)
    return torch.clamp(q2.unsqueeze(-1) + v2 - 2.0 * dot, min=0.0)


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
    _require_float_space(space)
    dot = _dot(queries, block)
    return _finish(space, dot, queries, block, q_aux[:, None], v_aux[None, :])


def query_block_distance(
    queries: torch.Tensor,  # [B, Dp] storage dtype
    blocks: torch.Tensor,  # [B, m, Dp] storage dtype (per-query rows)
    space_type: SpaceType,
    quantization: Quantization,
    q_aux: torch.Tensor,  # [B]
    v_aux: torch.Tensor,  # [B, m]
) -> torch.Tensor:
    """Distances [B, m] f32 between each query and its own m rows."""
    space = effective_space(space_type, quantization)
    _require_float_space(space)
    dot = torch.einsum("bd,bmd->bm", queries.float(), blocks.float())
    if space is SpaceType.EUCLIDEAN:
        q2 = queries.float().square().sum(-1)
        v2 = blocks.float().square().sum(-1)
        return torch.clamp(q2[:, None] + v2 - 2.0 * dot, min=0.0)
    return _finish(space, dot, None, None, q_aux[:, None], v_aux)


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
