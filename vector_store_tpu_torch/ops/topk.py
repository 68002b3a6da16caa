"""Top-k (smallest-distance) selection primitives.

Counterpart of vector_store_tpu/ops/topk.py. Selection is an exact
``torch.topk``; ``approx=True`` (lax.approx_min_k on the TPU) maps to the
same exact selection.
"""

from __future__ import annotations

import torch


def min_k(
    distances: torch.Tensor, ids: torch.Tensor, k: int, approx: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k along the last axis. distances [B, N] f32, ids [B, N] i32.
    Returns ([B, k] dists, [B, k] ids) sorted ascending by distance; when
    N < k the result is padded with (+inf, -1)."""
    del approx  # exact selection either way
    n = distances.shape[-1]
    if n < k:
        b = distances.shape[0]
        distances = torch.cat(
            [distances, distances.new_full((b, k - n), float("inf"))], dim=-1
        )
        ids = torch.cat([ids, ids.new_full((b, k - n), -1)], dim=-1)
    d, pos = torch.topk(distances, k, dim=-1, largest=False, sorted=True)
    return d, torch.gather(ids, -1, pos)


def merge_min_k(
    best_d: torch.Tensor,  # [B, k]
    best_i: torch.Tensor,  # [B, k]
    new_d: torch.Tensor,  # [B, m]
    new_i: torch.Tensor,  # [B, m]
    approx: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge a new candidate block into the running best-k set."""
    k = best_d.shape[-1]
    return min_k(
        torch.cat([best_d, new_d], dim=-1),
        torch.cat([best_i, new_i], dim=-1),
        k,
        approx=approx,
    )
