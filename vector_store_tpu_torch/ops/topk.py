"""Top-k (smallest-distance) selection primitives.

Counterpart of vector_store_tpu/ops/topk.py. Selection is an exact
``torch.topk``; ``approx=True`` (lax.approx_min_k on the TPU) maps to the
same exact selection. ``stable=True`` breaks ties as ``lax.top_k`` does,
to the lower position (``torch.topk`` leaves their order open): Hamming
and integer distances tie often, and the tie order decides which rows an
oversampled scan hands its rescore tier.
"""

from __future__ import annotations

import torch


def stable_min_k(distances: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k of [B, N] f32 (no NaN) along the last axis, ascending,
    ties to the lower position: ([B, k] distances, [B, k] positions). The
    key of an entry is its float's order-preserving int32 image times 2^32
    plus its position, so every key is distinct (-0.0 counts as 0.0)."""
    bits = (distances.float() + 0.0).contiguous().view(torch.int32).long()
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    pos = torch.arange(distances.shape[-1], device=distances.device)
    _, sel = torch.topk(order * (1 << 32) + pos, k, dim=-1, largest=False, sorted=True)
    return torch.gather(distances, -1, sel), sel


def min_k(
    distances: torch.Tensor,
    ids: torch.Tensor,
    k: int,
    approx: bool = False,
    stable: bool = False,
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
    if stable:
        d, pos = stable_min_k(distances, k)
    else:
        d, pos = torch.topk(distances, k, dim=-1, largest=False, sorted=True)
    return d, torch.gather(ids, -1, pos)


def merge_min_k(
    best_d: torch.Tensor,  # [B, k]
    best_i: torch.Tensor,  # [B, k]
    new_d: torch.Tensor,  # [B, m]
    new_i: torch.Tensor,  # [B, m]
    approx: bool = False,
    stable: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge a new candidate block into the running best-k set (with
    ``stable``, a tie goes to the running set, then to the lower id of a
    block taken in id order)."""
    k = best_d.shape[-1]
    return min_k(
        torch.cat([best_d, new_d], dim=-1),
        torch.cat([best_i, new_i], dim=-1),
        k,
        approx=approx,
        stable=stable,
    )
