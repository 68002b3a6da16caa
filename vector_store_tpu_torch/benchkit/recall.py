"""recall@k (parity with latte/vector-search/metrics.rn:24-41):
|returned ∩ true_top_k| / min(k, |ground_truth|)."""

from __future__ import annotations

import numpy as np


def recall_at_k(returned: np.ndarray, ground_truth: np.ndarray, k: int) -> float:
    """returned [B, <=k], ground_truth [B, >=k]; rows may be ragged lists."""
    total = 0.0
    b = len(returned)
    for row in range(b):
        ret = set(np.asarray(returned[row]).tolist())
        gt = np.asarray(ground_truth[row])[:k]
        denom = min(k, len(gt))
        if denom == 0:
            total += 1.0
            continue
        total += len(ret & set(gt.tolist())) / denom
    return total / b if b else 0.0
