"""What the port's bench programs share: the device they run on, host rows
copied to it, timed loops of device work, exact ground truth on it, and
the scan kernels' launch counts.

The JAX package generates its device rows on the TPU from scalars
(benchkit/synth.py's device half) and chains its timed searches in a
jitted ``fori_loop`` because its relay's host link and ``block_until_ready``
were unreliable. Here the device rows are the host rows copied from
pinned memory, and a timed loop ends with ``torch.cuda.synchronize`` and
reads CUDA events.

Every bench program runs on ``cuda`` unless the caller names another device: the
``device`` argument, else the ``BENCH_DEVICE`` environment variable (e.g.
``BENCH_DEVICE=cpu``, where the kernels' plain PyTorch versions run).
Importing this module loads no torch.
"""

from __future__ import annotations

import json
import time

import numpy as np


def bench_device(device=None):
    """The device a bench program runs on: ``device``, else ``BENCH_DEVICE``, else
    ``cuda`` (which must exist: run.resolve_device)."""
    import os

    from vector_store_tpu_torch.run import resolve_device

    return resolve_device(device if device is not None else os.environ.get("BENCH_DEVICE") or None)


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_device(rows: np.ndarray, device):
    """[n, d] host rows -> f32 tensor on ``device``, through pinned memory
    on a GPU."""
    import torch

    rows = np.ascontiguousarray(rows, dtype=np.float32)
    if not rows.flags.writeable:  # a read-only memmap slice
        rows = rows.copy()
    t = torch.from_numpy(rows)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def timed_loop(fn, m: int, device) -> float:
    """Seconds that ``m`` back-to-back calls of ``fn`` take on ``device``,
    after one warm-up call: CUDA events around the queued calls on a GPU,
    the host clock elsewhere."""
    import torch

    fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(m):
            fn()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(m):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3


def exact_top_k(
    rows: np.ndarray,  # [n, d] f32 host rows (a memmap or an array)
    queries: np.ndarray,  # [q, d] f32
    k: int,
    metric: str,  # "l2": |q|^2 + |v|^2 - 2 q.v; "cos": 1 - q.v (unit rows and queries)
    device,
    chunk: int = 131_072,
    subset: np.ndarray | None = None,  # [m] row ids: rank these rows only
) -> np.ndarray:
    """Exact f32 top-k row ids of each query, [q, min(k, n)] ascending by
    distance: ``rows`` is copied to ``device`` a chunk at a time and ranked
    by an f32 product (TF32 is off in this package). The ground truth of
    the bench programs; never a kernel's."""
    import torch

    import vector_store_tpu_torch.ops  # noqa: F401  (TF32 off for f32 products)

    ids = np.arange(rows.shape[0]) if subset is None else np.asarray(subset, dtype=np.int64)
    kk = min(k, ids.size)
    q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(device)
    q2 = q.square().sum(1)
    best_d = torch.empty((q.shape[0], 0), device=device)
    best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=device)
    for lo in range(0, ids.size, chunk):
        sel = ids[lo : lo + chunk]
        block = rows[sel] if subset is not None else rows[lo : lo + chunk]
        v = to_device(np.asarray(block), device)
        if metric == "l2":
            d = q2[:, None] + v.square().sum(1)[None, :] - 2.0 * (q @ v.T)
        else:
            d = 1.0 - q @ v.T
        bd, bi = torch.topk(d, min(kk, v.shape[0]), dim=1, largest=False)
        best_d = torch.cat([best_d, bd], 1)
        best_i = torch.cat([best_i, torch.from_numpy(sel).to(device)[bi]], 1)
    order = torch.sort(best_d, dim=1, stable=True).indices[:, :kk]
    return torch.gather(best_i, 1, order).cpu().numpy()


def recall(results, gt: np.ndarray, k: int) -> float:
    """Mean |returned slots & true top-k| / k over the rows of ``gt``."""
    return float(
        np.mean([len(set(r.slots.tolist()) & set(gt[i].tolist())) / k for i, r in enumerate(results[: len(gt)])])
    )


def launch_counts() -> dict[str, int]:
    """This process's scan-kernel launches, by the names of chip_smoke.py's
    kernels line: the fused scan's F32 and 16-bit instantiations, the
    dense grouped scan's float ones at one cluster a block, its int8 one
    and its g > 1 ones, the compact grouped scan's float and int8 ones
    (the search path), and the partition scan."""
    from vector_store_tpu_torch.ops.fused_scan import fused_scan
    from vector_store_tpu_torch.ops.ivf import PAIRS, grouped_scan
    from vector_store_tpu_torch.ops.partition_scan import partition_scan

    g = grouped_scan.launches_by
    return {
        "fused_scan": fused_scan.launches_by["float32"],
        "fused_scan_bf16": fused_scan.launches_by["bfloat16"] + fused_scan.launches_by["float16"],
        "grouped_scan": sum(n for (dt, gg), n in g.items() if dt != "int8" and gg == 1),
        "grouped_scan_i8": sum(n for (dt, gg), n in g.items() if dt == "int8" and gg == 1),
        "grouped_scan_g": sum(n for (dt, gg), n in g.items() if gg not in (1, PAIRS)),
        "grouped_scan_pairs": sum(n for (dt, gg), n in g.items() if dt != "int8" and gg == PAIRS),
        "grouped_scan_pairs_i8": g["int8", PAIRS],
        "partition_scan": partition_scan.launches,
    }


def print_launches() -> None:
    """One ``[launches] {...}`` line on stdout (before a bench program's JSON
    line): what chip_smoke.py reads from each bench process."""
    print("[launches] " + json.dumps(launch_counts()), flush=True)
