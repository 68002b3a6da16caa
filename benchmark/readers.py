"""Arithmetic the per-layer readers share (``benchmark/metrics/``).

A reader takes the traced run's readings (``tracing.Tracer.readings``)
and returns its number, or None where the span gave it nothing to read;
the harness then leaves the metric out of the result line.
"""

from __future__ import annotations

import torch

from benchmark import roofline


def hot(r: dict, name: str) -> tuple[int, float]:
    """(calls, total ms) of one ``utils/hotpath`` function over the span."""
    a = r["after"]["hotpath"].get(name, {"calls": 0, "total_ms": 0.0})
    b = r["before"]["hotpath"].get(name, {"calls": 0, "total_ms": 0.0})
    return a["calls"] - b["calls"], a["total_ms"] - b["total_ms"]


def delta(r: dict, key: str) -> float:
    return r["after"][key] - r["before"][key]


def server_ms(r: dict) -> float | None:
    """Mean server-side ms of an ANN request (``request_latency_seconds``)."""
    n = delta(r, "http_count")
    return delta(r, "http_sum_s") / n * 1e3 if n > 0 else None


def per_call_seconds(r: dict, kernels: tuple[tuple[str, ...], ...]) -> float | None:
    """Device seconds of one call of an entry point that launches one kernel
    of each group in ``kernels`` (names matched by substring): each group's
    time over its launches in the trace, summed. A call's mean, not the
    span's total, so a kernel record the profiler lost skews neither side."""
    ops, counts = r["trace"]["device_ops"], r["trace"]["device_counts"]
    total = 0.0
    for group in kernels:
        seconds = sum(s for name, s in ops.items() if any(p in name for p in group))
        launches = sum(c for name, c in counts.items() if any(p in name for p in group))
        if not launches:
            return None
        total += seconds / launches
    return total


def share(bounds: list[float], kernels: tuple[tuple[str, ...], ...], r: dict) -> float | None:
    """100 x a call's mean bound over its mean device time."""
    t = per_call_seconds(r, kernels)
    return 100.0 * sum(bounds) / len(bounds) / t if bounds and t else None


def pairs_roofline(r: dict) -> float | None:
    """The compact grouped scan (``csrc/grouped_scan.cu``: its tile prefix
    and its scan, one launch each a call) against the work its calls'
    pairs need over their clusters' live rows."""
    calls = r["calls"].get("grouped_scan_pairs", [])
    if not calls:
        return None
    pairs = torch.stack([c["counts"] for c in calls]).long().tolist()
    rows = torch.stack([c["rows"] for c in calls]).long().tolist()
    bounds = [roofline.pairs_scan_bound(p, n, c["dp"], c["row_dtype"], c["q_dtype"])
              for p, n, c in zip(pairs, rows, calls)]
    return share(bounds, (("grouped_scan_pairs",), ("tile_prefix",)), r)


def fused_roofline(r: dict) -> float | None:
    """The fused scan (``csrc/fused_scan.cu``, one launch a call) against
    the work its calls' live rows need."""
    bounds = [roofline.fused_scan_bound(c["nq"], int(c["rows"]), c["dp"], c["dtype"], c["block_rows"])
              for c in r["calls"].get("fused_scan", [])]
    return share(bounds, (("fused_scan_f32", "fused_scan_tensor"),), r)


def idle_pct(r: dict) -> float | None:
    t = r["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t.get("busy_s") else None
