"""The traced run's readings: counters, host spans and a device trace over
a few seconds in the middle of the window.

What the program already counts is read around the traced span: the
HTTP route's ``request_latency_seconds`` (what ``/metrics`` serves),
``utils/hotpath`` host times (switched on for the traced run only), the
IVF engine's ``dropped_pair_queries``. The benchmark's own wrappers, set
for the span only, add what the program does not keep:

- on the op attributes the engine calls through
  (``vector_store_tpu_torch.ops.ivf.grouped_scan_pairs`` and
  ``ops.fused_scan.fused_scan``), the inputs of every scan call, for the
  rooflines: shapes, the pairs of each cluster, and the live rows (those
  whose ``b`` is below the program's ``INVALID_CUTOFF``) of each cluster
  or of the delta, counted on the device once for each state of ``b``;
- on the engine's ``search_begin``, the queries each search holds;
- host spans (start and end on the host clock) around the actor's and
  the engine's steps, so the trace says what the host did while the card
  was idle. They run in the actor's executor threads, which the
  profiler's CPU view does not follow; a ``cudaDeviceSynchronize`` at the
  span's start puts the host clock on the trace's.

``torch.profiler`` records this process's CUDA activity; its Chrome trace
is read once the span has closed.
"""

from __future__ import annotations

import asyncio
import functools
import json
import os
import sys
import tempfile
import time
from collections import Counter, defaultdict

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = {
    "actor": ("_begin_window", "_collect_batches", "_apply_ops_batch"),
    "engine": ("search_begin", "search_collect", "maintain"),
}
DRAIN_S = 0.2  # between the last recorded call and the profiler's stop


class Tracer:
    def __init__(self, service, actor, metadata, seconds: float) -> None:
        self.service, self.actor, self.engine = service, actor, actor.engine
        self.engine_device = service.device
        self.labels = (metadata.keyspace_name, metadata.index_name)
        self.seconds = seconds
        self.calls: dict[str, list] = defaultdict(list)
        self.queries = 0
        self.spans: list[tuple[str, int, int]] = []  # (name, start ns, end ns), host clock
        self.recording = False
        self.before: dict = {}
        self.after: dict = {}
        self.trace: dict = {}

    # -- counters -------------------------------------------------------------
    def snapshot(self) -> dict:
        from vector_store_tpu_torch.utils import hotpath

        hist = self.service.metrics.latency.with_labels(*self.labels)
        return {
            "http_sum_s": hist.sum, "http_count": hist.total, "hotpath": hotpath.stats(),
            "dropped_pair_queries": getattr(self.engine, "dropped_pair_queries", None),
            "queries": self.queries, "t": time.perf_counter(),
        }

    # -- wrappers -------------------------------------------------------------
    def _record(self, name: str, fn, summary):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if self.recording:
                self.calls[name].append(summary(*args, **kwargs))
            return fn(*args, **kwargs)

        return wrapper

    def _spanned(self, name: str, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                if self.recording:
                    self.spans.append((name, t, time.perf_counter_ns()))

        return wrapper

    def _install(self) -> list:
        from vector_store_tpu_torch.ops import fused_scan as fs
        from vector_store_tpu_torch.ops import ivf

        live: dict = {}

        def live_rows(b: torch.Tensor, groups: int) -> torch.Tensor:
            """Live rows of each of ``groups`` equal parts of ``b``, on the
            device; counted again only once ``b`` has changed."""
            key = (b.data_ptr(), b._version, b.shape[0], groups)
            if key not in live:
                live[key] = (b.view(groups, -1) < fs.INVALID_CUTOFF).sum(1)
            return live[key]

        def pairs_inputs(queries, vectors, a, b, starts, counts, *, cmax):
            return {"counts": counts, "rows": live_rows(b, vectors.shape[0] // cmax), "dp": vectors.shape[1],
                    "row_dtype": _name(vectors.dtype), "q_dtype": _name(queries.dtype)}

        def fused_inputs(queries, vectors, a, b, block_rows):
            return {"nq": queries.shape[0], "rows": live_rows(b, 1), "dp": vectors.shape[1],
                    "dtype": _name(queries.dtype), "block_rows": block_rows}

        saved = [(ivf, "grouped_scan_pairs", ivf.grouped_scan_pairs),
                 (fs, "fused_scan", fs.fused_scan)]
        ivf.grouped_scan_pairs = self._record("grouped_scan_pairs", ivf.grouped_scan_pairs, pairs_inputs)
        fs.fused_scan = self._record("fused_scan", fs.fused_scan, fused_inputs)

        begin = self.engine.search_begin

        @functools.wraps(begin)
        def counted_begin(queries, *args, **kwargs):
            if self.recording:
                self.queries += int(np.atleast_2d(queries).shape[0])
            return begin(queries, *args, **kwargs)

        saved.append((self.engine, "search_begin", None))
        self.engine.search_begin = counted_begin
        for owner_name, methods in HOST_SPANS.items():
            owner = getattr(self, owner_name)
            for m in methods:
                if hasattr(owner, m):
                    saved.append((owner, m, owner.__dict__.get(m)))
                    setattr(owner, m, self._spanned(f"{owner_name}.{m}", getattr(owner, m)))
        return saved

    @staticmethod
    def _restore(saved: list) -> None:
        for owner, name, value in reversed(saved):
            if value is None:
                owner.__dict__.pop(name, None)  # an instance wrapper over the class's method
            else:
                setattr(owner, name, value)

    @staticmethod
    def profiler() -> torch.profiler.profile:
        return torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])

    def warm(self) -> None:
        """Start and stop a profiler once: its first start initialises the
        tracer (seconds), which the span must not wait for."""
        with self.profiler():
            torch.zeros(1, device=self.engine_device).add_(1)

    # -- the span ---------------------------------------------------------------
    async def window(self, t0: float, seconds: float) -> None:
        """Trace ``self.seconds`` in the middle of the window that starts at
        ``t0`` (monotonic) and lasts ``seconds``."""
        from vector_store_tpu_torch.utils import hotpath

        span = min(self.seconds, seconds)
        await asyncio.sleep(max(0.0, t0 + (seconds - span) / 2 - time.monotonic()))
        saved = self._install()
        hotpath.enable()
        prof = self.profiler()
        prof.start()
        sync = self.clock_mark()
        self.before = self.snapshot()
        self.recording = True
        await asyncio.sleep(span)
        self.recording = False
        self.after = self.snapshot()
        await asyncio.sleep(DRAIN_S)
        prof.stop()
        hotpath.disable()
        self._restore(saved)
        with tempfile.TemporaryDirectory(prefix="bench-trace-") as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self.trace = summarize(events, self.after["t"] - self.before["t"] + DRAIN_S, self.spans, sync)

    def clock_mark(self) -> int | None:
        """The host clock (ns) at the middle of a ``cudaDeviceSynchronize``,
        the first the trace holds."""
        if self.engine_device.type != "cuda":
            return None
        t = time.perf_counter_ns()
        torch.cuda.synchronize(self.engine_device)
        return (t + time.perf_counter_ns()) // 2

    def readings(self) -> dict:
        """What the per-layer readers read (``benchmark/metrics/``)."""
        return {"before": self.before, "after": self.after, "calls": dict(self.calls), "trace": self.trace}


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def union_seconds(iv: np.ndarray) -> float:
    """Seconds covered by intervals iv [n, 2] (microseconds)."""
    if not iv.size:
        return 0.0
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    starts_new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    seg_start = iv[starts_new, 0]
    seg_end = np.concatenate([ends[np.flatnonzero(starts_new)[1:] - 1], [ends[-1]]])
    return float((seg_end - seg_start).sum() / 1e6)


def summarize(events: list[dict], window_s: float, spans: list[tuple[str, int, int]] = (),
              sync_ns: int | None = None) -> dict:
    """Device busy seconds, kernel seconds by name, and the device's idle
    gaps by what the host was doing at the gap's middle: the innermost
    host span there, if the host clock could be put on the trace's."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    iv = np.asarray([(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in dev], dtype=np.float64).reshape(-1, 2)
    by_name: Counter = Counter()
    count: Counter = Counter()
    for e in dev:
        by_name[e["name"]] += e.get("dur", 0.0) / 1e6
        count[e["name"]] += 1
    out = {"busy_s": union_seconds(iv), "window_s": window_s, "device_ops": by_name, "device_counts": count,
           "idle_gaps": Counter()}
    if len(iv) < 2:
        return out
    marks = [e for e in events if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaDeviceSynchronize"]
    offset = None  # trace us = host ns / 1000 + offset
    if sync_ns is not None and marks:
        m = min(marks, key=lambda e: e["ts"])
        offset = m["ts"] + m.get("dur", 0.0) / 2 - sync_ns / 1e3
    print(f"[trace] {len(dev)} device operations, {len(spans)} host spans, host clock "
          f"{'placed' if offset is not None else 'not placed'} on the trace's", file=sys.stderr, flush=True)
    # spans as [start, end] us on the trace's clock, longest first so that
    # the innermost one labels a point
    sp = sorted(((n, a / 1e3 + offset, b / 1e3 + offset) for n, a, b in spans), key=lambda x: x[1] - x[2]) \
        if offset is not None else []
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    starts = iv[1:, 0]
    gap = starts > ends[:-1]
    g0, g1 = ends[:-1][gap], starts[gap]
    mid = (g0 + g1) / 2
    label = np.full(mid.size, -1)
    names = [n for n, _, _ in sp]
    for i, (_, a, b) in enumerate(sp):
        label[(mid >= a) & (mid <= b)] = i
    idle: Counter = Counter()
    for lab, dur in zip(label.tolist(), ((g1 - g0) / 1e6).tolist()):
        idle[names[lab] if lab >= 0 else "host outside the actor's and the engine's steps (HTTP, JSON, asyncio)"] += dur
    out["idle_gaps"] = idle
    return out


def breakdown(trace: dict) -> dict:
    """The result line's ``breakdown``: at most ten device operations by
    time, and ten host activities by the device idle time they spanned."""
    return {"device_ops": [[n, s] for n, s in Counter(trace["device_ops"]).most_common(10)],
            "idle_gaps": [[n, s] for n, s in Counter(trace["idle_gaps"]).most_common(10)]}
