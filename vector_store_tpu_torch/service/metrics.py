"""Prometheus metrics with the reference's exact names/labels/buckets
(metrics.rs:36-160). Hand-rolled registry (no prometheus_client in the
image): counters, gauges, histograms with label vectors and text exposition.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable

LATENCY_BUCKETS = [
    0.0001, 0.0002, 0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05,
    0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0,
]
LAG_BUCKETS = [0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0]


class _Child:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def set(self, value: float) -> None:
        self.value = value


class _HistChild:
    __slots__ = ("buckets", "counts", "total", "sum")

    def __init__(self, buckets: list[float]) -> None:
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.total += 1
        self.sum += value
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1

    def start_timer(self) -> "_Timer":
        return _Timer(self)


class _Timer:
    __slots__ = ("_hist", "_start")

    def __init__(self, hist: _HistChild) -> None:
        self._hist = hist
        self._start = time.monotonic()

    def observe_duration(self) -> float:
        dt = time.monotonic() - self._start
        self._hist.observe(dt)
        return dt


class _Vec:
    def __init__(self, name: str, help_: str, labels: tuple[str, ...], kind: str, buckets=None):
        self.name = name
        self.help = help_
        self.labels = labels
        self.kind = kind  # counter|gauge|histogram
        self.buckets = buckets
        self.children: dict[tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def with_labels(self, *values: str):
        key = tuple(values)
        with self._lock:
            child = self.children.get(key)
            if child is None:
                child = _HistChild(self.buckets) if self.kind == "histogram" else _Child()
                self.children[key] = child
            return child

    def remove(self, *values_prefix: str) -> None:
        """Drop all children whose label values start with the prefix (used
        when an index is deleted, metrics.rs:216-250)."""
        with self._lock:
            n = len(values_prefix)
            for key in [k for k in self.children if k[:n] == tuple(values_prefix)]:
                del self.children[key]

    def expose(self, out: list[str]) -> None:
        ptype = {"counter": "counter", "gauge": "gauge", "histogram": "histogram"}[self.kind]
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {ptype}")
        with self._lock:
            for key, child in sorted(self.children.items()):
                lbl = ",".join(
                    f'{name}="{_escape(v)}"' for name, v in zip(self.labels, key)
                )
                if self.kind == "histogram":
                    assert isinstance(child, _HistChild)
                    for b, c in zip(child.buckets, child.counts):
                        sep = "," if lbl else ""
                        out.append(
                            f'{self.name}_bucket{{{lbl}{sep}le="{_fmt(b)}"}} {c}'
                        )
                    sep = "," if lbl else ""
                    out.append(f'{self.name}_bucket{{{lbl}{sep}le="+Inf"}} {child.total}')
                    out.append(f"{self.name}_sum{{{lbl}}} {child.sum}")
                    out.append(f"{self.name}_count{{{lbl}}} {child.total}")
                else:
                    assert isinstance(child, _Child)
                    out.append(f"{self.name}{{{lbl}}} {_fmt(child.value)}")


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class Metrics:
    """The full metric surface of the reference (metrics.rs)."""

    def __init__(self) -> None:
        self.latency = _Vec(
            "request_latency_seconds",
            "Latency per index (seconds)",
            ("keyspace", "index_name"),
            "histogram",
            LATENCY_BUCKETS,
        )
        self.size = _Vec(
            "index_size",
            "Number of Vector per index",
            ("keyspace", "index_name"),
            "gauge",
        )
        self.modified = _Vec(
            "index_modified",
            "Number of modified items per index",
            ("keyspace", "index_name", "operation"),
            "counter",
        )
        self.indexing_lag = _Vec(
            "indexing_lag_seconds",
            "Time in seconds between a CDC-recorded change in ScyllaDB and its indexing in the vector store",
            ("keyspace", "index_name"),
            "histogram",
            LAG_BUCKETS,
        )
        self.cdc_reader_up = _Vec(
            "cdc_reader_up",
            "Whether the CDC reader for an index is currently running (1) or stopped (0)",
            ("keyspace", "index_name", "reader"),
            "gauge",
        )
        self.cdc_handler_errors_total = _Vec(
            "cdc_handler_errors_total",
            "Total number of CDC handler errors per index and reader",
            ("keyspace", "index_name", "reader"),
            "counter",
        )
        self.cdc_reader_restarts_total = _Vec(
            "cdc_reader_restarts_total",
            "Total number of CDC reader restart attempts after an error, per index and reader",
            ("keyspace", "index_name", "reader"),
            "counter",
        )
        self.cdc_last_processed_timestamp_seconds = _Vec(
            "cdc_last_processed_timestamp_seconds",
            "Unix timestamp (seconds) up to which the CDC log has been fully consumed. "
            "This is the reader's checkpoint position, not the wall-clock time of the last mutation.",
            ("keyspace", "index_name", "reader"),
            "gauge",
        )
        self.fts_index_size_bytes = _Vec(
            "fts_index_size_bytes",
            "Total size of a full-text search index (bytes)",
            ("keyspace", "index_name"),
            "gauge",
        )
        self.fts_segment_count = _Vec(
            "fts_segment_count",
            "Number of segments in a full-text search index",
            ("keyspace", "index_name"),
            "gauge",
        )
        self._all = [
            self.latency,
            self.size,
            self.modified,
            self.indexing_lag,
            self.cdc_reader_up,
            self.cdc_handler_errors_total,
            self.cdc_reader_restarts_total,
            self.cdc_last_processed_timestamp_seconds,
            self.fts_index_size_bytes,
            self.fts_segment_count,
        ]
        # scrape-time refresh hooks: index-size gauges are lazily refreshed
        # on scrape (metrics.rs:199-214)
        self._refreshers: list = []

    def add_refresher(self, fn) -> None:
        self._refreshers.append(fn)

    def remove_refresher(self, fn) -> None:
        if fn in self._refreshers:
            self._refreshers.remove(fn)

    def drop_index_labels(self, keyspace: str, index_name: str) -> None:
        for vec in self._all:
            vec.remove(keyspace, index_name)

    def expose_text(self) -> str:
        for fn in list(self._refreshers):
            try:
                fn()
            except Exception:  # refresher failure must not break /metrics
                pass
        out: list[str] = []
        for vec in self._all:
            vec.expose(out)
        return "\n".join(out) + "\n"

    def expose_protobuf(self) -> bytes:
        """Prometheus protobuf exposition: a stream of varint-length-
        delimited io.prometheus.client.MetricFamily messages
        (httproutes.rs:577-613 negotiates the same format). Hand-rolled
        encoder — the wire format is stable and tiny."""
        for fn in list(self._refreshers):
            try:
                fn()
            except Exception:
                pass
        out = bytearray()
        for vec in self._all:
            fam = _pb_metric_family(vec)
            out += _pb_varint(len(fam))
            out += fam
        return bytes(out)


# -- minimal protobuf wire encoding (io.prometheus.client) --------------------

_PB_TYPE = {"counter": 0, "gauge": 1, "histogram": 4}


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_tag(field: int, wire: int) -> bytes:
    return _pb_varint((field << 3) | wire)


def _pb_str(field: int, s: str) -> bytes:
    b = s.encode("utf-8")
    return _pb_tag(field, 2) + _pb_varint(len(b)) + b


def _pb_msg(field: int, payload: bytes) -> bytes:
    return _pb_tag(field, 2) + _pb_varint(len(payload)) + payload


def _pb_double(field: int, v: float) -> bytes:
    import struct

    return _pb_tag(field, 1) + struct.pack("<d", float(v))


def _pb_uint64(field: int, v: int) -> bytes:
    return _pb_tag(field, 0) + _pb_varint(int(v))


def _pb_enum(field: int, v: int) -> bytes:
    return _pb_tag(field, 0) + _pb_varint(v)


def _pb_metric_family(vec: "_Vec") -> bytes:
    body = _pb_str(1, vec.name) + _pb_str(2, vec.help)
    body += _pb_enum(3, _PB_TYPE[vec.kind])
    with vec._lock:
        children = sorted(vec.children.items())
    for key, child in children:
        metric = b""
        for name, value in zip(vec.labels, key):
            metric += _pb_msg(1, _pb_str(1, name) + _pb_str(2, value))
        if vec.kind == "gauge":
            metric += _pb_msg(2, _pb_double(1, child.value))
        elif vec.kind == "counter":
            metric += _pb_msg(3, _pb_double(1, child.value))
        else:  # histogram
            hist = _pb_uint64(1, child.total) + _pb_double(2, child.sum)
            for b, c in zip(child.buckets, child.counts):
                hist += _pb_msg(3, _pb_uint64(1, c) + _pb_double(2, b))
            hist += _pb_msg(3, _pb_uint64(1, child.total) + _pb_double(2, float("inf")))
            metric += _pb_msg(7, hist)
        body += _pb_msg(4, metric)
    return body
