"""The per-layer metrics that read the program's spans (``utils/spans``
through hotpath's registry): each reader on synthetic readings and on a
program that records no spans; the spans on the clock the trace places;
and a traced run on the CPU, where the harness's ``hotpath.enable()``
alone turns the program's spans on."""

from __future__ import annotations

import asyncio
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import cell as cell_mod
from benchmark import spec, tracing
from benchmark.tests.test_bench_control import tiny

SPAN_METRICS = ("http.parse_us.read", "http.encode_us.read", "actor.queue_ms.read", "actor.wake_ms.read",
                "host.gc_share.read", "host.loop_wait_share.read", "ivf.pull_ms.read")


def readings(after: dict, wall_s: float = 5.0) -> dict:
    """Readings whose span added ``after`` (name -> (calls, total ms)) to
    what hotpath held before it."""
    before = {"vs_index.VsIndexActor._begin_window": {"calls": 7, "total_ms": 3.0}}
    hot = dict(before)
    for name, (calls, ms) in after.items():
        b = before.get(name, {"calls": 0, "total_ms": 0.0})
        hot[name] = {"calls": b["calls"] + calls, "total_ms": b["total_ms"] + ms}
    return {"before": {"hotpath": before, "t": 100.0}, "after": {"hotpath": hot, "t": 100.0 + wall_s}}


SPANS = {
    "http.parse": (400, 30.0), "http.encode": (400, 50.0), "actor.queue_wait": (410, 820.0),
    "actor.wake": (400, 1200.0), "host.gc.gen0": (20, 40.0), "host.gc.gen1": (2, 10.0),
    "loop.select": (90, 750.0), "ivf.pull": (5, 4.0), "ivf.IvfDeviceIndex.search_collect": (4, 9.0),
}


@pytest.mark.parametrize("name, want", [
    ("http.parse_us.read", 75.0), ("http.encode_us.read", 125.0), ("actor.queue_ms.read", 2.0),
    ("actor.wake_ms.read", 3.0), ("host.gc_share.read", 1.0), ("host.loop_wait_share.read", 15.0),
    ("ivf.pull_ms.read", 1.0),
])
def test_reader_on_synthetic_spans(name, want):
    assert spec.reader(name)(readings(SPANS)) == pytest.approx(want)


def test_readers_without_program_spans():
    """The parent's program records no spans: every reader gives None,
    and the harness leaves the metric out."""
    r = readings({"ivf.IvfDeviceIndex.search_collect": (4, 9.0)})
    for name in SPAN_METRICS:
        assert spec.reader(name)(r) is None, name


def test_gc_share_reads_zero_without_a_collection():
    r = readings({k: v for k, v in SPANS.items() if not k.startswith("host.gc")})
    assert spec.reader("host.gc_share.read")(r) == 0.0


def test_program_spans_share_the_benchmarks_clock():
    """The program's span stamps taken inside a call that the benchmark's
    span wraps lie inside it: both read ``time.perf_counter_ns()``, the
    clock ``Tracer.clock_mark`` places on the trace."""
    from vector_store_tpu_torch.utils import hotpath, spans

    engine = SimpleNamespace()
    tracer = tracing.Tracer(SimpleNamespace(device=torch.device("cpu")), SimpleNamespace(engine=engine),
                            SimpleNamespace(keyspace_name="ks", index_name="idx"), 1.0)
    stamps = []

    def collect():
        stamps.append(spans.now())
        with spans.span("ivf.pull"):
            time.sleep(0.002)
        stamps.append(spans.now())

    wrapped = tracer._spanned("engine.search_collect", collect)
    before = hotpath.stats().get("ivf.pull", {"calls": 0, "total_ms": 0.0})
    hotpath.enable()
    tracer.recording = True
    try:
        wrapped()
    finally:
        tracer.recording = False
        hotpath.disable()
    after = hotpath.stats()["ivf.pull"]
    ((_, a, b),) = tracer.spans
    assert a <= stamps[0] < stamps[1] <= b
    pull_ms = after["total_ms"] - before["total_ms"]
    assert after["calls"] - before["calls"] == 1 and 2 <= pull_ms <= (stamps[1] - stamps[0]) / 1e6


def test_traced_run_reads_every_span_metric():
    c = tiny()
    c.traffic["trace_seconds"] = 1.0
    bench = spec.load()
    c.per_layer = spec.metrics_of(bench, "sift1m-f32-read", "per_layer")
    res = asyncio.run(cell_mod.run(c, 2**31 + 77, 3.0, True, torch.device("cpu"), time.perf_counter()))
    assert res["correct"]
    for name in SPAN_METRICS:
        value = spec.reader(name)(res["traced"])
        assert value is not None and value >= 0, name
