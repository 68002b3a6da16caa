"""The ``openai500k-i8-read`` cell's span readers on synthetic readings,
and on a program that records none of their spans (an older one),
where each gives None and the harness leaves the metric out."""

from __future__ import annotations

import pytest

from benchmark import spec
from benchmark.tests.test_bench_spans import readings

SPANS = {
    "ivf.queries": (40, 20.0), "ivf.delta_begin": (40, 2800.0), "ivf.rescore": (40, 120.0),
    "ivf.IvfDeviceIndex.search_begin": (40, 3000.0),
}


def with_http(r: dict, answered: int) -> dict:
    r["before"]["http_count"], r["after"]["http_count"] = 1000, 1000 + answered
    return r


@pytest.mark.parametrize("name, want", [
    ("ivf.queries_ms.i8read", 0.5), ("ivf.delta_ms.i8read", 70.0), ("ivf.rescore_us.i8read", 12.0),
])
def test_reader_on_synthetic_spans(name, want):
    assert spec.reader(name)(with_http(readings(SPANS), 10_000)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["ivf.queries_ms.i8read", "ivf.delta_ms.i8read", "ivf.rescore_us.i8read"])
def test_reader_without_the_spans(name):
    r = with_http(readings({"ivf.IvfDeviceIndex.search_begin": (40, 3000.0)}), 10_000)
    assert spec.reader(name)(r) is None
