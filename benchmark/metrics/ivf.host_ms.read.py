"""Host ms of one IVF search: hotpath totals of
``IvfDeviceIndex.search_begin`` and ``search_collect`` over the searches
begun."""

from benchmark import readers


def read(r: dict) -> float | None:
    n, begin_ms = readers.hot(r, "ivf.IvfDeviceIndex.search_begin")
    _, collect_ms = readers.hot(r, "ivf.IvfDeviceIndex.search_collect")
    return (begin_ms + collect_ms) / n if n else None
