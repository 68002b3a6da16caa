"""Host ms the actor spends per search window: hotpath totals of
``_begin_window`` and ``_collect_batches`` over the windows begun."""

from benchmark import readers


def read(r: dict) -> float | None:
    windows, begin_ms = readers.hot(r, "vs_index.VsIndexActor._begin_window")
    _, collect_ms = readers.hot(r, "vs_index.VsIndexActor._collect_batches")
    return (begin_ms + collect_ms) / windows if windows else None
