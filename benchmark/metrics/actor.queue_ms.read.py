"""Mean ms a request waits for its search window: ``actor.queue_wait``
spans, from submission (or requeue) to the window's start in the worker
thread, executor queue included (``utils/spans``, in
``service/vs_index.py``)."""

from benchmark import readers


def read(r: dict) -> float | None:
    n, ms = readers.hot(r, "actor.queue_wait")
    return ms / n if n else None
