"""Mean ms from the collect that answered a request to its task resuming
on the event loop: ``actor.wake`` spans (``utils/spans``, in
``service/vs_index.py``)."""

from benchmark import readers


def read(r: dict) -> float | None:
    n, ms = readers.hot(r, "actor.wake")
    return ms / n if n else None
