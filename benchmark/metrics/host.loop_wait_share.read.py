"""Share of the traced span's wall time the serving event loop waited on
its sockets, %: ``loop.select`` spans (``utils/spans``). Near 0 means the
one loop thread is saturated."""

from benchmark import readers


def read(r: dict) -> float | None:
    n, ms = readers.hot(r, "loop.select")
    return 100.0 * ms / 1e3 / readers.delta(r, "t") if n else None
