"""Share of the traced span's wall time the garbage collector ran in this
process, %: ``host.gc.gen0``-``gen2`` spans (``utils/spans``). It holds the
interpreter lock, so every thread waits. 0 where the program recorded
spans and no collection fell in the span."""

from benchmark import readers

GC = ("host.gc.gen0", "host.gc.gen1", "host.gc.gen2")


def read(r: dict) -> float | None:
    if not readers.hot(r, "http.parse")[0]:
        return None  # the program recorded no spans
    ms = sum(readers.hot(r, name)[1] for name in GC)
    return 100.0 * ms / 1e3 / readers.delta(r, "t")
