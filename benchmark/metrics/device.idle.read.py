"""Share of the traced span in which no operation ran on the device, %
(``torch.profiler``'s device activity)."""

from benchmark import readers


def read(r: dict) -> float | None:
    return readers.idle_pct(r)
