"""The fused scan over the IVF delta: its share of its roofline over the
traced span, % (``benchmark/roofline.py``; kernel time from the device
trace)."""

from benchmark import readers


def read(r: dict) -> float | None:
    return readers.fused_roofline(r)
