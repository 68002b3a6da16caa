"""The IVF compact grouped scan's share of its roofline over the traced
span, % (``benchmark/roofline.py``; kernel time from the device trace):
here the int8 entry, int8 rows scanned by bf16 queries."""

from benchmark import readers


def read(r: dict) -> float | None:
    return readers.pairs_roofline(r)
