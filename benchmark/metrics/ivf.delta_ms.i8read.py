"""Mean ms a window's IVF ``search_begin`` spends launching the delta
region's search: ``ivf.delta_begin`` spans (for I8 the lossy scan and its
bf16 rescore tier; ``utils/spans``, in ``engine/ivf.py``) over
``search_begin`` calls."""

from benchmark import readers


def read(r: dict) -> float | None:
    spans, ms = readers.hot(r, "ivf.delta_begin")
    begins, _ = readers.hot(r, "ivf.IvfDeviceIndex.search_begin")
    return ms / begins if spans and begins else None
