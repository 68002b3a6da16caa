"""Mean ms a window's IVF ``search_begin`` takes to put its queries on
the device: ``ivf.queries`` spans (cosine normalisation, bf16 conversion,
padding, upload; ``utils/spans``, in ``engine/ivf.py``) over
``search_begin`` calls."""

from benchmark import readers


def read(r: dict) -> float | None:
    spans, ms = readers.hot(r, "ivf.queries")
    begins, _ = readers.hot(r, "ivf.IvfDeviceIndex.search_begin")
    return ms / begins if spans and begins else None
