"""Mean host microseconds of exact f32 rescoring an answered request:
``ivf.rescore`` spans (``ids_postprocess`` over the oversampled
candidates; ``utils/spans``, in ``engine/ivf.py``) over the ANN requests
the HTTP route answered."""

from benchmark import readers


def read(r: dict) -> float | None:
    spans, ms = readers.hot(r, "ivf.rescore")
    n = readers.delta(r, "http_count")
    return ms * 1e3 / n if spans and n > 0 else None
