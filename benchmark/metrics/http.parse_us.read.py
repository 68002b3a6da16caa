"""Mean host microseconds of an ANN request's ``http.parse`` span: the
body's JSON and the vector and limit checks (``utils/spans``, in
``http/routes.py``)."""

from benchmark import readers


def read(r: dict) -> float | None:
    n, ms = readers.hot(r, "http.parse")
    return ms * 1e3 / n if n else None
