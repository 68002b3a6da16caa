"""Mean host microseconds of an ANN request's ``http.encode`` span: the
primary keys, distances and scores and the answer's JSON (``utils/spans``,
in ``http/routes.py``)."""

from benchmark import readers


def read(r: dict) -> float | None:
    n, ms = readers.hot(r, "http.encode")
    return ms * 1e3 / n if n else None
