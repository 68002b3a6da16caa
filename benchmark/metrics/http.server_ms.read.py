"""Mean server-side ms of an ANN request: the change in
``request_latency_seconds``'s sum over the change in its count (the
series ``/metrics`` serves)."""

from benchmark import readers


def read(r: dict) -> float | None:
    return readers.server_ms(r)
