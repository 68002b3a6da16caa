"""Requests answered per search window of the actor: the HTTP route's
answered requests over ``VsIndexActor._begin_window`` calls (hotpath)."""

from benchmark import readers


def read(r: dict) -> float | None:
    windows, _ = readers.hot(r, "vs_index.VsIndexActor._begin_window")
    return readers.delta(r, "http_count") / windows if windows else None
