"""Share of the IVF engine's searched queries re-dispatched after their
(query, cluster) pairs dropped: ``dropped_pair_queries`` over the
queries ``search_begin`` was given, %."""

from benchmark import readers


def read(r: dict) -> float | None:
    queries = readers.delta(r, "queries")
    if not queries or r["after"]["dropped_pair_queries"] is None:
        return None
    return 100.0 * readers.delta(r, "dropped_pair_queries") / queries
