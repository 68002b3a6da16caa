"""Route handlers (parity with reference httproutes.rs route table
:172-185 and handlers).

The answers that need the owner's state (index list and status, ANN,
BM25, info) are computed by ``*_answer`` functions that return
``(status, body)``: the routes here and the owner's IPC server
(service/ipc.py, which serves the frontend processes of ``serve_scaled``)
both answer through them, so a request gets the same answer either way.
A body is the JSON data of a 200, the message of an error, or the reason
object of a 503."""

from __future__ import annotations

import asyncio
import json
import logging
import math

from aiohttp import web

import vector_store_tpu_torch
from vector_store_tpu_torch.core.distance import similarity_score, saturate_f32
from vector_store_tpu_torch.core.filters import Restriction, RestrictionKind
from vector_store_tpu_torch.core.types import IndexKey, Limit
from vector_store_tpu_torch.service.indexes import BestIndexKind, Indexes
from vector_store_tpu_torch.service.node_state import (
    NodeState,
    NodeStatus,
    index_status_http,
    node_status_http,
)
from vector_store_tpu_torch.service.vs_index import DimensionMismatch

logger = logging.getLogger(__name__)


class AppState:
    def __init__(
        self,
        indexes: Indexes,
        node_state: NodeState,
        metrics,
        internals,
        engine=None,
        engine_version: str = "vector-store-tpu",
        use_tls: bool = False,
    ) -> None:
        self.indexes = indexes
        self.node_state = node_state
        self.metrics = metrics
        self.internals = internals
        self.engine = engine
        self.engine_version = engine_version
        self.use_tls = use_tls


def _state(request: web.Request) -> AppState:
    return request.app["state"]


def _json(data, status=200) -> web.Response:
    return web.json_response(data, status=status)


def _err(status: int, msg: str) -> web.Response:
    return web.Response(status=status, text=msg, content_type="application/json")


def _answer(status: int, body) -> web.Response:
    """The response of an ``*_answer`` function's (status, body)."""
    if status == 200 or status == 503:
        return _json(body, status=status)
    return _err(status, body)


# ---------------------------------------------------------------------------
# GET /api/v1/indexes
# ---------------------------------------------------------------------------


async def get_indexes(request: web.Request) -> web.Response:
    return _json(indexes_answer(_state(request)))


def indexes_answer(st: AppState) -> list[dict]:
    out = []
    for key, entry in st.indexes.vs_entries.items():
        vs = entry.metadata.vs_options
        out.append(
            {
                "keyspace": key.keyspace,
                "index": key.index,
                "options": {
                    "type": "vector",
                    "dimensions": int(vs.dimensions),
                    "maximum_node_connections": int(vs.connectivity),
                    "construction_beam_width": int(vs.expansion_add),
                    "search_beam_width": int(vs.expansion_search),
                    "similarity_function": _similarity_name(vs.space_type),
                    "quantization": vs.quantization.value,
                },
            }
        )
    for key, entry in st.indexes.fts_entries.items():
        out.append(
            {
                "keyspace": key.keyspace,
                "index": key.index,
                "options": {
                    "type": "fulltext",
                    "analyzer": "standard",
                    "positions": False,
                },
            }
        )
    return out


def _similarity_name(space_type) -> str:
    from vector_store_tpu_torch.core.types import SpaceType

    return {
        SpaceType.EUCLIDEAN: "EUCLIDEAN",
        SpaceType.COSINE: "COSINE",
        SpaceType.DOT_PRODUCT: "DOT_PRODUCT",
        SpaceType.HAMMING: "HAMMING",
    }[space_type]


# ---------------------------------------------------------------------------
# GET /api/v1/indexes/{keyspace}/{index}/status
# ---------------------------------------------------------------------------


async def get_index_status(request: web.Request) -> web.Response:
    return _answer(
        *await index_status_answer(
            _state(request), request.match_info["keyspace"], request.match_info["index"]
        )
    )


async def index_status_answer(st: AppState, keyspace: str, index: str) -> tuple[int, object]:
    key = IndexKey(keyspace, index)
    entry = st.indexes.get_vs(key) or st.indexes.get_fts(key)
    if entry is None:
        return 404, f"missing index: {keyspace}.{index}"
    try:
        count = await entry.actor.count()
    except Exception as e:
        return 500, f"index.count request error: {e}"
    return 200, {
        "status": index_status_http(entry.status),
        "count": count,
        "build_progress": entry.progress.percentage,
    }


# ---------------------------------------------------------------------------
# GET /api/v1/indexes/{keyspace}/{index}  (info)
# ---------------------------------------------------------------------------


async def get_index_info(request: web.Request) -> web.Response:
    st = _state(request)
    keyspace = request.match_info["keyspace"]
    index = request.match_info["index"]
    key = IndexKey(keyspace, index)
    entry = st.indexes.get_vs(key)
    if entry is not None:
        vs = entry.metadata.vs_options
        return _json(
            {
                "keyspace": keyspace,
                "index": index,
                "options": {
                    "type": "vector",
                    "dimensions": int(vs.dimensions),
                    "maximum_node_connections": int(vs.connectivity),
                    "construction_beam_width": int(vs.expansion_add),
                    "search_beam_width": int(vs.expansion_search),
                    "similarity_function": _similarity_name(vs.space_type),
                    "quantization": vs.quantization.value,
                },
            }
        )
    fentry = st.indexes.get_fts(key)
    if fentry is not None:
        return _json(
            {
                "keyspace": keyspace,
                "index": index,
                "options": {"type": "fulltext", "analyzer": "standard", "positions": False},
            }
        )
    return _err(404, f"missing index: {keyspace}.{index}")


# ---------------------------------------------------------------------------
# POST /api/v1/indexes/{keyspace}/{index}/ann
# ---------------------------------------------------------------------------

_RESTRICTION_TAGS = {k.value: k for k in RestrictionKind}


def parse_filter(
    data: dict,
) -> tuple[list[Restriction], bool]:
    """JSON filter -> typed restrictions (httproutes.rs:1056-1216)."""
    restrictions = []
    for r in data.get("restrictions", []):
        tag = r.get("type")
        kind = _RESTRICTION_TAGS.get(tag)
        if kind is None:
            raise ValueError(f"unknown restriction type: {tag}")
        lhs = r.get("lhs")
        rhs = r.get("rhs")
        if kind.is_tuple:
            if not isinstance(lhs, list):
                raise ValueError(f"{tag} requires a list of columns")
            if kind is RestrictionKind.IN_TUPLE:
                rhs_t = tuple(tuple(_from_json(v) for v in row) for row in rhs)
            else:
                rhs_t = tuple(_from_json(v) for v in rhs)
            restrictions.append(Restriction(kind, tuple(lhs), rhs_t))
        else:
            if not isinstance(lhs, str):
                raise ValueError(f"{tag} requires a single column name")
            if kind is RestrictionKind.IN:
                rhs_v = tuple(_from_json(v) for v in rhs)
            else:
                rhs_v = _from_json(rhs)
            restrictions.append(Restriction(kind, (lhs,), rhs_v))
    return restrictions, bool(data.get("allow_filtering", False))


def _from_json(v):
    # JSON -> comparable value; nested lists become tuples
    if isinstance(v, list):
        return tuple(_from_json(x) for x in v)
    return v


_INT_TYPES = {"tinyint", "smallint", "int", "bigint", "counter", "varint"}
_FLOAT_TYPES = {"float", "double"}
_TEXT_TYPES = {"text", "ascii", "varchar"}


def _coerce_typed(value, cql_type: str, column: str):
    """JSON value -> python value for a known CQL column type; raises
    ValueError on type mismatch (reference try_from_json, ~18 native
    types)."""
    import datetime
    import uuid as _uuid
    from decimal import Decimal, InvalidOperation

    t = cql_type.lower()
    if t in _INT_TYPES:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"column {column} expects {cql_type}, got {value!r}")
        return value
    if t in _FLOAT_TYPES:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"column {column} expects {cql_type}, got {value!r}")
        return float(value)
    if t in _TEXT_TYPES:
        if not isinstance(value, str):
            raise ValueError(f"column {column} expects {cql_type}, got {value!r}")
        return value
    if t == "boolean":
        if not isinstance(value, bool):
            raise ValueError(f"column {column} expects boolean, got {value!r}")
        return value
    if t in ("uuid", "timeuuid"):
        if not isinstance(value, str):
            raise ValueError(f"column {column} expects {cql_type}, got {value!r}")
        try:
            return _uuid.UUID(value)
        except ValueError:
            raise ValueError(f"column {column}: invalid uuid {value!r}") from None
    if t == "decimal":
        try:
            return Decimal(str(value))
        except InvalidOperation:
            raise ValueError(f"column {column}: invalid decimal {value!r}") from None
    if t == "timestamp":
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return datetime.datetime.fromtimestamp(
                value / 1e3, tz=datetime.timezone.utc
            )
        if isinstance(value, str):
            try:
                return datetime.datetime.fromisoformat(value)
            except ValueError:
                raise ValueError(
                    f"column {column}: invalid timestamp {value!r}"
                ) from None
        raise ValueError(f"column {column} expects timestamp, got {value!r}")
    if t == "blob":
        if isinstance(value, str):
            try:
                return bytes.fromhex(value)
            except ValueError:
                raise ValueError(f"column {column}: invalid blob hex") from None
        raise ValueError(f"column {column} expects blob hex string")
    # unknown/unhandled type: pass through untyped
    return value


def coerce_restrictions(
    restrictions: list[Restriction], table_columns: dict
) -> list[Restriction]:
    """Convert restriction values using the base table's column types;
    unknown columns pass through untyped (the table-side comparison treats
    incomparable values as non-matches)."""
    if not table_columns:
        return restrictions
    out = []
    for r in restrictions:
        def conv(col, v):
            t = table_columns.get(col)
            return _coerce_typed(v, t, col) if t else v

        if r.kind.is_tuple:
            if r.kind is RestrictionKind.IN_TUPLE:
                rhs = tuple(
                    tuple(conv(c, v) for c, v in zip(r.lhs, row)) for row in r.rhs  # type: ignore[union-attr]
                )
            else:
                rhs = tuple(conv(c, v) for c, v in zip(r.lhs, r.rhs))  # type: ignore[arg-type]
        elif r.kind is RestrictionKind.IN:
            rhs = tuple(conv(r.lhs[0], v) for v in r.rhs)  # type: ignore[union-attr]
        else:
            rhs = conv(r.lhs[0], r.rhs)
        out.append(Restriction(r.kind, r.lhs, rhs))
    return out


def restriction_columns(restrictions: list[Restriction]) -> tuple[list[str], list[str]]:
    equality: list[str] = []
    range_: list[str] = []
    for r in restrictions:
        if r.kind in (
            RestrictionKind.EQ,
            RestrictionKind.IN,
            RestrictionKind.EQ_TUPLE,
            RestrictionKind.IN_TUPLE,
        ):
            equality.extend(r.lhs)
        else:
            range_.extend(r.lhs)
    return equality, range_


def key_values(pk_columns: tuple[str, ...], keys: list) -> list[tuple]:
    """Each primary key's values; ValueError for a key whose arity is not
    the columns'."""
    out = []
    for pk in keys:
        values = pk.values()
        if len(values) != len(pk_columns):
            raise ValueError(
                f"primary key arity {len(values)} != columns {len(pk_columns)}"
            )
        out.append(values)
    return out


def collect_primary_keys(
    pk_columns: tuple[str, ...], keys: list
) -> dict[str, list]:
    """Columnar primary-key response (httproutes.rs:1237-1269)."""
    out: dict[str, list] = {c: [] for c in pk_columns}
    for values in key_values(pk_columns, keys):
        for c, v in zip(pk_columns, values):
            out[c].append(_to_json(v))
    return out


def _to_json(v):
    import datetime
    import decimal
    import uuid as _uuid

    if isinstance(v, float):
        return saturate_f32(v)
    if isinstance(v, (_uuid.UUID,)):
        return str(v)
    if isinstance(v, decimal.Decimal):
        return str(v)
    if isinstance(v, bytes):
        return v.hex()
    if isinstance(v, datetime.datetime):
        return v.isoformat()
    if isinstance(v, (datetime.date, datetime.time)):
        return v.isoformat()
    if isinstance(v, tuple):
        return [_to_json(x) for x in v]
    import numpy as _np

    if isinstance(v, _np.ndarray):
        return [_to_json(x) for x in v.tolist()]
    if isinstance(v, _np.generic):
        return _to_json(v.item())
    return v


def check_insecure_tls(st: AppState, request: web.Request) -> web.Response | None:
    """Reject plain-HTTP requests when TLS is configured
    (httproutes.rs:1218-1235)."""
    if st.use_tls and request.scheme != "https":
        return _err(
            403, "TLS is enabled: this endpoint must be accessed over HTTPS"
        )
    return None


async def post_index_ann(request: web.Request) -> web.Response:
    st = _state(request)
    keyspace = request.match_info["keyspace"]
    index_name = request.match_info["index"]
    denied = check_insecure_tls(st, request)
    if denied is not None:
        return denied
    try:
        body = await request.json()
    except Exception:
        return _err(400, "malformed JSON body")
    vector = body.get("vector")
    if not isinstance(vector, list) or not all(
        isinstance(x, (int, float)) and not isinstance(x, bool) for x in vector
    ):
        return _err(400, "missing or malformed 'vector'")
    limit = body.get("limit", 1)
    try:
        limit = int(Limit(int(limit)))
    except (ValueError, TypeError):
        return _err(400, "invalid 'limit'")

    status, answer = await ann_answer(st, keyspace, index_name, vector, limit, body.get("filter"))
    if status != 200:
        return _answer(status, answer)
    pk_columns, result = answer
    try:
        primary_keys = collect_primary_keys(pk_columns, [pk for pk, _ in result])
    except ValueError as e:
        return _err(500, str(e))
    distances = [d for _, d in result]
    return _json(
        {
            "primary_keys": primary_keys,
            "distances": [saturate_f32(d.value) for d in distances],
            "similarity_scores": [saturate_f32(similarity_score(d)) for d in distances],
        }
    )


def unservable_answer(st: AppState, keyspace: str, index_name: str, best) -> tuple[int, object] | None:
    """The answer for an index that cannot take an ANN query (missing,
    local-only, not serving yet), or None."""
    if best.kind is BestIndexKind.NOT_FOUND:
        return 404, f"missing index: {keyspace}.{index_name}"
    if best.kind is BestIndexKind.NO_GLOBAL_INDEX:
        return 400, (
            f"Global ANN query is not supported when only a local "
            f"vector index is available for {keyspace}.{index_name}"
        )
    if best.kind is BestIndexKind.NOT_SERVING:
        progress = best.progress.percentage if best.progress else 0.0
        if st.node_state.get_status() is NodeStatus.SERVING:
            return 503, {
                "reason": "INDEX_BUILDING",
                "message": (
                    f"Index {keyspace}.{index_name} is not available yet as it "
                    f"is still being constructed, progress: {progress:.3f}%"
                ),
            }
        return 503, {"reason": "NODE_BOOTSTRAPPING"}
    return None


async def ann_answer(
    st: AppState, keyspace: str, index_name: str, vector, limit: int, filter_data
) -> tuple[int, object]:
    """One ANN query of a validated vector and limit; a 200's body is
    (primary key columns, [(PrimaryKey, Distance)])."""
    timer = st.metrics.latency.with_labels(keyspace, index_name).start_timer()
    try:
        return await _ann(st, keyspace, index_name, vector, limit, filter_data)
    finally:
        timer.observe_duration()


async def _ann(st, keyspace, index_name, vector, limit, filter_data) -> tuple[int, object]:
    try:
        restrictions, allow_filtering = (
            parse_filter(filter_data) if filter_data else ([], False)
        )
    except ValueError as e:
        return 400, str(e)

    equality, range_ = restriction_columns(restrictions)
    best = st.indexes.best_index(IndexKey(keyspace, index_name), equality, range_)
    unservable = unservable_answer(st, keyspace, index_name, best)
    if unservable is not None:
        return unservable
    if best.needs_filtering > 0 and not allow_filtering:
        return 400, f"Index {keyspace}.{index_name} requires ALLOW FILTERING for this query"

    # routing observability (reference's slow-test-hooks counter)
    st.internals.increment(
        f"ann-served-request--{best.key.keyspace}--{best.key.index}"
    )
    entry = best.entry
    if restrictions:
        try:
            restrictions = coerce_restrictions(
                restrictions, getattr(entry, "table_columns", {})
            )
        except ValueError as e:
            return 400, str(e)
    try:
        if restrictions:
            result = await entry.actor.filtered_ann(vector, restrictions, limit)
        else:
            result = await entry.actor.ann(vector, limit)
    except DimensionMismatch as e:
        return 400, str(e)
    except Exception as e:
        logger.exception("post_index_ann failed")
        return 500, f"index.ann request error: {e}"
    return 200, (entry.metadata.primary_key_columns, result)


# ---------------------------------------------------------------------------
# POST /api/v1/indexes/{keyspace}/{index}/bm25
# ---------------------------------------------------------------------------


async def post_index_bm25(request: web.Request) -> web.Response:
    st = _state(request)
    keyspace = request.match_info["keyspace"]
    index_name = request.match_info["index"]
    denied = check_insecure_tls(st, request)
    if denied is not None:
        return denied
    try:
        body = await request.json()
    except Exception:
        return _err(400, "malformed JSON body")
    query = body.get("query")
    if not isinstance(query, str):
        return _err(400, "missing or malformed 'query'")
    limit = body.get("limit", 1)
    try:
        limit = int(Limit(int(limit)))
    except (ValueError, TypeError):
        return _err(400, "invalid 'limit'")

    status, answer = await bm25_answer(st, keyspace, index_name, query, limit)
    if status != 200:
        return _answer(status, answer)
    pk_columns, keys, scores = answer
    try:
        primary_keys = collect_primary_keys(pk_columns, keys)
    except ValueError as e:
        return _err(500, str(e))
    return _json({"primary_keys": primary_keys, "scores": scores})


async def bm25_answer(
    st: AppState, keyspace: str, index_name: str, query: str, limit: int
) -> tuple[int, object]:
    """One BM25 query; a 200's body is (primary key columns, keys, scores)."""
    from vector_store_tpu_torch.service.node_state import IndexStatus

    entry = st.indexes.get_fts(IndexKey(keyspace, index_name))
    if entry is None:
        return 404, f"missing index: {keyspace}.{index_name}"
    if entry.status is not IndexStatus.SERVING:
        progress = entry.progress.percentage
        if st.node_state.get_status() is NodeStatus.SERVING:
            return 503, {
                "reason": "INDEX_BUILDING",
                "message": (
                    f"Index {keyspace}.{index_name} is not available yet as it "
                    f"is still being constructed, progress: {progress:.3f}%"
                ),
            }
        return 503, {"reason": "NODE_BOOTSTRAPPING"}

    timer = st.metrics.latency.with_labels(keyspace, index_name).start_timer()
    try:
        keys, scores = await entry.actor.search(query, limit)
    except Exception as e:
        logger.exception("post_index_bm25 failed")
        return 500, f"index.bm25 request error: {e}"
    finally:
        timer.observe_duration()
    return 200, (entry.metadata.primary_key_columns, keys, scores)


# ---------------------------------------------------------------------------
# info / status / metrics / internals
# ---------------------------------------------------------------------------


async def get_info(request: web.Request) -> web.Response:
    return _json(info_answer(_state(request)))


def info_answer(st: AppState) -> dict:
    return {
        "engine": st.engine_version,
        "service": vector_store_tpu_torch.SERVICE_NAME,
        "version": vector_store_tpu_torch.__version__,
    }


async def get_status(request: web.Request) -> web.Response:
    st = _state(request)
    return _json(node_status_http(st.node_state.get_status()))


_METRICS_PB_CONTENT_TYPE = (
    "application/vnd.google.protobuf; "
    "proto=io.prometheus.client.MetricFamily; encoding=delimited"
)


async def get_metrics(request: web.Request) -> web.Response:
    """Prometheus exposition with content negotiation: protobuf when the
    scraper asks for it, text otherwise (httproutes.rs:577-613)."""
    st = _state(request)
    accept = request.headers.get("Accept", "")
    if "application/vnd.google.protobuf" in accept:
        body = st.metrics.expose_protobuf()
        return web.Response(
            body=body, headers={"Content-Type": _METRICS_PB_CONTENT_TYPE}
        )
    text = st.metrics.expose_text()
    return web.Response(text=text, content_type="text/plain", charset="utf-8")


async def get_internal_counters(request: web.Request) -> web.Response:
    return _json(_state(request).internals.counters())


async def delete_internal_counters(request: web.Request) -> web.Response:
    _state(request).internals._counters.clear()
    return _json({})


async def put_internal_counter(request: web.Request) -> web.Response:
    name = request.match_info["id"]
    _state(request).internals.increment(name, 0)
    return _json({})


async def get_internal_session_counters(request: web.Request) -> web.Response:
    st = _state(request)
    counters = st.internals.session_counters()
    # live CQL session counters when a real DB session is attached
    db = getattr(st.engine, "db", None) if st.engine else None
    session = getattr(db, "session", None)
    if session is not None:
        counters = dict(counters)
        counters["cql_connect_failures"] = getattr(session, "connect_failures", 0)
        counters["cql_reconnects"] = getattr(session, "reconnects", 0)
        counters["cql_connected"] = int(getattr(session, "is_connected", False))
    return _json(counters)


async def get_internal_hotpath(request: web.Request) -> web.Response:
    from vector_store_tpu_torch.utils import hotpath

    return _json(hotpath.stats())


async def get_openapi(request: web.Request) -> web.Response:
    from vector_store_tpu_torch.http.openapi import openapi_doc

    return _json(openapi_doc())


async def get_swagger_ui(request: web.Request) -> web.Response:
    from vector_store_tpu_torch.http.swagger_ui import PAGE

    return web.Response(text=PAGE, content_type="text/html", charset="utf-8")


async def redirect_swagger_ui(request: web.Request) -> web.Response:
    raise web.HTTPFound("/swagger-ui/")


def build_app(state: AppState) -> web.Application:
    app = web.Application(client_max_size=64 * 1024 * 1024)
    app["state"] = state
    app.router.add_get("/api/v1/indexes", get_indexes)
    app.router.add_get("/api/v1/indexes/{keyspace}/{index}/status", get_index_status)
    app.router.add_get("/api/v1/indexes/{keyspace}/{index}", get_index_info)
    app.router.add_post("/api/v1/indexes/{keyspace}/{index}/ann", post_index_ann)
    app.router.add_post("/api/v1/indexes/{keyspace}/{index}/bm25", post_index_bm25)
    app.router.add_get("/api/v1/info", get_info)
    app.router.add_get("/api/v1/status", get_status)
    app.router.add_get("/metrics", get_metrics)
    app.router.add_get("/api/internals/counters", get_internal_counters)
    app.router.add_delete("/api/internals/counters", delete_internal_counters)
    app.router.add_put("/api/internals/counters/{id}", put_internal_counter)
    app.router.add_get(
        "/api/internals/session/counters", get_internal_session_counters
    )
    app.router.add_get("/api/internals/hotpath", get_internal_hotpath)
    app.router.add_get("/api-docs/openapi.json", get_openapi)
    app.router.add_get("/swagger-ui", redirect_swagger_ui)
    app.router.add_get("/swagger-ui/", get_swagger_ui)
    return app
