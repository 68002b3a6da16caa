"""ScyllaDB-backed Db implementation.

Parity targets: db.rs (session + schema discovery), db_index.rs (token-range
parallel full scan with retries and token-space progress), db_index_backend.rs
(scan/request query builders incl. the Alternator ':attrs' dialect), and
db_cdc/ (two-tier CDC readers — wide/consistent + fine/low-latency — with
dedup and read-after-CDC upsert fetch).

Built on the pure-python CQL driver (db/cql). Schema metadata comes from
system_schema tables instead of driver-internal cluster state.
"""

from __future__ import annotations

import asyncio
import datetime
import json
import logging
import struct
import time
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Optional

from vector_store_tpu_torch.core.keys import PrimaryKey
from vector_store_tpu_torch.core.timestamp import Timestamp, Timestamped
from vector_store_tpu_torch.core.types import (
    ALTERNATOR_ATTRS_COLUMN,
    ColumnName,
    DbCustomIndex,
    DbIndexKind,
    DbIndexPartitioning,
    DbIndexedOperation,
    DbIndexedRow,
    DbIndexedValue,
    IndexKey,
    IndexMetadata,
    IndexVersion,
    Progress,
    is_alternator_keyspace,
)
from vector_store_tpu_torch.db import Db, DbIndex, ScanLatch
from vector_store_tpu_torch.db.cql.session import CqlSession
from vector_store_tpu_torch.service.monitor_items import AsyncInProgress

logger = logging.getLogger(__name__)

import re

RE_VECTOR_TYPE = re.compile(r"^vector<float, (?P<dimensions>\d+)>$")

FULLSCAN_RETRY_MIN = 0.1
FULLSCAN_RETRY_MAX = 16.0
TOKEN_MIN = -(2**63)
TOKEN_MAX = 2**63 - 1

# CDC operation codes (cdc$operation)
CDC_OP_PRE_IMAGE = 0
CDC_OP_UPDATE = 1
CDC_OP_INSERT = 2
CDC_OP_ROW_DELETE = 3
CDC_OP_PARTITION_DELETE = 4
CDC_OP_POST_IMAGE = 9


def quote_ident(name: str) -> str:
    return '"' + name.replace('"', '""') + '"'


def build_columns_list(keyspace: str, columns: list[str]) -> str:
    """Value+writetime select-list; Alternator reads attributes out of the
    ':attrs' map (db_index_backend.rs:37-63)."""
    parts = []
    if is_alternator_keyspace(keyspace):
        attrs = quote_ident(ALTERNATOR_ATTRS_COLUMN)
        for col in columns:
            lit = "'" + col.replace("'", "''") + "'"
            parts.append(f"{attrs}[{lit}]")
            parts.append(f"writetime({attrs}[{lit}])")
    else:
        for col in columns:
            parts.append(quote_ident(col))
            parts.append(f"writetime({quote_ident(col)})")
    return ", ".join(parts)


def range_scan_query(
    keyspace: str,
    table: str,
    columns: list[str],
    primary_key_columns: list[str],
    partition_key_columns: list[str],
) -> str:
    cols = build_columns_list(keyspace, columns)
    pk_list = ", ".join(quote_ident(c) for c in primary_key_columns)
    part_list = ", ".join(quote_ident(c) for c in partition_key_columns)
    return (
        f"SELECT {pk_list}, {cols} FROM {quote_ident(keyspace)}.{quote_ident(table)} "
        f"WHERE token({part_list}) >= ? AND token({part_list}) <= ? BYPASS CACHE"
    )


def request_query(
    keyspace: str, table: str, columns: list[str], primary_key_columns: list[str]
) -> str:
    cols = build_columns_list(keyspace, columns)
    restr = " AND ".join(f"{quote_ident(c)} = ?" for c in primary_key_columns)
    return f"SELECT {cols} FROM {quote_ident(keyspace)}.{quote_ident(table)} WHERE {restr}"


def parse_target_option(
    value: str,
    table_columns: set[str],
    partition_key: list[str],
) -> tuple[DbIndexPartitioning, str, tuple[str, ...]] | None:
    """Index 'target' option -> (partitioning, target column, filtering
    columns). Handles the modern JSON form {tc, pk, fc}, the legacy
    {pk, ck} form, and the bare-column-name form (db.rs:1007-1063,
    from_target_option)."""
    target = None
    try:
        doc = json.loads(value)
    except (json.JSONDecodeError, ValueError):
        doc = None
    if isinstance(doc, dict) and "tc" in doc:
        target = (
            doc["tc"],
            list(doc.get("pk", [])),
            list(doc.get("fc", [])),
        )
    elif isinstance(doc, dict) and "pk" in doc and "ck" in doc:
        pk, ck = list(doc["pk"]), list(doc["ck"])
        is_local = all(c in partition_key for c in pk)
        if is_local:
            if not ck:
                logger.warning("invalid legacy target: ck empty for local index")
                return None
            target = (ck[0], pk, ck[1:])
        else:
            if len(pk) != 1:
                logger.warning("invalid legacy target: global pk must be 1 column")
                return None
            target = (pk[0], [], ck)
    if target is None:
        # bare column name -> global index, no filtering columns
        return (DbIndexPartitioning.global_(), value, ())
    tc, pk_cols, fc = target
    if pk_cols:
        if any(c not in table_columns for c in pk_cols):
            logger.warning("target pk column not in table columns; skipping")
            return None
        partitioning = DbIndexPartitioning.local(tuple(pk_cols))
    else:
        partitioning = DbIndexPartitioning.global_()
    return (partitioning, tc, tuple(fc))


@dataclass
class TableSchema:
    keyspace: str
    table: str
    partition_key: list[str]
    clustering_key: list[str]
    columns: dict[str, str]  # name -> cql type string

    @property
    def primary_key_columns(self) -> tuple[str, ...]:
        return tuple(self.partition_key + self.clustering_key)


class ScyllaDb(Db):
    def __init__(
        self,
        session: CqlSession,
        cdc_safety_interval: float = 30.0,
        cdc_sleep_interval: float = 10.0,
        cdc_fine_safety_interval: float = 0.1,
        cdc_fine_sleep_interval: float = 0.5,
        scan_concurrency: int = 12,
        metrics=None,
        internals=None,
    ) -> None:
        self.session = session
        self.cdc_safety_interval = cdc_safety_interval
        self.cdc_sleep_interval = cdc_sleep_interval
        self.cdc_fine_safety_interval = cdc_fine_safety_interval
        self.cdc_fine_sleep_interval = cdc_fine_sleep_interval
        self.scan_concurrency = scan_concurrency
        self.metrics = metrics
        self.internals = internals

    # -- schema helpers ---------------------------------------------------------

    async def get_table_schema(self, keyspace: str, table: str) -> TableSchema | None:
        rs = await self.session.execute_prepared(
            "SELECT column_name, kind, position, type FROM system_schema.columns "
            "WHERE keyspace_name = ? AND table_name = ?",
            [keyspace, table],
        )
        if not rs.rows:
            return None
        part: list[tuple[int, str]] = []
        clus: list[tuple[int, str]] = []
        columns: dict[str, str] = {}
        for name, kind, position, type_ in rs.rows:
            columns[name] = type_
            if kind == "partition_key":
                part.append((position, name))
            elif kind == "clustering":
                clus.append((position, name))
        return TableSchema(
            keyspace=keyspace,
            table=table,
            partition_key=[n for _, n in sorted(part)],
            clustering_key=[n for _, n in sorted(clus)],
            columns=columns,
        )

    # -- Db interface -----------------------------------------------------------

    async def latest_schema_version(self):
        rs = await self.session.execute_prepared(
            "SELECT state_id FROM system.group0_history WHERE key = 'history' "
            "ORDER BY state_id DESC LIMIT 1"
        )
        row = rs.one()
        return row[0] if row else None

    async def get_indexes(self) -> list[DbCustomIndex]:
        rs = await self.session.execute_prepared(
            "SELECT keyspace_name, index_name, table_name, options "
            "FROM system_schema.indexes WHERE kind = 'CUSTOM' ALLOW FILTERING"
        )
        out: list[DbCustomIndex] = []
        for keyspace, index, table, options in rs.rows:
            options = dict(options or {})
            class_name = options.get("class_name")
            if class_name in (None, "vector_index"):
                kind = DbIndexKind.VECTOR_SEARCH
            elif class_name == "fulltext_index":
                kind = DbIndexKind.FULL_TEXT_SEARCH
            else:
                logger.debug("unrecognized index class_name %r; skipping", class_name)
                continue
            target = options.get("target")
            if target is None:
                continue
            schema = await self.get_table_schema(keyspace, table)
            if schema is None or not schema.primary_key_columns:
                continue
            parsed = parse_target_option(
                target, set(schema.columns), schema.partition_key
            )
            if parsed is None:
                continue
            partitioning, target_column, filtering = parsed
            out.append(
                DbCustomIndex(
                    keyspace=keyspace,
                    index=index,
                    table=table,
                    primary_key_columns=schema.primary_key_columns,
                    partition_key_count=len(schema.partition_key),
                    target_columns=(target_column,),
                    partitioning=partitioning,
                    filtering_columns=filtering,
                    kind=kind,
                )
            )
        return out

    async def _get_options(self, key: IndexKey, table: str | None = None) -> dict | None:
        if table is None:
            # locate the table via the indexes table
            rs = await self.session.execute_prepared(
                "SELECT table_name, options FROM system_schema.indexes "
                "WHERE keyspace_name = ? AND index_name = ? ALLOW FILTERING",
                [key.keyspace, key.index],
            )
            row = rs.one()
            return dict(row[1] or {}) if row else None
        rs = await self.session.execute_prepared(
            "SELECT options FROM system_schema.indexes "
            "WHERE keyspace_name = ? AND table_name = ? AND index_name = ?",
            [key.keyspace, table, key.index],
        )
        row = rs.one()
        return dict(row[0] or {}) if row else None

    async def get_index_version(self, key: IndexKey):
        options = await self._get_options(key)
        if options is None:
            return None
        raw = options.get("index_version")
        try:
            return IndexVersion(uuid_mod.UUID(raw)) if raw else IndexVersion.nil()
        except ValueError:
            return IndexVersion.nil()

    async def get_index_target_dimensions(self, key: IndexKey):
        options = await self._get_options(key)
        if options is None:
            return None
        target = options.get("target")
        if target is None:
            return None
        parsed = parse_target_option(target, set(), [])
        target_column = parsed[1] if parsed else target
        # locate the base table
        rs = await self.session.execute_prepared(
            "SELECT table_name FROM system_schema.indexes "
            "WHERE keyspace_name = ? AND index_name = ? ALLOW FILTERING",
            [key.keyspace, key.index],
        )
        row = rs.one()
        if row is None:
            return None
        table = row[0]
        if is_alternator_keyspace(key.keyspace):
            # Alternator: dimensions live in index options (db_index_backend
            # dimensions-from-options path)
            raw = options.get("dimension") or options.get("dimensions")
            if not raw:
                return None
            try:
                dims = int(raw)
            except (TypeError, ValueError):
                logger.warning(
                    "index %s has a non-numeric dimension option %r; skipping",
                    key,
                    raw,
                )
                return None
            return dims if dims > 0 else None
        rs = await self.session.execute_prepared(
            "SELECT type FROM system_schema.columns "
            "WHERE keyspace_name = ? AND table_name = ? AND column_name = ?",
            [key.keyspace, table, target_column],
        )
        row = rs.one()
        if row is None:
            return None
        m = RE_VECTOR_TYPE.match(row[0])
        return int(m.group("dimensions")) if m else None

    async def get_index_params(self, key: IndexKey) -> dict:
        from vector_store_tpu_torch.core.types import (
            Connectivity,
            ExpansionAdd,
            ExpansionSearch,
            Quantization,
            SpaceType,
        )

        options = await self._get_options(key)
        if options is None:
            return {}
        params: dict = {}
        if raw := options.get("maximum_node_connections"):
            try:
                params["connectivity"] = Connectivity(int(raw))
            except (ValueError, TypeError):
                pass
        if raw := options.get("construction_beam_width"):
            try:
                params["expansion_add"] = ExpansionAdd(int(raw))
            except (ValueError, TypeError):
                pass
        if raw := options.get("search_beam_width"):
            try:
                params["expansion_search"] = ExpansionSearch(int(raw))
            except (ValueError, TypeError):
                pass
        if raw := options.get("similarity_function"):
            try:
                params["space_type"] = SpaceType.parse(raw)
            except ValueError:
                pass
        if raw := options.get("quantization"):
            try:
                params["quantization"] = Quantization.parse(raw)
            except ValueError:
                pass
        # quantization_and_rescoring validator options: fetch-multiplier
        # over LIMIT + whether the exact re-rank runs (validator
        # quantization_and_rescoring.rs:109-118 passes these through
        # CREATE INDEX ... WITH OPTIONS)
        if raw := options.get("oversampling"):
            try:
                params["oversampling"] = float(raw)
            except (ValueError, TypeError):
                pass
        if raw := options.get("rescoring"):
            if str(raw).lower() in ("true", "false"):
                params["rescoring"] = str(raw).lower() == "true"
        return params

    async def is_valid_index(self, key: IndexKey) -> bool:
        """Schema sanity: index exists, base table exists, CDC log exists,
        and the schema version is agreed across the check
        (db.rs:954-1004)."""
        try:
            v_begin = await self._schema_agreement()
            if v_begin is None:
                return False
            rs = await self.session.execute_prepared(
                "SELECT table_name FROM system_schema.indexes "
                "WHERE keyspace_name = ? AND index_name = ? ALLOW FILTERING",
                [key.keyspace, key.index],
            )
            row = rs.one()
            if row is None:
                return False
            table = row[0]
            schema = await self.get_table_schema(key.keyspace, table)
            if schema is None:
                return False
            cdc = await self.get_table_schema(key.keyspace, f"{table}_scylla_cdc_log")
            if cdc is None:
                logger.debug("is_valid_index: no cdc log for %s", key)
                return False
            v_end = await self._schema_agreement()
            return v_end is not None and v_begin == v_end
        except Exception:
            logger.debug("is_valid_index failed for %s", key, exc_info=True)
            return False

    async def _schema_agreement(self):
        local = await self.session.execute_prepared(
            "SELECT schema_version FROM system.local WHERE key='local'"
        )
        peers = await self.session.execute_prepared(
            "SELECT schema_version FROM system.peers"
        )
        versions = {r[0] for r in local.rows} | {r[0] for r in peers.rows}
        versions.discard(None)
        if len(versions) == 1:
            return versions.pop()
        return None

    # -- ingestion --------------------------------------------------------------

    def get_db_index(self, metadata: IndexMetadata) -> "ScyllaDbIndex":
        return ScyllaDbIndex(self, metadata)

    async def token_ring(self) -> list[int]:
        local = await self.session.execute_prepared("SELECT tokens FROM system.local WHERE key='local'")
        peers = await self.session.execute_prepared("SELECT tokens FROM system.peers")
        tokens: set[int] = set()
        for rs in (local, peers):
            for (toks,) in rs.rows:
                for t in toks or []:
                    tokens.add(int(t))
        return sorted(tokens)


def fullscan_ranges(tokens: list[int]) -> list[tuple[int, int]]:
    """Token ring -> inclusive scan ranges covering the full token space
    (db_index.rs:527-561). With no ring info, one full range."""
    if not tokens:
        return [(TOKEN_MIN, TOKEN_MAX)]
    ranges: list[tuple[int, int]] = []
    # from the minimum token up to each next token
    prev = TOKEN_MIN
    for t in tokens:
        if t >= prev:
            ranges.append((prev, t))
            prev = t + 1
    if prev <= TOKEN_MAX:
        ranges.append((prev, TOKEN_MAX))
    return ranges


class ScyllaDbIndex(DbIndex):
    """Per-index ingestion: parallel token-range full scan, then two CDC
    readers (wide + fine)."""

    def __init__(self, db: ScyllaDb, metadata: IndexMetadata) -> None:
        super().__init__()
        self.db = db
        self.metadata = metadata
        self.progress = Progress(0.0)
        self._tasks: list[asyncio.Task] = []
        self._stopped = False
        self.latch: ScanLatch | None = None
        self._cdc = CdcReaderPair(db, metadata, self.feed)

        md = metadata
        self._scan_columns = (
            [md.target_column]
            + list(md.nonpk_partition_key_columns())
            + list(md.filtering_columns)
        )
        self._scan_query = range_scan_query(
            md.keyspace_name,
            md.table_name,
            self._scan_columns,
            list(md.primary_key_columns),
            list(md.primary_key_columns[: md.partition_key_count]),
        )

    def start(self, on_scan_started, on_scan_finished) -> None:
        self._tasks.append(
            asyncio.get_running_loop().create_task(
                self._run(on_scan_started, on_scan_finished)
            )
        )

    async def stop(self) -> None:
        self._stopped = True
        await self._cdc.stop()
        for t in self._tasks:
            t.cancel()
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass

    def full_scan_progress(self) -> Progress:
        return self.progress

    async def get_table_columns(self) -> dict[str, str]:
        md = self.metadata
        schema = await self.db.get_table_schema(md.keyspace_name, md.table_name)
        return dict(schema.columns) if schema else {}

    async def _run(self, on_scan_started, on_scan_finished) -> None:
        on_scan_started()

        def done() -> None:
            self.progress = Progress.done()
            on_scan_finished()

        self.latch = ScanLatch(done)
        # CDC starts alongside the scan (reference spawns CDC actors first,
        # starting from now - 10 min)
        self._cdc.start()

        tokens = []
        try:
            tokens = await self.db.token_ring()
        except Exception:
            logger.warning("failed to read token ring; scanning one range")
        ranges = fullscan_ranges(tokens)
        total_span = float(2**64)
        scanned = 0.0
        sem = asyncio.Semaphore(self.db.scan_concurrency)

        async def scan_range(lo: int, hi: int) -> None:
            nonlocal scanned
            async with sem:
                backoff = FULLSCAN_RETRY_MIN
                paging = None
                while not self._stopped:
                    try:
                        rs = await self.db.session.execute_prepared(
                            self._scan_query,
                            [lo, hi],
                            page_size=1000,
                            paging_state=paging,
                        )
                        for row in rs.rows:
                            parsed = self._parse_row(row)
                            if parsed is not None:
                                self.latch.row_emitted()
                                await self.feed.put(
                                    (parsed, AsyncInProgress("fullscan", latch=self.latch))
                                )
                        if rs.paging_state is None:
                            break
                        paging = rs.paging_state
                    except Exception as e:
                        logger.debug("scan range retry after error: %s", e)
                        await asyncio.sleep(backoff)
                        backoff = min(backoff * 2, FULLSCAN_RETRY_MAX)
                scanned += (hi - lo + 1) / total_span
                self.progress = Progress(min(99.9, scanned * 100.0))

        await asyncio.gather(*(scan_range(lo, hi) for lo, hi in ranges))
        self.latch.finish_emitting()

    def _parse_row(self, row: tuple) -> DbIndexedRow | None:
        """Row layout: pk columns, then (value, writetime) per scan column
        (db_index.rs parse_values)."""
        md = self.metadata
        npk = len(md.primary_key_columns)
        pk_values = row[:npk]
        if any(v is None for v in pk_values):
            return None
        pk = PrimaryKey.from_values(pk_values)
        values: list[Timestamped] = []
        rest = row[npk:]
        for i, col in enumerate(self._scan_columns):
            value = rest[2 * i]
            writetime = rest[2 * i + 1]
            ts = (
                Timestamp.from_micros(int(writetime))
                if writetime is not None
                else Timestamp.MIN
            )
            if i == 0:
                if md.vs_options is not None:
                    dv = (
                        _decode_vector_or_none(value, md)
                        if value is not None
                        else None
                    )
                else:
                    dv = DbIndexedValue.document(str(value)) if value is not None else None
            else:
                dv = DbIndexedValue.filtering(value) if value is not None else None
            values.append(Timestamped(ts, dv))
        return DbIndexedRow(
            primary_key=pk, operation=DbIndexedOperation.upsert(tuple(values))
        )


def _decode_vector_or_none(value, md) -> "DbIndexedValue | None":
    """Per-row decode guard: a malformed vector value (bad Alternator blob
    tag, garbage bytes) must skip THAT row, not fail the whole token-range
    scan — a poisoned row would otherwise be retried forever
    (vector.rs decode errors are row-local in the reference too)."""
    try:
        return DbIndexedValue.vector(decode_vector_value(value, md))
    except (ValueError, TypeError) as e:
        logger.warning("skipping undecodable vector value: %s", e)
        return None


def decode_vector_value(value, metadata: IndexMetadata):
    """Vector column value -> float32 array/list. CQL vector columns decode
    in the driver (as numpy f32 rows on the hot path); Alternator
    attributes arrive as serialized blobs with a leading type tag —
    4 = JSON array, 5 = big-endian f32 array (vector.rs:39-110)."""
    import numpy as _np

    if isinstance(value, _np.ndarray):
        return value.astype(_np.float32, copy=False)
    if isinstance(value, (list, tuple)):
        return [float(x) for x in value]
    if isinstance(value, (bytes, bytearray)):
        b = bytes(value)
        if not b:
            raise ValueError("empty vector blob")
        tag = b[0]
        if tag == 4:
            return [float(x) for x in json.loads(b[1:].decode("utf-8"))]
        if tag == 5:
            n = (len(b) - 1) // 4
            return _np.frombuffer(b, dtype=">f4", count=n, offset=1).astype(
                _np.float32
            )
        raise ValueError(f"unknown alternator vector type tag {tag}")
    raise ValueError(f"cannot decode vector from {type(value).__name__}")


@dataclass
class _CdcState:
    last_time: uuid_mod.UUID | None = None
    seen: set = field(default_factory=set)  # (pk_bytes, time, op) dedup


class CdcReaderPair:
    """Two readers per index (db_cdc/actor.rs:44-50): 'wide' favors
    consistency (long safety interval), 'fine' favors latency. Both poll the
    CDC log table, classify operations, dedup, and re-read the current base
    row for upserts (read-after-CDC, consumer.rs:60-122).

    Stream-generation aware (db_cdc/actor.rs:439-488 via scylla-cdc): the
    reader discovers stream ids from system_distributed.cdc_generation_
    timestamps / cdc_streams_descriptions_v2 and issues single-partition
    reads per stream ("cdc$stream_id" = ? AND "cdc$time" range) with
    bounded concurrency. Only when the generation tables are absent (e.g.
    a minimal fake backend) does it fall back to one ALLOW FILTERING scan
    per window."""

    CHECKPOINT_OFFSET = 600.0  # start from now - 10 min (db_cdc/actor.rs:42)
    GEN_REFRESH = 10.0  # re-read stream topology at most this often
    STREAM_CONCURRENCY = 16  # parallel per-stream reads per window
    DEDUP_GENERATION = 50_000  # entries per dedup generation (two kept)

    def __init__(self, db: ScyllaDb, metadata: IndexMetadata, feed: asyncio.Queue) -> None:
        self.db = db
        self.metadata = metadata
        self.feed = feed
        self._tasks: list[asyncio.Task] = []
        self._stopped = False
        # two-generation dedup: membership checked in both, inserts go to
        # cur; rotation keeps the previous generation so a duplicate right
        # after rotation is still caught (no wholesale forgetting)
        self._dedup_cur: set = set()
        self._dedup_prev: set = set()
        self._gen_cache: list[tuple[float, list[bytes]]] | None = None
        self._gen_cache_at = 0.0
        md = metadata
        self._columns = (
            [md.target_column]
            + list(md.nonpk_partition_key_columns())
            + list(md.filtering_columns)
        )
        self._request_query = request_query(
            md.keyspace_name,
            md.table_name,
            self._columns,
            list(md.primary_key_columns),
        )
        self._log_table = f"{md.table_name}_scylla_cdc_log"

    def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(
                self._reader(
                    "wide", self.db.cdc_safety_interval, self.db.cdc_sleep_interval
                )
            ),
            loop.create_task(
                self._reader(
                    "fine",
                    self.db.cdc_fine_safety_interval,
                    self.db.cdc_fine_sleep_interval,
                )
            ),
        ]

    async def stop(self) -> None:
        self._stopped = True
        for t in self._tasks:
            t.cancel()
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass

    def _metric(self, name: str, reader: str):
        m = self.db.metrics
        if m is None:
            return None
        ks, ix = self.metadata.key
        return getattr(m, name).with_labels(ks, ix, reader)

    async def _reader(self, name: str, safety: float, sleep: float) -> None:
        md = self.metadata
        up = self._metric("cdc_reader_up", name)
        errors = self._metric("cdc_handler_errors_total", name)
        restarts = self._metric("cdc_reader_restarts_total", name)
        last_ts = self._metric("cdc_last_processed_timestamp_seconds", name)
        if up:
            up.set(1)
        window_start = time.time() - self.CHECKPOINT_OFFSET
        while not self._stopped:
            try:
                window_end = time.time() - safety
                if window_end > window_start:
                    await self._poll_window(window_start, window_end)
                    window_start = window_end
                    if last_ts:
                        last_ts.set(window_end)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.debug("cdc %s reader error for %s: %s", name, md.key, e)
                if errors:
                    errors.inc()
                if restarts:
                    restarts.inc()
                await asyncio.sleep(5.0)  # restart backoff (db_cdc/actor.rs:53)
            await asyncio.sleep(sleep)
        if up:
            up.set(0)

    async def _get_generations(self) -> list[tuple[float, list[bytes]]]:
        """CDC stream topology: [(generation_start_seconds, [stream_id])],
        sorted ascending. Empty when the cluster doesn't expose the
        generation tables (fallback to the scan path)."""
        now = time.time()
        if self._gen_cache is not None and now - self._gen_cache_at < self.GEN_REFRESH:
            return self._gen_cache
        gens: list[tuple[float, list[bytes]]] = []
        try:
            rs = await self.db.session.query(
                "SELECT time FROM system_distributed.cdc_generation_timestamps "
                "WHERE key = 'timestamps'"
            )
            times = sorted(
                row[0].timestamp() for row in rs.rows if row[0] is not None
            )
            for t in times:
                rs2 = await self.db.session.execute_prepared(
                    "SELECT streams FROM "
                    "system_distributed.cdc_streams_descriptions_v2 WHERE time = ?",
                    [datetime.datetime.fromtimestamp(t, tz=datetime.timezone.utc)],
                )
                streams: list[bytes] = []
                for row in rs2.rows:
                    if row[0]:
                        streams.extend(bytes(s) for s in row[0])
                if streams:
                    gens.append((t, streams))
        except Exception as e:
            logger.debug("cdc generation discovery unavailable: %s", e)
            gens = []
        self._gen_cache = gens
        self._gen_cache_at = now
        return gens

    def _streams_for_window(
        self, gens: list[tuple[float, list[bytes]]], start: float, end: float
    ) -> list[bytes]:
        """Stream ids of every generation active anywhere in [start, end):
        generation i covers [t_i, t_{i+1})."""
        out: list[bytes] = []
        for i, (t, streams) in enumerate(gens):
            nxt = gens[i + 1][0] if i + 1 < len(gens) else float("inf")
            if t < end and nxt > start:
                out.extend(streams)
        return out

    async def _poll_window(self, start: float, end: float) -> None:
        md = self.metadata
        start_uuid = _min_timeuuid(start)
        end_uuid = _min_timeuuid(end)
        pk_cols = ", ".join(quote_ident(c) for c in md.primary_key_columns)
        log = f"{quote_ident(md.keyspace_name)}.{quote_ident(self._log_table)}"

        gens = await self._get_generations()
        rows: list[tuple] = []
        if gens:
            # per-stream single-partition reads, bounded fan-out
            q = (
                f'SELECT "cdc$time", "cdc$operation", {pk_cols} FROM {log} '
                f'WHERE "cdc$stream_id" = ? AND "cdc$time" > ? AND "cdc$time" < ?'
            )
            sem = asyncio.Semaphore(self.STREAM_CONCURRENCY)

            async def read_stream(sid: bytes):
                async with sem:
                    rs = await self.db.session.execute_prepared(
                        q, [sid, start_uuid, end_uuid]
                    )
                    return rs.rows

            for chunk in await asyncio.gather(
                *(read_stream(s) for s in self._streams_for_window(gens, start, end))
            ):
                rows.extend(chunk)
            # CDC log clustering order only holds per stream; restore global
            # time order so LWW sees changes in sequence
            rows.sort(key=lambda r: r[0].time if r[0] is not None else 0)
        else:
            q = (
                f'SELECT "cdc$time", "cdc$operation", {pk_cols} FROM {log} '
                f'WHERE "cdc$time" > ? AND "cdc$time" < ? ALLOW FILTERING'
            )
            rs = await self.db.session.execute_prepared(q, [start_uuid, end_uuid])
            rows = list(rs.rows)

        for row in rows:
            cdc_time, op = row[0], row[1]
            pk_values = row[2:]
            if any(v is None for v in pk_values):
                continue
            if op in (CDC_OP_PRE_IMAGE, CDC_OP_POST_IMAGE):
                continue
            if op not in (
                CDC_OP_UPDATE,
                CDC_OP_INSERT,
                CDC_OP_ROW_DELETE,
                CDC_OP_PARTITION_DELETE,
            ):
                continue  # range deletes skipped (consumer.rs:186-201)
            pk = PrimaryKey.from_values(pk_values)
            dedup_key = (pk.data, cdc_time, op)
            if dedup_key in self._dedup_cur or dedup_key in self._dedup_prev:
                continue
            self._dedup_cur.add(dedup_key)
            if len(self._dedup_cur) > self.DEDUP_GENERATION:
                self._dedup_prev = self._dedup_cur
                self._dedup_cur = set()
            ts = _timeuuid_timestamp(cdc_time)
            change_seconds = ts.as_seconds()
            if op in (CDC_OP_ROW_DELETE, CDC_OP_PARTITION_DELETE):
                row_out = DbIndexedRow(
                    primary_key=pk, operation=DbIndexedOperation.delete(ts)
                )
            else:
                row_out = await self._read_current(pk, ts)
            await self.feed.put(
                (row_out, AsyncInProgress("cdc", change_seconds=change_seconds))
            )

    async def _read_current(self, pk: PrimaryKey, ts: Timestamp) -> DbIndexedRow:
        """Read-after-CDC: fetch the live row by PK; a missing row becomes a
        delete (consumer.rs:60-122)."""
        md = self.metadata
        rs = await self.db.session.execute_prepared(
            self._request_query, list(pk.values())
        )
        row = rs.one()
        if row is None:
            return DbIndexedRow(primary_key=pk, operation=DbIndexedOperation.delete(ts))
        values: list[Timestamped] = []
        for i, col in enumerate(self._columns):
            value = row[2 * i]
            writetime = row[2 * i + 1]
            wts = (
                Timestamp.from_micros(int(writetime)) if writetime is not None else ts
            )
            if i == 0:
                if md.vs_options is not None:
                    dv = (
                        _decode_vector_or_none(value, md)
                        if value is not None
                        else None
                    )
                else:
                    dv = DbIndexedValue.document(str(value)) if value is not None else None
            else:
                dv = DbIndexedValue.filtering(value) if value is not None else None
            values.append(Timestamped(wts, dv))
        if all(v.is_tombstone for v in values):
            return DbIndexedRow(primary_key=pk, operation=DbIndexedOperation.delete(ts))
        return DbIndexedRow(
            primary_key=pk, operation=DbIndexedOperation.upsert(tuple(values))
        )


_GREGORIAN_OFFSET = 0x01B21DD213814000  # 100ns ticks between 1582 and 1970


def _min_timeuuid(unix_seconds: float) -> uuid_mod.UUID:
    ticks = int(unix_seconds * 1e7) + _GREGORIAN_OFFSET
    time_low = ticks & 0xFFFFFFFF
    time_mid = (ticks >> 32) & 0xFFFF
    time_hi = ((ticks >> 48) & 0x0FFF) | 0x1000
    return uuid_mod.UUID(
        fields=(time_low, time_mid, time_hi, 0x80, 0x00, 0x808080808080)
    )


def _timeuuid_timestamp(u: uuid_mod.UUID) -> Timestamp:
    if u.version != 1:
        return Timestamp.now()
    return Timestamp.from_100_nanos(u.time - _GREGORIAN_OFFSET)
