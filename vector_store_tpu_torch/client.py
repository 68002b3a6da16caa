"""Typed REST client for the vector-store API (parity with the reference's
crates/httpclient): ANN/BM25 search, index listing/status/info, service
info/status, and internals counters."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import aiohttp


@dataclass
class AnnResult:
    primary_keys: dict[str, list]
    distances: list[float]
    similarity_scores: list[float]


@dataclass
class Bm25Result:
    primary_keys: dict[str, list]
    scores: list[float]


@dataclass
class IndexStatus:
    status: str
    count: int
    build_progress: float


class ApiError(Exception):
    def __init__(self, status: int, body: str) -> None:
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body


class VectorStoreClient:
    def __init__(self, base_url: str, session: aiohttp.ClientSession | None = None, ssl=None):
        self.base_url = base_url.rstrip("/")
        self._session = session
        self._own_session = session is None
        self.ssl = ssl

    async def __aenter__(self) -> "VectorStoreClient":
        if self._session is None:
            # no total-duration cap: benchmark drivers must not kill the
            # request (aiohttp's 5-min default) while a server warms a
            # fresh device-program shape; per-read inactivity still guards
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=None, sock_read=1200)
            )
        return self

    async def __aexit__(self, *exc) -> None:
        if self._own_session and self._session is not None:
            await self._session.close()

    async def _get(self, path: str):
        resp = await self._session.get(f"{self.base_url}{path}", ssl=self.ssl)
        if resp.status != 200:
            raise ApiError(resp.status, await resp.text())
        return await resp.json()

    async def _post(self, path: str, payload: dict):
        resp = await self._session.post(
            f"{self.base_url}{path}", json=payload, ssl=self.ssl
        )
        if resp.status != 200:
            raise ApiError(resp.status, await resp.text())
        return await resp.json()

    # -- api/v1 ------------------------------------------------------------------

    async def info(self) -> dict:
        return await self._get("/api/v1/info")

    async def status(self) -> str:
        return await self._get("/api/v1/status")

    async def indexes(self) -> list[dict]:
        return await self._get("/api/v1/indexes")

    async def index_status(self, keyspace: str, index: str) -> IndexStatus:
        data = await self._get(f"/api/v1/indexes/{keyspace}/{index}/status")
        return IndexStatus(
            status=data["status"],
            count=data["count"],
            build_progress=data.get("build_progress", 100.0),
        )

    async def index_info(self, keyspace: str, index: str) -> dict:
        return await self._get(f"/api/v1/indexes/{keyspace}/{index}")

    async def ann(
        self,
        keyspace: str,
        index: str,
        vector: list[float],
        limit: int = 1,
        filter: dict | None = None,
    ) -> AnnResult:
        payload: dict = {"vector": vector, "limit": limit}
        if filter is not None:
            payload["filter"] = filter
        data = await self._post(f"/api/v1/indexes/{keyspace}/{index}/ann", payload)
        return AnnResult(
            primary_keys=data["primary_keys"],
            distances=data["distances"],
            similarity_scores=data["similarity_scores"],
        )

    async def bm25(
        self, keyspace: str, index: str, query: str, limit: int = 1
    ) -> Bm25Result:
        data = await self._post(
            f"/api/v1/indexes/{keyspace}/{index}/bm25",
            {"query": query, "limit": limit},
        )
        return Bm25Result(primary_keys=data["primary_keys"], scores=data["scores"])

    # -- internals ----------------------------------------------------------------

    async def internal_counters(self) -> dict[str, int]:
        return await self._get("/api/internals/counters")

    async def metrics_text(self) -> str:
        resp = await self._session.get(f"{self.base_url}/metrics", ssl=self.ssl)
        if resp.status != 200:
            raise ApiError(resp.status, await resp.text())
        return await resp.text()
