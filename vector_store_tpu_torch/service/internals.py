"""Debug counters exposed at /api/internals/* (reference internals.rs)."""

from __future__ import annotations

import threading


class Internals:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._session_counters: dict[str, int] = {}

    def increment(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + amount

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(sorted(self._counters.items()))

    def increment_session(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._session_counters[name] = self._session_counters.get(name, 0) + amount

    def session_counters(self) -> dict[str, int]:
        with self._lock:
            return dict(sorted(self._session_counters.items()))
