"""Lightweight hot-path timing (the reference compiles `hotpath` measure
macros into ~40 hot functions; here the equivalent is an opt-in decorator
feeding per-function count/total-ns counters, exposed through
/api/internals/counters and togglable at runtime).

Enable with VECTOR_STORE_HOTPATH=1 or `hotpath.enable()`.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)

_ENABLED = os.environ.get("VECTOR_STORE_HOTPATH", "") == "1"
_LOCK = threading.Lock()
_STATS: dict[str, list[int]] = {}  # name -> [count, total_ns]


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def measure(fn: F) -> F:
    """Decorator: times each call when enabled; ~zero cost when disabled."""
    name = f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__qualname__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _ENABLED:
            return fn(*args, **kwargs)
        t0 = time.perf_counter_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            dt = time.perf_counter_ns() - t0
            with _LOCK:
                s = _STATS.get(name)
                if s is None:
                    _STATS[name] = [1, dt]
                else:
                    s[0] += 1
                    s[1] += dt

    return wrapper  # type: ignore[return-value]


def stats() -> dict[str, dict[str, float]]:
    with _LOCK:
        return {
            name: {
                "calls": c,
                "total_ms": t / 1e6,
                "avg_us": (t / c) / 1e3 if c else 0.0,
            }
            for name, (c, t) in sorted(_STATS.items())
        }


def reset() -> None:
    with _LOCK:
        _STATS.clear()
