"""Program spans: named host intervals on ``time.perf_counter_ns()``, the
clock the benchmark's trace places on the profiler's.

A span is recorded while ``utils/hotpath`` measures: ``VECTOR_STORE_HOTPATH=1``,
``hotpath.enable()`` or ``start()`` turn both on, ``hotpath.disable()`` or
``stop()`` both off. Off, a span site costs one check of that switch: no
clock read, no allocation, no lock. Each closed span adds its call and
nanoseconds to hotpath's registry under its name, so ``hotpath.stats()``
and ``GET /api/internals/hotpath`` list spans beside the measured
functions. ``utils/hotpath.py`` is the JAX package's module, copied as it
is, so this one reads its switch, lock and registry.

The spans, by where they are taken:

- ``http.parse``, ``http.encode`` (``http/routes.py``, the ANN route): the
  body's JSON and checks; the keys, distances and the answer's JSON;
- ``actor.queue_wait`` (``service/vs_index.py``): a request from its
  submission (or requeue) to the start of its search window;
  ``actor.wake``: from the collect that answered it to the request's task
  resuming, the event loop's lag;
- ``ivf.pull`` (``engine/ivf.py``): ``search_collect`` blocked on the
  device's answer;
- ``ivf.queries`` (``engine/ivf.py``): from the start of ``search_begin``
  to the main region's queries on the device (cosine normalisation, the
  storage or bf16 conversion, padding, upload); ``ivf.delta_begin``: the
  delta region's ``search_begin`` (for I8 the lossy scan and its bf16
  rescore tier); ``ivf.rescore``: the exact f32 ``ids_postprocess`` of
  the oversampled candidates, in ``_postprocess`` and ``_retry_dropped``;
- ``ivf.rescore_numpy`` (``engine/flat.py::ids_postprocess``): the NumPy
  gather, taken only where ``native_rescore`` gives nothing (no native
  library, or a layout it does not take);
- ``host.gc.gen0`` / ``gen1`` / ``gen2``: the garbage collector, by
  generation (``gc.callbacks``);
- ``loop.select``: the serving event loop waiting on its sockets (its
  selector's ``select``).

The last two hooks are installed while recording only: by ``start()``, or
by the next ANN request once hotpath was switched on otherwise
(``sync_hooks``), and removed likewise. This module imports neither torch
nor numpy: frontends of ``run.serve_scaled`` load neither.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import gc
import threading
import time

from vector_store_tpu_torch.utils import hotpath

GC_SPANS = ("host.gc.gen0", "host.gc.gen1", "host.gc.gen2")

# (name, calls, ns) closed while hotpath's lock was held elsewhere (``add``)
_DEFERRED: collections.deque[tuple[str, int, int]] = collections.deque()
_OFF = contextlib.nullcontext()


def recording() -> bool:
    return hotpath._ENABLED


def now() -> int:
    """The clock while recording, else 0 (a stamp that records nothing)."""
    return time.perf_counter_ns() if hotpath._ENABLED else 0


def _count_locked(name: str, calls: int, ns: int) -> None:
    s = hotpath._STATS.get(name)
    if s is None:
        hotpath._STATS[name] = [calls, ns]
    else:
        s[0] += calls
        s[1] += ns


def add(name: str, calls: int, ns: int) -> None:
    """Add ``calls`` spans of ``ns`` in all to hotpath's registry: now if
    its lock is free, else at the next span that takes it. A span never
    waits on the lock: a thread blocked on it would wait again for the
    interpreter lock once it is released, and a collection may begin
    inside it, in the very thread whose callback then records the
    collection."""
    if hotpath._LOCK.acquire(blocking=False):
        try:
            while _DEFERRED:
                _count_locked(*_DEFERRED.popleft())
            _count_locked(name, calls, ns)
        finally:
            hotpath._LOCK.release()
    else:
        _DEFERRED.append((name, calls, ns))


def record(name: str, t0_ns: int, t1_ns: int) -> None:
    """A span measured by its caller (a wait that starts in one thread and
    ends in another); nothing while not recording."""
    if hotpath._ENABLED:
        add(name, 1, t1_ns - t0_ns)


class _Span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        add(self.name, 1, time.perf_counter_ns() - self.t0)


def span(name: str):
    """``with span(name):`` records the block."""
    return _Span(name) if hotpath._ENABLED else _OFF


def sync_hooks() -> None:
    """Bring the hooks into line with hotpath's switch; called on the
    serving loop for each ANN request, so that a bare ``hotpath.enable()``
    or ``disable()`` is followed."""
    if not hotpath._ENABLED:
        if _HOOKS is not None:
            _unhook()
        return
    loop, hooks = asyncio.get_running_loop(), _HOOKS
    if hooks is None or hooks.loop is not loop:
        _hook(loop)


class _Hooks:
    """The garbage collector's callback and the loop's selector wrapper."""

    def __init__(self, loop: asyncio.AbstractEventLoop | None) -> None:
        self.loop = loop
        self.selector = getattr(loop, "_selector", None)  # a selector loop's; none on others
        self.gc_t0 = 0
        gc.callbacks.append(self.on_gc)
        if self.selector is not None:
            inner = self.selector.select

            def select(timeout=None):
                t0 = time.perf_counter_ns()
                try:
                    return inner(timeout)
                finally:
                    record("loop.select", t0, time.perf_counter_ns())

            self.selector.select = select

    def remove(self) -> None:
        if self.on_gc in gc.callbacks:
            gc.callbacks.remove(self.on_gc)
        if self.selector is not None:
            self.selector.__dict__.pop("select", None)

    def on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.gc_t0 = time.perf_counter_ns()
            return
        if not (self.gc_t0 and hotpath._ENABLED):
            return
        add(GC_SPANS[info["generation"]], 1, time.perf_counter_ns() - self.gc_t0)
        self.gc_t0 = 0


_HOOKS: _Hooks | None = None
_HOOK_LOCK = threading.Lock()


def _hook(loop: asyncio.AbstractEventLoop | None) -> None:
    global _HOOKS
    with _HOOK_LOCK:
        if _HOOKS is not None:
            _HOOKS.remove()
        _HOOKS = _Hooks(loop)


def _unhook() -> None:
    global _HOOKS
    with _HOOK_LOCK:
        if _HOOKS is not None:
            _HOOKS.remove()
            _HOOKS = None


def start() -> None:
    """Record: hotpath on, the garbage collector's hook, and the running
    loop's selector wrapped (if called on a loop; else the next ANN request
    wraps its loop's)."""
    hotpath.enable()
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        loop = None
    hooks = _HOOKS
    if hooks is None or (loop is not None and hooks.loop is not loop):
        _hook(loop)


def stop() -> None:
    """Stop recording: hotpath off, both hooks removed."""
    hotpath.disable()
    _unhook()
