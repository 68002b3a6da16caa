"""The bootstrapped heap kept out of the cyclic collector's full passes.

An index's bootstrap leaves millions of GC-tracked objects that live as
long as the index (the table's keys and ids, the feed's rows) and hold no
cycles. CPython's collector walks every one of them in each full (gen2)
collection: seconds a pass at a million rows, during the bootstrap each
time the heap grows by a quarter, and later once in a while in the middle
of serving, with no answer meanwhile. ``gc.freeze()`` moves every tracked
object into the permanent generation, which no collection walks.
Reference counting still frees a frozen object, but the collector no
longer frees a frozen cycle: a cycle that is alive at a freeze and dropped
later stays until ``gc.unfreeze()``.

So the heap is frozen only while a process bootstraps, before any of its
indexes serves:

- while a vector index's full scan is open and no index of the running
  services has finished its scan, after every gen1 (or gen2) collection,
  by a ``gc.callbacks`` hook: the young cyclic garbage has just been
  collected, so what is frozen is live, and the freezes follow the
  allocation rate. The hook goes as soon as any index finishes its scan,
  FTS indexes included;
- once, after a young collection, when the actor has applied the scan's
  last row, unless another index serves by then.

An index added while another serves, and an IVF rebuild, freeze nothing:
what a serving process frees is never held back. What stays until the
release is what was alive at those freezes and became cyclic garbage
later, plus the cycles already in the oldest generation at the first one:
bounded by the first bootstrap, not growing with uptime.

``gc.unfreeze()`` runs when the last running service of the process stops,
so that a stopped service's cycles can be collected again. The state here
is the process's, as the collector's is: every service of the process
shares it. ``counters()`` gives ``host-gc-freezes`` (the freezes in this
process) and ``host-gc-frozen-objects`` (``gc.get_freeze_count()``), which
``run.py`` adds to ``GET /api/internals/counters``. The second is counted
when it is read, never after a freeze: counting walks the whole frozen
list, tenths of a second at a million rows. This module imports neither
torch nor numpy.
"""

from __future__ import annotations

import gc
import threading

_LOCK = threading.Lock()  # never taken in the collector's callback
_services: list = []  # each running service
_scans: dict[int, object] = {}  # id(metadata) -> metadata: scans that may freeze
_served: set[int] = set()  # id(metadata) of each index whose scan finished
_froze = False  # a freeze since the first service started
_freezes = 0


def _freeze() -> None:
    global _froze, _freezes
    gc.freeze()
    _froze = True
    _freezes += 1


def _on_gc(phase: str, info: dict) -> None:
    if phase == "stop" and info["generation"] >= 1:
        _freeze()


def _sync_hook() -> None:
    """The collector's hook installed while a scan is open and no index
    serves, and only then."""
    want = bool(_scans) and not _served
    hooked = _on_gc in gc.callbacks
    if want and not hooked:
        gc.callbacks.append(_on_gc)
    elif hooked and not want:
        gc.callbacks.remove(_on_gc)


def counters() -> dict[str, int]:
    """The freezes so far and the objects frozen now."""
    return {"host-gc-freezes": _freezes, "host-gc-frozen-objects": gc.get_freeze_count()}


def acquire(service) -> None:
    """A service runs: its indexes' scans may freeze."""
    with _LOCK:
        _services.append(service)


def release(service) -> None:
    """A service stops; the last one to stop unfreezes the heap."""
    global _froze
    with _LOCK:
        if not any(s is service for s in _services):
            return
        _services[:] = [s for s in _services if s is not service]
        if not _services:
            _scans.clear()
            _served.clear()
            if _froze:
                gc.unfreeze()
                _froze = False
        _sync_hook()


def scan_started(metadata) -> None:
    """A vector index's full scan starts: while no index serves, freeze
    after every gen1 collection."""
    with _LOCK:
        if _services and not _served:
            _scans[id(metadata)] = metadata
            _sync_hook()


def scan_finished(metadata) -> None:
    """An index's last row reached its table, and the index serves: no
    more freezes after collections."""
    with _LOCK:
        if _services:
            _served.add(id(metadata))
            _sync_hook()


def scan_applied(metadata) -> None:
    """The index's actor has nothing left to apply: once its scan has
    finished, close the scan, and freeze once unless another index
    serves."""
    key = id(metadata)
    if key not in _scans or key not in _served:
        return
    with _LOCK:
        if _scans.pop(key, None) is None:
            return
        _sync_hook()
        if _served <= {key}:
            gc.collect(1)  # what is frozen is live
            _freeze()


def scan_dropped(metadata) -> None:
    """Close the index's scan without a freeze (its actor stopped)."""
    with _LOCK:
        if _scans.pop(id(metadata), None) is not None:
            _sync_hook()
