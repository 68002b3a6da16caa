"""ctypes bindings for the native BM25 core (native/fts_native.cpp), with
the same interface as the pure-python fts.InvertedIndex."""

from __future__ import annotations

import ctypes

from vector_store_tpu_torch.native import load_native


def _bind():
    lib = load_native("fts_native")
    if lib is None:
        return None
    lib.fts_create.restype = ctypes.c_void_p
    lib.fts_destroy.argtypes = [ctypes.c_void_p]
    lib.fts_add_document.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p]
    lib.fts_delete_document.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fts_uncommitted.argtypes = [ctypes.c_void_p]
    lib.fts_uncommitted.restype = ctypes.c_int64
    lib.fts_commit.argtypes = [ctypes.c_void_p]
    lib.fts_commit.restype = ctypes.c_int64
    lib.fts_num_docs.argtypes = [ctypes.c_void_p]
    lib.fts_num_docs.restype = ctypes.c_int64
    lib.fts_search.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.fts_search.restype = ctypes.c_int64
    lib.fts_size_bytes.argtypes = [ctypes.c_void_p]
    lib.fts_size_bytes.restype = ctypes.c_int64
    return lib


_LIB = None
_TRIED = False


def native_available() -> bool:
    global _LIB, _TRIED
    if not _TRIED:
        _LIB = _bind()
        _TRIED = True
    return _LIB is not None


class NativeInvertedIndex:
    """Same surface as fts.InvertedIndex, backed by the C++ core."""

    def __init__(self) -> None:
        if not native_available():
            raise RuntimeError("native fts core unavailable")
        self._h = _LIB.fts_create()

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h and _LIB is not None:
            _LIB.fts_destroy(h)
            self._h = None

    def add_document(self, doc_id: int, body: str) -> None:
        _LIB.fts_add_document(self._h, doc_id, body.encode("utf-8"))

    def delete_document(self, doc_id: int) -> None:
        _LIB.fts_delete_document(self._h, doc_id)

    @property
    def uncommitted(self) -> int:
        return _LIB.fts_uncommitted(self._h)

    def commit(self) -> int:
        return _LIB.fts_commit(self._h)

    @property
    def num_docs(self) -> int:
        return _LIB.fts_num_docs(self._h)

    def search(self, query: str, limit: int) -> list[tuple[int, float]]:
        # the core can never return more than num_docs hits; clamp before
        # allocating so an attacker-controlled limit can't demand GBs
        limit = max(0, min(int(limit), self.num_docs))
        if limit == 0:
            return []
        ids = (ctypes.c_int64 * limit)()
        scores = (ctypes.c_float * limit)()
        n = _LIB.fts_search(self._h, query.encode("utf-8"), limit, ids, scores)
        return [(int(ids[i]), float(scores[i])) for i in range(n)]

    def size_bytes(self) -> int:
        return _LIB.fts_size_bytes(self._h)


def make_inverted_index():
    """Native when the toolchain allows, python fallback otherwise."""
    if native_available():
        return NativeInvertedIndex()
    from vector_store_tpu_torch.fts import InvertedIndex

    return InvertedIndex()
