"""ctypes binding for the fused gather+rescore kernel
(native/rescore_native.cpp), with a numpy fallback contract documented in
engine/flat.py::ids_postprocess (the caller).

The native path fuses the [b, kf, d] candidate gather with the distance
computation — one streaming pass with software prefetch instead of a
DRAM-roundtripped temporary. Distances are bitwise-deterministic (fixed
8-lane partial-sum order) but may differ from numpy's reduction order by
~1 ulp; the cosine metric uses the 0.5*||q-v||^2 form (identical to
1-dot on the unit-norm mirror rows in real arithmetic) so a self-match
is STRUCTURALLY 0.0 in any summation order — the exactness contract the
service verifies live."""

from __future__ import annotations

import ctypes

import numpy as np

from vector_store_tpu_torch.core.types import SpaceType
from vector_store_tpu_torch.native import load_native

_METRIC = {
    SpaceType.EUCLIDEAN: 0,
    SpaceType.COSINE: 1,
    SpaceType.DOT_PRODUCT: 2,
}


def _bind():
    lib = load_native("rescore_native")
    if lib is None:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.rescore_f32.argtypes = [
        f32p,
        ctypes.c_int64,
        ctypes.c_int32,
        i32p,
        f32p,
        f32p,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.rescore_f32.restype = None
    return lib


_LIB = None
_TRIED = False


def native_rescore(
    vecs_host: np.ndarray,  # [cap, D] f32, C-contiguous
    ids: np.ndarray,  # [b, kf] int32 (negatives allowed; junk distance out)
    q: np.ndarray,  # [b, D] f32 (normalized for cosine), C-contiguous
    space: SpaceType,
) -> np.ndarray | None:
    """[b, kf] f32 distances, or None when the native path is unavailable
    or the inputs don't meet its layout contract (caller falls back)."""
    global _LIB, _TRIED
    if not _TRIED:
        _LIB = _bind()
        _TRIED = True
    if _LIB is None or space not in _METRIC:
        return None
    if not (
        vecs_host.dtype == np.float32
        and vecs_host.flags.c_contiguous
        and q.dtype == np.float32
        and vecs_host.shape[1] == q.shape[1]
    ):
        return None
    ids32 = np.ascontiguousarray(ids, dtype=np.int32)
    qc = np.ascontiguousarray(q)
    b, kf = ids32.shape
    out = np.empty((b, kf), dtype=np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    _LIB.rescore_f32(
        vecs_host.ctypes.data_as(f32p),
        ctypes.c_int64(vecs_host.shape[0]),
        ctypes.c_int32(vecs_host.shape[1]),
        ids32.ctypes.data_as(i32p),
        qc.ctypes.data_as(f32p),
        out.ctypes.data_as(f32p),
        ctypes.c_int64(b),
        ctypes.c_int32(kf),
        ctypes.c_int32(_METRIC[space]),
    )
    return out
