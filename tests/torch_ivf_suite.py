"""Shared helpers of the twins of tests/test_engine_ivf.py: the reference
suite's own helpers (``clustered``, ``exact_topk``, its ``make_index``
settings), copied, and the JAX engine and the port's built as that suite
builds them, on the same delta scan block so kernel 1's lane minima fall
alike on both sides."""

import numpy as np
import pytest
import torch

from torch_parity import jax_state, to_jax
from vector_store_tpu_torch.core.types import Quantization, SpaceType
from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex

CPU = torch.device("cpu")
# the JAX delta's scan block in interpret mode (IvfDeviceIndex._set_delta_interpret)
DELTA_BLOCK = 256
DEFAULTS = dict(min_build=1024, kmeans_block=1024, nprobe=16, kmeans_iters=4)
MAIN, DELTA = 1, 2  # the regions a slot lives in (engine/ivf.py)
NOT_CARRIED = "Do not carry over (ROADMAP.md): "


@pytest.fixture
def interp_pallas(monkeypatch):
    """Force the JAX flat engine's Pallas kernel into interpret mode (the
    IVF delta region runs through it)."""
    import vector_store_tpu.ops.pallas_scan as ps

    orig = ps.pallas_rank_search
    monkeypatch.setattr(
        ps, "pallas_rank_search", lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
    )


def jax_index(d=32, space=SpaceType.EUCLIDEAN, quant=Quantization.F32, **kw):
    """The reference suite's make_index (exact selectors: the port has no
    approx_max_k)."""
    from vector_store_tpu.engine.ivf import IvfDeviceIndex as JaxIvf

    return JaxIvf(
        d, space_type=to_jax(space), quantization=to_jax(quant), initial_capacity=4096,
        interpret=True, query_i8=False, approx_select=False, **{**DEFAULTS, **kw},
    )


def port_index(d=32, space=SpaceType.EUCLIDEAN, quant=Quantization.F32, **kw):
    return IvfDeviceIndex(
        d, space_type=space, quantization=quant, device=CPU, initial_capacity=4096,
        scan_block_rows=DELTA_BLOCK, **{**DEFAULTS, **kw},
    )


def ingest(engines, slots, epochs, vecs):
    """The same upsert on every engine."""
    for eng in engines:
        eng.upsert_batch(np.asarray(slots), np.asarray(epochs, np.int32), vecs)


def loaded(j, d=32, space=SpaceType.EUCLIDEAN, quant=Quantization.F32, **kw):
    """The port's engine holding a built JAX engine's state (its k-means
    clustering included), so both answer id for id."""
    p = port_index(d, space, quant, **kw)
    p.load_state(jax_state(j))
    assert (p.nlist, p.cmax, p.size) == (j.nlist, j.cmax, j.size)
    return p


def both_built(vecs, epoch, d=32, space=SpaceType.EUCLIDEAN, quant=Quantization.F32, **kw):
    """The reference's ``_built``: the JAX engine ingests ``vecs`` at slots
    0..n-1 and builds; the port takes its state."""
    n = vecs.shape[0]
    j = jax_index(d, space, quant, **kw)
    j.upsert_batch(np.arange(n), np.full(n, epoch, np.int32), vecs)
    assert j.maintain()
    j._warm_queue.clear()  # the reference drives shapes explicitly
    return j, loaded(j, d, space, quant, **kw)


def clustered(n, d, n_clusters=64, seed=1):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 4
    assign = rng.integers(0, n_clusters, size=n)
    return centers[assign] + rng.normal(size=(n, d)).astype(np.float32), centers


def exact_topk(queries, vecs, k, space):
    if space is SpaceType.EUCLIDEAN:
        d = ((queries[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    else:
        qn = queries / np.linalg.norm(queries, axis=-1, keepdims=True)
        vn = vecs / np.linalg.norm(vecs, axis=-1, keepdims=True)
        d = 1.0 - qn @ vn.T
    return np.argsort(d, axis=1)[:, :k]


def recall(results, gt) -> float:
    k = gt.shape[1]
    return sum(len(set(r.slots.tolist()) & set(g.tolist())) for r, g in zip(results, gt)) / (len(gt) * k)


def assert_same(got, want, norm2=0.0):
    """Exact paths: slots and epochs equal, distances within
    1e-5 * (1 + |d|). Below a build the JAX engine answers with its
    delta's device distances, |q|^2 - 2 q.v + |v|^2 in f32, which cancel
    to within ~1e-7 of ``norm2``, the rows' largest squared norm (the port
    answers from the f32 host mirror): 1e-6 * norm2 is added."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.slots, w.slots)
        np.testing.assert_array_equal(g.epochs, w.epochs)
        tol = 1e-5 * (1 + np.abs(w.distances)) + 1e-6 * norm2
        assert (np.abs(g.distances - w.distances) <= tol).all()


def assert_same_up_to_ties(got, want):
    """As assert_same, but rows at equal distance (the point-mass rows)
    compare as sets of (distance, slot): torch.topk and lax.top_k order
    ties differently. The last tie group may be cut by k differently on
    each side: only its size is compared."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.slots.size == w.slots.size
        assert (np.abs(g.distances - w.distances) <= 1e-5 * (1 + np.abs(w.distances))).all()
        groups = np.r_[0, np.flatnonzero(np.diff(w.distances) > 1e-5 * (1 + np.abs(w.distances[1:]))) + 1]
        for lo, hi in zip(groups[:-1], groups[1:]):
            assert set(g.slots[lo:hi].tolist()) == set(w.slots[lo:hi].tolist())
            assert set(g.epochs[lo:hi].tolist()) == set(w.epochs[lo:hi].tolist())
