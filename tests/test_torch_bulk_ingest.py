"""Bulk ingest of rows already on the device (``upsert_bulk_device``): the
port's twins of tests/test_bulk_ingest.py's flat and IVF cases, on the CPU,
and one parity case against the JAX IVF engine.

The JAX tests feed the device half of benchkit/synth.py (rows generated
on the TPU); the port keeps only the numpy half, so the host rows, copied
to the device, stand in for it. Contracts:

- an index bulk-loaded serves what one built by host upserts serves, for
  each space and storage, and with partitions;
- bulk ingest refuses occupied slots, and the IVF engine refuses a block
  whose delta positions are taken (positions equal slots on this path);
- an IVF index bulk-loaded serves from its delta, rebuilds into its main
  region and takes mutations after; float storage at >= 512 dimensions
  fetches 2x ids and returns k rows in exact order;
- below ``min_build`` the port's and the JAX IVF engines, bulk-loaded with
  the same rows, return the same slots and distances within 1e-5 (the
  JAX delta's Pallas kernel in interpret mode at the port's scan block,
  as tests/test_torch_engine_ivf.py runs it).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vector_store_tpu_torch.benchkit import synth  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.engine.flat import FlatDeviceIndex  # noqa: E402
from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex  # noqa: E402

CPU = torch.device("cpu")


def dev(rows: np.ndarray) -> torch.Tensor:
    """The device copy of host rows (the stand-in for synth_rows_jax)."""
    return torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32)).to(CPU)


def recall(res, gt, k):
    return np.mean([len(set(r.slots.tolist()) & set(gt[i].tolist())) / k for i, r in enumerate(res)])


@pytest.mark.parametrize(
    "space,quant",
    [
        (SpaceType.COSINE, Quantization.BF16),
        (SpaceType.EUCLIDEAN, Quantization.F32),
        (SpaceType.COSINE, Quantization.I8),
        (SpaceType.DOT_PRODUCT, Quantization.F16),
    ],
)
def test_flat_bulk_matches_host_upsert(space, quant):
    n, d, k = 600, 48, 10
    rows_host = synth.synth_rows_np(11, 0, n, d, 16)
    queries = rows_host[:32] + 0.05

    ref = FlatDeviceIndex(d, space_type=space, quantization=quant, device=CPU, initial_capacity=n)
    ref.upsert_batch(np.arange(n), np.zeros(n, np.int32), rows_host)
    bulk = FlatDeviceIndex(d, space_type=space, quantization=quant, device=CPU, initial_capacity=n)
    bulk.upsert_bulk_device(0, n, dev(rows_host), rows_host)

    assert bulk.size == ref.size == n
    r_ref, r_blk = ref.search(queries, k), bulk.search(queries, k)
    for a, b in zip(r_ref, r_blk):
        np.testing.assert_allclose(np.sort(a.distances), np.sort(b.distances), atol=2e-3)
    overlap = np.mean([len(set(a.slots.tolist()) & set(b.slots.tolist())) / k for a, b in zip(r_ref, r_blk)])
    assert overlap >= 0.9


def test_flat_bulk_rejects_occupied_slots():
    d = 16
    idx = FlatDeviceIndex(d, space_type=SpaceType.COSINE, quantization=Quantization.BF16, device=CPU,
                          initial_capacity=64)
    idx.upsert_batch(np.array([3]), np.array([0]), np.ones((1, d), np.float32))
    rows = synth.synth_rows_np(1, 0, 8, d, 4)
    with pytest.raises(ValueError, match="fresh slots"):
        idx.upsert_bulk_device(0, 8, dev(rows), rows)


def test_flat_bulk_with_partitions():
    n, d = 128, 16
    rows_host = synth.synth_rows_np(5, 0, n, d, 4)
    parts = np.arange(n) % 3
    idx = FlatDeviceIndex(d, space_type=SpaceType.COSINE, quantization=Quantization.BF16, device=CPU,
                          initial_capacity=n)
    idx.upsert_bulk_device(0, n, dev(rows_host), rows_host, partitions=parts)
    for r in idx.search(rows_host[:8], k=5, partitions=np.full((8,), 1, np.int32)):
        assert r.slots.size and all(int(s) % 3 == 1 for s in r.slots)


def test_ivf_bulk_serves_and_rebuilds():
    n, d, k = 2048, 32, 10
    rows_host = synth.synth_rows_np(23, 0, n, d, 24)
    queries = rows_host[:64]
    idx = IvfDeviceIndex(d, space_type=SpaceType.COSINE, quantization=Quantization.BF16, device=CPU,
                         initial_capacity=n, min_build=1024, nprobe=8)
    idx.upsert_bulk_device(0, n, dev(rows_host), rows_host)
    assert idx.size == n and idx._delta_next == n
    np.testing.assert_array_equal(idx._delta_pos2slot_host[:n], np.arange(n))
    np.testing.assert_array_equal(idx._delta_pos2slot[:n].numpy(), np.arange(n))

    norm = rows_host / np.linalg.norm(rows_host, axis=-1, keepdims=True)
    gt = np.argsort(1.0 - norm[:64] @ norm.T, axis=1)[:, :k]
    # before the build every query is served by the delta (exact)
    assert recall(idx.search(queries, k), gt, k) >= 0.95
    # the build moves the block into the clustered main region
    while idx.maintain():
        pass
    assert idx.main_vecs is not None and idx._main_rows > 0
    assert recall(idx.search(queries, k), gt, k) >= 0.9
    # a mutation on top of the bulk block
    idx.upsert_batch(np.array([n + 1]), np.array([1]), rows_host[:1] * 0.5)
    assert idx.size == n + 1


def test_ivf_high_dim_oversample_contract():
    """Float storage at >= 512 dims fetches 2x ids; results still honor k
    and arrive in exact-rescored (sorted) order."""
    n, d, k = 3072, 512, 10
    rows_host = synth.synth_rows_np(31, 0, n, d, 16)
    idx = IvfDeviceIndex(d, space_type=SpaceType.COSINE, quantization=Quantization.BF16, device=CPU,
                         initial_capacity=n, min_build=1024, nprobe=8)
    assert idx.oversample == 2
    idx.upsert_bulk_device(0, n, dev(rows_host), rows_host)
    while idx.maintain():
        pass
    res = idx.search(rows_host[:32], k)
    norm = rows_host / np.linalg.norm(rows_host, axis=-1, keepdims=True)
    gt = np.argsort(1.0 - norm[:32] @ norm.T, axis=1)[:, :k]
    for r in res:
        assert len(r.slots) <= k
        assert np.all(np.diff(r.distances) >= -1e-6)
    assert recall(res, gt, k) >= 0.95


def test_ivf_bulk_rejects_overlap():
    d = 16
    rows = synth.synth_rows_np(1, 0, 8, d, 4)
    idx = IvfDeviceIndex(d, space_type=SpaceType.COSINE, quantization=Quantization.BF16, device=CPU,
                         initial_capacity=64)
    idx.upsert_batch(np.array([2]), np.array([0]), np.ones((1, d), np.float32))
    with pytest.raises(ValueError, match="fresh slots"):
        idx.upsert_bulk_device(0, 8, dev(rows), rows)
    # slots 2 and 40 took delta positions 0 and 1: a block of fresh slots
    # over those positions is refused
    idx.upsert_batch(np.array([40]), np.array([0]), np.ones((1, d), np.float32))
    with pytest.raises(ValueError, match="occupied delta positions"):
        idx.upsert_bulk_device(0, 2, dev(rows[:2]), rows[:2])
    assert idx.size == 2 and idx._delta_next == 2


def test_ivf_bulk_parity_with_jax(monkeypatch):
    """The same seeded rows bulk-ingested into the JAX and the port IVF
    engines below min_build: the same slots, distances within 1e-5."""
    jnp = pytest.importorskip("jax.numpy")
    import vector_store_tpu.ops.pallas_scan as ps
    from torch_parity import to_jax
    from vector_store_tpu.engine.ivf import IvfDeviceIndex as JaxIvf

    n, d, k, block = 3000, 32, 10, 8192
    space = SpaceType.EUCLIDEAN
    rows_host = synth.synth_rows_np(7, 0, n, d, 24)
    queries = rows_host[::100] + 0.01
    j = JaxIvf(d, space_type=to_jax(space), quantization=to_jax(Quantization.F32), initial_capacity=4096,
               interpret=True, query_i8=False, approx_select=False)
    j._delta.pallas_block = block
    p = IvfDeviceIndex(d, space_type=space, quantization=Quantization.F32, device=CPU, initial_capacity=4096,
                       scan_block_rows=block)
    for lo, hi in ((0, 1024), (1024, n)):
        j.upsert_bulk_device(lo, hi, jnp.asarray(rows_host[lo:hi]), rows_host[lo:hi])
        p.upsert_bulk_device(lo, hi, dev(rows_host[lo:hi]), rows_host[lo:hi])
    assert p.size == j.size == n and p.main_vecs is None and j.main_vecs is None
    np.testing.assert_array_equal(p._delta_pos2slot_host[:n], np.asarray(j._delta_pos2slot_host)[:n])

    orig = ps.pallas_rank_search
    monkeypatch.setattr(ps, "pallas_rank_search", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    for g, w in zip(p.search(queries, k), j.search(queries, k)):
        np.testing.assert_array_equal(g.slots, w.slots)
        np.testing.assert_allclose(g.distances, w.distances, rtol=0, atol=1e-5)
