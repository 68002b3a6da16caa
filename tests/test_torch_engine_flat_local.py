"""Local (per-partition) indexes: the port's flat engine against the JAX
FlatDeviceIndex on the same mutations and queries.

The JAX engine runs its partition kernel in interpret mode and resolves
the kernel path's ids on its host mirror, set up as
tests/test_engine_flat.py's TestPartitionKernel does. Rules:

- the partition directory (bucket order, swap-remove order) is equal
  element for element after the same adds, moves, removes, pmax growth and
  P_cap growth;
- the kernel path (k <= 128) has exact top-1, an overlap of at least k - 1
  and distances within 1e-4 (group-min may drop one of two true
  neighbours that share a lane);
- the exact paths (the k > 128 bucket gather and the masked scan) return
  exactly the JAX XLA paths' slots, distances within 1e-5.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_parity import to_jax  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.engine import flat as port_flat  # noqa: E402
from vector_store_tpu_torch.engine.flat import (  # noqa: E402
    LOCAL_RESERVE_INCREMENT,
    PART_CROSSOVER,
    FlatDeviceIndex,
)
from vector_store_tpu_torch.ops import partition_scan as ps  # noqa: E402

CPU = torch.device("cpu")
D = 32


def jax_index(space=SpaceType.EUCLIDEAN, quant=Quantization.F32):
    from vector_store_tpu.engine.flat import FlatDeviceIndex as JaxFlat

    idx = JaxFlat(
        D, space_type=to_jax(space), quantization=to_jax(quant), initial_capacity=512, block_rows=64,
        reserve_increment=LOCAL_RESERVE_INCREMENT,
    )
    idx._part_interpret = True
    # the ids-only kernel path resolves distances from the host mirror
    idx.host_distances = True
    idx._vecs_host = np.zeros((idx.capacity, D), dtype=np.float32)
    return idx


def port_index(space=SpaceType.EUCLIDEAN, quant=Quantization.F32, capacity=2048):
    """At 2048 rows of capacity pmax up to 256 stays on the directory."""
    return FlatDeviceIndex(
        D, space_type=space, quantization=quant, device=CPU, initial_capacity=capacity,
        block_rows=128, reserve_increment=LOCAL_RESERVE_INCREMENT,
    )


class Pair:
    """A JAX engine and a port engine fed the same calls."""

    def __init__(self, space=SpaceType.EUCLIDEAN, quant=Quantization.F32):
        self.j, self.p = jax_index(space, quant), port_index(space, quant)

    def upsert(self, slots, vecs, parts, epoch=0):
        slots = np.asarray(slots)
        for idx in (self.j, self.p):
            idx.upsert_batch(
                slots, np.full(slots.size, epoch, np.int32), vecs,
                partitions=np.asarray(parts, np.int32),
            )

    def remove(self, slots):
        for idx in (self.j, self.p):
            idx.remove_batch(np.asarray(slots))

    def assert_same_directory(self, n):
        j, p = self.j, self.p
        assert p._part_bucket == j._part_bucket
        np.testing.assert_array_equal(p._part_rows_host, j._part_rows_host)
        np.testing.assert_array_equal(p._part_count, j._part_count)
        np.testing.assert_array_equal(p._slot_pos[:n], j._slot_pos[:n])
        np.testing.assert_array_equal(p._slot_part[:n], j._slot_part[:n])
        assert tuple(p.part_rows.shape) == p._part_rows_host.shape
        np.testing.assert_array_equal(p.part_rows.numpy(), p._part_rows_host)


def assert_kernel_like(got, want, k):
    """Kernel-path rule: exact top-1, overlap >= k - 1, distances 1e-4."""
    for a, b in zip(got, want):
        assert a.slots[0] == b.slots[0], (a.slots, b.slots)
        inter = set(a.slots.tolist()) & set(b.slots.tolist())
        assert len(inter) >= min(k, b.slots.size) - 1, (a.slots, b.slots)
        da, db = dict(zip(a.slots, a.distances)), dict(zip(b.slots, b.distances))
        for s in inter:
            np.testing.assert_allclose(da[s], db[s], rtol=1e-4, atol=1e-4)


def assert_exact(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.slots, b.slots)
        np.testing.assert_array_equal(a.epochs, b.epochs)
        np.testing.assert_allclose(a.distances, b.distances, rtol=1e-5, atol=1e-5)


def jax_gather_path(j, queries, k, psel):
    """The JAX engine's exact XLA gather path for the same query."""
    j._part_interpret = False
    try:
        return j.search(queries, k, partitions=psel)
    finally:
        j._part_interpret = True


def mutated_pair(space=SpaceType.EUCLIDEAN, quant=Quantization.F32, seed=1):
    """400 rows in 8 partitions, then removes, moves, re-adds, one
    partition past pmax 128 and more than 256 partitions (P_cap 512)."""
    rng = np.random.default_rng(seed)
    pair = Pair(space, quant)
    vecs = rng.normal(size=(1200, D)).astype(np.float32)
    n = 400
    pair.upsert(np.arange(n), vecs[:n], np.arange(n) % 8)
    pair.remove([8, 16, 3, 250])
    pair.upsert([2, 5, 17], vecs[[2, 5, 17]], [3, 3, 6], epoch=1)  # moves
    pair.upsert([8], vecs[900:901], [0], epoch=2)  # re-add of a removed slot
    pair.upsert(np.arange(400, 600), vecs[400:600], np.zeros(200))  # pmax 128 -> 256
    pair.upsert(np.arange(600, 900), vecs[600:900], 100 + np.arange(300))  # P_cap 512
    pair.remove([0, 24, 600])
    return pair, vecs, 900


def test_directory_matches_jax_through_mutations():
    pair, _, n = mutated_pair()
    pair.assert_same_directory(n)
    assert pair.p._part_rows_host.shape == (512, 256)
    for part in (0, 1, 3, 6, 100, 399, 7777):
        assert pair.p.partition_count(part) == pair.j.partition_count(part)
    # the mirror holds each listed slot's row at its position
    p = pair.p
    rows = p._part_rows_host.reshape(-1)
    live = rows >= 0
    assert torch.equal(p.part_vecs[torch.from_numpy(live)], p.vectors[torch.from_numpy(rows[live]).long()])
    assert bool((p.part_b[torch.from_numpy(~live)] >= ps.INVALID_CUTOFF).all())


@pytest.mark.parametrize(
    "space,quant",
    [(SpaceType.EUCLIDEAN, Quantization.F32), (SpaceType.COSINE, Quantization.BF16)],
)
def test_kernel_path_matches_jax_kernel(space, quant):
    pair, vecs, _ = mutated_pair(space, quant)
    assert pair.p._part_directory_wins()
    launches = ps.partition_scan.launches
    q = np.concatenate([vecs[[10, 11, 2, 450]], vecs[700:702] + 0.01])
    psel = np.array([2, 3, 3, 0, 200, 201], np.int32)
    for k in (1, 8, 50):  # the JAX kernel path takes k up to its k bucket 64
        assert_kernel_like(pair.p.search(q, k, partitions=psel), pair.j.search(q, k, partitions=psel), k)
    assert pair.j._part_kernel_probed and not pair.j._part_kernel_failed
    assert ps.partition_scan.launches == launches  # CPU: the plain version


def test_exact_paths_match_jax_xla_paths():
    pair, vecs, _ = mutated_pair()
    q = vecs[[10, 11, 450, 451]] + 0.05
    psel = np.array([2, 3, 0, 0], np.int32)
    # k > 128: the exact gather of each bucket (JAX k bucket 256 > 128)
    assert_exact(pair.p.search(q, 200, partitions=psel), pair.j.search(q, 200, partitions=psel))
    # a query without a partition (-1) sends the batch to the masked scan
    psel_all = np.array([2, -1, 0, 7], np.int32)
    for k in (5, 60):
        assert_exact(pair.p.search(q, k, partitions=psel_all), pair.j.search(q, k, partitions=psel_all))


def test_masked_scan_keeps_block_memory(monkeypatch):
    """The masked scan ranks [B, block_rows] at a time and gives the same
    slots as one whole-capacity product."""
    pair, vecs, _ = mutated_pair()
    p = pair.p
    widths = []
    orig = port_flat.pairwise_distance

    def spy(q, block, *a):
        widths.append(block.shape[0])
        return orig(q, block, *a)

    monkeypatch.setattr(port_flat, "pairwise_distance", spy)
    q = vecs[[10, 450]]
    res = p.search(q, 7, partitions=np.array([-1, 0], np.int32))
    assert set(widths) == {p.block_rows} and len(widths) == p.capacity // p.block_rows
    whole = ((q[:, None, :] - p._vecs_host[None]) ** 2).sum(-1)
    whole[0, ~p._valid_host] = np.inf
    whole[1, ~(p._valid_host & (p._slot_part == 0))] = np.inf
    for row, r in enumerate(res):
        np.testing.assert_array_equal(r.slots, np.argsort(whole[row], kind="stable")[:7])


def test_same_partition_update_is_found_by_the_kernel_path():
    """A live row given a new vector in its own partition (a CDC UPDATE of
    the embedding) must be found at its new vector. The JAX engine's
    partition-major mirror misses it: _part_upsert skips rows whose
    partition is unchanged (vector_store_tpu/engine/flat.py:1206-1207), so
    part_vecs keeps the old vector and the JAX kernel path ranks with it;
    its exact gather path finds the row. The port refreshes the row's
    mirror position and its kernel path answers like the JAX gather path."""
    rng = np.random.default_rng(7)
    pair = Pair()
    vecs = rng.normal(size=(200, D)).astype(np.float32)
    pair.upsert(np.arange(200), vecs, np.arange(200) % 4)
    new = rng.normal(size=(1, D)).astype(np.float32)
    pair.upsert([8], new, [0], epoch=1)  # slot 8 stays in partition 0
    assert pair.p._part_directory_wins()
    psel = np.array([0], np.int32)
    got = pair.p.search(new, 5, partitions=psel)[0]
    want = jax_gather_path(pair.j, new, 5, psel)[0]
    assert got.slots[0] == 8 and got.epochs[0] == 1 and abs(got.distances[0]) <= 1e-6
    np.testing.assert_array_equal(got.slots, want.slots)
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        pair.p.part_vecs[int(pair.p._slot_pos[8])].numpy(), pair.p.vectors[8].numpy()
    )


def test_unknown_partition_and_counts():
    pair, vecs, _ = mutated_pair()
    q = vecs[[10]]
    for k in (5, 300):  # kernel path and gather path
        assert pair.p.search(q, k, partitions=np.array([4242], np.int32))[0].slots.size == 0
    # the masked scan (one query without a partition) also finds nothing there
    res = pair.p.search(np.repeat(q, 2, 0), 5, partitions=np.array([4242, -1], np.int32))
    assert res[0].slots.size == 0 and res[1].slots.size == 5
    assert pair.p.partition_count(4242) == 0
    assert pair.p.partition_count(0) == pair.j.partition_count(0) > 128


def test_overflow_falls_back_to_masked_scan(monkeypatch):
    from vector_store_tpu.engine.flat import FlatDeviceIndex as JaxFlat

    monkeypatch.setattr(JaxFlat, "_PART_PMAX_CAP", 128)
    monkeypatch.setattr(FlatDeviceIndex, "_PART_PMAX_CAP", 128)
    rng = np.random.default_rng(3)
    pair = Pair()
    vecs = rng.normal(size=(300, D)).astype(np.float32)
    pair.upsert(np.arange(300), vecs, np.where(np.arange(300) < 200, 0, 1))
    p = pair.p
    assert p._part_overflow and p.part_rows is None and p.part_vecs is None
    assert p.partition_count(0) == 200  # the O(N) count
    q = vecs[[7, 250]]
    psel = np.array([0, 1], np.int32)
    got = p.search(q, 5, partitions=psel)
    assert got[0].slots[0] == 7 and got[1].slots[0] == 250
    assert_exact(got, pair.j.search(q, 5, partitions=psel))


def test_crossover_rule(monkeypatch):
    """The directory serves while pmax <= PART_CROSSOVER * capacity (on the
    H100 both paths grow with the batch); a partition holding a large share
    of the table goes to the masked scan, with the same exact answer."""
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(300, D)).astype(np.float32)
    # partition 0's 250 rows give pmax 256: a table too small for it to
    # take the directory, then (reserve) one just large enough
    idx = port_index(capacity=min(512, math.ceil(256 / PART_CROSSOVER) - 1))
    idx.upsert_batch(np.arange(300), np.zeros(300, np.int32), vecs, partitions=(np.arange(300) >= 250))
    pmax = idx._part_rows_host.shape[1]
    assert pmax == 256 and pmax > PART_CROSSOVER * idx.capacity
    assert not idx._part_directory_wins()
    calls = []
    orig = FlatDeviceIndex._masked_scan
    monkeypatch.setattr(
        FlatDeviceIndex, "_masked_scan", lambda self, *a: calls.append(1) or orig(self, *a)
    )
    q, psel = vecs[[3, 260]] + 0.05, np.array([0, 1], np.int32)
    masked = idx.search(q, 200, partitions=psel)
    assert calls == [1]
    idx.reserve(math.ceil(pmax / PART_CROSSOVER))  # a larger table: the same partition now takes the directory
    assert pmax <= PART_CROSSOVER * idx.capacity and idx._part_directory_wins()
    assert_exact(idx.search(q, 200, partitions=psel), masked)  # the bucket gather
    assert calls == [1]
    assert masked[0].slots[0] == 3 and masked[1].slots[0] == 260 and masked[0].slots.size == 200


def test_load_state_from_jax_engine():
    pair, vecs, n = mutated_pair(SpaceType.COSINE, Quantization.BF16)
    j = pair.j
    port = port_index(SpaceType.COSINE, Quantization.BF16)
    port.load_state({
        "vectors": np.asarray(j.vectors), "paux": np.asarray(j.paux),
        "valid": np.asarray(j.valid), "epochs": np.asarray(j.epochs),
        "_vecs_host": j._vecs_host, "_part_bucket": j._part_bucket,
        "_part_rows_host": j._part_rows_host, "_part_count": j._part_count,
        "_slot_part": j._slot_part, "_slot_pos": j._slot_pos,
        "_part_overflow": j._part_overflow,
    })
    assert port.size == j.size and port.capacity % port.block_rows == 0
    np.testing.assert_array_equal(port._part_rows_host, j._part_rows_host)
    q = vecs[[10, 450, 700]] + 0.02
    psel = np.array([2, 0, 200], np.int32)
    assert_kernel_like(port.search(q, 8, partitions=psel), j.search(q, 8, partitions=psel), 8)
    psel_all = np.array([2, -1, 200], np.int32)
    for k, sel in ((200, psel), (9, psel_all)):  # the bucket gather, the masked scan
        got = port.search(q, k, partitions=sel)
        # the same answers as the port engine that took the mutations itself
        assert_exact(got, pair.p.search(q, k, partitions=sel))
        # the JAX XLA paths rank (and report distances) in bf16 storage
        # precision, the port in exact f32 on its host mirror: same rows
        for a, b in zip(got, j.search(q, k, partitions=sel)):
            assert set(a.slots.tolist()) == set(b.slots.tolist())
    # the loaded engine keeps taking mutations like the JAX one
    pair.p = port
    pair.upsert([3, 900], vecs[[3, 901]], [5, 5], epoch=4)
    pair.remove([11])
    pair.assert_same_directory(n + 1)


def test_device_bytes_count_directory_and_mirror():
    p = port_index()
    before = p.device_bytes
    p.upsert_batch(np.arange(10), np.zeros(10, np.int32), np.ones((10, D), np.float32), partitions=[1] * 10)
    npos = 256 * 128  # P_cap 256 x pmax 128
    assert p.device_bytes - before == 4 * npos + npos * (4 * p.dp + 8)
