"""Local (per-partition) I8 and B1 indexes: the port's flat engine against
the JAX FlatDeviceIndex on the same mutations and queries, on the CPU.

The mutations are tests/test_torch_engine_flat_local.py's: 400 rows in 8
partitions, removes (so buckets hold swap-removed positions), moves, a
re-add, a partition past pmax 128 (the doubling to 256) and P_cap growth.
Lossy storage never reaches the JAX package's partition kernel (its gate
admits F32/F16/BF16), so a query naming its partition takes the exact
gather of its bucket and the bf16 rescore tier on both sides. Rules:

- the directory is equal element for element, and the port keeps no
  partition-major mirror for these kinds;
- the gather (``_part_gather`` against the JAX ``_part_search``) returns
  the same distances and, both breaking ties to the earlier bucket
  position, the same slots; the tier (``_rescore_stage``) re-ranks them to
  the same slots, distances within 1e-5 relative;
- ``search`` at one candidate count (k 16: the JAX engine's k bucket 16 x
  oversample 4 = 64 candidates from a bucket on both sides) answers like
  the JAX engine with rescoring on and off, through the directory, the
  masked scan (a query without a partition) and a slot filter: the same
  slots and epochs, distances within 1e-6 of the row's largest;
- ``load_state`` from a JAX engine of each kind answers the same;
- ``device_bytes`` counts the directory and the rescore tier and no
  mirror, as the JAX engine does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import math  # noqa: E402

from test_torch_b1 import jax_flat_state  # noqa: E402
from test_torch_engine_flat_local import D, port_index  # noqa: E402
from test_torch_i8 import assert_same_topk  # noqa: E402
from torch_parity import to_jax  # noqa: E402
from vector_store_tpu.ops import distance as jdist  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.ops import distance  # noqa: E402
from vector_store_tpu_torch.ops import partition_scan as ps  # noqa: E402

I8, B1, BF16 = Quantization.I8, Quantization.B1, Quantization.BF16
KINDS = [(I8, SpaceType.COSINE), (I8, SpaceType.EUCLIDEAN), (B1, SpaceType.COSINE), (B1, SpaceType.DOT_PRODUCT)]
IDS = ["i8-cosine", "i8-euclidean", "b1-cosine", "b1-dot"]
# partition 0 outgrew pmax 128 and lost rows 0 and 24; 2 and 3 took moves
# and removes; 200 came with P_cap growth; 7777 holds no row
PSEL = np.array([0, 2, 3, 0, 200, 7777], np.int32)


def queries_for(vecs):
    return np.concatenate([vecs[[10, 11, 2, 450]], vecs[700:702] + 0.01]) + 0.05


def assert_same_results(got, want, keep=None, q=None):
    """Equal slots and epochs, distances within 1e-6 of the row's largest
    (or of the query's |q|^2, given ``q``: euclidean distances cancel
    |q|^2 + |v|^2 - 2 q.v, summed in another order). ``keep(row, slots)``
    selects the JAX rows that its query may see (see
    test_local_lossy_search_matches_jax)."""
    for row, (a, b) in enumerate(zip(got, want)):
        if keep is not None:
            ok = keep(row, b.slots)
            b = type(b)(slots=b.slots[ok], epochs=b.epochs[ok], distances=b.distances[ok])
            a = a.truncated(b.slots.size)
        np.testing.assert_array_equal(a.slots, b.slots)
        np.testing.assert_array_equal(a.epochs, b.epochs)
        scale = 0.0 if q is None else float(np.square(q[row]).sum())
        atol = 1e-6 * max(1.0, scale, float(np.abs(b.distances).max(initial=0.0)))
        np.testing.assert_allclose(a.distances, b.distances, rtol=1e-6, atol=atol)


@pytest.mark.parametrize("quant,space", KINDS, ids=IDS)
def test_directory_gather_and_tier_match_jax(quant, space):
    from vector_store_tpu.engine import flat as jflat

    pair, vecs, n = lossy_pair(space, quant)
    p, j = pair.p, pair.j
    pair.assert_same_directory(n)
    assert p._part_rows_host.shape == (512, 256) and p._part_directory_wins()
    assert p.part_vecs is None and j.part_vecs is None  # no mirror for lossy storage
    q = queries_for(vecs)
    if p.normalize:
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    bsel = np.array([p._part_bucket.get(int(x), -1) for x in PSEL], np.int32)
    assert bsel[-1] == -1 and (bsel[:-1] >= 0).all()
    qs, q_aux = distance.prepare_queries(q, space, quant)
    jqs, jq_aux = jdist.prepare_queries(q, to_jax(space), to_jax(quant))
    kc = 64
    dist, slots = p._part_gather(qs, torch.from_numpy(bsel), kc)
    packed = jflat._part_search(
        j.vectors, j.aux, j.epochs, j.valid, j.part_rows, jnp.asarray(jqs), jnp.asarray(jq_aux),
        jnp.asarray(bsel), space=to_jax(space), quant=to_jax(quant), k=kc,
    )
    jd, ji, _ = jflat.unpack_results(np.asarray(packed))
    finite = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(dist.numpy()), finite)
    assert_same_topk(np.where(finite, dist.numpy(), 0), slots.numpy(), np.where(finite, jd, 0), ji)
    np.testing.assert_array_equal(slots.numpy()[~finite], -1)
    assert not np.isin(slots.numpy(), [0, 24, 16, 3, 250]).any()  # removed rows stay out

    rqs, rq_aux = distance.prepare_queries(q, space, BF16)
    jrqs, jrq_aux = jdist.prepare_queries(q, to_jax(space), to_jax(BF16))
    got_d, got_i = p._rescore_stage(slots, rqs, rq_aux, 16)
    jres = jflat._rescore_stage(
        packed, j.rescore_vectors, j.rescore_aux, jnp.asarray(jrqs), jnp.asarray(jrq_aux),
        space=to_jax(space), k=16,
    )
    rd, ri, _ = jflat.unpack_results(np.asarray(jres))
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(got_i.numpy()[~fin], -1)
    assert_same_topk(np.where(fin, got_d.numpy(), 0), got_i.numpy(), np.where(fin, rd, 0), ri, rtol=1e-5)


@pytest.mark.parametrize("rescoring", (True, False), ids=["rescore", "no-rescore"])
@pytest.mark.parametrize("quant,space", KINDS, ids=IDS)
def test_local_lossy_search_matches_jax(quant, space, rescoring):
    pair, vecs, n = lossy_pair(space, quant, rescoring)
    p, j = pair.p, pair.j
    assert p.rescore is j.rescore is rescoring
    q = queries_for(vecs)
    launches = ps.partition_scan.launches
    # the directory
    assert_same_results(p.search(q, 16, partitions=PSEL), j.search(q, 16, partitions=PSEL), q=q)
    # A query without a partition sends the batch to the masked scan, and so
    # does a slot filter. Where a partition holds fewer allowed rows than
    # the scan fetches, the JAX engine's rescore tier also ranks the empty
    # candidates, whose slots it keeps, and returns rows of other
    # partitions or filtered out (ROADMAP queue 3, a fault of the JAX
    # package): the rows a query may see are compared.
    allow = np.zeros(p.capacity, bool)
    allow[:n:3] = True
    for psel, mask in ((np.array([0, -1, 3, 0, 200, 5], np.int32), None), (PSEL, allow)):
        def keep(row, slots, psel=psel, mask=mask):
            ok = p._valid_host[slots] & ((psel[row] < 0) | (p._slot_part[slots] == psel[row]))
            return ok if mask is None else ok & mask[slots]

        got = p.search(q, 16, partitions=psel, allow_mask=mask)
        assert all(keep(row, r.slots).all() for row, r in enumerate(got))
        assert_same_results(got, j.search(q, 16, partitions=psel, allow_mask=mask), keep, q)
    assert ps.partition_scan.launches == launches  # no kernel 3 for lossy storage


# a lossy index takes the directory while pmax <= PART_CROSSOVER_LOSSY x
# capacity: pmax 256 wants 12,191 rows of capacity
CAPACITY = 16384


def lossy_pair(space, quant, rescoring=True):
    """tests/test_torch_engine_flat_local.py's mutated_pair, the port's
    engine at CAPACITY rows and both with the index option ``rescoring``
    from their construction."""
    import test_torch_engine_flat_local as local

    from vector_store_tpu_torch.engine.flat import LOCAL_RESERVE_INCREMENT, FlatDeviceIndex

    def jax_index(s, q):
        j = real[0](s, q)
        if not rescoring:
            j.rescoring = j.rescore = False
            j.oversample = 1
        return j

    def port(s, q):
        return FlatDeviceIndex(
            D, s, q, device=torch.device("cpu"), initial_capacity=CAPACITY, block_rows=128,
            reserve_increment=LOCAL_RESERVE_INCREMENT, rescoring=rescoring,
        )

    real = local.jax_index, local.port_index
    try:
        local.jax_index, local.port_index = jax_index, port
        return local.mutated_pair(space, quant)
    finally:
        local.jax_index, local.port_index = real


@pytest.mark.parametrize("quant,space", KINDS[::2], ids=IDS[::2])
def test_load_state_from_jax_local_engine(quant, space):
    pair, vecs, n = lossy_pair(space, quant)
    j = pair.j
    port = port_index(space, quant)
    port.load_state(jax_flat_state(j))
    assert port.size == j.size and port._vecs_host is None and port.part_vecs is None
    port.reserve(CAPACITY - 1)  # as large a table as the pair's: the directory serves
    assert port._part_directory_wins()
    np.testing.assert_array_equal(port._part_rows_host, j._part_rows_host)
    q = queries_for(vecs)
    assert_same_results(port.search(q, 16, partitions=PSEL), j.search(q, 16, partitions=PSEL))
    # the loaded engine keeps taking mutations like the JAX one
    pair.p = port
    pair.upsert([3, 900], vecs[[3, 901]], [5, 5], epoch=4)
    pair.remove([11])
    pair.assert_same_directory(n + 1)
    assert_same_results(port.search(q, 16, partitions=PSEL), j.search(q, 16, partitions=PSEL))


@pytest.mark.parametrize("quant", (I8, B1))
def test_device_bytes_count_directory_and_tier(quant):
    """A local I8 or B1 index adds its directory and no mirror, as the JAX
    engine; the rescore tier is counted from the start."""
    p = port_index(SpaceType.COSINE, quant)
    before = p.device_bytes
    assert before == p.capacity * (p.dp * p.vectors.element_size() + 16 + 2 * p.dp_rescore + 4)
    p.upsert_batch(np.arange(10), np.zeros(10, np.int32), np.ones((10, D), np.float32), partitions=[1] * 10)
    assert p.device_bytes - before == 4 * 256 * 128  # P_cap 256 x pmax 128, i32


def test_crossover_rule_for_lossy_storage(monkeypatch):
    """A lossy index takes the directory while pmax <= PART_CROSSOVER_LOSSY
    x capacity, the masked integer scan beyond, with the same exact
    answer (test_torch_engine_flat_local.py::test_crossover_rule's shape)."""
    from vector_store_tpu_torch.engine.flat import PART_CROSSOVER, PART_CROSSOVER_LOSSY, FlatDeviceIndex

    assert PART_CROSSOVER_LOSSY < PART_CROSSOVER
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(300, D)).astype(np.float32)
    # partition 0's 250 rows give pmax 256: a table too small for it to take
    # the directory (the float rule would take it), then one large enough
    idx = port_index(SpaceType.COSINE, I8, capacity=2048)
    idx.upsert_batch(np.arange(300), np.zeros(300, np.int32), vecs, partitions=(np.arange(300) >= 250))
    pmax = idx._part_rows_host.shape[1]
    assert pmax == 256 and PART_CROSSOVER_LOSSY * idx.capacity < pmax <= PART_CROSSOVER * idx.capacity
    assert not idx._part_directory_wins()
    calls = []
    orig = FlatDeviceIndex._part_gather
    monkeypatch.setattr(FlatDeviceIndex, "_part_gather", lambda self, *a: calls.append(1) or orig(self, *a))
    q, psel = vecs[[3, 260]] + 0.05, np.array([0, 1], np.int32)
    masked = idx.search(q, 10, partitions=psel)
    assert calls == []
    idx.reserve(math.ceil(pmax / PART_CROSSOVER_LOSSY))
    assert idx._part_directory_wins()
    gathered = idx.search(q, 10, partitions=psel)
    assert calls == [1]
    for a, b in zip(gathered, masked):
        np.testing.assert_array_equal(a.slots, b.slots)
        np.testing.assert_allclose(a.distances, b.distances, rtol=1e-6, atol=1e-6)
    assert masked[0].slots[0] == 3 and masked[1].slots[0] == 260
