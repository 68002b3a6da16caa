"""Kernel 2 (grouped rank scan) and the IVF search around it: the port's
plain version against the JAX Pallas kernel in interpret mode, then
ivf_candidates against the JAX ivf_candidates (exact selectors) on the
same centroids and queries.

Tolerances as for kernel 1: ranks within 1e-5 * (1 + |r|), positions
equal outside near ties. The regroup, probe and merge are exact, so the
packed positions and dropped-pair counts must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import to_jax  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu.ops import ivf as jivf  # noqa: E402
from vector_store_tpu_torch.ops import fused_scan, ivf  # noqa: E402
from vector_store_tpu_torch.ops.distance import prepare_queries  # noqa: E402

NLIST, CMAX, S, D = 8, 256, 16, 32
LANES = fused_scan.LANES
RTOL = 1e-5


def _region(quant, seed=3):
    """A cluster-major region: rows of cluster c near center c; some slots
    empty (dead), as after a real layout."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(NLIST, D)).astype(np.float32) * 3
    rows = np.repeat(centers, CMAX, axis=0) + rng.normal(size=(NLIST * CMAX, D)).astype(np.float32)
    vs, _ = prepare_queries(rows, SpaceType.EUCLIDEAN, quant)
    a, b = fused_scan.paux_coeffs(SpaceType.EUCLIDEAN, vs)
    b[torch.from_numpy(rng.random(NLIST * CMAX) < 0.1)] = fused_scan.INVALID_BIAS
    return centers, vs, a, b


def _jax(x: torch.Tensor, quant):
    from vector_store_tpu.ops.quantize import storage_dtype

    arr = np.pad(x.float().numpy(), [(0, 0), (0, 128 - x.shape[1])])
    return jnp.asarray(arr, storage_dtype(to_jax(quant)))


def _jpaux(a, b):
    paux = np.zeros((8, a.shape[0]), np.float32)
    paux[0], paux[1] = a.numpy(), b.numpy()
    return jnp.asarray(paux)


@pytest.mark.parametrize("quant", (Quantization.F32, Quantization.BF16))
def test_plain_matches_pallas_kernel(quant):
    centers, vs, a, b = _region(quant)
    rng = np.random.default_rng(4)
    q = np.repeat(centers, S, axis=0) + rng.normal(size=(NLIST * S, D)).astype(np.float32)
    qg, _ = prepare_queries(q, SpaceType.EUCLIDEAN, quant)
    rank, pos = ivf.grouped_scan(qg, vs, a, b, s=S, cmax=CMAX)  # CPU: plain
    assert rank.shape == pos.shape == (NLIST * S, LANES) and pos.dtype == torch.int32

    jr, jo = jivf._grouped_scan(_jax(qg, quant), _jax(vs, quant), _jpaux(a, b), s=S, cmax=CMAX, interpret=True)
    cluster = np.arange(NLIST * S)[:, None] // S
    jpos = cluster * CMAX + np.asarray(jo).astype(np.int64) + np.arange(LANES)
    np.testing.assert_allclose(rank.numpy(), np.asarray(jr), rtol=RTOL, atol=RTOL)

    full = torch.stack(
        [
            a[c * CMAX : (c + 1) * CMAX] * (qg[c * S : (c + 1) * S].float() @ vs[c * CMAX : (c + 1) * CMAX].float().T)
            + b[c * CMAX : (c + 1) * CMAX]
            for c in range(NLIST)
        ]
    ).view(NLIST * S, CMAX // LANES, LANES)
    two = torch.topk(full, 2, dim=1, largest=False).values
    ok = ((two[:, 1] - two[:, 0]).abs() > RTOL * (1 + two[:, 0].abs())).numpy()
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(pos.numpy()[ok], jpos[ok])


@pytest.mark.parametrize("spherical", (False, True))
def test_ivf_candidates_match_jax(spherical):
    quant = Quantization.F32
    centers, vs, a, b = _region(quant, seed=5)
    cent = torch.from_numpy(np.pad(centers, [(0, 0), (0, vs.shape[1] - D)]))
    rng = np.random.default_rng(6)
    # skewed batch: most queries near cluster 0, so its S slots overflow
    nq = 48
    near = rng.integers(0, NLIST, size=nq)
    near[:30] = 0
    q = centers[near] + 0.5 * rng.normal(size=(nq, D)).astype(np.float32)
    qs, _ = prepare_queries(q, SpaceType.EUCLIDEAN, quant)
    live = np.ones(nq, bool)
    live[-4:] = False
    k, nprobe = 10, 3

    rank, got_pos, dropped = ivf.ivf_candidates(
        vs, a, b, cent, qs, torch.from_numpy(live),
        k=k, nprobe=nprobe, s=S, cmax=CMAX, spherical=spherical,
    )
    packed, jdropped = jivf.ivf_candidates(
        _jax(vs, quant), _jpaux(a, b), jnp.asarray(np.pad(centers, [(0, 0), (0, 128 - D)])),
        _jax(qs, quant), jnp.asarray(live),
        k=k, nprobe=nprobe, s=S, cmax=CMAX, spherical=spherical, interpret=True, approx=False,
    )
    packed = np.asarray(packed)
    assert np.asarray(jdropped).sum() > 0  # the skew really dropped pairs
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdropped))
    np.testing.assert_array_equal(got_pos.numpy(), packed[1].view(np.int32))
    np.testing.assert_allclose(rank.numpy(), packed[0], rtol=RTOL, atol=RTOL)


def test_regroup_is_first_come_within_cluster():
    probes = torch.tensor([[2, 0], [2, 1], [2, 0], [9, 2]])  # 9: sentinel
    qtab, filled, row_of_pair = ivf.regroup_pairs(probes, nlist=3, s=2)
    # cluster 2 slots go to queries 0 and 1 (arrival order); query 3 drops
    assert qtab[4:6].tolist() == [0, 1] and filled[4:6].all()
    assert row_of_pair.tolist() == [[4, 0], [5, 2], [-1, 1], [-1, -1]]


def test_layout_places_overflow_in_second_choice():
    labels = torch.tensor([0, 0, 0, 1, 0])
    labels2 = torch.tensor([1, 1, 1, 0, 1])
    live = torch.tensor([True, True, True, True, False])
    pos, overflow = ivf.ivf_layout(labels, live, nlist=2, cmax=2, labels2=labels2)
    jpos, jover = jivf.ivf_layout(
        jnp.asarray(labels.numpy()), jnp.asarray(live.numpy()), nlist=2, cmax=2,
        labels2=jnp.asarray(labels2.numpy()),
    )
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(overflow.numpy(), np.asarray(jover))
    assert pos.tolist() == [0, 1, 3, 2, -1]


def test_kmeans_with_generator_finds_clusters():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(4, 8)).astype(np.float32) * 10
    x = torch.from_numpy(np.repeat(centers, 50, axis=0) + rng.normal(size=(200, 8)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    cent, labels = ivf.kmeans(x, None, nlist=8, generator=gen, iters=6, block=64)
    assert cent.shape == (8, 8) and labels.shape == (200,)
    # no learned cluster mixes rows of two true clusters
    truth = torch.arange(200) // 50
    for lbl in labels.unique():
        assert truth[labels == lbl].unique().numel() == 1
    top2 = ivf.kmeans_assign(x, cent, block=64, top2=True)
    assert top2.shape == (200, 2) and torch.equal(top2[:, 0], labels)
