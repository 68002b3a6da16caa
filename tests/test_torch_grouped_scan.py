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


# -- the shapes the CUDA kernel's two cores must get right ---------------------
# (row length, slots a cluster, cmax, clusters): row lengths that are 8 mod 16,
# a slot budget that is no power of two, cmax 384 and 640, and Dp 3072; int8
# rows pad to 16 codes

GROUPED_TAILS = [(72, 24, 384, 4), (136, 20, 640, 3), (8, 1, 128, 3), (3072, 8, 384, 2)]
STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16, "i8": torch.int8}


def _tail_region(d, s, cmax, nlist, storage):
    """Unit rows and queries from numpy; cluster 1 has no live row. i8: the
    I8 codes round(127 v) under bf16 queries, the scale folded into a."""
    rng = np.random.default_rng(d + s)
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)  # noqa: E731
    if storage == "i8":
        d = -(-d // 16) * 16
    rows = torch.from_numpy(unit(rng.normal(size=(nlist * cmax, d))).astype(np.float32))
    q = torch.from_numpy(unit(rng.normal(size=(nlist * s, d))).astype(np.float32))
    a = torch.full((nlist * cmax,), -1.0)
    if storage == "i8":
        vs, qg = torch.round(rows * 127).to(torch.int8), q.to(torch.bfloat16)
        a = -1.0 / vs.float().norm(dim=1)
    else:
        vs, qg = rows.to(STORAGE[storage]), q.to(STORAGE[storage])
    b = torch.zeros(nlist * cmax)
    b[torch.from_numpy(rng.random(nlist * cmax) < 0.2)] = fused_scan.INVALID_BIAS
    b[cmax : 2 * cmax] = fused_scan.INVALID_BIAS
    return vs, qg, a, b


def _jax_rows(x: torch.Tensor):
    """Rows padded with zeros to the Pallas kernel's 128-lane width, in
    their own dtype."""
    dt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}[x.dtype]
    return jnp.asarray(np.pad(x.float().numpy(), [(0, 0), (0, -x.shape[1] % 128)]), dt)


def _cluster_ranks(qg, vs, a, b, s, cmax, nlist):
    return torch.stack(
        [
            a[c * cmax : (c + 1) * cmax] * (qg[c * s : (c + 1) * s].float() @ vs[c * cmax : (c + 1) * cmax].float().T)
            + b[c * cmax : (c + 1) * cmax]
            for c in range(nlist)
        ]
    )  # [nlist, s, cmax]


@pytest.mark.parametrize("storage", ("f32", "bf16", "i8"))
@pytest.mark.parametrize("d,s,cmax,nlist", GROUPED_TAILS)
def test_plain_matches_pallas_kernel_at_tail_shapes(d, s, cmax, nlist, storage):
    vs, qg, a, b = _tail_region(d, s, cmax, nlist, storage)
    rank, pos = ivf.grouped_scan(qg, vs, a, b, s=s, cmax=cmax, g=1)  # CPU: plain
    jr, jo = jivf._grouped_scan(_jax_rows(qg), _jax_rows(vs), _jpaux(a, b), s=s, cmax=cmax, interpret=True)
    cluster = np.arange(nlist * s)[:, None] // s
    jpos = cluster * cmax + np.asarray(jo).astype(np.int64) + np.arange(LANES)
    np.testing.assert_allclose(rank.numpy(), np.asarray(jr), rtol=RTOL, atol=RTOL)
    full = _cluster_ranks(qg, vs, a, b, s, cmax, nlist).view(nlist * s, cmax // LANES, LANES)
    if cmax > LANES:
        two = torch.topk(full, 2, dim=1, largest=False).values
        ok = ((two[:, 1] - two[:, 0]).abs() > RTOL * (1 + two[:, 0].abs())).numpy()
    else:
        ok = np.ones(rank.shape, bool)
    ok[s : 2 * s] = True  # the dead cluster's exact ties go to the first row on both sides
    np.testing.assert_array_equal(pos.numpy()[ok], jpos[ok])
    assert (rank[s : 2 * s] == fused_scan.INVALID_BIAS).all()
    np.testing.assert_array_equal(pos[s : 2 * s].numpy(), np.broadcast_to(cmax + np.arange(LANES), (s, LANES)))


@pytest.mark.parametrize("storage", ("f32", "bf16", "i8"))
def test_plain_matches_numpy_oracle_at_dp_3072(storage):
    d, s, cmax, nlist = 3072, 5, 256, 2
    vs, qg, a, b = _tail_region(d, s, cmax, nlist, storage)
    rank, pos = ivf.grouped_scan(qg, vs, a, b, s=s, cmax=cmax)
    q64, v64 = qg.double().numpy().reshape(nlist, s, d), vs.double().numpy().reshape(nlist, cmax, d)
    full = (
        a.double().numpy().reshape(nlist, 1, cmax) * np.einsum("csd,crd->csr", q64, v64)
        + b.double().numpy().reshape(nlist, 1, cmax)
    ).reshape(nlist * s, cmax)
    want = full.reshape(nlist * s, cmax // LANES, LANES).min(axis=1)
    np.testing.assert_allclose(rank.numpy(), want, rtol=1e-4, atol=1e-4)
    off = pos.numpy().astype(np.int64) - (np.arange(nlist * s)[:, None] // s) * cmax
    assert ((off >= 0) & (off < cmax) & (off % LANES == np.arange(LANES))).all()
    np.testing.assert_allclose(np.take_along_axis(full, off, axis=1), want, rtol=1e-4, atol=1e-4)


def test_grouped_scan_refuses_int8_rows_not_padded_to_16():
    vs, qg, a, b = _tail_region(16, 2, 128, 1, "i8")
    with pytest.raises(ValueError, match="multiple of 16"):
        ivf.grouped_scan(qg[:, :8].contiguous(), vs[:, :8].contiguous(), a, b, s=2, cmax=128)
