"""Kernel 2 over the compact pair list (``ops/ivf.py::compact_pairs`` and
``grouped_scan_pairs``, the search path) against the dense slot plane of
the JAX package and the port, on the CPU.

- The compact regroup against the port's ``regroup_pairs`` and the JAX
  ``_regroup_pairs`` (both sorts): the same pairs kept, each kept pair at
  dense slot c * s + (its position - starts[c]), counts min(pairs, s).
- ``grouped_scan_pairs``'s plain version against the JAX Pallas kernel in
  interpret mode on the filled slots of the same pairs, F32, BF16 and I8.
- ``ivf_candidates`` (compact) against the port's dense pipeline and the
  JAX ``ivf_candidates`` at a boosted budget, with drops present.

Tolerances: ranks within 1e-5 * (1 + |r|) (the same f32 products summed
in another order), positions equal outside near ties; the regroup and the
dropped counts exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from vector_store_tpu.ops import ivf as jivf  # noqa: E402
from vector_store_tpu_torch.ops import fused_scan, ivf  # noqa: E402

LANES = fused_scan.LANES
RTOL = 1e-5


def _probes(layout: str, seed: int = 0):
    """[B, nprobe] cluster ids, distinct within a row, and the (nlist, s)
    the layout is cut for: balanced (random clusters), skewed (most
    queries take cluster 0 and 1, past s), sentinel (padding rows and
    pairs another shard owns at ids >= nlist), s >= B (nothing drops)."""
    rng = np.random.default_rng(seed)
    nlist, b, nprobe, s = 12, 40, 3, 8
    probes = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(b)])
    if layout == "skewed":
        probes[:30, 0], probes[:30, 1] = 0, 1
        probes[:30, 2] = 2 + rng.integers(0, nlist - 2, size=30)
    elif layout == "sentinel":
        probes[rng.random(probes.shape) < 0.3] = nlist
        probes[-5:] = nlist + 3
    elif layout == "s_ge_b":
        probes[:, 0] = 4
        s = 64
    return probes.astype(np.int64), nlist, s


@pytest.mark.parametrize("fallback", (False, True))
@pytest.mark.parametrize("layout", ("balanced", "skewed", "sentinel", "s_ge_b"))
def test_compact_pairs_match_the_dense_regroups(layout, fallback):
    probes, nlist, s = _probes(layout)
    b, nprobe = probes.shape
    qidx, starts, counts, row_of_pair = ivf.compact_pairs(torch.from_numpy(probes), nlist=nlist, s=s)
    qtab, filled, drow = ivf.regroup_pairs(torch.from_numpy(probes), nlist=nlist, s=s)
    jq, jfilled, jrow = (np.asarray(x) for x in jivf._regroup_pairs(
        jnp.asarray(probes.astype(np.int32)), nlist=nlist, s=s, nprobe=nprobe, force_fallback=fallback))
    assert qidx.shape == (b * nprobe,) and starts.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(drow.numpy(), jrow)  # the port's dense regroup is the JAX one
    np.testing.assert_array_equal(filled.numpy(), jfilled)
    np.testing.assert_array_equal(qtab.numpy()[jfilled], jq[jfilled])

    kept = row_of_pair.numpy() >= 0
    np.testing.assert_array_equal(kept, jrow >= 0)  # the same pairs drop
    dropped = ((row_of_pair < 0) & (torch.from_numpy(probes) < nlist)).sum(1)
    np.testing.assert_array_equal(dropped.numpy(), ((jrow < 0) & (probes < nlist)).sum(1))
    np.testing.assert_array_equal(counts.numpy(), jfilled.reshape(nlist, s).sum(1))
    np.testing.assert_array_equal(
        counts.numpy(), np.minimum(np.bincount(probes[probes < nlist], minlength=nlist), s)
    )
    # a kept pair sits at its cluster's run, in arrival order, at dense slot c * s + rank
    pos, c = row_of_pair.numpy()[kept], probes[kept]
    rank = pos - starts.numpy()[c]
    assert ((rank >= 0) & (rank < counts.numpy()[c])).all()
    np.testing.assert_array_equal(c * s + rank, jrow[kept])
    np.testing.assert_array_equal(qidx.numpy()[pos], np.nonzero(kept)[0])
    for cl in range(nlist):
        run = qidx.numpy()[starts[cl] : starts[cl] + counts[cl]]
        np.testing.assert_array_equal(run, jq[cl * s : cl * s + counts[cl]])
    if layout == "skewed":
        assert dropped.sum() > 0
    if layout == "s_ge_b":
        assert dropped.sum() == 0


def _scan_case(storage: str, seed: int = 5):
    """Unit rows of nlist clusters and unit queries; cluster 1 has no live
    row. i8: the I8 codes round(127 v) under bf16 queries, the scale folded
    into a."""
    rng = np.random.default_rng(seed)
    nlist, cmax, d, nq = 6, 256, 48, 40
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)  # noqa: E731
    rows = torch.from_numpy(unit(rng.normal(size=(nlist * cmax, d))).astype(np.float32))
    q = torch.from_numpy(unit(rng.normal(size=(nq, d))).astype(np.float32))
    a = torch.full((nlist * cmax,), -1.0)
    if storage == "i8":
        vs, qs = torch.round(rows * 127).to(torch.int8), q.to(torch.bfloat16)
        a = -1.0 / vs.float().norm(dim=1)
    else:
        dt = {"f32": torch.float32, "bf16": torch.bfloat16}[storage]
        vs, qs = rows.to(dt), q.to(dt)
    b = torch.zeros(nlist * cmax)
    b[torch.from_numpy(rng.random(nlist * cmax) < 0.2)] = fused_scan.INVALID_BIAS
    b[cmax : 2 * cmax] = fused_scan.INVALID_BIAS
    probes = np.stack([rng.permutation(nlist)[:3] for _ in range(nq)])
    probes[:20, 0] = 0  # cluster 0 takes 20+ pairs: past s 16
    return vs, qs, a, b, torch.from_numpy(probes), nlist, cmax


def _jax_rows(x: torch.Tensor):
    dt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}[x.dtype]
    return jnp.asarray(np.pad(x.float().numpy(), [(0, 0), (0, -x.shape[1] % 128)]), dt)


def _jpaux(a, b):
    paux = np.zeros((8, a.shape[0]), np.float32)
    paux[0], paux[1] = a.numpy(), b.numpy()
    return jnp.asarray(paux)


@pytest.mark.parametrize("storage", ("f32", "bf16", "i8"))
def test_pairs_plain_matches_pallas_kernel_on_the_filled_slots(storage):
    vs, qs, a, b, probes, nlist, cmax = _scan_case(storage)
    s = 16
    qidx, starts, counts, row_of_pair = ivf.compact_pairs(probes, nlist=nlist, s=s)
    rank, row = ivf.grouped_scan_pairs(qs[qidx], vs, a, b, starts, counts, cmax=cmax)  # CPU: plain
    assert rank.shape == row.shape == (qidx.shape[0], LANES) and row.dtype == torch.int32

    qtab, filled, drow = ivf.regroup_pairs(probes, nlist=nlist, s=s)
    jr, jo = jivf._grouped_scan(_jax_rows(qs[qtab]), _jax_rows(vs), _jpaux(a, b), s=s, cmax=cmax, interpret=True)
    slot = np.arange(nlist * s)[:, None]
    jpos = (slot // s) * cmax + np.asarray(jo).astype(np.int64) + np.arange(LANES)
    kept = row_of_pair >= 0
    assert not kept.all()  # cluster 0 dropped pairs
    mine, theirs = row_of_pair[kept].numpy(), drow[kept].numpy()
    np.testing.assert_allclose(rank.numpy()[mine], np.asarray(jr)[theirs], rtol=RTOL, atol=RTOL)

    # positions: equal unless the runner-up of the lane ties the winner
    cl = probes[kept].numpy()
    qf, vf = qs[qidx[mine]].float(), vs.float().view(nlist, cmax, -1)
    full = a.view(nlist, 1, cmax)[cl] * torch.einsum("pd,prd->pr", qf, vf[cl])[:, None, :] + b.view(nlist, 1, cmax)[cl]
    two = torch.topk(full.view(len(mine), cmax // LANES, LANES), 2, dim=1, largest=False).values
    ok = ((two[:, 1] - two[:, 0]).abs() > RTOL * (1 + two[:, 0].abs())).numpy()
    ok[cl == 1] = True  # the dead cluster's exact ties go to the first row on both sides
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(row.numpy()[mine][ok], jpos[theirs][ok])
    # unscanned pairs: the plain version's sentinel rows
    unscanned = np.setdiff1d(np.arange(qidx.shape[0]), mine)
    assert (rank.numpy()[unscanned] == fused_scan.INVALID_BIAS).all() and (row.numpy()[unscanned] == -1).all()


def test_grouped_scan_pairs_refuses_bad_inputs():
    vs, qs, a, b, probes, nlist, cmax = _scan_case("f32")
    qidx, starts, counts, _ = ivf.compact_pairs(probes, nlist=nlist, s=16)
    with pytest.raises(ValueError, match="int32"):
        ivf.grouped_scan_pairs(qs[qidx], vs, a, b, starts.long(), counts, cmax=cmax)
    with pytest.raises(ValueError, match="int32"):
        ivf.grouped_scan_pairs(qs[qidx], vs, a, b, starts, counts[:-1], cmax=cmax)
    with pytest.raises(ValueError, match="cmax"):
        ivf.grouped_scan_pairs(qs[qidx], vs, a, b, starts, counts, cmax=cmax + 8)


@pytest.mark.parametrize("spherical", (False, True))
@pytest.mark.parametrize("s", (16, 32))
def test_ivf_candidates_compact_matches_dense_and_jax(spherical, s):
    """At the serving budget (16) and a boosted one (32), a skewed batch
    still dropping pairs: the compact path's (rank, pos, dropped) are the
    dense pipeline's and the JAX package's."""
    rng = np.random.default_rng(11)
    nlist, cmax, d, nq, k, nprobe = 8, 256, 32, 56, 10, 3
    centers = rng.normal(size=(nlist, d)).astype(np.float32) * 3
    rows = np.repeat(centers, cmax, axis=0) + rng.normal(size=(nlist * cmax, d)).astype(np.float32)
    rows = np.pad(rows, [(0, 0), (0, 128 - d)])
    vs = torch.from_numpy(rows)
    a = torch.full((nlist * cmax,), -2.0)
    b = vs.square().sum(1)
    b[torch.from_numpy(rng.random(nlist * cmax) < 0.1)] = fused_scan.INVALID_BIAS
    near = rng.integers(0, nlist, size=nq)
    near[:40] = 0  # 40 queries near cluster 0: past s 32
    q = np.pad(centers[near] + 0.5 * rng.normal(size=(nq, d)).astype(np.float32), [(0, 0), (0, 128 - d)])
    qs, cent = torch.from_numpy(q), torch.from_numpy(np.pad(centers, [(0, 0), (0, 128 - d)]))
    live = np.ones(nq, bool)
    live[-4:] = False
    tl = torch.from_numpy(live)

    rank, pos, dropped = ivf.ivf_candidates(
        vs, a, b, cent, qs, tl, k=k, nprobe=nprobe, s=s, cmax=cmax, spherical=spherical
    )
    assert dropped.sum() > 0
    probes = ivf.ivf_probe(cent, qs, tl, nprobe=nprobe, spherical=spherical)
    qtab, _, drow = ivf.regroup_pairs(probes, nlist=nlist, s=s)
    drank, dpos = ivf.merge_candidates(*ivf.grouped_scan(qs[qtab], vs, a, b, s, cmax), drow, k=k)
    np.testing.assert_allclose(rank.numpy(), drank.numpy(), rtol=RTOL, atol=RTOL)
    np.testing.assert_array_equal(pos.numpy(), dpos.numpy())

    packed, jdropped = jivf.ivf_candidates(
        jnp.asarray(rows), _jpaux(a, b), jnp.asarray(cent.numpy()), jnp.asarray(q), jnp.asarray(live),
        k=k, nprobe=nprobe, s=s, cmax=cmax, spherical=spherical, interpret=True, approx=False,
    )
    packed = np.asarray(packed)
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdropped))
    np.testing.assert_array_equal(pos.numpy(), packed[1].view(np.int32))
    np.testing.assert_allclose(rank.numpy(), packed[0], rtol=RTOL, atol=RTOL)
