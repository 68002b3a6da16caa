"""The CUDA scan kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (the kernels build at first use)
and skip elsewhere. The grouped scan runs at g = 1, 2, 4 and 8 clusters
per block and over int8 rows (the I8 index). On a GPU machine run them with

    python -m pytest tests/test_torch_cuda.py -m cuda

Ranks agree within 1e-4 * (1 + |r|) (f32 sums in another order) and every
returned row is a minimum of its group within that tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vector_store_tpu_torch.ops import fused_scan, ivf  # noqa: E402
from vector_store_tpu_torch.ops import partition_scan as ps  # noqa: E402

pytestmark = pytest.mark.cuda
RTOL = 1e-4
DTYPES = (torch.float32, torch.float16, torch.bfloat16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rows(rng, n, d, device, dtype):
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(device)
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


def _assert_close_to_plain(rank, pos, prank, full):
    assert torch.allclose(rank, prank, rtol=RTOL, atol=RTOL)
    # the kernel's row holds (within tolerance) its group's minimum
    won = full.gather(1, pos.long())
    assert torch.allclose(won, prank, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nq", [1, 17, 64])
def test_fused_scan_matches_plain(cuda, dtype, nq):
    rng = np.random.default_rng(nq)
    cap, d, block = 4096, 136, 1024
    v, q = _rows(rng, cap, d, cuda, dtype), _rows(rng, nq, d, cuda, dtype)
    a = torch.full((cap,), -2.0, device=cuda)
    b = torch.rand(cap, device=cuda)
    b[::7] = fused_scan.INVALID_BIAS
    before = fused_scan.fused_scan.launches
    rank, pos = fused_scan.fused_scan(q, v, a, b, block)
    assert fused_scan.fused_scan.launches == before + 1
    prank, _ = fused_scan.fused_scan_plain(q, v, a, b, block)
    full = a * (q.float() @ v.float().T) + b
    _assert_close_to_plain(rank, pos, prank, full)
    # each candidate lies in its (block, lane) group
    col = torch.arange(rank.shape[1], device=cuda)
    assert torch.equal((pos // block) * fused_scan.LANES + pos % fused_scan.LANES, col.expand_as(pos).int())


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_scan_matches_plain(cuda, dtype):
    rng = np.random.default_rng(1)
    nlist, cmax, s, d = 16, 384, 24, 64
    v = _rows(rng, nlist * cmax, d, cuda, dtype)
    qg = _rows(rng, nlist * s, d, cuda, dtype)
    a = torch.full((nlist * cmax,), -1.0, device=cuda)
    b = torch.zeros(nlist * cmax, device=cuda)
    b[::5] = fused_scan.INVALID_BIAS
    before = ivf.grouped_scan.launches
    rank, pos = ivf.grouped_scan(qg, v, a, b, s, cmax)
    assert ivf.grouped_scan.launches == before + 1
    prank, _ = ivf.grouped_scan_plain(qg, v, a, b, s, cmax)
    full = torch.full((nlist * s, nlist * cmax), float("inf"), device=cuda)
    for c in range(nlist):
        rows = slice(c * cmax, (c + 1) * cmax)
        full[c * s : (c + 1) * s, rows] = a[rows] * (qg[c * s : (c + 1) * s].float() @ v[rows].float().T) + b[rows]
    _assert_close_to_plain(rank, pos, prank, full)


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES + (torch.int8,))
def test_grouped_scan_g_clusters_per_block(cuda, dtype, g):
    """g clusters per block (kernel 4) and the I8 instantiation (int8 rows,
    bf16 queries): the plain version's ranks, and the same output at every
    g."""
    rng = np.random.default_rng(g)
    nlist, cmax, s, d = 16, 256, 20, 48
    v = _rows(rng, nlist * cmax, d, cuda, torch.float32)
    a = torch.full((nlist * cmax,), -1.0, device=cuda)
    if dtype is torch.int8:
        v = torch.clamp(torch.round(v * 127), -127, 127).to(torch.int8)
        a = -1.0 / v.float().norm(dim=1)
    else:
        v = v.to(dtype)
    qg = _rows(rng, nlist * s, d, cuda, torch.bfloat16 if dtype is torch.int8 else dtype)
    b = torch.zeros(nlist * cmax, device=cuda)
    b[::7] = fused_scan.INVALID_BIAS
    before = dict(ivf.grouped_scan.launches_by)
    rank, pos = ivf.grouped_scan(qg, v, a, b, s, cmax, g=g)
    key = (str(dtype).removeprefix("torch."), g)
    assert ivf.grouped_scan.launches_by[key] == before.get(key, 0) + 1
    prank, _ = ivf.grouped_scan_plain(qg, v, a, b, s, cmax)
    full = torch.full((nlist * s, nlist * cmax), float("inf"), device=cuda)
    for c in range(nlist):
        rows = slice(c * cmax, (c + 1) * cmax)
        full[c * s : (c + 1) * s, rows] = a[rows] * (qg[c * s : (c + 1) * s].float() @ v[rows].float().T) + b[rows]
    _assert_close_to_plain(rank, pos, prank, full)
    rank1, pos1 = ivf.grouped_scan(qg, v, a, b, s, cmax, g=1)
    assert torch.equal(rank, rank1) and torch.equal(pos, pos1)
    with pytest.raises(ValueError, match="divide"):
        ivf.grouped_scan(qg, v, a, b, s, cmax, g=3)


@pytest.mark.parametrize("nq", [3, 40])
def test_i8_distances_on_the_card_are_exact(cuda, nq):
    """The I8 integer product (torch._int_mm on the card) equals the CPU's
    int64 product at 1536-d, where an f32 product would round."""
    from vector_store_tpu_torch.core.types import Quantization, SpaceType
    from vector_store_tpu_torch.ops import distance

    rng = np.random.default_rng(nq)
    q = rng.normal(size=(nq, 1536)).astype(np.float32)
    v = rng.normal(size=(37, 1536)).astype(np.float32)
    for space in (SpaceType.EUCLIDEAN, SpaceType.COSINE, SpaceType.DOT_PRODUCT):
        qs, q_aux = distance.prepare_queries(q / np.abs(q).max(), space, Quantization.I8)
        vs, v_aux = distance.prepare_queries(v / np.abs(v).max(), space, Quantization.I8)
        want = distance.pairwise_distance(qs, vs, space, Quantization.I8, q_aux, v_aux)
        got = distance.pairwise_distance(
            qs.to(cuda), vs.to(cuda), space, Quantization.I8, q_aux.to(cuda), v_aux.to(cuda)
        )
        assert torch.allclose(got.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nq,pmax", [(1, 128), (13, 384), (64, 1024)])
def test_partition_scan_matches_plain(cuda, dtype, nq, pmax):
    rng = np.random.default_rng(nq + pmax)
    nparts, d = 9, 72
    v = _rows(rng, nparts * pmax, d, cuda, dtype)
    q = _rows(rng, nq, d, cuda, dtype)
    a = torch.full((nparts * pmax,), -2.0, device=cuda)
    b = torch.rand(nparts * pmax, device=cuda)
    b[::6] = fused_scan.INVALID_BIAS  # empty positions
    b[3 * pmax : 4 * pmax] = fused_scan.INVALID_BIAS  # an empty bucket
    bsel = torch.from_numpy(rng.integers(0, nparts, size=nq).astype(np.int32)).to(cuda)
    bsel[0] = 3
    before = ps.partition_scan.launches
    rank, pos = ps.partition_scan(v, a, b, q, bsel, pmax)
    assert ps.partition_scan.launches == before + 1
    prank, ppos = ps.partition_scan_plain(v, a, b, q, bsel, pmax)
    sel = bsel.long()
    full = a.view(nparts, pmax)[sel] * torch.einsum(
        "bd,bmd->bm", q.float(), v.float().view(nparts, pmax, d)[sel]
    ) + b.view(nparts, pmax)[sel]
    off = pos.long() - sel[:, None] * pmax
    assert bool(((off >= 0) & (off < pmax) & (off % fused_scan.LANES == torch.arange(128, device=cuda))).all())
    _assert_close_to_plain(rank, off, prank, full)
    assert torch.equal(pos[0], ppos[0])  # the empty bucket: exact ties go to the first row


def test_partition_candidates_on_the_card(cuda):
    """The kernel path's slots agree with the CPU plain version's."""
    rng = np.random.default_rng(2)
    nparts, pmax, d, nq = 5, 256, 64, 16
    v = _rows(rng, nparts * pmax, d, cuda, torch.bfloat16)
    q = _rows(rng, nq, d, cuda, torch.bfloat16)
    a = torch.full((nparts * pmax,), -1.0, device=cuda)
    b = torch.zeros(nparts * pmax, device=cuda)
    rows = torch.arange(nparts * pmax, dtype=torch.int32, device=cuda).view(nparts, pmax)
    rows[:, 200:] = -1
    b.view(nparts, pmax)[:, 200:] = fused_scan.INVALID_BIAS
    bsel = torch.from_numpy(rng.integers(-1, nparts, size=nq).astype(np.int32)).to(cuda)
    got = ps.partition_candidates(v, a, b, rows, q, bsel, k=10, pmax=pmax)
    cpu = [t.cpu() for t in (v, a, b, rows, q, bsel)]
    want = ps.partition_candidates(*cpu, k=10, pmax=pmax)
    assert torch.equal(got.cpu()[:, 0], want[:, 0])
    assert bool((got.cpu()[bsel.cpu() < 0] == -1).all())


def test_wrappers_refuse_bad_inputs(cuda):
    v = torch.zeros((1024, 64), device=cuda)
    a = torch.zeros(1024, device=cuda)
    with pytest.raises(ValueError):  # mixed devices
        fused_scan.fused_scan(torch.zeros((2, 64)), v, a, a, 1024)
    with pytest.raises(TypeError):
        fused_scan.fused_scan(torch.zeros((2, 64), device=cuda, dtype=torch.float16), v, a, a, 1024)
    with pytest.raises(ValueError):
        ivf.grouped_scan(torch.zeros((3, 64), device=cuda), v, a, a, 2, 512)
    with pytest.raises(ValueError):  # bsel on the host
        ps.partition_scan(v, a, a, torch.zeros((2, 64), device=cuda), torch.zeros(2, dtype=torch.int32), 512)
