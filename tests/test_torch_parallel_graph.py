"""The port's sharded graph index beside the JAX package's.

Twins of tests/test_parallel_graph.py on meshes of CPU devices (the JAX
side on its virtual CPU devices). Recall is measured against exact brute
force over all rows: the merge has to recover the global top-k from the
per-shard beams. Beside the twins:

- the port's per-shard build from the same rows gives the JAX build's
  adjacency row for row and the same entries: at least 0.99 of the rows
  equal (the ties of the kNN merge, the sorts and the prune go as the JAX
  program leaves them; an f32 near-tie that the two products round
  apart may flip an edge: 2 of 32,768 edges in one run, none in others);
- after ``load_state`` of the JAX adjacency and entries the port's beam
  returns the JAX beam's ids and epochs, and distances within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import vector_store_tpu.parallel.graph_sharded as jax_graph  # noqa: E402
import vector_store_tpu.parallel.sharded as jax_sharded  # noqa: E402
from torch_parity import jax_sharded_graph_state, to_jax  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.parallel.graph_sharded import ShardedGraphIndex  # noqa: E402
from vector_store_tpu_torch.parallel.sharded import make_mesh  # noqa: E402

CPU = torch.device("cpu")
RNG = np.random.default_rng(42)
COS, F32 = SpaceType.COSINE, Quantization.F32


def clustered(n, d, centers=32):
    c = RNG.normal(size=(centers, d)).astype(np.float32)
    a = RNG.integers(0, centers, n)
    v = (c[a] + 0.15 * RNG.normal(size=(n, d))).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def port_index(model, d, n, **kw):
    return ShardedGraphIndex(make_mesh(model, devices=[CPU]), d, space_type=COS, quantization=F32, capacity=n, **kw)


def test_sharded_graph_recall_beats_gate():
    n, d, k = 4096, 32, 10
    vecs = clustered(n, d)
    idx = port_index(4, d, n, connectivity=16, expansion_add=32, expansion_search=64, row_block=256)
    idx.load_rows(np.arange(n), np.ones(n, np.int32), vecs)
    idx.build()

    nq = 64
    queries = vecs[RNG.integers(0, n, nq)] + 0.02 * RNG.normal(size=(nq, d)).astype(np.float32)
    qn = queries / np.linalg.norm(queries, axis=-1, keepdims=True)
    gt = np.argsort(1.0 - qn @ vecs.T, axis=1)[:, :k]
    d_out, i_out, e_out = idx.search(queries, k)
    recall = np.mean([len(set(i_out[r]) & set(gt[r])) / k for r in range(nq)])
    assert recall >= 0.9, recall
    # distances are real and ordered; epochs carried through the merge
    assert (np.diff(d_out, axis=1) >= -1e-6).all()
    assert (e_out[i_out >= 0] == 1).all()


def test_sharded_matches_across_mesh_shapes():
    """Self-queries find their row first on 2-way and 4-way meshes."""
    n, d, k = 2048, 16, 5
    vecs = clustered(n, d, centers=8)
    for model in (2, 4):
        idx = port_index(model, d, n, expansion_search=64, row_block=256)
        idx.load_rows(np.arange(n), np.ones(n, np.int32), vecs)
        idx.build()
        _, i_out, _ = idx.search(vecs[:16], k)
        assert (i_out[:, 0] == np.arange(16)).all()


def jax_index(model, d, n, **kw):
    return jax_graph.ShardedGraphIndex(
        jax_sharded.make_mesh(model), d, space_type=to_jax(COS), quantization=to_jax(F32), capacity=n, **kw
    )


def test_build_matches_jax_adjacency():
    n, d, model = 2048, 16, 4
    vecs = clustered(n, d, centers=16)
    kw = dict(connectivity=16, expansion_add=32, row_block=256)
    port, ref = port_index(model, d, n, **kw), jax_index(model, d, n, **kw)
    for idx in (port, ref):
        idx.load_rows(np.arange(n), np.ones(n, np.int32), vecs)
        idx.build()
    got, want = torch.cat(port.adjacency).numpy(), np.asarray(ref.adjacency)
    same = (got == want).all(axis=1).mean()
    assert same >= 0.99, f"{same:.4f} of the rows equal"
    np.testing.assert_array_equal(torch.cat(port.entries).numpy(), np.asarray(ref.entries))


def test_load_state_beam_matches_jax():
    n, d, model, k = 2048, 16, 4, 10
    vecs = clustered(n, d, centers=16)
    kw = dict(connectivity=16, expansion_add=32, expansion_search=32, row_block=256)
    ref = jax_index(model, d, n, **kw)
    ref.load_rows(np.arange(n), np.arange(n, dtype=np.int32) % 7, vecs)
    ref.build()
    port = port_index(model, d, n, **kw)
    port.load_state(jax_sharded_graph_state(ref))
    queries = vecs[RNG.integers(0, n, 48)] + 0.05 * RNG.normal(size=(48, d)).astype(np.float32)
    got, want = port.search(queries, k), ref.search(queries, k)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
