"""The port's sharded flat and IVF indexes beside the JAX package's.

Twins of tests/test_parallel.py on ``make_mesh(8, data=2)`` of CPU
devices (the JAX side on its 8 virtual CPU devices, its IVF scan in
interpret mode). The same rows, made from a seed with numpy, go through
both:

- the sharded flat search equals numpy's ranking and the JAX index id for
  id (exact f32 on both);
- a k-means step from the same linspace init gives the JAX centroids
  within 1e-4 (the bf16-rounded products are exact on both sides; only
  the f32 sums' order differs), and the built layouts agree on the
  cluster of at least 99% of the rows;
- after ``load_state`` of a JAX-built ShardedIvfIndex, the port's recall@10
  against the exact oracle is within 0.01 of the JAX index's, and its
  answers equal the JAX answers under the group-min rule (ROADMAP queue
  3: the same key set where ranks tie within 1e-5);
- a post-build upsert and a remove answer as the JAX index does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import vector_store_tpu.parallel.ivf_sharded as jax_ivf  # noqa: E402
import vector_store_tpu.parallel.sharded as jax_sharded  # noqa: E402
from torch_parity import jax_sharded_flat_state, jax_sharded_ivf_state, to_jax  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.parallel import ShardedFlatIndex, make_mesh  # noqa: E402
from vector_store_tpu_torch.parallel.ivf_sharded import ShardedIvfIndex, sharded_kmeans_step  # noqa: E402

CPU = torch.device("cpu")
RNG = np.random.default_rng(21)
EUC = SpaceType.EUCLIDEAN


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8, data=2, devices=[CPU] * 8), jax_sharded.make_mesh(8, data=2)


def flat_pair(meshes, d, capacity, block_rows):
    port = ShardedFlatIndex(meshes[0], d, space_type=EUC, capacity=capacity, block_rows=block_rows)
    ref = jax_sharded.ShardedFlatIndex(
        meshes[1], d, space_type=to_jax(EUC), capacity=capacity, block_rows=block_rows
    )
    assert port.capacity == ref.capacity
    return port, ref


class TestShardedFlat:
    def test_exact_search_matches_numpy_and_jax(self, meshes):
        n, d = 2048, 32
        port, ref = flat_pair(meshes, d, n, 128)
        vecs = RNG.normal(size=(n, d)).astype(np.float32)
        for idx in (port, ref):
            idx.upsert_batch(np.arange(n), np.zeros(n, np.int32), vecs)
        queries = RNG.normal(size=(5, d)).astype(np.float32)  # odd: uneven data rows
        dists, ids, epochs = port.search(queries, 10)
        want = np.argsort(((queries[:, None] - vecs[None]) ** 2).sum(-1), axis=1)[:, :10]
        np.testing.assert_array_equal(ids, want)
        assert (epochs == 0).all()
        jd, ji, je = ref.search(queries, 10)
        np.testing.assert_array_equal(ids, ji)
        np.testing.assert_array_equal(epochs, je)
        np.testing.assert_allclose(dists, jd, rtol=1e-5, atol=1e-4)

    def test_cross_shard_results(self, meshes):
        # targets planted in every shard are all found
        n, d = 1024, 16
        port, ref = flat_pair(meshes, d, n, 128)
        per_shard = port.capacity // 4  # model = 4
        vecs = RNG.normal(size=(n, d)).astype(np.float32) * 100
        special = np.arange(4) * per_shard
        for idx in (port, ref):
            idx.upsert_batch(np.arange(n), np.zeros(n, np.int32), vecs)
            idx.upsert_batch(special, np.ones(4, np.int32), np.zeros((4, d), np.float32))
        _, ids, epochs = port.search(np.zeros((2, d), np.float32), 4)
        np.testing.assert_array_equal(np.sort(ids[0]), special)
        assert np.all(epochs[0] == 1)
        np.testing.assert_array_equal(ids, ref.search(np.zeros((2, d), np.float32), 4)[1])

    def test_update_epoch_visible(self, meshes):
        n, d = 512, 16
        port, ref = flat_pair(meshes, d, n, 64)
        vecs = RNG.normal(size=(n, d)).astype(np.float32)
        port.upsert_batch(np.arange(n), np.zeros(n, np.int32), vecs)
        port.upsert_batch(np.array([5]), np.array([3], np.int32), vecs[5][None] * 0.0)
        _, ids, epochs = port.search(np.zeros((1, d), np.float32), 1)
        assert ids[0, 0] == 5 and epochs[0, 0] == 3
        # the JAX index's state carried over answers the same
        ref.upsert_batch(np.arange(n), np.zeros(n, np.int32), vecs)
        ref.upsert_batch(np.array([5]), np.array([3], np.int32), vecs[5][None] * 0.0)
        carried = ShardedFlatIndex(meshes[0], d, space_type=EUC, capacity=n, block_rows=64)
        carried.load_state(jax_sharded_flat_state(ref))
        q = RNG.normal(size=(3, d)).astype(np.float32)
        for got, want in zip(carried.search(q, 7), ref.search(q, 7)):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def clustered(rng, n, d, centers=64):
    c = rng.normal(size=(centers, d)).astype(np.float32) * 4
    return c[rng.integers(0, centers, size=n)] + rng.normal(size=(n, d)).astype(np.float32)


def ivf_pair(meshes, d, **kw):
    port = ShardedIvfIndex(meshes[0], d, space_type=EUC, quantization=Quantization.F32, **kw)
    ref = jax_ivf.ShardedIvfIndex(
        meshes[1], d, space_type=to_jax(EUC), quantization=to_jax(Quantization.F32), interpret=True, **kw
    )
    return port, ref


def recall(slot, queries, vecs, k):
    hits = 0
    for row in range(len(queries)):
        want = set(np.argsort(((queries[row] - vecs) ** 2).sum(-1))[:k].tolist())
        hits += len(want & set(slot[row].tolist()))
    return hits / (len(queries) * k)


class TestShardedIvf:
    def test_build_and_search(self, meshes):
        n, d, b, k = 4096, 32, 16, 10
        rng = np.random.default_rng(3)
        vecs = clustered(rng, n, d)
        idx = ShardedIvfIndex(meshes[0], d, space_type=EUC, quantization=Quantization.F32, nprobe=16, kmeans_iters=4)
        idx.upsert_batch(np.arange(n), np.full(n, 4, np.int32), vecs)
        idx.build()
        assert idx.nlist % meshes[0].shape["model"] == 0
        assert sum(idx.placed_per_shard()) + idx._delta_next == n
        queries = vecs[rng.integers(0, n, size=b)] + 0.05 * rng.normal(size=(b, d)).astype(np.float32)
        dist, slot, epochs = idx.search(queries, k)
        assert recall(slot, queries, vecs, k) >= 0.8
        assert (epochs[slot >= 0] == 4).all()
        assert (np.diff(dist, axis=1) >= -1e-5).all()

    def test_kmeans_step_and_labels_match_jax(self, meshes):
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        n, d, nlist = 4096, 32, 64
        rng = np.random.default_rng(7)
        vecs = clustered(rng, n, d)
        sel = np.linspace(0, n - 1, nlist).astype(np.int64)
        # one step from the same init: the JAX program over 8 virtual
        # devices (model = 4) against the port's over 4 CPU shards
        jmesh = meshes[1]
        step = jax_ivf.sharded_kmeans_step(jmesh, nlist=nlist, block=256, spherical=False)
        xpad = np.zeros((n, 128), np.float32)
        xpad[:, :d] = vecs
        cj = np.asarray(step(
            jax.device_put(jnp.asarray(xpad), NamedSharding(jmesh, P("model", None))),
            jax.device_put(jnp.ones((n,), jnp.float32), NamedSharding(jmesh, P("model"))),
            jnp.asarray(xpad[sel]),
        ))[:, :d]
        mesh = meshes[0]
        per = n // mesh.shape["model"]
        x = [torch.from_numpy(vecs[j * per : (j + 1) * per]) for j in range(mesh.shape["model"])]
        w = [torch.ones(per) for _ in x]
        cent = sharded_kmeans_step(mesh, x, w, [torch.from_numpy(vecs[sel])] * len(x), spherical=False)
        np.testing.assert_allclose(cent[0].numpy(), cj, rtol=0, atol=1e-4)

        # whole builds (4 iterations each): each row's cluster
        port, ref = ivf_pair(meshes, d, nprobe=16, kmeans_iters=4)
        for idx in (port, ref):
            idx.upsert_batch(np.arange(n), np.zeros(n, np.int32), vecs)
            idx.build()
        assert (port.nlist, port.cmax) == (ref.nlist, ref.cmax)
        both = sorted(set(port._pos_of_slot) & set(ref._pos_of_slot))
        assert len(both) >= 0.99 * n
        same = sum(port._pos_of_slot[s] // port.cmax == ref._pos_of_slot[s] // ref.cmax for s in both)
        assert same >= 0.99 * n, f"{n - same} of {n} rows in another cluster"

    def test_load_state_recall_matches_jax(self, meshes):
        n, d, b, k = 4096, 32, 32, 10
        rng = np.random.default_rng(3)
        vecs = clustered(rng, n, d)
        _, ref = ivf_pair(meshes, d, nprobe=16, kmeans_iters=4)
        ref.upsert_batch(np.arange(n), np.full(n, 4, np.int32), vecs)
        ref.build()
        port = ShardedIvfIndex(meshes[0], d, space_type=EUC, quantization=Quantization.F32, nprobe=16)
        port.load_state(jax_sharded_ivf_state(ref))
        queries = vecs[rng.integers(0, n, size=b)] + 0.05 * rng.normal(size=(b, d)).astype(np.float32)
        dist, slot, epochs = port.search(queries, k)
        jd, js, je = ref.search(queries, k)
        assert abs(recall(slot, queries, vecs, k) - recall(js, queries, vecs, k)) <= 0.01
        np.testing.assert_allclose(dist, jd, rtol=1e-5, atol=1e-4)
        for row in range(b):
            if not (slot[row] == js[row]).all():  # a tie may swap keys
                assert set(slot[row]) == set(js[row])
                diff = np.nonzero(slot[row] != js[row])[0]
                assert np.all(np.abs(np.diff(jd[row]))[np.clip(diff, 0, k - 2)] <= 1e-5)
        np.testing.assert_array_equal(epochs, je)

    def test_post_build_upsert_and_remove(self, meshes):
        n, d = 2048, 32
        rng = np.random.default_rng(5)
        vecs = rng.normal(size=(n, d)).astype(np.float32)
        _, ref = ivf_pair(meshes, d, nprobe=64, kmeans_iters=3)
        ref.upsert_batch(np.arange(n), np.zeros(n, np.int32), vecs)
        ref.build()
        idx = ShardedIvfIndex(meshes[0], d, space_type=EUC, quantization=Quantization.F32, nprobe=64)
        idx.load_state(jax_sharded_ivf_state(ref))
        # a new vector after the build goes to the delta and is found
        new = np.full((1, d), 30.0, np.float32)
        for i in (idx, ref):
            i.upsert_batch(np.asarray([n]), np.asarray([7]), new)
        dist, slot, epochs = idx.search(new, 3)
        assert slot[0, 0] == n and epochs[0, 0] == 7
        assert dist[0, 0] == pytest.approx(0.0, abs=1e-2)
        # a row removed from the main region no longer answers
        dist, slot, _ = idx.search(vecs[11:12], 3)
        assert slot[0, 0] == 11
        for i in (idx, ref):
            i.remove_batch(np.asarray([11, n]))
        q = np.concatenate([vecs[11:12], new, vecs[:6]])
        got, want = idx.search(q, 5), ref.search(q, 5)
        assert 11 not in got[1][0] and n not in got[1][1]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-4)
