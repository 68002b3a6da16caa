"""The port's host engines: the OpenSearch remote engine against the same
mock server as tests/test_opensearch_sim.py, the simulator engine (twins
of that file's five cases), and the port's SimulatorIndex against the JAX
one on the same seeded rows: every space, unfiltered, under a partition
filter and under an allow-mask, slots and epochs equal and distances
within 1e-6."""

import asyncio
import time

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_opensearch_sim import MockOpenSearch  # noqa: E402
from torch_parity import to_jax  # noqa: E402

from vector_store_tpu.engine.simulator import SimulatorIndex as JaxSimulatorIndex  # noqa: E402
from vector_store_tpu_torch.core.types import Quantization, SpaceType  # noqa: E402
from vector_store_tpu_torch.engine import SimulatorIndex  # noqa: E402
from vector_store_tpu_torch.engine.simulator import parse_delays  # noqa: E402


@pytest.fixture
async def mock_server(loop):
    from aiohttp import web

    mock = MockOpenSearch()
    runner = web.AppRunner(mock.app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = None
    for s in runner.sites:
        server = getattr(s, "_server", None)
        if server and server.sockets:
            port = server.sockets[0].getsockname()[1]
    yield mock, f"http://127.0.0.1:{port}"
    await runner.cleanup()


class TestOpenSearchEngine:
    async def test_upsert_search_remove(self, mock_server):
        mock, url = mock_server
        from vector_store_tpu_torch.engine import OpenSearchIndex

        def run():
            idx = OpenSearchIndex(url, "ks-idx", 4, space_type=SpaceType.EUCLIDEAN)
            vecs = np.eye(4, dtype=np.float32) * 2
            idx.upsert_batch(np.arange(4), np.ones(4, np.int32), vecs)
            assert idx.size == 4
            res = idx.search(vecs[2][None], k=2)[0]
            assert res.slots[0] == 2
            assert res.epochs[0] == 1
            assert res.distances[0] == pytest.approx(0.0, abs=1e-5)
            idx.remove_batch(np.array([2]))
            assert idx.size == 3
            res = idx.search(vecs[2][None], k=1)[0]
            assert res.slots[0] != 2
            return True

        # requests is blocking: run in a thread while the mock serves
        assert await asyncio.get_running_loop().run_in_executor(None, run)
        assert "ks-idx" in mock.indices


class TestSimulator:
    def test_parse_delays(self):
        assert parse_delays("5ms:1ms:100ms") == (0.005, 0.001, 0.1)
        with pytest.raises(ValueError):
            parse_delays("5ms")

    def test_exact_search(self):
        idx = SimulatorIndex(4, space_type=SpaceType.EUCLIDEAN)
        vecs = np.eye(4, dtype=np.float32)
        idx.upsert_batch(np.arange(4), np.zeros(4, np.int32), vecs)
        res = idx.search(vecs[1][None], k=2)[0]
        assert res.slots[0] == 1
        assert idx.size == 4
        idx.remove_batch(np.array([1]))
        assert idx.search(vecs[1][None], k=1)[0].slots[0] != 1

    def test_partition_filter(self):
        idx = SimulatorIndex(2, space_type=SpaceType.EUCLIDEAN)
        vecs = np.asarray([[0.0, 0.0], [0.1, 0.0], [0.2, 0.0]], np.float32)
        idx.upsert_batch(np.arange(3), np.zeros(3, np.int32), vecs, partitions=np.array([0, 1, 1]))
        res = idx.search(vecs[0][None], k=3, partitions=np.array([1]))[0]
        assert set(res.slots.tolist()) == {1, 2}

    def test_delay_applied(self):
        idx = SimulatorIndex(2, delays=(0.02, 0.0, 0.0), space_type=SpaceType.EUCLIDEAN)
        idx.upsert_batch(np.array([0]), np.zeros(1, np.int32), np.zeros((1, 2), np.float32))
        t0 = time.perf_counter()
        idx.search(np.zeros((1, 2), np.float32), k=1)
        assert time.perf_counter() - t0 >= 0.02


@pytest.mark.parametrize(
    "space,quant",
    [
        (SpaceType.EUCLIDEAN, Quantization.F32),
        (SpaceType.COSINE, Quantization.F32),
        (SpaceType.DOT_PRODUCT, Quantization.F32),
        (SpaceType.HAMMING, Quantization.F32),
        (SpaceType.COSINE, Quantization.B1),
    ],
    ids=["euclidean", "cosine", "dot", "hamming", "b1"],
)
def test_simulator_matches_jax(space, quant):
    """The same seeded rows, removals, re-inserts and queries through the
    JAX SimulatorIndex and the port's: equal slots and epochs, distances
    within 1e-6, unfiltered, under a partition filter and an allow-mask."""
    rng = np.random.default_rng(91)
    n, d, k = 300, 16, 12
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    vecs[50:60] = vecs[40:50]  # exact ties: the stable argsort decides
    slots = rng.permutation(2 * n)[:n].astype(np.int64)
    epochs = rng.integers(0, 5, size=n).astype(np.int32)
    parts = rng.integers(0, 4, size=n).astype(np.int32)
    queries = rng.normal(size=(9, d)).astype(np.float32)
    queries[0] = vecs[7]
    qparts = np.asarray([0, 1, 2, 3, -1, 0, 1, 2, 3], np.int32)
    allow = rng.random(2 * n) < 0.3

    port = SimulatorIndex(d, space_type=space, quantization=quant)
    jax = JaxSimulatorIndex(d, space_type=to_jax(space), quantization=to_jax(quant))
    for idx in (port, jax):
        idx.upsert_batch(slots, epochs, vecs, partitions=parts)
        idx.remove_batch(slots[100:120])
        idx.upsert_batch(slots[105:110], epochs[105:110] + 1, vecs[105:110] * 2, partitions=parts[105:110])
    assert port.size == jax.size == n - 15

    for kwargs in ({}, {"partitions": qparts}, {"allow_mask": allow}):
        got = port.search(queries, k, **kwargs)
        want = jax.search(queries, k, **kwargs)
        assert len(got) == len(want) == len(queries)
        for g, w in zip(got, want):
            assert g.slots.size > 0
            np.testing.assert_array_equal(g.slots, w.slots)
            np.testing.assert_array_equal(g.epochs, w.epochs)
            np.testing.assert_allclose(g.distances, w.distances, rtol=0, atol=1e-6)
            if "allow_mask" in kwargs:
                assert allow[g.slots].all()
