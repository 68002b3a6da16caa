"""The reference against brute-force NumPy on a tiny set with writes
applied; the roofline arithmetic on known shapes; what the benchmark's
modules load."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import data, reference, roofline
from benchmark.data import Writes
from benchmark.spec import ROOT

CPU = torch.device("cpu")
TINY = {"dimensions": 8, "rows": {"count": 300, "clusters": 4, "sigma": 0.4, "unit": False},
        "queries": {"pool": 16, "noise": 0.1}}
WRITES = {"rate": 100, "insert": 0.7, "update": 0.2, "delete": 0.1, "probes_per_s": 2}


def numpy_live(base: np.ndarray, w: Writes) -> dict[int, np.ndarray]:
    """The live set after applying the writes one by one."""
    live = {i: base[i] for i in range(base.shape[0])}
    for kind, key, vec in zip(w.kind, w.key, w.vec):
        if kind == Writes.DELETE:
            live.pop(int(key), None)
        else:
            live[int(key)] = w.vectors[vec]
    return live


@pytest.mark.parametrize("space", ["EUCLIDEAN", "COSINE"])
def test_exact_top_k_against_numpy(space):
    rows = data.base_rows(TINY, 5, CPU)
    q = torch.from_numpy(data.values_of(data.query_codes(TINY, rows, 5)))
    ids, dist = reference.exact_top_k(rows, q, 10, space)
    r, qq = rows.double().numpy(), q.double().numpy()
    if space == "COSINE":
        d = 1 - (qq / np.linalg.norm(qq, axis=1, keepdims=True)) @ (r / np.linalg.norm(r, axis=1, keepdims=True)).T
    else:
        d = ((qq[:, None, :] - r[None]) ** 2).sum(-1)
    want = np.argsort(d, axis=1, kind="stable")[:, :10]
    assert (np.sort(ids, 1) == np.sort(want, 1)).all()
    np.testing.assert_allclose(dist, np.take_along_axis(d, want, 1), rtol=1e-4, atol=1e-5)


def test_live_set_after_writes_against_numpy():
    rows = data.base_rows(TINY, 9, CPU).numpy()
    w = data.write_stream(TINY, WRITES, 9, 3.0, CPU)
    assert w.times.size == 300 and (w.times >= 0).all() and (np.diff(w.times) >= 0).all()
    assert np.unique(w.key).size == w.key.size, "a key is written twice"
    assert w.probe.sum() == 6 and (w.kind[w.probe] == Writes.INSERT).all()
    book = reference.KeyBook(rows, w)
    keys, vecs = book.final_rows()
    live = numpy_live(rows, w)
    assert sorted(live) == keys.tolist()
    assert all((live[int(k)] == v).all() for k, v in zip(keys, vecs))
    upd = w.key[w.kind == Writes.UPDATE]
    assert (book.vectors(upd, after=False) == rows[upd]).all()
    dead = w.key[w.kind == Writes.DELETE]
    assert not book.live_after(dead).any() and book.ever_live(dead).all()
    assert not book.ever_live(np.array([-1, rows.shape[0] + book.inserted])).any()


def test_pair_distances_in_float64():
    rng = np.random.default_rng(0)
    q, v = rng.normal(size=(3, 8)).astype(np.float32), rng.normal(size=(3, 5, 8)).astype(np.float32)
    d, scale = reference.pair_distances(q, v, "EUCLIDEAN", CPU)
    np.testing.assert_allclose(d, ((q[:, None].astype(np.float64) - v) ** 2).sum(-1), rtol=1e-12)
    np.testing.assert_allclose(scale, (q.astype(np.float64) ** 2).sum(-1)[:, None] + (v.astype(np.float64) ** 2).sum(-1))


def test_same_seed_same_inputs():
    a, b = data.base_rows(TINY, 2**31 + 3, CPU), data.base_rows(TINY, 2**31 + 3, CPU)
    assert torch.equal(a, b) and not torch.equal(a, data.base_rows(TINY, 2**31 + 4, CPU))
    codes = data.query_codes(TINY, a, 2**31 + 3)
    text = np.char.mod("%.4f", codes / 1e4)
    assert (np.asarray([[float(t) for t in row] for row in text], dtype=np.float32) == data.values_of(codes)).all()


def test_roofline_known_shapes():
    # PERF.md section 5: the fused scan at 1,015,808 x 128, B 1024, F32: 4.005 ms, bound by operations
    assert roofline.fused_scan_bound(1024, 1_015_808, 128, "float32", 2048) == pytest.approx(4.005e-3, rel=1e-3)
    nbytes, ops = roofline.scan_work(100, 10, 1000, 64, "int8", "bfloat16", 10 * 128)
    assert nbytes == 100 * (64 + 8) + 10 * 64 * 2 + 1280 * 8 and ops == 2 * 1000 * 65
    # 2048 clusters of 768 live rows, 16 pairs each: bound by bytes
    t = roofline.pairs_scan_bound([16] * 2048, [768] * 2048, 128, "float32", "float32")
    nbytes, _ = roofline.scan_work(2048 * 768, 32_768, 32_768 * 768, 128, "float32", "float32", 32_768 * 128)
    assert t == pytest.approx(nbytes / 3.35e12)


def test_roofline_counts_live_rows_only():
    """The bound is the work the inputs need: a cluster no pair scans and
    a cluster's dead or padding rows cost nothing; the delta's free
    capacity neither."""
    nbytes, ops = roofline.scan_work(300 + 50, 3 + 1, 3 * 300 + 1 * 50, 64, "int8", "bfloat16", 4 * 128)
    want = max(nbytes / 3.35e12, ops / 989e12)
    assert roofline.pairs_scan_bound([3, 0, 1], [300, 999, 50], 64, "int8", "bfloat16") == pytest.approx(want)
    # 20,000 live rows of a delta with room for 131,072: 10 blocks of 2048 hold them
    nbytes, ops = roofline.scan_work(20_000, 64, 64 * 20_000, 128, "float32", "float32", 64 * 10 * 128)
    want = max(nbytes / 3.35e12, ops / 67e12)
    assert roofline.fused_scan_bound(64, 20_000, 128, "float32", 2048) == pytest.approx(want)


def loaded_top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_no_jax():
    mods = loaded_top_level("import benchmark.run, benchmark.cell, benchmark.control, benchmark.tracing, "
                            "benchmark.spec\nimport vector_store_tpu_torch.run")
    assert "vector_store_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "vector_store_tpu"}


def test_reference_and_loadgen_load_nothing_of_the_program():
    mods = loaded_top_level("import benchmark.reference, benchmark.judge, benchmark.roofline")
    assert not mods & {"vector_store_tpu_torch", "vector_store_tpu", "jax"}
    assert not loaded_top_level("import benchmark.loadgen") & {"torch", "vector_store_tpu_torch"}


def test_trace_summary_busy_time_and_idle_labels():
    from benchmark import tracing

    # device work at [0, 10] and [5, 20] us (overlapping) and [100, 110]; the
    # host clock's mark (500 ns) lands at trace us 2 (a sync of 2 us at 1 us)
    events = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5.0, "dur": 15.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 100.0, "dur": 10.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 1.0, "dur": 2.0},
    ]
    # the gap [20, 100] has its middle at trace us 60 = host ns 58,500
    spans = [("actor._collect_batches", 40_000, 90_000), ("engine.search_collect", 55_000, 65_000)]
    out = tracing.summarize(events, 1.0, spans, 500)
    assert out["busy_s"] == pytest.approx(30e-6)
    assert out["device_ops"] == {"k1": 10e-6, "k2": 15e-6, "m": 10e-6}
    assert out["device_counts"] == {"k1": 1, "k2": 1, "m": 1}
    assert out["idle_gaps"] == {"engine.search_collect": pytest.approx(80e-6)}
    out = tracing.summarize(events, 1.0, spans[:1], None)
    assert list(out["idle_gaps"]) == ["host outside the actor's and the engine's steps (HTTP, JSON, asyncio)"]
    assert tracing.breakdown(out)["device_ops"][0] == ["k2", 15e-6]


def test_roofline_share_is_per_call():
    """A kernel record the profiler lost moves neither the bound nor the
    time of a call: the share is a call's mean bound over its mean time."""
    from benchmark import readers

    calls = [{"nq": 64, "rows": torch.tensor([131_072]), "dp": 128, "dtype": "float32", "block_rows": 2048}] * 4
    bound = roofline.fused_scan_bound(64, 131_072, 128, "float32", 2048)
    trace = {"device_ops": {"void fused_scan_f32<2>(...)": 3 * 2 * bound}, "device_counts": {"void fused_scan_f32<2>(...)": 3}}
    assert readers.fused_roofline({"calls": {"fused_scan": calls}, "trace": trace}) == pytest.approx(50.0)
    assert readers.fused_roofline({"calls": {}, "trace": trace}) is None
