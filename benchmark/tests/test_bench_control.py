"""``correct`` on the CPU at a tiny size: a sound run passes; the control
(the reference one precision down, in the program's place) fails; and a
run with the program broken underneath the timed path fails, once for
each fault a cell can have. The harness's look for a card is skipped: the
run is driven through ``cell.run`` on ``torch.device("cpu")``, where the
program runs its kernels' plain versions."""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest
import torch

from benchmark import cell as cell_mod
from benchmark import control, spec

CPU = torch.device("cpu")


def tiny(config: str = "sift-1m-f32", traffic: str = "closed-128", dims: int = 16) -> cell_mod.Cell:
    c = spec.from_files(f"{config}.{traffic}", f"benchmark/configs/{config}.json", traffic)
    c.config["rows"]["count"], c.config["dimensions"] = 3000, dims
    c.config["queries"]["pool"] = 64
    # 3,000 rows stay in the flat delta, whose lanes lose a neighbour that
    # shares one with a nearer row: 3-4% of recall at any seed (the cells'
    # limits are set at their own size, PERF.md)
    c.config["limits"]["recall_miss"] = 0.2
    c.traffic["warm_seconds"] = 0.3
    c.traffic["queries"]["connections"] = 8
    if "writes" in c.traffic:
        c.traffic["writes"].update(rate=120, checks=20, grace_s=5)
    return c


def run(c: cell_mod.Cell, seed: int, device: torch.device = CPU) -> dict:
    return asyncio.run(cell_mod.run(c, seed, 2.0, False, device, time.perf_counter(), keep=True))


def failed(checks: dict) -> set[str]:
    return {name for name, (v, lim) in checks.items() if v > lim}


@pytest.mark.parametrize("config,dims", [("sift-1m-f32", 16), ("openai-500k-i8", 32)])
def test_program_passes_and_control_fails(config, dims):
    c = tiny(config, dims=dims)
    res = run(c, 2**31 + 11)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["metrics"]["qps"]["value"] > 0
    assert res["checks"]["dist_err"][0] < c.config["limits"]["dist_err"] / 10
    assert res["checks"]["recall_miss"][0] < c.config["limits"]["recall_miss"] / 3
    ctrl = control.control_checks(c, res["inputs"], CPU)
    assert "dist_err" in failed(ctrl["precision"]), ctrl
    assert "recall_miss" in failed(ctrl["half_rows"]), ctrl


def test_controls_without_the_program():
    """``--program 0``: the controls answer a sample of the pool over the
    rows a run makes from the seed, with no program run."""
    from benchmark import data

    c = tiny()
    rows = data.base_rows(c.config, 8, CPU)
    inputs = {"rows": rows.numpy(), "codes": data.query_codes(c.config, rows, 8), "writes": None, "seed": 8}
    ctrl = control.control_checks(c, inputs, CPU)
    assert failed(ctrl["precision"]) == {"dist_err"} and failed(ctrl["half_rows"]) == {"recall_miss"}, ctrl
    assert 0.3 < ctrl["half_rows"]["recall_miss"][0] < 0.7


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12], dtype=torch.float32)
    assert control.tf32(x).tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0]


def swap_first_two(orig):
    def resolve(self, req, res):
        out = orig(self, req, res)
        if len(out) > 1:
            (a, da), (b, db) = out[0], out[1]
            out[0], out[1] = (b, da), (a, db)
        return out
    return resolve


def half_the_rows(orig):
    """Every other row of each cluster (or of the delta) is skipped: its
    rank bias is the dead rows'."""
    from vector_store_tpu_torch.ops.fused_scan import INVALID_BIAS

    def scan(queries, vectors, a, b, *args, **kwargs):
        b = b.clone()
        b[1::2] = INVALID_BIAS
        return orig(queries, vectors, a, b, *args, **kwargs)
    return scan


def half_left_out(orig):
    """Each batch searches its first half only; the rest get the first
    query's results."""
    def collect_many(self, pendings):
        out = orig(self, pendings)
        for results in out:
            for i in range(-(-len(results) // 2), len(results)):
                results[i] = results[0]
        return out
    return collect_many


@pytest.mark.parametrize("fault,traffic", [
    ("writes_unapplied", "mixed-cdc"), ("answer_altered", "mixed-cdc"), ("half_the_batch_left_out", "mixed-cdc"),
    ("half_the_rows_skipped", "closed-128"), ("half_the_rows_skipped", "mixed-cdc"),
])
def test_faults_make_correct_false(fault, traffic, monkeypatch):
    from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex
    from vector_store_tpu_torch.ops import fused_scan, ivf
    from vector_store_tpu_torch.service.vs_index import VsIndexActor
    from vector_store_tpu_torch.table import Table

    c = tiny(traffic=traffic)
    if fault == "writes_unapplied":
        # the write step returns the state unchanged; the full scan keeps its own path
        monkeypatch.setattr(Table, "upsert", lambda self, *a, **k: [])
        monkeypatch.setattr(Table, "delete", lambda self, *a, **k: [])
        monkeypatch.setattr(cell_mod, "APPLIED_TIMEOUT_S", 2.0)
    elif fault == "answer_altered":
        monkeypatch.setattr(VsIndexActor, "_resolve", swap_first_two(VsIndexActor._resolve))
    elif fault == "half_the_batch_left_out":
        monkeypatch.setattr(IvfDeviceIndex, "collect_many", half_left_out(IvfDeviceIndex.collect_many))
    else:
        monkeypatch.setattr(fused_scan, "fused_scan", half_the_rows(fused_scan.fused_scan))
        monkeypatch.setattr(ivf, "grouped_scan_pairs", half_the_rows(ivf.grouped_scan_pairs))
    res = run(c, 5)
    assert not res["correct"], res["checks"]
    expect = {"writes_unapplied": "writes_missed", "answer_altered": "dist_err",
              "half_the_batch_left_out": "dist_err", "half_the_rows_skipped": "recall_miss"}[fault]
    assert expect in failed(res["checks"]), res["checks"]


def test_sound_mixed_run_passes():
    res = run(tiny(traffic="mixed-cdc"), 6)
    assert res["correct"], res["checks"]
    assert res["checks"]["writes_missed"] == [0, 0]
    assert res["checks"]["recall_miss"][0] < res["checks"]["recall_miss"][1] / 3
    assert np.isfinite(res["metrics"]["fresh_p50_ms"]["value"])


@pytest.mark.cuda
def test_on_the_card(cuda_device):
    c = tiny()
    res = run(c, 3, cuda_device)
    assert res["correct"], res["checks"]
    ctrl = control.control_checks(c, res["inputs"], cuda_device)
    assert "dist_err" in failed(ctrl["precision"]) and "recall_miss" in failed(ctrl["half_rows"]), ctrl


@pytest.fixture
def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
