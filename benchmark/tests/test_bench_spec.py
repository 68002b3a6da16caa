"""The harness finds every cell, configuration, traffic mix and per-layer
metric by name, and a new one is added as new files alone."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench() -> dict:
    return spec.load()


def test_every_cell_resolves(bench):
    for work in bench["workloads"]:
        cell = spec.cell(bench, work["name"])
        assert cell.config["name"] == work["config"]
        assert cell.traffic["limit"] == 10
        assert work["chips"] == 1
        assert cell.per_layer, f"{work['name']} reports no per-layer metric"
        e2e = {m["name"] for m in spec.metrics_of(bench, work["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in cell.per_layer:
            assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, which {work['name']} does not report"


def test_every_configuration_file(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for entry in bench["configs"]:
        cfg = json.loads((spec.ROOT / entry["file"]).read_text())
        assert cfg["name"] == entry["name"]
        assert entry["reduced"] == []
        assert cfg["control"] in ("tf32", "int4")
        assert 0 < cfg["limits"]["dist_err"] < 1 and 0 < cfg["limits"]["recall_miss"] < 1
        assert any(w["config"] == entry["name"] for w in bench["workloads"])


def test_every_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_names_and_units(bench):
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[key]]
    assert len(set(names)) == len(names)
    for name in names:
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_a_cell_mix_and_metric_added_as_files_alone(tmp_path: Path, bench):
    """A later change adds a traffic mix, a per-layer metric and a cell by
    adding their files and entries; no file of the harness changes."""
    shutil.copytree(spec.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((tmp_path / "benchmark/traffic/closed-128.json").read_text())
    mix["queries"]["connections"] = 4
    (tmp_path / "benchmark/traffic/closed-4.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/metrics/actor.windows.lowconc.py").write_text(
        "from benchmark import readers\n\n\ndef read(r):\n"
        "    return readers.hot(r, 'vs_index.VsIndexActor._begin_window')[0]\n")
    new = dict(bench)
    new["workloads"] = bench["workloads"] + [
        {"name": "sift1m-f32-lowconc", "config": "sift-1m-f32", "traffic": "closed-4", "chips": 1, "why": "x"}]
    new["per_layer"] = bench["per_layer"] + [
        {"name": "actor.windows.lowconc", "unit": "windows", "better": "higher", "source": "program_span",
         "layer": "actor (service/vs_index.py)", "moves": "qps", "workloads": ["sift1m-f32-lowconc"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    loaded = spec.load(tmp_path)
    cell = spec.cell(loaded, "sift1m-f32-lowconc", tmp_path)
    assert cell.traffic["queries"]["connections"] == 4
    assert [m["name"] for m in cell.per_layer] == ["actor.windows.lowconc"]
    readings = {"before": {"hotpath": {}}, "after": {"hotpath": {
        "vs_index.VsIndexActor._begin_window": {"calls": 3, "total_ms": 1.0}}}}
    assert spec.reader("actor.windows.lowconc", tmp_path)(readings) == 3
    for work in bench["workloads"]:
        name = work["name"]
        assert spec.cell(loaded, name, tmp_path).per_layer == spec.cell(bench, name).per_layer
