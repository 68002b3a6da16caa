"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is the JSON file its entry names; a traffic mix is
``benchmark/traffic/<traffic>.json``; a per-layer metric is the reader
``benchmark/metrics/<name>.py`` (a function ``read(readings)``). Adding
one is adding its file and its entry: nothing here names a cell.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from benchmark.cell import Cell

ROOT = Path(__file__).resolve().parents[1]


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def by_name(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``workload`` reports."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    work = by_name(bench["workloads"], name, "workload")
    entry = by_name(bench["configs"], work["config"], "configuration")
    return from_files(name, entry["file"], work["traffic"], metrics_of(bench, name, "per_layer"), root)


def from_files(name: str, config_file: str, traffic: str, per_layer: list[dict] | None = None,
               root: Path = ROOT) -> Cell:
    """A cell of a configuration file (a path from the checkout's root) and
    a traffic mix (its name)."""
    with open(root / config_file) as f:
        config = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{traffic}.json") as f:
        mix = json.load(f)
    return Cell(name, config, mix, per_layer or [])


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of per-layer metric ``name``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
