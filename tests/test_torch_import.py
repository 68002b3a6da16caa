"""The port stands alone: its serving stack, its own fake DB, the engines
and ops, the stage-ablation script and the chip smoke script load in a
fresh interpreter without jax and without any module of the JAX package.
(A subprocess, because this test process imported jax in conftest.)

The device-free modules the port copied from the JAX package must not
drift from their originals: each copy equals its original with
``vector_store_tpu.`` read as ``vector_store_tpu_torch.``, apart from the
few lines named in ALLOWED below.
"""

import difflib
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("vector_store_tpu", "jax", "jaxlib")

COPIED = (
    "core/__init__.py",
    "core/distance.py",
    "core/filters.py",
    "core/ids.py",
    "core/keys.py",
    "core/timestamp.py",
    "core/types.py",
    "db/__init__.py",
    "db/fake.py",
    "db/scylla.py",
    "db/cql/__init__.py",
    "db/cql/connection.py",
    "db/cql/frame.py",
    "db/cql/session.py",
    "db/cql/testing.py",
    "db/cql/types.py",
    "table/__init__.py",
    "service/config.py",
    "service/indexes.py",
    "service/internals.py",
    "service/metrics.py",
    "service/node_state.py",
    "service/worker.py",
    "service/monitor_items.py",
    "service/file_monitor.py",
    "service/fts_index.py",
    "fts/__init__.py",
    "fts/native.py",
    "native/__init__.py",
    "native/fts_native.cpp",
    "native/rescore_native.cpp",
    "http/server.py",
    "http/openapi.py",
    "http/swagger_ui.py",
    "utils/__init__.py",
    "utils/hotpath.py",
    "engine/rescore.py",
    "service/monitor_indexes.py",
)

# copy -> the only lines (on either side) where a copy may differ from its
# rewritten original: the package constants live in the port's own
# __init__.py, and the native loader builds into the port's _build/
# directory, never into the JAX package's native/
ALLOWED = {
    "http/openapi.py": {"import vector_store_tpu", "import vector_store_tpu_torch"},
    "native/__init__.py": {
        "import vector_store_tpu",
        "import vector_store_tpu_torch",
        '_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")',
        'so = os.path.join(_DIR, f"lib{name}.so")',
        'so = os.path.join(_BUILD_DIR, f"lib{name}.so")',
        "os.makedirs(_BUILD_DIR, exist_ok=True)",
    },
}


@pytest.mark.parametrize(
    "modules",
    [
        "vector_store_tpu_torch.run, vector_store_tpu_torch.db.fake",
        "vector_store_tpu_torch.engine, vector_store_tpu_torch.ops.ivf, "
        "vector_store_tpu_torch.ops.fused_scan, vector_store_tpu_torch.ops.partition_scan, "
        "vector_store_tpu_torch.ops.topk",
        "chip_smoke",
        "vector_store_tpu_torch.bench.ivf_stage",
        "vector_store_tpu_torch.bench.scan_ablation",
    ],
    ids=["serving-stack", "engines-and-ops", "chip-smoke", "stage-ablation", "scan-ablation"],
)
def test_no_jax_in_sys_modules(modules):
    code = (
        f"import sys; import {modules}; "
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_copied_modules_are_listed():
    """Every file of the port that has an original under the same relative
    path is a copy, and every copy is held by the drift test."""
    port = REPO / "vector_store_tpu_torch"
    twins = {
        str(p.relative_to(port))
        for p in port.rglob("*")
        if p.suffix in (".py", ".cpp")
        and (REPO / "vector_store_tpu" / p.relative_to(port)).exists()
    }
    # the port's own modules beside their originals (engines, ops, service
    # wiring, routes, run) are rewrites, not copies
    rewrites = {
        "__init__.py", "run.py", "engine/__init__.py", "engine/flat.py", "engine/graph.py", "engine/ivf.py",
        "http/__init__.py", "http/routes.py", "ops/__init__.py", "ops/distance.py",
        "ops/ivf.py", "ops/partition_scan.py", "ops/quantize.py", "ops/topk.py",
        "service/__init__.py", "service/engine.py", "service/memory.py", "service/vs_index.py",
    }
    assert twins - rewrites == set(COPIED)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_matches_original(rel):
    original = (REPO / "vector_store_tpu" / rel).read_text()
    original = original.replace("vector_store_tpu.", "vector_store_tpu_torch.")
    copy = (REPO / "vector_store_tpu_torch" / rel).read_text()
    changed = {
        line[2:].strip()
        for line in difflib.ndiff(original.splitlines(), copy.splitlines())
        if line[:2] in ("- ", "+ ")
    }
    assert changed <= ALLOWED.get(rel, set())
