"""The port stands alone: its serving stack, its own fake DB, the engines
and ops, the stage-ablation script, the bench programs (benchkit) and the
chip smoke script load in a fresh interpreter without jax and without any
module of the JAX package. (A subprocess, because this test process
imported jax in conftest.)

The modules a frontend process of ``serve_scaled`` or a client process of
benchkit/http_bench.py imports load no torch either, and importing the
engines turns TF32 off for float32 products.

The device-free modules the port copied from the JAX package must not
drift from their originals: each copy equals its original with
``vector_store_tpu.`` read as ``vector_store_tpu_torch.``, apart from the
few lines named in ALLOWED and the definitions named in REMOVED below.
"""

import ast
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
    "engine/simulator.py",
    "engine/opensearch.py",
    "http/frontend.py",
    "client.py",
    "benchkit/__init__.py",
    "benchkit/data.py",
    "benchkit/recall.py",
    "benchkit/harness.py",
    "benchkit/load.py",
    "benchkit/fts_bench.py",
    "benchkit/synth.py",
)

# copy -> the original's top-level definitions the copy leaves out: the
# device half of benchkit/synth.py generated rows on the TPU for its relay
# (the port copies host rows to the GPU instead)
REMOVED = {
    "benchkit/synth.py": {"functools", "_ava_jx", "_noise_jx", "_rows_jx", "synth_rows_jax"},
}

# copy -> the only lines (on either side) where a copy may differ from its
# rewritten original: the package constants live in the port's own
# __init__.py, the native loader builds into the port's _build/ directory,
# never into the JAX package's native/, and the OpenSearch engine imports
# requests where it opens a session, not when the module is imported
ALLOWED = {
    "engine/opensearch.py": {
        "import requests",
        "import requests  # where a session opens: importing the port needs no requests",
    },
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
        "vector_store_tpu_torch.engine.simulator, vector_store_tpu_torch.engine.opensearch, "
        "vector_store_tpu_torch.service.ipc, vector_store_tpu_torch.http.frontend",
        "vector_store_tpu_torch.benchkit, vector_store_tpu_torch.benchkit.synth, "
        "vector_store_tpu_torch.benchkit.common, vector_store_tpu_torch.benchkit.headline, "
        "vector_store_tpu_torch.benchkit.scale, vector_store_tpu_torch.benchkit.suite, "
        "vector_store_tpu_torch.benchkit.http_bench, vector_store_tpu_torch.benchkit.pipeline, "
        "vector_store_tpu_torch.benchkit.harness, vector_store_tpu_torch.benchkit.load, "
        "vector_store_tpu_torch.benchkit.fts_bench",
    ],
    ids=["serving-stack", "engines-and-ops", "chip-smoke", "stage-ablation", "scan-ablation", "scaled-serving",
         "benchkit"],
)
def test_no_jax_in_sys_modules(modules):
    # requests too: the OpenSearch engine imports it only to open a session
    assert _loaded(modules, FORBIDDEN + ("requests",)) == []


def _loaded(modules: str, roots: tuple) -> list[str]:
    """The modules under ``roots`` that importing ``modules`` loads in a
    fresh interpreter."""
    code = (
        f"import sys; import {modules}; "
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {roots!r}))"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    return ast.literal_eval(out.stdout.strip())


def test_frontend_process_loads_no_torch():
    """What a frontend process of serve_scaled imports (the frontend, its
    IPC client, the REST client) loads neither torch nor anything of the
    JAX package: a frontend stays small and never reaches the GPU."""
    modules = "vector_store_tpu_torch.http.frontend, vector_store_tpu_torch.service.ipc, vector_store_tpu_torch.client"
    assert _loaded(modules, FORBIDDEN + ("requests", "torch")) == []


def test_http_bench_client_loads_no_torch():
    """A client process of benchkit/http_bench.py imports the module to
    reach its entry point: that loads no torch (and nothing of JAX)."""
    modules = "vector_store_tpu_torch.benchkit.http_bench, vector_store_tpu_torch.service.ipc"
    assert _loaded(modules, FORBIDDEN + ("torch",)) == []


def test_f32_products_never_take_tf32():
    """Importing the engines turns TF32 off for float32 products even where
    the process had turned it on: F32 storage ranks in full f32."""
    code = (
        "import torch; torch.backends.cuda.matmul.allow_tf32 = True; torch.backends.cudnn.allow_tf32 = True; "
        "import vector_store_tpu_torch.engine; "
        "print(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


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
        "service/__init__.py", "service/engine.py", "service/ipc.py", "service/memory.py",
        "service/vs_index.py", "benchkit/scale.py", "benchkit/suite.py", "benchkit/http_bench.py",
        "benchkit/pipeline.py",
    }
    assert twins - rewrites == set(COPIED)


def without(source: str, names: set[str]) -> str:
    """``source`` less its top-level definitions (and imports) of ``names``
    and the blank lines after each."""
    lines = source.splitlines(keepends=True)
    spans = []
    for node in ast.parse(source).body:
        name = node.names[0].name if isinstance(node, ast.Import) else getattr(node, "name", None)
        if name in names:
            start = (node.decorator_list[0].lineno if getattr(node, "decorator_list", None) else node.lineno) - 1
            end = node.end_lineno
            while end < len(lines) and not lines[end].strip():
                end += 1
            spans.append((start, end))
    for start, end in sorted(spans, reverse=True):
        del lines[start:end]
    return "".join(lines)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_matches_original(rel):
    original = (REPO / "vector_store_tpu" / rel).read_text()
    if rel in REMOVED:
        shorter = without(original, REMOVED[rel])
        for name in REMOVED[rel]:  # each one the original still defines
            assert without(original, {name}) != original, name
        original = shorter
    original = original.replace("vector_store_tpu.", "vector_store_tpu_torch.")
    copy = (REPO / "vector_store_tpu_torch" / rel).read_text()
    changed = {
        line[2:].strip()
        for line in difflib.ndiff(original.splitlines(), copy.splitlines())
        if line[:2] in ("- ", "+ ")
    }
    assert changed <= ALLOWED.get(rel, set())
