"""The port imports no JAX: its serving stack, the fake DB it is tested
with and the chip smoke script load in a fresh interpreter without jax.
(A subprocess, because this test process imported jax in conftest.)"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "modules",
    [
        "vector_store_tpu_torch.run, vector_store_tpu.db.fake",
        "vector_store_tpu_torch.engine, vector_store_tpu_torch.ops.ivf, "
        "vector_store_tpu_torch.ops.fused_scan, vector_store_tpu_torch.ops.partition_scan, "
        "vector_store_tpu_torch.ops.topk",
        "chip_smoke",
    ],
    ids=["serving-stack", "engines-and-ops", "chip-smoke"],
)
def test_no_jax_in_sys_modules(modules):
    code = f"import sys; import {modules}; print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')))"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
