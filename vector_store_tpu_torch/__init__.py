"""vector-store-tpu on PyTorch and CUDA: the port of ``vector_store_tpu``.

The ANN paths (an unfiltered or filtered query on a global F32/F16/BF16/I8
index, served by the IVF engine; a query on a B1 or Hamming index, served
by the flat engine's Hamming scan and bf16 rescore tier; and a
partition-restricted query on a local index of any storage, served by the
flat engine's partition directory) run here on an NVIDIA H100: device state lives in torch tensors, the plain
tensor work is PyTorch, and the scan kernels are hand-written CUDA for
sm_90a (csrc/). The JAX package stays the reference. This package imports
nothing of it: the device-free modules (core, table, db, fts, native, the
HTTP server) are copies kept beside their originals under the same
relative paths, and it imports no JAX.

Importing the package itself loads no torch: the HTTP frontend processes
of ``run.serve_scaled`` import only device-free modules. The TF32 switches
are set where the device code is imported (``ops/__init__.py``).
"""

__version__ = "0.1.0"

SERVICE_NAME = "scylla-vector-store"
# Mirrors the reference's OpenAPI version (httproutes.rs:102).
API_VERSION = "3.0.0"
