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
"""

import torch

# F32 storage promises full f32 distances (the JAX package ran F32 products
# at Precision.HIGHEST), so no float32 product may take the TF32 path.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

SERVICE_NAME = "scylla-vector-store"
# Mirrors the reference's OpenAPI version (httproutes.rs:102).
API_VERSION = "3.0.0"
