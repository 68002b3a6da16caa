"""vector-store-tpu on PyTorch and CUDA: the port of ``vector_store_tpu``.

The default ANN path (an unfiltered query on a global F32/F16/BF16 index,
served by the IVF engine) runs here on an NVIDIA H100: device state lives
in torch tensors, the plain tensor work is PyTorch, and the two scan
kernels of that path are hand-written CUDA for sm_90a (csrc/). The JAX
package stays the reference; this package reuses its device-free modules
(core, table, db, fts, native, the HTTP server) and imports no JAX.
"""

import torch

# F32 storage promises full f32 distances (the JAX package ran F32 products
# at Precision.HIGHEST), so no float32 product may take the TF32 path.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
