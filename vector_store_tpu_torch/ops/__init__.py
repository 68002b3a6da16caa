"""Device compute ops: quantization, distances, top-k, and the two scan
kernels (fused_scan: flat scan; ivf.grouped_scan: IVF cluster scan) with
their build/bind layer (kernels).

Every engine imports this package, so the switches below hold before any
device index exists."""

import torch

# F32 storage promises full f32 distances (the JAX package ran F32 products
# at Precision.HIGHEST), so no float32 product may take the TF32 path.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
