"""Device-resident ANN index engines on PyTorch tensors.

- FlatDeviceIndex: exact scan (fused scan kernel); serves small global
  indexes and is the IVF engine's delta region.
- IvfDeviceIndex: k-means-clustered main region + exact delta, searched by
  the grouped scan kernel over nprobe clusters per query.
"""

from vector_store_tpu_torch.engine.flat import FlatDeviceIndex, SearchResult
from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex

__all__ = ["FlatDeviceIndex", "IvfDeviceIndex", "SearchResult"]
