"""Device-resident ANN index engines on PyTorch tensors.

- FlatDeviceIndex: exact scan (fused scan kernel); serves small global
  indexes and is the IVF engine's delta region and the graph engine's
  store.
- IvfDeviceIndex: k-means-clustered main region + exact delta, searched by
  the grouped scan kernel over nprobe clusters per query.
- GraphDeviceIndex: a navigable graph searched by a lockstep beam, plus an
  exact delta (ENGINE=graph).
"""

from vector_store_tpu_torch.engine.flat import FlatDeviceIndex, SearchResult
from vector_store_tpu_torch.engine.graph import GraphDeviceIndex
from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex

__all__ = ["FlatDeviceIndex", "GraphDeviceIndex", "IvfDeviceIndex", "SearchResult"]
