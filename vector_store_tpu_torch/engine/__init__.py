"""Device-resident ANN index engines on PyTorch tensors, and two host
engines.

- FlatDeviceIndex: exact scan (fused scan kernel); serves small global
  indexes and is the IVF engine's delta region and the graph engine's
  store.
- IvfDeviceIndex: k-means-clustered main region + exact delta, searched by
  the grouped scan kernel over nprobe clusters per query.
- GraphDeviceIndex: a navigable graph searched by a lockstep beam, plus an
  exact delta (ENGINE=graph).
- SimulatorIndex: the reference's usearch simulator, an exact numpy engine
  with configurable delays (VECTOR_STORE_USEARCH_SIMULATOR); host only, as
  in the JAX package.
- OpenSearchIndex: indexes kept in a remote OpenSearch cluster
  (VECTOR_STORE_OPENSEARCH_URI); needs ``requests`` only when constructed.
"""

from vector_store_tpu_torch.engine.flat import FlatDeviceIndex, SearchResult
from vector_store_tpu_torch.engine.graph import GraphDeviceIndex
from vector_store_tpu_torch.engine.ivf import IvfDeviceIndex
from vector_store_tpu_torch.engine.opensearch import OpenSearchIndex
from vector_store_tpu_torch.engine.simulator import SimulatorIndex

__all__ = [
    "FlatDeviceIndex",
    "GraphDeviceIndex",
    "IvfDeviceIndex",
    "OpenSearchIndex",
    "SearchResult",
    "SimulatorIndex",
]
