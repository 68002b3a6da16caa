"""Scale-out: one index sharded over a mesh of devices.

Counterpart of vector_store_tpu/parallel/. Vector rows (or whole IVF
clusters) shard over the mesh's "model" axis, the query batch splits over
"data", every shard computes its local top-k, and one gather and an exact
merge give the global top-k. One process drives every shard; a mesh of
more shards than devices places shard i on device i % devices, so S
shards also run on one card.
"""

from vector_store_tpu_torch.parallel.sharded import (
    Mesh,
    ShardedFlatIndex,
    make_mesh,
    sharded_search_step,
    sharded_upsert_step,
)

__all__ = [
    "Mesh",
    "ShardedFlatIndex",
    "make_mesh",
    "sharded_search_step",
    "sharded_upsert_step",
]
