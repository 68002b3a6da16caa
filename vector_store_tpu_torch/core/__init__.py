"""Domain core: pure-python types shared by every layer.

Mirrors the domain types of the reference's lib.rs (see SURVEY.md §2.1) with
no I/O and no JAX dependency, so the control plane and tests stay host-only.
"""

from vector_store_tpu_torch.core.types import (
    SpaceType,
    Quantization,
    Dimensions,
    Connectivity,
    ExpansionAdd,
    ExpansionSearch,
    Limit,
    IndexKey,
    IndexVersion,
    IndexOptionsVs,
    IndexOptionsFts,
    IndexMetadata,
    DbIndexPartitioning,
    DbIndexKind,
    DbCustomIndex,
    DbIndexedValue,
    DbIndexedOperation,
    DbIndexedRow,
    Progress,
)
from vector_store_tpu_torch.core.timestamp import Timestamp, Timestamped
from vector_store_tpu_torch.core.ids import PrimaryId, PartitionId, IndexId, IndexIdGenerator
from vector_store_tpu_torch.core.keys import InvariantKey, PrimaryKey, PartitionKey
from vector_store_tpu_torch.core.distance import Distance, similarity_score
from vector_store_tpu_torch.core.filters import Filter, Restriction, RestrictionKind

__all__ = [
    "SpaceType",
    "Quantization",
    "Dimensions",
    "Connectivity",
    "ExpansionAdd",
    "ExpansionSearch",
    "Limit",
    "IndexKey",
    "IndexVersion",
    "IndexOptionsVs",
    "IndexOptionsFts",
    "IndexMetadata",
    "DbIndexPartitioning",
    "DbIndexKind",
    "DbCustomIndex",
    "DbIndexedValue",
    "DbIndexedOperation",
    "DbIndexedRow",
    "Progress",
    "Timestamp",
    "Timestamped",
    "PrimaryId",
    "PartitionId",
    "IndexId",
    "IndexIdGenerator",
    "InvariantKey",
    "PrimaryKey",
    "PartitionKey",
    "Distance",
    "similarity_score",
    "Filter",
    "Restriction",
    "RestrictionKind",
]
