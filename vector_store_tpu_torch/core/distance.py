"""Distance validation and distance→similarity mapping.

Parity with reference distance.rs (range validation per space type) and
similarity.rs (similarity formulas).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from vector_store_tpu_torch.core.types import SpaceType


@dataclass(frozen=True)
class Distance:
    """A validated distance in a given space (reference distance.rs:32-105)."""

    value: float
    space_type: SpaceType
    dimensions: int | None = None  # required for Hamming

    def __post_init__(self) -> None:
        v = self.value
        st = self.space_type
        if st is SpaceType.COSINE:
            if not (0.0 <= v <= 2.0):  # NaN fails this too
                raise ValueError("Cosine distance must be in range [0.0, 2.0]")
        elif st is SpaceType.EUCLIDEAN:
            if not (v >= 0.0):
                raise ValueError("Euclidean distance must be >= 0.0")
        elif st is SpaceType.DOT_PRODUCT:
            if math.isnan(v):
                raise ValueError("Dot Product distance must be a valid number, got NaN")
        elif st is SpaceType.HAMMING:
            if not (v >= 0.0):
                raise ValueError("Hamming distance must be >= 0.0")
            if not math.isfinite(v):
                raise ValueError("Hamming distance must be a finite number")
            if v != math.floor(v):
                raise ValueError("Hamming distance must be an integer value")
            if self.dimensions is None:
                raise ValueError("Dimensions must be provided for Hamming distance")
            if v > self.dimensions:
                raise ValueError(
                    "Hamming distance cannot be greater than the number of dimensions"
                )

    @staticmethod
    def euclidean(v: float) -> "Distance":
        return Distance(v, SpaceType.EUCLIDEAN)

    @staticmethod
    def cosine(v: float) -> "Distance":
        return Distance(v, SpaceType.COSINE)

    @staticmethod
    def dot_product(v: float) -> "Distance":
        return Distance(v, SpaceType.DOT_PRODUCT)

    @staticmethod
    def hamming(v: float, dimensions: int) -> "Distance":
        return Distance(v, SpaceType.HAMMING, dimensions)


def similarity_score(distance: Distance) -> float:
    """Map a distance to a similarity score, higher = more similar
    (reference similarity.rs:26-37):

    - Cosine / DotProduct: (2 - d) / 2
    - Euclidean: 1 / (1 + d)
    - Hamming: 1 - d / dimensions
    """
    d = distance.value
    st = distance.space_type
    if st in (SpaceType.COSINE, SpaceType.DOT_PRODUCT):
        return (2.0 - d) / 2.0
    if st is SpaceType.EUCLIDEAN:
        return 1.0 / (1.0 + d)
    assert distance.dimensions is not None
    return 1.0 - d / distance.dimensions


def saturate_f32(v: float) -> float:
    """±inf → ±f32::MAX for JSON responses (reference httpapi lib.rs:397-409)."""
    f32_max = 3.4028235e38
    if v == math.inf:
        return f32_max
    if v == -math.inf:
        return -f32_max
    return v
