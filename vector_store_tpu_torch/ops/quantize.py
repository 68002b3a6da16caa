"""Vector storage types for the device arrays.

Counterpart of vector_store_tpu/ops/quantize.py for the float modes
F32/F16/BF16, which map onto torch dtypes, and I8 scalar quantization
(v -> round(127 v), clipped to [-127, 127]: USearch's i8 convention).
B1 binary packing is not ported yet (ROADMAP.md, port queue item 3).
"""

from __future__ import annotations

import numpy as np
import torch

from vector_store_tpu_torch.core.types import Quantization

FLOAT_QUANTIZATIONS = (Quantization.F32, Quantization.F16, Quantization.BF16)
STORED_QUANTIZATIONS = FLOAT_QUANTIZATIONS + (Quantization.I8,)

I8_SCALE = 127.0

# Row length granularity in elements. The scan kernels load a row 8
# elements at a time (16 bytes of f16/bf16, two 16-byte loads of f32), so
# a multiple of 8 keeps every row start 16-byte aligned for the float
# dtypes; int8 rows pad to 16 elements for the same 16-byte alignment. The
# JAX package padded to 128 lanes for the TPU's (8, 128) tiling; on the
# H100 that would only add zero work (3-d rows would cost 128 columns).
ROW_ALIGN = 8
I8_ROW_ALIGN = 16


def _require_stored(quantization: Quantization) -> None:
    if quantization not in STORED_QUANTIZATIONS:
        raise NotImplementedError(
            f"{quantization.name} storage is not ported to the PyTorch engines "
            "yet (ROADMAP.md, port queue: B1/Hamming)"
        )


def storage_dtype(quantization: Quantization) -> torch.dtype:
    _require_stored(quantization)
    return {
        Quantization.F32: torch.float32,
        Quantization.F16: torch.float16,
        Quantization.BF16: torch.bfloat16,
        Quantization.I8: torch.int8,
    }[quantization]


def padded_dim(dimensions: int, quantization: Quantization) -> int:
    """Storage row length: dimensions rounded up to a multiple of 8 (16
    for I8)."""
    _require_stored(quantization)
    align = I8_ROW_ALIGN if quantization is Quantization.I8 else ROW_ALIGN
    return -(-dimensions // align) * align


def quantize_i8(x: torch.Tensor) -> torch.Tensor:
    """f32 rows -> I8 codes, on x's device: round half to even, as
    ``np.round`` does in the JAX package."""
    return torch.clamp(torch.round(x * I8_SCALE), -127, 127).to(torch.int8)


def quantize_for_storage(x: np.ndarray, quantization: Quantization) -> torch.Tensor:
    """f32 host vectors [..., D] -> their storage representation, as a CPU
    tensor of the storage dtype (round to nearest even, as numpy/ml_dtypes
    do in the JAX package)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    if quantization is Quantization.I8:
        return quantize_i8(t)
    return t.to(storage_dtype(quantization))
