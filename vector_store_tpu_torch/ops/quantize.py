"""Vector storage types for the device arrays.

Counterpart of vector_store_tpu/ops/quantize.py for the float modes
F32/F16/BF16, which map onto torch dtypes. I8 scalar quantization and B1
binary packing are not ported yet (ROADMAP.md, port queue items 2-3).
"""

from __future__ import annotations

import numpy as np
import torch

from vector_store_tpu.core.types import Quantization

FLOAT_QUANTIZATIONS = (Quantization.F32, Quantization.F16, Quantization.BF16)

# Row length granularity in elements. The scan kernels load a row 8
# elements at a time (16 bytes of f16/bf16, two 16-byte loads of f32), so
# a multiple of 8 keeps every row start 16-byte aligned for all three
# dtypes. The JAX package padded to 128 lanes for the TPU's (8, 128)
# tiling; on the H100 that would only add zero work (3-d rows would cost
# 128 columns).
ROW_ALIGN = 8


def _require_float(quantization: Quantization) -> None:
    if quantization not in FLOAT_QUANTIZATIONS:
        raise NotImplementedError(
            f"{quantization.name} storage is not ported to the PyTorch engines "
            "yet (ROADMAP.md, port queue: I8 storage, B1/Hamming)"
        )


def storage_dtype(quantization: Quantization) -> torch.dtype:
    _require_float(quantization)
    return {
        Quantization.F32: torch.float32,
        Quantization.F16: torch.float16,
        Quantization.BF16: torch.bfloat16,
    }[quantization]


def padded_dim(dimensions: int, quantization: Quantization) -> int:
    """Storage row length: dimensions rounded up to a multiple of 8."""
    _require_float(quantization)
    return -(-dimensions // ROW_ALIGN) * ROW_ALIGN


def quantize_for_storage(x: np.ndarray, quantization: Quantization) -> torch.Tensor:
    """f32 host vectors [..., D] -> their storage representation, as a CPU
    tensor of the storage dtype (round to nearest even, as numpy/ml_dtypes
    do in the JAX package)."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        storage_dtype(quantization)
    )
