"""Vector storage types for the device arrays.

Counterpart of vector_store_tpu/ops/quantize.py: the float modes
F32/F16/BF16 map onto torch dtypes; I8 is scalar quantization
(v -> round(127 v), clipped to [-127, 127]: USearch's i8 convention); B1
packs one sign bit a component, 8 a byte, MSB first, set iff the
component is > 0 (usearch.rs:1179-1205; the bytes of ``np.packbits``).
"""

from __future__ import annotations

import numpy as np
import torch

from vector_store_tpu_torch.core.types import Quantization

# lossy storage: ranked by its own scan, re-ranked by the bf16 rescore tier
LOSSY_QUANTIZATIONS = (Quantization.I8, Quantization.B1)

I8_SCALE = 127.0

# Row length granularity in elements (bytes for B1). The scan kernels load
# a row 8 elements at a time (16 bytes of f16/bf16, two 16-byte loads of
# f32), so a multiple of 8 keeps every row start 16-byte aligned for the
# float dtypes; int8 rows pad to 16 elements for the same 16-byte
# alignment; packed B1 rows to 8 bytes (64 bits, a multiple of 8 unpacked
# columns for torch._int_mm). The JAX package padded to 128 lanes for the
# TPU's (8, 128) tiling; on the H100 that would only add zero work (3-d
# rows would cost 128 columns).
ROW_ALIGN = 8
I8_ROW_ALIGN = 16

_STORAGE_DTYPES = {
    Quantization.F32: torch.float32,
    Quantization.F16: torch.float16,
    Quantization.BF16: torch.bfloat16,
    Quantization.I8: torch.int8,
    Quantization.B1: torch.uint8,
}
# bit weights of one packed byte, MSB first
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def storage_dtype(quantization: Quantization) -> torch.dtype:
    return _STORAGE_DTYPES[quantization]


def padded_dim(dimensions: int, quantization: Quantization) -> int:
    """Storage row length: dimensions rounded up to a multiple of 8 (16
    for I8); for B1, ceil(D / 8) bytes rounded up to a multiple of 8."""
    if quantization is Quantization.B1:
        dimensions = -(-dimensions // 8)
    align = I8_ROW_ALIGN if quantization is Quantization.I8 else ROW_ALIGN
    return -(-dimensions // align) * align


def quantize_i8(x: torch.Tensor) -> torch.Tensor:
    """f32 rows -> I8 codes, on x's device: round half to even, as
    ``np.round`` does in the JAX package."""
    return torch.clamp(torch.round(x * I8_SCALE), -127, 127).to(torch.int8)


def pack_b1(x: torch.Tensor) -> torch.Tensor:
    """f32 [..., D] -> uint8 [..., ceil(D / 8)] on x's device: bit set iff
    the component is > 0, MSB first within each byte."""
    bits = (x > 0).to(torch.uint8)
    bits = torch.nn.functional.pad(bits, (0, -x.shape[-1] % 8))
    bits = bits.view(*bits.shape[:-1], -1, 8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=x.device)
    return (bits * weights).sum(-1, dtype=torch.uint8)


def unpack_b1(packed: torch.Tensor, dimensions: int) -> torch.Tensor:
    """uint8 [..., Db] -> f32 {0, 1} [..., dimensions], MSB first."""
    return unpack_bits(packed)[..., :dimensions].float()


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., Db] -> int8 {0, 1} [..., 8 Db], MSB first, on the
    tensor's device (the matrix-product form of a popcount)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.view(*packed.shape[:-1], packed.shape[-1] * 8).to(torch.int8)


def quantize_tensor(x: torch.Tensor, quantization: Quantization) -> torch.Tensor:
    """f32 rows [..., D] -> their storage representation, on x's device
    (round to nearest even, as numpy/ml_dtypes do in the JAX package)."""
    if quantization is Quantization.I8:
        return quantize_i8(x)
    if quantization is Quantization.B1:
        return pack_b1(x)
    return x.to(storage_dtype(quantization))


def quantize_for_storage(x: np.ndarray, quantization: Quantization) -> torch.Tensor:
    """f32 host vectors [..., D] -> their storage representation, as a CPU
    tensor of the storage dtype."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return quantize_tensor(t, quantization)


def to_storage_rows(x: torch.Tensor, quantization: Quantization, dp: int) -> torch.Tensor:
    """f32 rows [n, D] -> storage rows [n, dp], zero-padded, on x's
    device."""
    vals = quantize_tensor(x, quantization)
    return torch.nn.functional.pad(vals, (0, dp - vals.shape[-1]))
