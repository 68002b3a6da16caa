"""Shared helper of the port's parity tests: the port and the JAX package
define their own enums (``core.types``), so a test gives each side its own
member, mapped by class and member name."""

import vector_store_tpu.core.types as jax_types


def to_jax(member):
    """The JAX package's member of the same enum class and name as the
    port's ``member`` (Quantization.I8 -> jax's Quantization.I8)."""
    return getattr(jax_types, type(member).__name__)[member.name]
