"""Shared helpers of the port's parity tests: the port and the JAX package
define their own enums (``core.types``), so a test gives each side its own
member, mapped by class and member name; and a JAX IVF engine's state is
carried into the port's with ``load_state(jax_state(j))``."""

import numpy as np

import vector_store_tpu.core.types as jax_types


def to_jax(member):
    """The JAX package's member of the same enum class and name as the
    port's ``member`` (Quantization.I8 -> jax's Quantization.I8)."""
    return getattr(jax_types, type(member).__name__)[member.name]


def jax_state(j) -> dict:
    """The attributes of a JAX IvfDeviceIndex that the port's
    ``IvfDeviceIndex.load_state`` takes, as numpy arrays."""
    return {
        "main_vecs": np.asarray(j.main_vecs),
        "main_paux": np.asarray(j.main_paux),
        "main_pos2slot": np.asarray(j.main_pos2slot),
        "centroids": np.asarray(j.centroids),
        "nlist": j.nlist,
        "cmax": j.cmax,
        "_region": j._region,
        "_pos": j._pos,
        "_epochs_host": j._epochs_host,
        "_valid_host": j._valid_host,
        "_vecs_host": j._vecs_host,
        "_delta_pos2slot_host": j._delta_pos2slot_host,
        "_delta_next": j._delta_next,
        "_delta_free": j._delta_free,
        "delta_vectors": np.asarray(j._delta.vectors),
        "delta_paux": np.asarray(j._delta.paux),
        "delta_valid": np.asarray(j._delta.valid),
        "delta_epochs": np.asarray(j._delta.epochs),
    }
