"""Shared helpers of the port's parity tests: the port and the JAX package
define their own enums (``core.types``), so a test gives each side its own
member, mapped by class and member name; and a JAX engine's state is
carried into the port's with ``load_state``: ``jax_state`` of an IVF engine,
``jax_flat_state`` of a flat one, ``jax_graph_state`` of a graph one, and
``jax_sharded_*_state`` of the sharded indexes."""

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
        # an I8 delta's bf16 rescore tier
        "delta_rescore_vectors": (
            np.asarray(j._delta.rescore_vectors.astype(np.float32)) if j._delta.rescore else None
        ),
        "delta_rescore_aux": np.asarray(j._delta.rescore_aux) if j._delta.rescore else None,
    }


def jax_flat_state(j, vecs_host=None) -> dict:
    """The attributes of a JAX FlatDeviceIndex that the port's
    ``FlatDeviceIndex.load_state`` takes, as numpy arrays. A float store
    of the JAX package off the TPU keeps neither rank coefficients nor an
    f32 mirror (``_vecs_host``); the port's always does: the coefficients
    come from the stored rows, and ``vecs_host`` gives the mirror's rows
    (the f32 rows as stored: unit rows for cosine), by default the stored
    values."""
    state = {
        "vectors": np.asarray(j.vectors), "paux": np.asarray(j.paux),
        "valid": np.asarray(j.valid), "epochs": np.asarray(j.epochs),
        "_vecs_host": j._vecs_host, "_part_bucket": j._part_bucket,
        "_part_rows_host": j._part_rows_host, "_part_count": j._part_count,
        "_slot_part": j._slot_part, "_slot_pos": j._slot_pos,
        "_part_overflow": j._part_overflow,
    }
    lossy = j.quantization.name in ("I8", "B1")
    if not j.use_pallas and not lossy:
        # the JAX store keeps its rank coefficients for its Pallas scan only
        from vector_store_tpu.ops.pallas_scan import paux_coeffs

        a, b = paux_coeffs(j.space_type, np.asarray(j.vectors).astype(np.float32))
        state["paux"] = np.stack([a, b])
    if state["_vecs_host"] is None and not lossy:
        if vecs_host is None:
            vecs_host = np.asarray(j.vectors).astype(np.float32)[:, : j.dimensions]
        mirror = np.zeros((state["valid"].shape[0], j.dimensions), np.float32)
        mirror[: len(vecs_host)] = vecs_host
        state["_vecs_host"] = mirror
    if j.rescore:
        state["rescore_vectors"] = np.asarray(j.rescore_vectors)
        state["rescore_aux"] = np.asarray(j.rescore_aux)
    return state


def jax_graph_state(g, vecs_host=None) -> dict:
    """The attributes of a JAX GraphDeviceIndex that the port's
    ``GraphDeviceIndex.load_state`` takes, as numpy (``vecs_host`` as in
    ``jax_flat_state``)."""
    return {
        "store": jax_flat_state(g.store, vecs_host),
        "adjacency": np.asarray(g.adjacency),
        "_entries": list(g._entries),
        "_entries_seen": g._entries_seen,
        "_graph_nodes": g._graph_nodes,
        "_graph_slots": list(g._graph_slots),
        "_members": g._members.copy(),
        "_delta_slots": list(g._delta_slots),
        "_rescore_host": g._rescore_host,
        "_refine_cursor": g._refine_cursor,
        "_last_refined_nodes": g._last_refined_nodes,
        "_rng": g._rng.bit_generator.state,
    }


def jax_sharded_flat_state(j) -> dict:
    """The global arrays of a JAX ShardedFlatIndex that the port's
    ``ShardedFlatIndex.load_state`` takes, as numpy."""
    return {name: np.asarray(getattr(j, name)) for name in ("vectors", "aux", "valid", "epochs")}


def jax_sharded_ivf_state(j) -> dict:
    """The state of a JAX ShardedIvfIndex that the port's
    ``ShardedIvfIndex.load_state`` takes: the global arrays as numpy, the
    host dicts, and the delta's arrays and maps."""
    built = j.main_vecs is not None
    return {
        "main_vecs": np.asarray(j.main_vecs) if built else None,
        "main_paux": np.asarray(j.main_paux) if built else None,
        "main_pos2slot": np.asarray(j.main_pos2slot) if built else None,
        "centroids": np.asarray(j.centroids) if built else None,
        "nlist": j.nlist,
        "cmax": j.cmax,
        "_vecs_host": j._vecs_host,
        "_epochs_host": j._epochs_host,
        "_pos_of_slot": j._pos_of_slot,
        "delta": jax_sharded_flat_state(j._delta),
        "_delta_pos_of_slot": j._delta_pos_of_slot,
        "_delta_slot_of_pos": j._delta_slot_of_pos,
        "_delta_next": j._delta_next,
    }


def jax_sharded_graph_state(j) -> dict:
    """The global arrays of a JAX ShardedGraphIndex that the port's
    ``ShardedGraphIndex.load_state`` takes, as numpy."""
    return {
        name: np.asarray(getattr(j, name))
        for name in ("vectors", "aux", "valid", "epochs", "adjacency", "entries")
    }
