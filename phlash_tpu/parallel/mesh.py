"""Mesh construction and sharding specs for the SVGD training step."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PARTICLE_AXIS = "p"
CHUNK_AXIS = "d"


def make_mesh(n_devices: int = None, particle_axis: int = None) -> Mesh:
    """Build a (p, d) mesh over the first n_devices devices.

    By default the particle axis gets as many devices as possible while
    keeping the chunk axis >= 1; for n >= 4 we use an (n//2, 2) mesh so both
    axes are exercised, otherwise (n, 1).  Every GPU of a host reaches every
    other at the same rate, so the layout follows the algorithm alone.
    """
    devs = jax.devices()
    n = n_devices or len(devs)
    assert n <= len(devs), f"requested {n} devices, have {len(devs)}"
    if particle_axis is None:
        particle_axis = n // 2 if n >= 4 else n
    chunk_axis = n // particle_axis
    assert particle_axis * chunk_axis == n, "mesh axes must tile the device count"
    grid = np.array(devs[:n]).reshape(particle_axis, chunk_axis)
    return Mesh(grid, (PARTICLE_AXIS, CHUNK_AXIS))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    "Batched-particle pytrees: leading axis sharded over the particle axis."
    return NamedSharding(mesh, P(PARTICLE_AXIS))


def chunk_sharding(mesh: Mesh) -> NamedSharding:
    "The (num_chunks, L) int8 tensor: rows sharded over the chunk axis."
    return NamedSharding(mesh, P(CHUNK_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_training_step(step_fn, mesh: Mesh, aux_out: bool = False):
    """Jit a (state, key) -> state SVGD step with mesh shardings.

    The SVGD state (particles + optimizer moments) is sharded over the
    particle axis; the PRNG key is replicated.  Inside the step, the Gram
    matrix of the SVGD kernel needs all particles — XLA inserts the
    all-gather (tiny: P x ~19 floats) while the heavy per-particle HMM
    work stays sharded.

    With ``aux_out=True`` the step function returns ``(state, aux)`` where
    ``aux`` is a replicated scalar/array (used by the fused in-call ELPD
    evaluation); the output sharding becomes (state shardings, replicated).
    """
    p_shard = particle_sharding(mesh)
    r_shard = replicated(mesh)

    def shard_state(state):
        return jax.tree.map(
            lambda leaf: p_shard if getattr(leaf, "ndim", 0) >= 1 else r_shard, state
        )

    def place(state):
        "Device-place an (unsharded) state according to the mesh."
        return jax.tree.map(
            lambda leaf: jax.device_put(
                leaf, p_shard if getattr(leaf, "ndim", 0) >= 1 else r_shard
            ),
            state,
        )

    def jit_step(example_state):
        ss = shard_state(example_state)
        out = (ss, r_shard) if aux_out else ss
        return jax.jit(step_fn, in_shardings=(ss, r_shard), out_shardings=out)

    return place, jit_step
