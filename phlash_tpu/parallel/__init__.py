"""Multi-chip scaling via a JAX device mesh.

Replaces the reference's multi-GPU scheme (host threads + replicated data +
host-side concat, /root/reference/src/phlash/gpu.py:328-438) with
sharding-annotated jit: one 2-D mesh

    axis "p" — SVGD particles (data-parallel over the particle cloud)
    axis "d" — genome chunks (the sequence-parallel axis: the chunk tensor
               is sharded over devices; per-chunk log-likelihoods combine
               with an all-reduce that XLA inserts automatically)

The whole training step (minibatch sampling, warmup filtering, HMM
likelihood + gradients, SVGD update) is a single jitted, sharded program —
no host callbacks, no replication of the chunk tensor; XLA hands the
collectives to NCCL over NVLink.
"""

from phlash_tpu.parallel.mesh import (
    chunk_sharding,
    make_mesh,
    particle_sharding,
    replicated,
    shard_training_step,
)

__all__ = [
    "make_mesh",
    "particle_sharding",
    "chunk_sharding",
    "replicated",
    "shard_training_step",
]
