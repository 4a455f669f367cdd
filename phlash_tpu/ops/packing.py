"""Dense reconstruction of the compressed SMC' transition.

The compressed PSMCParams (b, d, u, v) describe the M x M transition matrix

    A[i, j] = b[j] * 1{i > j}  +  d[j] * 1{i == j}  +  u[i] v[j] * 1{i < j}.

The O(M)-per-site form (phlash_tpu.hmm.matvec_smc) is what the kernels use;
the dense matrix backs the `dense` backend and the structure tests.
"""

from __future__ import annotations

import jax.numpy as jnp

from phlash_tpu.params import PSMCParams


def dense_transition(pp: PSMCParams) -> jnp.ndarray:
    "Materialize the (M, M) transition matrix from compressed parameters."
    M = pp.d.shape[-1]
    i, j = jnp.ogrid[:M, :M]
    lower = jnp.broadcast_to(pp.b[None, :], (M, M)) * (i > j)
    diag = jnp.diagflat(pp.d)
    upper = pp.u[:, None] * pp.v[None, :] * (i < j)
    return lower + diag + upper


def block_diag_pack(As: jnp.ndarray) -> jnp.ndarray:
    """Pack G transition matrices (G, M, M) into one block-diagonal (G*M, G*M).

    One product then advances several particles' HMMs (tests/test_hmm.py).
    """
    G, M, _ = As.shape
    eye = jnp.eye(G, dtype=As.dtype)
    # out[g*M + a, h*M + b] = As[g, a, b] * eye[g, h]
    out = jnp.einsum("gab,gh->gahb", As, eye)
    return out.reshape(G * M, G * M)
