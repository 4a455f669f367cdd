"""Stein Variational Gradient Descent on flattened particle coordinates.

Replaces the reference's blackjax.svgd dependency
(/root/reference/src/phlash/mcmc.py:178-199) with a self-contained,
mesh-shardable implementation: RBF kernel with the median heuristic, the
standard SVGD update direction

    phi_i = (1/P) sum_j [ K(x_j, x_i) grad_j  +  grad_{x_j} K(x_j, x_i) ],

and any optax optimizer for the step.  Particles live as a batched pytree;
the kernel matrix is computed on flattened coordinates (P x D with D ~ 19,
so the P x P Gram matrix is tiny and can be computed after an all-gather
when particles are sharded across devices).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from phlash_tpu.utils.accurate import matmul_hi


class SVGDState(NamedTuple):
    particles: jax.Array | object  # batched pytree of particles
    opt_state: optax.OptState


def median_bandwidth(sq_dists: jax.Array, num_particles: int) -> jax.Array:
    """Median heuristic: h = med^2 / log(P), floored away from zero.

    Matches blackjax's ``update_median_heuristic`` exactly (the semantics the
    reference runs, /root/reference/src/phlash/mcmc.py:178-199; parity-checked
    step-for-step in tools/ref_parity.py §9 against tools/vendored_svgd.py):
    ``med`` is the median of the *strict lower triangle* of pairwise Euclidean
    distances — not of the full P x P matrix, whose P diagonal zeros would bias
    the median low — and the denominator is ``log(P)``.  The only deviation is
    the 1e-12 floor, inert unless all particles coincide (where blackjax would
    divide by zero).
    """
    P = num_particles
    # The strict-lower-triangle median is computed WITHOUT a gather: by
    # symmetry the off-diagonal multiset duplicates every lower-triangle
    # value exactly twice, and duplicating a multiset preserves its median
    # (both interpolation neighbors map to the original neighbors), so
    # masking the diagonal to +inf, sorting the full P x P matrix, and
    # averaging the two middle off-diagonal order statistics is bit-identical
    # to jnp.median(d[tril_indices(P, -1)]).  (A sort-free bitwise
    # order-statistic selection gave the same bits but ran slower on an
    # H100 at P=500.)  numpy eye / python-float log(P): P is static, and jnp
    # equivalents would plant f64 tensors in the f32 step graph (pinned by
    # test_f32_step_graph_has_no_tensor_f64).
    d = jnp.where(np.eye(P, dtype=bool), jnp.inf, jnp.sqrt(sq_dists))
    n = P * P - P
    s = jnp.sort(d.ravel())
    med = 0.5 * (s[(n - 1) // 2] + s[n // 2])
    h = med**2 / float(np.log(P))
    return jnp.maximum(h, 1e-12)


def svgd_direction(flat_particles: jax.Array, flat_grads: jax.Array) -> jax.Array:
    """SVGD update direction for flattened particles (P, D)."""
    P = flat_particles.shape[0]
    diffs = flat_particles[:, None, :] - flat_particles[None, :, :]  # (P, P, D)
    sq = jnp.sum(diffs**2, -1)  # (P, P)
    h = median_bandwidth(sq, P)
    K = jnp.exp(-sq / h)  # (P, P)
    # attractive term: K^T @ grads; repulsive term: sum_j dK(x_j, x_i)/dx_j
    mm = matmul_hi
    attract = mm(K, flat_grads)
    repulse = (2.0 / h) * (mm(K, flat_particles) - K.sum(1, keepdims=True) * flat_particles)
    # note sign: d/dx_j exp(-|x_j - x_i|^2/h) summed over j
    return (attract - repulse) / P


class SVGD:
    """SVGD driver: pairs a log-density gradient with an optax optimizer.

    Drop-in replacement for blackjax.svgd with the same init/step shape but
    no dependency and full jit/shard_map compatibility.
    """

    def __init__(
        self,
        grad_log_density: Callable,
        optimizer: optax.GradientTransformation,
        batched_grad: bool = False,
    ):
        """batched_grad=False: grad_log_density takes one particle (vmapped
        here).  batched_grad=True: it takes the whole batched particle pytree
        and returns batched gradients — the fast path for kernels that want
        the full (particles x chunks) batch (e.g. the triton kernel via
        `jax.grad(lambda P: log_density_batched(P, ...).sum())`)."""
        self.grad_fn = grad_log_density
        self.optimizer = optimizer
        self.batched_grad = batched_grad

    def init(self, particles) -> SVGDState:
        return SVGDState(particles=particles, opt_state=self.optimizer.init(particles))

    def step(self, state: SVGDState, **density_kwargs) -> SVGDState:
        particles = state.particles
        if self.batched_grad:
            grads = self.grad_fn(particles, **density_kwargs)
        else:
            grads = jax.vmap(lambda p: self.grad_fn(p, **density_kwargs))(particles)
        # a pathological particle (clamped likelihood underflow) can emit
        # inf/nan gradients; zero them so it is carried by the kernel-weighted
        # attraction instead of poisoning the optimizer moments
        grads = jax.tree.map(lambda g: jnp.where(jnp.isfinite(g), g, 0.0), grads)

        # flatten the batched pytrees to (P, D) for the kernel computation
        leaves = jax.tree.leaves(particles)
        P = leaves[0].shape[0]
        flat_p = jnp.concatenate([jnp.reshape(l, (P, -1)) for l in jax.tree.leaves(particles)], 1)
        flat_g = jnp.concatenate([jnp.reshape(l, (P, -1)) for l in jax.tree.leaves(grads)], 1)

        phi_flat = svgd_direction(flat_p, flat_g)

        # unflatten phi back into the particle pytree structure (static sizes)
        sizes = [l.size // P for l in leaves]
        splits = [int(s) for s in np.cumsum(sizes)[:-1]]
        pieces = jnp.split(phi_flat, splits, axis=1)
        phi = jax.tree.unflatten(
            jax.tree.structure(particles),
            [p.reshape(l.shape) for p, l in zip(pieces, leaves)],
        )

        # optax minimizes; SVGD ascends the density, so negate
        neg_phi = jax.tree.map(jnp.negative, phi)
        updates, opt_state = self.optimizer.update(neg_phi, state.opt_state, particles)
        particles = optax.apply_updates(particles, updates)
        return SVGDState(particles=particles, opt_state=opt_state)
