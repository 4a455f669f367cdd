"""Pure-XLA pair-coalescent HMM forward algorithm.

Three roles (mirroring /root/reference/src/phlash/hmm.py:14-87):

1. correctness oracle for the optimized kernels in phlash_tpu.ops;
2. the "warmup" engine that filters each chunk's overlap prefix to produce a
   per-chunk initial distribution (the sequence-parallel correction trick);
3. the portable fallback likelihood on CPU.

`matvec_smc` exploits the compressed SMC' transition structure
(A[i>j,j]=b[j]; A[j,j]=d[j]; A[i<j,j]=u[i]v[j]) to apply v @ A in O(M) work
per site.  The invariant `matvec_smc(v, pp) == v @ dense_transition(pp)` is
what validates the O(M) and dense kernels alike (tests/test_hmm.py).
"""

from __future__ import annotations

import operator
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from phlash_tpu.params import PSMCParams
from phlash_tpu.size_history import DemographicModel


def matvec_smc(v: jax.Array, pp: PSMCParams) -> jax.Array:
    """Compute v @ A in O(M) using the compressed transition structure.

    lower: out[j] += b[j] * sum_{i>j} v[i]   (suffix sums)
    diag : out[j] += d[j] * v[j]
    upper: out[j] += v_col[j] * sum_{i<j} u[i] v[i]   (exclusive prefix sums)
    """
    # dtype-stable append: a python 0.0 through jnp.append materializes as
    # f64 under x64 and silently promotes an f32 chain
    suffix = lax.associative_scan(
        operator.add, jnp.append(v, jnp.zeros_like(v[:1]))[1:], reverse=True
    )
    weighted = pp.u * v
    prefix = jnp.concatenate([jnp.zeros_like(v[:1]), jnp.cumsum(weighted)[:-1]])
    return suffix * pp.b + pp.d * v + prefix * pp.v


@partial(jax.jit, static_argnames=())
def psmc_ll(pp: PSMCParams, data: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Scaled forward algorithm over one observation sequence.

    Args:
        pp: HMM natural parameters (unbatched).
        data: int8 observations in {-1 (missing), 0 (hom), 1 (het)}.

    Returns:
        (filtered distribution at the final site, log-likelihood).
    """
    # emission row per observation value; missing sites contribute factor 1
    emis = jnp.stack([pp.emis0, pp.emis1, jnp.ones_like(pp.emis0)])

    @jax.checkpoint
    def site(carry, ob):
        alpha, ll = carry
        alpha = matvec_smc(alpha, pp) * emis[ob]
        norm = jnp.maximum(alpha.sum(), 1e-35)
        return (alpha / norm, ll + jnp.log(norm)), None

    init = (pp.pi, jnp.zeros((), pp.pi.dtype))
    return lax.scan(site, init, data)[0]


def psmc_ll_dm(dm: DemographicModel, data: jax.Array):
    "Convenience overload used by tests: likelihood from a demographic model."
    return psmc_ll(PSMCParams.from_dm(dm), data)


class PureXLAKernel:
    """Fallback/oracle likelihood kernel with the common kernel interface.

    Holds the int8 chunk tensor as a device array; `loglik(pp, index)` is a
    pure jittable function (no host callback — unlike the reference's CUDA
    kernel this composes directly with jit/vmap/grad/shard_map).
    """

    def __init__(self, M: int, data, double_precision: bool = False, **_ignored):
        self.M = M
        self.data = jnp.asarray(data, dtype=jnp.int8)
        self.double_precision = double_precision

    @property
    def float_type(self):
        return jnp.float64 if self.double_precision else jnp.float32

    def loglik(self, pp, index):
        if isinstance(pp, DemographicModel):
            pp = PSMCParams.from_dm(pp)
        pp = jax.tree.map(lambda a: a.astype(self.float_type), pp)
        return psmc_ll(pp, self.data[index])[1]

    def loglik_batched(self, pps, inds):
        "(B, S) log-likelihoods from (B, S)-batched pps and (S,) indices."
        per_chunk = jax.vmap(self.loglik, in_axes=(0, 0))
        return jax.vmap(per_chunk, in_axes=(0, None))(pps, inds)

    def filter_batched(self, pps, warmup):
        "Filtered state over warmup prefixes: (B, S, M), differentiable."
        warmup = jnp.asarray(warmup)

        def per_particle(pp):
            pp = jax.tree.map(lambda a: a[0] if a.ndim == 2 else a, pp)
            pp = jax.tree.map(lambda a: a.astype(self.float_type), pp)
            return jax.vmap(lambda w: psmc_ll(pp, w)[0])(warmup)

        return jax.vmap(per_particle)(pps)

    def __call__(self, pp, index, grad: bool):
        index = jnp.asarray(index)
        assert index.ndim in (0, 1)
        f = self.loglik
        if grad:
            f = jax.value_and_grad(f)
        if index.ndim == 1:
            f = jax.vmap(f, in_axes=(None, 0))
        return f(pp, index)
