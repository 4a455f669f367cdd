"""Composite log-density: prior + chunked HMM likelihood + AFS likelihood.

Semantics match the reference (/root/reference/src/phlash/model.py:11-73):

* `log_prior`: standard-normal prior on log(rho/theta), an alpha-weighted
  squared-difference smoothness penalty on log c, and a beta-weighted ridge
  on the flattened coordinates.
* `log_density`: expands MCMC coordinates to HMM natural parameters once,
  runs the cheap O(M)-per-site forward pass over each chunk's overlap prefix
  to get a per-chunk filtered initial distribution (the sequence-parallel
  correction), evaluates the heavy per-chunk likelihood through the supplied
  kernel, adds the AFS term, and combines with weights c = [1, N/S, 1] so
  minibatch gradients are unbiased.

Everything here is pure and jit/vmap/grad-composable; the whole
per-particle density (warmup scan + kernel + AFS) fuses into one XLA program
with no host callbacks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import vmap
from jax.scipy.special import xlogy

import phlash_tpu.hmm
from phlash_tpu.params import MCMCParams, PSMCParams
from phlash_tpu.utils.accurate import matmul_hi as mm


def log_prior(mcp: MCMCParams) -> jax.Array:
    from phlash_tpu.utils.accurate import log as alog

    lp = jax.scipy.stats.norm.logpdf(alog(mcp.rho_over_theta)).sum()
    lp -= mcp.alpha * jnp.sum(jnp.diff(mcp.log_c) ** 2)
    flat, _ = jax.flatten_util.ravel_pytree(mcp)
    # sum-of-squares, not flat @ flat: no 19-element batched dot per particle
    lp -= mcp.beta * jnp.sum(flat * flat)
    return lp


def log_density(
    mcp: MCMCParams,
    c: jax.Array,  # (3,) weights: prior, HMM, AFS
    inds: jax.Array,  # (S,) minibatch chunk indices
    warmup: jax.Array,  # (S, overlap) int8 prefix observations
    kern,  # kernel with .loglik(pp, index)
    afs: jax.Array | None,  # (n-1,) observed spectrum, or None
    afs_transform: jax.Array | None = None,
) -> jax.Array:
    """Weighted model log-density for one particle on one minibatch.

    Returns -inf where any component is non-finite, which the SVGD gradient
    treats as a hard rejection.
    """
    dm = mcp.to_dm()
    pp = PSMCParams.from_dm(dm)

    # per-chunk filtered initial distribution from the overlap prefix; a
    # zero-width warmup (e.g. held-out ELPD rows, which have no preceding
    # context) passes pi through without running the filter at all
    if warmup.shape[1] == 0:
        pis = jnp.broadcast_to(pp.pi, (warmup.shape[0],) + pp.pi.shape)  # (S, M)
    else:
        pis = vmap(lambda d: phlash_tpu.hmm.psmc_ll(pp, d)[0])(warmup)  # (S, M)
    pps = vmap(lambda pi: pp._replace(pi=pi))(pis)

    l_prior = log_prior(mcp)
    l_hmm = vmap(kern.loglik, (0, 0))(pps, inds).sum()

    if afs is not None:
        n = len(afs) + 1
        # float32 throughout: f32 is exact for realistic AFS counts'
        # purposes and keeps the f32 graph free of f64
        T = jnp.eye(n - 1, dtype=jnp.float32) if afs_transform is None else afs_transform
        T = T.astype(jnp.float32)
        assert T.ndim == 2 and T.shape[1] == n - 1
        etbl = dm.eta.etbl(n)
        esfs = (etbl / etbl.sum()).astype(jnp.float32)
        # elementwise form of T @ esfs — see log_density_batched's note
        l_afs = xlogy(mm(T, afs.astype(jnp.float32)), (T * esfs).sum(-1)).sum()
    else:
        l_afs = 0.0

    total = c[0] * l_prior + c[1] * l_hmm + c[2] * l_afs
    return jnp.where(jnp.isfinite(total), total, -jnp.inf)


def log_density_batched(
    mcps: MCMCParams,  # batched pytree: leaves have leading particle axis B
    c: jax.Array,
    inds: jax.Array,
    warmup: jax.Array,
    kern,
    afs: jax.Array | None,
    afs_transform: jax.Array | None = None,
) -> jax.Array:
    """Per-particle log-densities, (B,), through the batched kernel entry.

    Functionally identical to vmap(log_density) but routes the HMM term and
    the warmup filtering through kern.loglik_batched / kern.filter_batched so
    optimized kernels (Pallas) see the whole (particles x chunks) batch
    explicitly instead of per-sample calls under vmap.  One jax.grad of
    `log_density_batched(...).sum()` yields all per-particle gradients (the
    particles are independent).
    """
    dms = jax.vmap(MCMCParams.to_dm)(mcps)
    pps = jax.vmap(PSMCParams.from_dm)(dms)  # leaves (B, M)

    S = warmup.shape[0]
    if warmup.shape[1] == 0:  # no prefix context: pi passthrough (no kernel)
        pis = jnp.broadcast_to(
            pps.pi[:, None], (pps.pi.shape[0], S, pps.pi.shape[1])
        )
    else:
        pis = kern.filter_batched(pps, warmup)  # (B, S, M), differentiable
    bc = lambda a: jnp.broadcast_to(a[:, None], (a.shape[0], S) + a.shape[1:])  # noqa: E731
    pps_chunks = PSMCParams(*[bc(leaf) for leaf in pps])._replace(pi=pis)

    l_prior = jax.vmap(log_prior)(mcps)
    l_hmm = kern.loglik_batched(pps_chunks, inds).sum(1)

    if afs is not None:
        n = len(afs) + 1
        T = jnp.eye(n - 1, dtype=jnp.float32) if afs_transform is None else afs_transform
        T = T.astype(jnp.float32)
        T_afs = mm(T, afs.astype(jnp.float32))  # constant across particles

        def one_afs(dm):
            etbl = dm.eta.etbl(n)
            esfs = (etbl / etbl.sum()).astype(jnp.float32)
            # T @ esfs as an elementwise product + reduce: exactly-rounded
            # f32 (same accuracy as the HIGHEST-precision matmul) without a
            # tiny per-particle batched dot_general
            return xlogy(T_afs, (T * esfs).sum(-1)).sum()

        l_afs = jax.vmap(one_afs)(dms)
    else:
        l_afs = jnp.zeros_like(l_prior)

    total = c[0] * l_prior + c[1] * l_hmm + c[2] * l_afs
    return jnp.where(jnp.isfinite(total), total, -jnp.inf)
