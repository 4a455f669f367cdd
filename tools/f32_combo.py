"""Factorize the f32 gradient error: assembly VJP vs kernel noise vs bias.

At a realistic particle cloud (the traj experiment's setup), compute the
density gradient under every (assembly dtype) x (kernel backend) combo:

    dense64   dense XLA kernel, f64 state   (reference gradient)
    dense32   dense XLA kernel, f32 state
    prod      the platform's production kernel (f32)

x assembly f64 / f32.  For each combo vs the (f64, dense64) reference:

* per-particle relative error (median / p99 / max over the cloud) — is the
  error concentrated in a few particles or everywhere?
* cloud-mean bias: |mean_p(g - g_ref)| / |mean_p(g_ref)| per leaf — SVGD
  averages gradients over particles, so unbiased noise washes out while a
  systematic bias steers the whole cloud.

Run on the accelerator:  python tools/f32_combo.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from phlash_tpu.model import log_density_batched
from phlash_tpu.sim import bottleneck_demography, simulate_hmm
from phlash_tpu.training import build_training
from phlash_tpu.kernel import get_kernel


def main():
    truth = bottleneck_demography(theta=1e-2)
    contigs = [simulate_hmm(truth, L=200_000, key=i) for i in range(3)]
    from phlash_tpu.mcmc import init_mcmc_data

    window_size, overlap = 100, 500
    afs, chunks = init_mcmc_data(contigs, window_size, overlap, None, 20, 1)
    options = dict(
        niter=300, theta=1e-4, t1=1e-3, tM=15.0, alpha=1.0,
        minibatch_size=5, double_precision_params=True, num_particles=64,
    )
    prog = build_training(
        chunks, afs, window_size=window_size, overlap=overlap,
        key=jax.random.PRNGKey(7), options=options,
    )
    P64 = prog.state.particles
    P32 = jax.tree.map(lambda a: a.astype(jnp.float32), P64)

    inds = jnp.arange(prog.S, dtype=jnp.int32)
    warmup = prog.warmup[inds]
    weights = jnp.array([1.0, prog.N / prog.S, 1.0])

    import numpy as _np

    data_host = _np.asarray(prog.kern.data)

    kerns = dict(
        dense64=get_kernel(M=16, data=data_host, backend="dense", double_precision=True),
        dense32=get_kernel(M=16, data=data_host, backend="dense", double_precision=False),
        prod=prog.kern,
    )

    def grad_fn(kern):
        def g(P):
            kw = dict(c=weights, inds=inds, warmup=warmup, kern=kern,
                      afs=prog.afs, afs_transform=prog.afs_transform)
            return jax.grad(lambda Q: log_density_batched(Q, **kw).sum())(P)
        return jax.jit(g)

    results = {}
    for kname, kern in kerns.items():
        for aname, P in (("a64", P64), ("a32", P32)):
            results[(kname, aname)] = jax.tree.map(
                lambda x: np.asarray(x, np.float64), grad_fn(kern)(P)
            )
            print(f"computed {kname}/{aname}", flush=True)

    ref = results[("dense64", "a64")]
    leaf_names = ["t_tr", "c_tr", "rho_tr"]
    for combo, g in results.items():
        if combo == ("dense64", "a64"):
            continue
        print(f"== {combo[0]}/{combo[1]} vs dense64/a64")
        for name, a, b in zip(leaf_names, jax.tree.leaves(ref), jax.tree.leaves(g)):
            a2 = a.reshape(a.shape[0], -1)
            b2 = b.reshape(b.shape[0], -1)
            pn = np.linalg.norm(a2, axis=1) + 1e-12      # per-particle scale
            rel = np.linalg.norm(b2 - a2, axis=1) / pn   # per-particle relerr
            bias = np.linalg.norm(b2.mean(0) - a2.mean(0)) / (
                np.linalg.norm(a2.mean(0)) + 1e-12
            )
            print(
                f"   {name:7s} relerr med {np.median(rel):.2e} "
                f"p99 {np.quantile(rel, 0.99):.2e} max {rel.max():.2e} "
                f"| bias {bias:.2e}",
                flush=True,
            )


if __name__ == "__main__":
    main()
