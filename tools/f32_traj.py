"""Track f32-vs-f64 gradient agreement along a real f64 SVGD trajectory.

tools/f32_dynamics.py proved the f32 *gradient path* alone causes the
posterior-recovery regression, while tools/f32_bisect.py showed gradients
agree to ~1e-5 at the initial cloud — so the corruption develops at
parameter values visited during optimization.  This script follows the f64
trajectory and, every step, compares the f32-assembly gradient against the
f64 one at the same (cast-down) cloud: per-leaf max relative error,
non-finite density counts, and the coordinates of the worst particle once
the error crosses a threshold.

Run on the accelerator:  python tools/f32_traj.py [--niter N]
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from phlash_tpu.model import log_density_batched
from phlash_tpu.sim import bottleneck_demography, simulate_hmm
from phlash_tpu.training import build_training


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--niter", type=int, default=300)
    ap.add_argument("--L", type=int, default=200_000)
    ap.add_argument("--every", type=int, default=10)
    args = ap.parse_args()

    truth = bottleneck_demography(theta=1e-2)
    contigs = [simulate_hmm(truth, L=args.L, key=i) for i in range(3)]
    from phlash_tpu.mcmc import init_mcmc_data

    window_size, overlap = 100, 500
    afs, chunks = init_mcmc_data(contigs, window_size, overlap, None, 20, 1)
    options = dict(
        niter=args.niter, theta=1e-4, t1=1e-3, tM=15.0, alpha=1.0,
        minibatch_size=5, double_precision_params=True,
    )
    prog = build_training(
        chunks, afs, window_size=window_size, overlap=overlap,
        key=jax.random.PRNGKey(7), options=options,
    )

    inds = jnp.arange(prog.S, dtype=jnp.int32)  # fixed probe minibatch
    warmup = prog.warmup[inds]
    weights = jnp.array([1.0, prog.N / prog.S, 1.0])
    kw = dict(
        c=weights, inds=inds, warmup=warmup, kern=prog.kern,
        afs=prog.afs, afs_transform=prog.afs_transform,
    )

    def val_and_grad(P):
        return jax.value_and_grad(lambda Q: log_density_batched(Q, **kw).sum())(P)

    vg64 = jax.jit(val_and_grad)
    vg32 = jax.jit(
        lambda P: val_and_grad(jax.tree.map(lambda a: a.astype(jnp.float32), P))
    )
    dens = jax.jit(lambda P: log_density_batched(P, **kw))
    dens32 = jax.jit(
        lambda P: log_density_batched(
            jax.tree.map(lambda a: a.astype(jnp.float32), P), **kw
        )
    )
    step = jax.jit(prog.step)

    state = prog.state
    key = jax.random.PRNGKey(11)
    worst_saved = False
    leaf_names = ["t_tr", "c_tr", "rho_tr"]
    for t in range(args.niter):
        if t % args.every == 0:
            _, g64 = vg64(state.particles)
            _, g32 = vg32(state.particles)
            d64 = np.asarray(dens(state.particles))
            d32 = np.asarray(dens32(state.particles))
            nbad64 = int((~np.isfinite(d64)).sum())
            nbad32 = int((~np.isfinite(d32)).sum())
            rels, worst = [], (0.0, None, None)
            for name, l64, l32 in zip(leaf_names, jax.tree.leaves(g64), jax.tree.leaves(g32)):
                a = np.asarray(l64, np.float64)
                b = np.asarray(l32, np.float64)
                scale = np.abs(a).max() + 1e-12
                rel = np.abs(b - a) / scale
                rels.append(f"{name}={rel.max():.2e}")
                if rel.max() > worst[0]:
                    pidx = int(np.unravel_index(np.argmax(rel), rel.shape)[0])
                    worst = (float(rel.max()), name, pidx)
            print(
                f"step {t:4d}: relerr {' '.join(rels)} | -inf64 {nbad64} -inf32 {nbad32}",
                flush=True,
            )
            if worst[0] > 1e-2 and not worst_saved:
                pidx = worst[2]
                bad = jax.tree.map(lambda a: np.asarray(a)[pidx], state.particles)
                with open("/tmp/f32_worst_particle.pkl", "wb") as f:
                    pickle.dump(
                        dict(step=t, leaf=worst[1], particle=bad, relerr=worst[0]), f
                    )
                print(
                    f"  saved worst particle (step {t}, leaf {worst[1]}, "
                    f"relerr {worst[0]:.2e}) -> /tmp/f32_worst_particle.pkl",
                    flush=True,
                )
                worst_saved = True
        key, k = jax.random.split(key)
        state = step(state, k)


if __name__ == "__main__":
    main()
