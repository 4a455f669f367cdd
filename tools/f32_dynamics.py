"""Isolate the f32 posterior-recovery regression: gradients vs dynamics.

Round-2/3 finding: per-step gradients of the density match between f32 and
f64 parameter graphs to ~1e-5 relative at the initial cloud
(tools/f32_bisect.py), yet full f32 runs degrade bottleneck tv 0.49 vs
0.14.  This script runs the bottleneck validation in four configurations
on identical data:

  A  f64 params, f64 gradients            (control, expect good tv)
  B  f32 params, f32 gradients            (known-bad config)
  C  f64 params/dynamics, f32 gradients   (cast to f32 inside the density)
  D  f32 params/dynamics, f64 gradients   (upcast to f64 inside the density)

If C degrades and D recovers -> the gradient path is the culprit (somewhere
later in parameter space than the init).  If D degrades and C is fine ->
the f32 SVGD/optimizer dynamics (or the f32 initial draw realization) are.

Run on the accelerator:  python tools/f32_dynamics.py [--niter N] [--L L]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def tv_of(post, truth):
    from phlash_tpu.size_history import SizeHistory

    grid = np.geomspace(truth.eta.quantile(0.05), truth.eta.quantile(0.95), 64)
    Ne = np.stack([np.asarray(dm.eta(grid, Ne=True)) for dm in post])
    med = np.quantile(Ne, 0.5, axis=0)
    return float(truth.eta.tv(SizeHistory(t=grid, c=1.0 / (2.0 * med))))


def run_config(name, cast_to, contigs, test, truth, niter):
    """cast_to: None (no patch), jnp.float32, or jnp.float64 — the dtype the
    particle pytree is cast to *inside* the differentiated density, so the
    gradient is computed at that precision while the dynamics keep theirs."""
    import phlash_tpu
    import phlash_tpu.training as training

    orig = training.log_density_batched
    if cast_to is not None:
        def patched(P, **kw):
            P_cast = jax.tree.map(lambda a: a.astype(cast_to), P)
            return orig(P_cast, **kw)

        training.log_density_batched = patched
    try:
        t0 = time.time()
        post = phlash_tpu.fit(
            contigs,
            test_data=test,
            niter=niter,
            num_workers=1,
            progress=False,
            theta=1e-4,
            t1=1e-3,
            tM=15.0,
            alpha=1.0,
            minibatch_size=5,
            elpd_cutoff=max(50, niter // 4),
            key=jax.random.PRNGKey(7),
            double_precision_params=name in ("A", "C"),
        )
        tv = tv_of(post, truth)
        print(f"config {name}: tv = {tv:.3f}  (wall {time.time() - t0:.0f}s)", flush=True)
        return tv
    finally:
        training.log_density_batched = orig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--niter", type=int, default=300)
    ap.add_argument("--L", type=int, default=200_000)
    ap.add_argument("--configs", default="A,B,C,D")
    args = ap.parse_args()

    from phlash_tpu.sim import bottleneck_demography, simulate_hmm

    truth = bottleneck_demography(theta=1e-2)
    contigs = [simulate_hmm(truth, L=args.L, key=i) for i in range(3)]
    test = simulate_hmm(truth, L=args.L, key=99)

    cast = dict(A=None, B=None, C=jnp.float32, D=jnp.float64)
    results = {}
    for name in args.configs.split(","):
        results[name] = run_config(name, cast[name], contigs, test, truth, args.niter)
    print("RESULTS " + " ".join(f"{k}={v:.3f}" for k, v in results.items()))


if __name__ == "__main__":
    main()
