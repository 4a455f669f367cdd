"""Posterior-recovery validation on simulated demographies (run on the GPU).

For each test demography, simulates chromosome-scale data from the exact
SMC' generative model, fits the posterior with default-scale settings
(500 particles), and reports:

* total-variation distance between the posterior-median model's coalescence
  density and the truth (the reference's headline evaluation metric,
  SizeHistory.tv);
* pointwise coverage: fraction of time-grid points where the true Ne lies
  inside the posterior 95% band.

Writes docs/validation_<name>.png per demography and a summary line each.

Usage: python tools/validate.py [--quick]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def run(
    name: str,
    truth,
    L: int,
    niter: int,
    n_contigs: int = 3,
    simulator: str = "continuous",
    n_samples: int = 1,
) -> dict:
    import jax

    import phlash_tpu
    from phlash_tpu.sim import simulate_hmm, simulate_smc_continuous
    from phlash_tpu.utils import tree_stack

    if simulator == "continuous":
        # exact continuous-time SMC' draws: independent of the discretized
        # transition-matrix code the likelihood uses (non-circular — the
        # reference gets this independence from msprime/scrm).  n_samples > 1
        # exercises the composite likelihood: each het-matrix row is an
        # independent diploid SMC' path, exactly the independence the model
        # assumes when it sums per-row log-likelihoods.
        contigs = [
            simulate_smc_continuous(truth, L=L, seed=i, n_samples=n_samples)
            for i in range(n_contigs)
        ]
        test = simulate_smc_continuous(truth, L=L, seed=99, n_samples=n_samples)
    else:
        contigs = [simulate_hmm(truth, L=L, key=i) for i in range(n_contigs)]
        test = simulate_hmm(truth, L=L, key=99)
    t0 = time.time()
    post = phlash_tpu.fit(
        contigs,
        test_data=test,
        niter=niter,
        num_workers=1,
        progress=False,
        theta=1e-4,  # per-bp; matches the simulator scale exactly
        t1=1e-3,     # the simulator's discretization grid
        tM=15.0,
        alpha=1.0,   # mild smoothness prior on log c
        minibatch_size=5,
        elpd_cutoff=max(50, niter // 4),
        key=jax.random.PRNGKey(7),
    )
    wall = time.time() - t0

    # evaluate where the data inform: the central 90% of coalescence mass
    grid = np.geomspace(truth.eta.quantile(0.05), truth.eta.quantile(0.95), 64)
    Ne = np.stack([np.asarray(dm.eta(grid, Ne=True)) for dm in post])
    lo, med, hi = np.quantile(Ne, [0.025, 0.5, 0.975], axis=0)
    true_ne = np.asarray(truth.eta(grid, Ne=True))
    coverage = float(((true_ne >= lo) & (true_ne <= hi)).mean())

    # TV distance of the posterior-median model vs truth
    from phlash_tpu.size_history import SizeHistory

    med_eta = SizeHistory(t=grid, c=1.0 / (2.0 * med))
    tv = float(truth.eta.tv(med_eta))

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(5, 3.2))
        ax.fill_between(grid, lo, hi, alpha=0.25, label="posterior 95%")
        ax.plot(grid, med, label="posterior median")
        ax.plot(grid, true_ne, "k--", label="truth")
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_xlabel("time (coalescent units)")
        ax.set_ylabel("Ne")
        ax.set_title(name)
        ax.legend(fontsize=7)
        fig.tight_layout()
        out = os.path.join(os.path.dirname(__file__), "..", "docs", f"validation_{name}.png")
        fig.savefig(out, dpi=130)
    except Exception:
        pass

    print(
        f"{name}: tv(median, truth) = {tv:.3f}, 95%-band coverage = {coverage:.2f}, "
        f"{len(post)} samples, wall {wall:.0f}s"
    )
    return dict(name=name, tv=tv, coverage=coverage, wall=wall)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small sizes for smoke testing")
    ap.add_argument(
        "--simulator",
        choices=["continuous", "hmm"],
        default="continuous",
        help="continuous = exact SMC' process (non-circular, default); "
        "hmm = the discretized HMM the likelihood assumes",
    )
    ap.add_argument(
        "--n-samples",
        type=int,
        default=1,
        help="diploid samples per contig (continuous simulator only); "
        ">1 validates the multi-sample composite-likelihood path",
    )
    args = ap.parse_args()

    from phlash_tpu.sim import (
        bottleneck_demography,
        constant_demography,
        zigzag_demography,
    )

    L = 100_000 if args.quick else 500_000
    niter = 100 if args.quick else 300
    kw = dict(simulator=args.simulator, n_samples=args.n_samples)
    suffix = "" if args.n_samples == 1 else f"_n{args.n_samples}"
    results = [
        run("constant" + suffix, constant_demography(theta=1e-2), L, niter, **kw),
        run("bottleneck" + suffix, bottleneck_demography(theta=1e-2), L, niter, **kw),
        run("zigzag" + suffix, zigzag_demography(theta=1e-2), L, niter, **kw),
    ]
    worst_tv = max(r["tv"] for r in results)
    print(f"SUMMARY worst tv={worst_tv:.3f}")
    return 0 if worst_tv < 0.25 else 1


if __name__ == "__main__":
    sys.exit(main())
