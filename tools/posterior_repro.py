"""Posterior reproduction: phlash_tpu.fit vs the REFERENCE stack, end to end.

Every layer below the sampler is machine-checked against the reference by
tools/ref_parity.py (values + gradients at f64), and the sampler update is
checked against tools/vendored_svgd.py (a transcription of the blackjax
semantics the reference runs).  This harness closes the north-star claim —
"reproduce reference posteriors within test tolerance" — at the *posterior*
level: it composes the reference's own pure modules (model, params, hmm,
size_history, afs) with the vendored sampler into a runnable reference
``fit`` (a faithful re-enactment of /root/reference/src/phlash/mcmc.py:34-314
on the CPU scan kernel), runs it and ``phlash_tpu.fit`` on ONE simulated
dataset with the same hyper-parameters and init discipline (same pattern /
t1 / tM / sigma / learning rate / particle count / minibatch size; both
packages derive Watterson's theta from the identical chunk tensor), and
compares the two posterior clouds:

  * TV distance between the posterior-median coalescence densities
    (the reference's own headline evaluation metric, SizeHistory.tv) —
    cross-package TV must be well inside the 0.25 budget tools/validate.py
    allows between a posterior median and the TRUTH;
  * mutual band coverage: each package's median curve must lie inside the
    other package's 95% posterior band over (almost) the whole grid;
  * both packages' TV to the simulated truth, as context.

The two runs use different PRNG keys on purpose: SVGD is a deterministic
map, so with identical keys the comparison would degenerate into the
step-level parity ref_parity §9 already proves.  Independent keys make this
a statement about the *posterior approximation* both packages converge to.

AFS handling: the reference's autodiff gradient of the AFS term is NaN at
generic parameters (the where/expm1 trap documented in ref_parity §7), so a
reference fit driven by ``grad(log_density)`` with an AFS term can blow up
where phlash_tpu does not.  The harness probes the reference gradient at the
init point and includes the AFS term only if the reference side can actually
differentiate it (it prints which composite was compared).

Usage:  JAX_PLATFORMS=cpu python tools/posterior_repro.py [--quick]
Exit 0 iff the clouds agree.  Budgeted for the 1-core CI host (~10 min).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# this harness is CPU-by-design (the reference side runs its scan kernel),
# so the platform is pinned in-process before the first jax use
os.environ["JAX_PLATFORMS"] = "cpu"
import jax as _jax

_jax.config.update("jax_platforms", "cpu")

import numpy as np

from ref_parity import import_reference


def reference_fit(ref, chunks, afs, window_size, overlap, options):
    """Re-enactment of the reference's fit loop on its own pure modules.

    Follows /root/reference/src/phlash/mcmc.py step for step from the point
    where (afs, chunks) exist: Watterson init (mcmc.py:146-176), default
    fold+BWS AFS transform (mcmc.py:104-113), particle init from
    N(ravel(init), sigma*I) (mcmc.py:181-195), blackjax-semantics SVGD with
    optax.amsgrad (mcmc.py:178-199 via tools/vendored_svgd.py), minibatch
    indices jax.random.choice(subkey, N, (S,)) with the [1, N/S, 1] composite
    weights (mcmc.py:240-283), returning the final particle cloud as
    DemographicModels in per-window units rescaled to per-bp (mcmc.py:261-268).
    """
    import jax
    import jax.numpy as jnp
    import optax
    from jax.flatten_util import ravel_pytree

    import vendored_svgd

    key = options["key"]
    niter = options["niter"]
    P = options["num_particles"]
    S = options["minibatch_size"]
    N = len(chunks)

    ch0 = chunks[:, overlap:]
    watterson = ch0[ch0 > -1].mean() / window_size
    theta = float(options.get("theta", watterson))
    rho = options.get("rho_over_theta", 1.0) * theta
    pat = "14*1+1*2"
    init = ref.params.MCMCParams.from_linear(
        pattern=pat,
        rho=rho * window_size,
        t1=options.get("t1", 1e-4),
        tM=options.get("tM", 15.0),
        c=jnp.ones(15),
        theta=theta * window_size,
        alpha=options.get("alpha", 0.0),
        beta=options.get("beta", 0.0),
    )

    if afs is not None:
        T1 = ref.afs.fold_transform(len(afs) + 1)
        T2 = ref.afs.bws_transform(T1 @ afs)
        afs_transform = T2 @ T1
        afs_j = jnp.asarray(afs)
    else:
        afs_transform = afs_j = None

    warmup_chunks, data_chunks = np.split(chunks, [overlap], axis=1)
    kern = ref.hmm.PureJaxPSMCKernel(
        M=init.M, data=np.ascontiguousarray(data_chunks), double_precision=False
    )

    def log_density(mcp, **kw):
        return ref.model.log_density(mcp, **kw)

    # probe: can the reference differentiate its own full composite here?
    use_afs = afs_j is not None
    if use_afs:
        g = jax.grad(
            lambda m: log_density(
                m,
                c=jnp.array([1.0, N / S, 1.0]),
                inds=jnp.arange(S),
                warmup=jnp.asarray(warmup_chunks[:S], dtype=jnp.int8),
                kern=kern,
                afs=afs_j,
                afs_transform=afs_transform,
            )
        )(init)
        finite = all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(g))
        if not finite:
            print(
                "reference gradient of the AFS composite is NaN at init (the "
                "known where/expm1 trap) — comparing the chunk-HMM composite"
            )
            use_afs = False
    kw_afs = (
        dict(afs=afs_j, afs_transform=afs_transform) if use_afs else dict(afs=None)
    )

    opt = optax.amsgrad(learning_rate=options.get("learning_rate", 0.1))
    svgd = vendored_svgd.svgd(jax.grad(lambda m, **kw: log_density(m, **kw)), opt)

    x0, unravel = ravel_pytree(init)
    key, k_init = jax.random.split(key)
    particles = jax.vmap(unravel)(
        jax.random.multivariate_normal(
            k_init, x0, options.get("sigma", 1.0) * jnp.eye(len(x0)), shape=(P,)
        )
    )
    state = svgd.init(particles)
    step = jax.jit(svgd.step, static_argnames=["kern"])

    cw = jnp.array([1.0, N / S, 1.0])
    for _ in range(niter):
        key, sub = jax.random.split(key)
        inds = np.asarray(jax.random.choice(sub, N, shape=(S,)))
        state = step(
            state,
            kern=kern,
            c=cw,
            inds=jnp.asarray(inds),
            warmup=jnp.asarray(warmup_chunks[inds], dtype=jnp.int8),
            **kw_afs,
        )
        flat, _ = ravel_pytree(state.particles)
        if not bool(jnp.isfinite(flat).all()):
            raise RuntimeError("reference fit produced non-finite particles")

    dms = jax.vmap(ref.params.MCMCParams.to_dm)(state.particles)
    dms = dms._replace(theta=dms.theta / window_size, rho=dms.rho / window_size)
    return dms, use_afs


def ne_curves(t_knots, c_knots, grid):
    """Piecewise-constant Ne(t)=1/(2c) for a (P, K) knot cloud on `grid`."""
    out = []
    for t, c in zip(np.asarray(t_knots), np.asarray(c_knots)):
        idx = np.minimum(np.searchsorted(t, grid, side="right") - 1, len(c) - 1)
        out.append(1.0 / (2.0 * c[idx]))
    return np.stack(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="smaller run (smoke only)")
    ap.add_argument("--json", default=None, help="write summary JSON here")
    args = ap.parse_args()

    import jax

    ref = import_reference()

    import phlash_tpu
    from phlash_tpu.data import init_mcmc_data
    from phlash_tpu.sim import bottleneck_demography, simulate_smc_continuous
    from phlash_tpu.size_history import SizeHistory

    # one dataset, simulated from the exact continuous-time SMC' generative
    # model (independent of both packages' discretized likelihood code)
    truth = bottleneck_demography(theta=1e-2)
    L = 2_000_000 if args.quick else 6_000_000
    n_contigs = 1 if args.quick else 2
    niter = 40 if args.quick else 250
    P = 16 if args.quick else 48
    window_size, overlap, chunk_size = 100, 500, 2000

    contigs = [
        simulate_smc_continuous(truth, L=L, seed=i, n_samples=1)
        for i in range(n_contigs)
    ]
    afs, chunks = init_mcmc_data(contigs, window_size, overlap, chunk_size, 20, 1)
    print(f"dataset: {len(chunks)} chunks x {chunks.shape[1]} windows, afs={afs}")

    shared = dict(
        niter=niter,
        num_particles=P,
        minibatch_size=5,
        learning_rate=0.1,
        sigma=1.0,
        theta=1e-4,  # per-bp, matching the simulator scale (as validate.py)
        t1=1e-3,
        tM=15.0,
    )

    t0 = time.time()
    ref_dms, ref_used_afs = reference_fit(
        ref,
        chunks,
        afs,
        window_size,
        overlap,
        dict(shared, key=jax.random.PRNGKey(2)),
    )
    t_ref = time.time() - t0
    print(f"reference fit: {t_ref:.0f}s (afs term: {ref_used_afs})")

    t0 = time.time()
    ours = phlash_tpu.fit(
        contigs,
        test_data=None,
        window_size=window_size,
        overlap=overlap,
        chunk_size=chunk_size,
        num_workers=1,
        progress=False,
        key=jax.random.PRNGKey(7),
        **shared,
    )
    t_ours = time.time() - t0
    print(f"phlash_tpu fit: {t_ours:.0f}s")

    # common evaluation grid over the data-informed window
    grid = np.geomspace(truth.eta.quantile(0.05), truth.eta.quantile(0.95), 64)
    ne_ref = ne_curves(ref_dms.eta.t, ref_dms.eta.c, grid)
    ne_ours = np.stack([np.asarray(dm.eta(grid, Ne=True)) for dm in ours])

    qs = [0.025, 0.5, 0.975]
    lo_r, med_r, hi_r = np.quantile(ne_ref, qs, axis=0)
    lo_o, med_o, hi_o = np.quantile(ne_ours, qs, axis=0)

    # SizeHistory requires t[0] == 0: extend the first epoch back to 0
    tgrid = np.insert(grid, 0, 0.0)
    med_eta_r = SizeHistory(t=tgrid, c=np.insert(1.0 / (2.0 * med_r), 0, 1.0 / (2.0 * med_r[0])))
    med_eta_o = SizeHistory(t=tgrid, c=np.insert(1.0 / (2.0 * med_o), 0, 1.0 / (2.0 * med_o[0])))
    tv_cross = float(med_eta_o.tv(med_eta_r))
    tv_ref_truth = float(truth.eta.tv(med_eta_r))
    tv_ours_truth = float(truth.eta.tv(med_eta_o))
    cover_ours_in_ref = float(((med_o >= lo_r) & (med_o <= hi_r)).mean())
    cover_ref_in_ours = float(((med_r >= lo_o) & (med_r <= hi_o)).mean())
    med_log_gap = float(np.max(np.abs(np.log(med_o / med_r))))

    print(
        f"tv(median_ours, median_ref) = {tv_cross:.4f}  "
        f"[tv to truth: ref {tv_ref_truth:.3f}, ours {tv_ours_truth:.3f}]"
    )
    print(
        f"mutual 95%-band coverage: ours-in-ref {cover_ours_in_ref:.2f}, "
        f"ref-in-ours {cover_ref_in_ours:.2f}; max |log Ne ratio| {med_log_gap:.3f}"
    )

    # thresholds: cross-package TV must be far inside the 0.25 budget that
    # tools/validate.py allows vs TRUTH; each median must sit inside the
    # other's 95% band essentially everywhere.  --quick only smoke-tests.
    tv_tol, cover_tol = (0.30, 0.5) if args.quick else (0.10, 0.90)
    ok = (
        tv_cross <= tv_tol
        and cover_ours_in_ref >= cover_tol
        and cover_ref_in_ours >= cover_tol
    )
    summary = dict(
        tv_cross=tv_cross,
        tv_ref_truth=tv_ref_truth,
        tv_ours_truth=tv_ours_truth,
        cover_ours_in_ref=cover_ours_in_ref,
        cover_ref_in_ours=cover_ref_in_ours,
        med_log_gap=med_log_gap,
        ref_used_afs=ref_used_afs,
        wall_ref=t_ref,
        wall_ours=t_ours,
        quick=args.quick,
        ok=ok,
    )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    print(("POSTERIOR REPRO PASS: " if ok else "POSTERIOR REPRO FAIL: ") + json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
