"""Drill into the f32 assembly-VJP error, stage by stage (CPU only).

tools/f32_combo.py showed the f32 parameter-assembly VJP is wrong by 1-2
orders of magnitude (and biased) in the production regime regardless of
the HMM kernel.  Here the assembly map

    mcp --to_dm--> dm --transition/ect/pi--> (A, lam, pi) --read-off--> pp

is split and each stage's f32 VJP is compared against f64 with the SAME
f64 cotangent, pulled back from the true density gradient:

1. w_pp   = d density / d pp            (f64, dense64 kernel)
2. J^T w  through the full assembly     (f64 vs f32)
3. per-pp-leaf masked cotangents        (which leaf's backprop is wrong)
4. intermediate (A, lam, pi) cotangents (which producer stage is wrong)

Run:  JAX_PLATFORMS=cpu python tools/f32_stage.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

import phlash_tpu.transition as transition
from phlash_tpu.model import log_density_batched
from phlash_tpu.params import PSMCParams
from phlash_tpu.sim import bottleneck_demography, simulate_hmm
from phlash_tpu.training import build_training
from phlash_tpu.kernel import get_kernel


def assemble(mcp):
    "mcp -> pp, the full differentiated parameter graph."
    return PSMCParams.from_dm(mcp.to_dm())


def cast(tree, dt):
    return jax.tree.map(lambda a: a.astype(dt), tree)


def rel(a, b):
    "relative error of b vs a per leaf, scale = per-leaf max |a|."
    out = {}
    for name, x, y in zip(["t_tr", "c_tr", "rho_tr"], jax.tree.leaves(a), jax.tree.leaves(b)):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        out[name] = float(np.abs(y - x).max() / (np.abs(x).max() + 1e-12))
    return out


def main():
    truth = bottleneck_demography(theta=1e-2)
    contigs = [simulate_hmm(truth, L=200_000, key=i) for i in range(3)]
    from phlash_tpu.mcmc import init_mcmc_data

    window_size, overlap = 100, 500
    afs, chunks = init_mcmc_data(contigs, window_size, overlap, None, 20, 1)
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--num-particles", type=int, default=8)
    args = ap.parse_args()

    options = dict(
        niter=300, theta=1e-4, t1=1e-3, tM=15.0, alpha=1.0,
        minibatch_size=5, double_precision_params=True,
        num_particles=args.num_particles,
    )
    prog = build_training(
        chunks, afs, window_size=window_size, overlap=overlap,
        key=jax.random.PRNGKey(7), options=options,
    )
    P64 = prog.state.particles

    inds = jnp.arange(prog.S, dtype=jnp.int32)
    warmup = prog.warmup[inds]
    weights = jnp.array([1.0, prog.N / prog.S, 1.0])
    kern = get_kernel(M=16, data=np.asarray(prog.kern.data), backend="dense",
                      double_precision=True)

    # --- stage 0: which density TERM carries the f32 error ------------------
    # (prior is mcp-direct; AFS flows through dm.eta.etbl, not pp; HMM flows
    # through pp = from_dm(to_dm(mcp)))
    from phlash_tpu.model import log_prior

    def prior_term(P):
        return jax.vmap(log_prior)(P).sum()

    def afs_term(P):
        import phlash_tpu.model as model  # noqa: F401

        dms = jax.vmap(lambda m: m.to_dm())(P)
        n = len(prog.afs) + 1
        T = (jnp.eye(n - 1, dtype=jnp.float32) if prog.afs_transform is None
             else prog.afs_transform.astype(jnp.float32))
        afs32 = prog.afs.astype(jnp.float32)

        def one(dm):
            etbl = dm.eta.etbl(n)
            esfs = (etbl / etbl.sum()).astype(jnp.float32)
            from jax.scipy.special import xlogy

            return xlogy(T @ afs32, T @ esfs).sum()

        return jax.vmap(one)(dms).sum()

    def hmm_term(P):
        pps = jax.vmap(assemble)(P)
        pi = kern.filter_batched(pps, warmup)
        bc = lambda a: jnp.broadcast_to(  # noqa: E731
            a[:, None], (a.shape[0], len(inds)) + a.shape[1:]
        )
        ppc = PSMCParams(*[bc(l) for l in pps])._replace(pi=pi)
        return kern.loglik_batched(ppc, inds).sum()

    for tname, f in (("prior", prior_term), ("afs", afs_term), ("hmm", hmm_term)):
        a = cast(jax.grad(f)(cast(P64, jnp.float64)), jnp.float64)
        b = cast(jax.grad(f)(cast(P64, jnp.float32)), jnp.float64)
        print(f"term {tname:5s} grad f32-vs-f64: {rel(a, b)}", flush=True)

    # --- stage 1: the true pp cotangent (HMM term), f64, per particle ------
    def dens_of_pp(pps):
        pi = kern.filter_batched(pps, warmup)
        bc = lambda a: jnp.broadcast_to(  # noqa: E731
            a[:, None], (a.shape[0], len(inds)) + a.shape[1:]
        )
        ppc = PSMCParams(*[bc(l) for l in pps])._replace(pi=pi)
        return weights[1] * kern.loglik_batched(ppc, inds).sum()

    pp64 = jax.vmap(assemble)(P64)
    w_pp = jax.grad(dens_of_pp)(pp64)

    # --- stage 2: full-assembly VJP in f64 vs f32 --------------------------
    def pullback(P, w, dt):
        Pc = cast(P, dt)
        wc = cast(w, dt)
        _, vjp = jax.vjp(jax.vmap(assemble), Pc)
        return cast(vjp(wc)[0], jnp.float64)

    g64 = pullback(P64, w_pp, jnp.float64)
    g32 = pullback(P64, w_pp, jnp.float32)
    print("full assembly VJP f32-vs-f64:", rel(g64, g32), flush=True)

    # per-particle norms (the combo experiment's metric): find the particles
    # that carry the error, print the worst one's coordinates
    a2 = np.concatenate(
        [np.asarray(l, np.float64).reshape(len(jax.tree.leaves(g64)[0]), -1)
         for l in jax.tree.leaves(g64)], axis=1)
    b2 = np.concatenate(
        [np.asarray(l, np.float64).reshape(len(jax.tree.leaves(g32)[0]), -1)
         for l in jax.tree.leaves(g32)], axis=1)
    pn = np.linalg.norm(a2, axis=1) + 1e-12
    relp = np.linalg.norm(b2 - a2, axis=1) / pn
    order = np.argsort(relp)[::-1]
    print(f"per-particle relerr: med {np.median(relp):.2e} max {relp.max():.2e}")
    for i in order[:3]:
        bad = jax.tree.map(lambda a: np.asarray(a)[i], P64)
        print(f"  worst particle {i}: relerr {relp[i]:.2e} ||g64|| {pn[i]:.2e}")
        print(f"    t_tr={bad.t_tr} rho_tr={float(bad.rho_over_theta_tr):.3f}")
        print(f"    c_tr={bad.c_tr}")
    import pickle

    with open("/tmp/f32_stage_worst.pkl", "wb") as f:
        pickle.dump(jax.tree.map(lambda a: np.asarray(a)[order[:3]], P64), f)

    # --- stage 3: which pp leaf's cotangent carries the error --------------
    for i, name in enumerate(PSMCParams._fields):
        mask = PSMCParams(*[
            jax.tree.leaves(w_pp)[j] if j == i else jnp.zeros_like(jax.tree.leaves(w_pp)[j])
            for j in range(7)
        ])
        a = pullback(P64, mask, jnp.float64)
        b = pullback(P64, mask, jnp.float32)
        r = rel(a, b)
        # report error relative to the FULL f64 gradient scale so leaves with
        # tiny own-gradients don't look falsely alarming
        rfull = {
            k: float(
                np.abs(np.asarray(jax.tree.leaves(b)[j], np.float64)
                       - np.asarray(jax.tree.leaves(a)[j], np.float64)).max()
                / (np.abs(np.asarray(jax.tree.leaves(g64)[j], np.float64)).max() + 1e-12)
            )
            for j, k in enumerate(["t_tr", "c_tr", "rho_tr"])
        }
        print(f"  leaf {name:6s}: own-rel {r} | vs-full {rfull}", flush=True)

    # --- stage 4: producer stages (A vs lam vs pi) --------------------------
    def stage1(mcp):
        dm = mcp.to_dm()
        A = transition.transition_matrix(dm)
        lam = dm.theta * dm.eta.ect()
        pi = dm.eta.pi
        return A, lam, pi

    def stage2(A, lam, pi):
        emis0 = jnp.exp(-lam)
        emis1 = -jnp.expm1(-lam)
        emis0, emis1, pi, A = jax.tree.map(
            lambda a: a.clip(1e-20, 1.0 - 1e-20), (emis0, emis1, pi, A)
        )
        sub = jnp.diagonal(A, -1)
        diag = jnp.diagonal(A, 0)
        sup = jnp.diagonal(A, 1)
        v = A[0, 1:] / A[0, 1]
        u = sup / v
        return PSMCParams(
            b=jnp.append(sub, 0.0), d=diag, u=jnp.append(u, 0.0),
            v=jnp.insert(v, 0, 0.0), emis0=emis0, emis1=emis1, pi=pi,
        )

    mids64 = jax.vmap(stage1)(P64)
    _, vjp2 = jax.vjp(jax.vmap(stage2), *mids64)
    w_mid = vjp2(w_pp)  # (wA, wlam, wpi) in f64

    for i, name in enumerate(["A", "lam", "pi"]):
        mask = tuple(
            w_mid[j] if j == i else jnp.zeros_like(w_mid[j]) for j in range(3)
        )

        def pull_stage1(P, w, dt):
            Pc = cast(P, dt)
            wc = cast(w, dt)
            _, vjp1 = jax.vjp(jax.vmap(stage1), Pc)
            return cast(vjp1(wc)[0], jnp.float64)

        a = pull_stage1(P64, mask, jnp.float64)
        b = pull_stage1(P64, mask, jnp.float32)
        rfull = {
            k: float(
                np.abs(np.asarray(jax.tree.leaves(b)[j], np.float64)
                       - np.asarray(jax.tree.leaves(a)[j], np.float64)).max()
                / (np.abs(np.asarray(jax.tree.leaves(g64)[j], np.float64)).max() + 1e-12)
            )
            for j, k in enumerate(["t_tr", "c_tr", "rho_tr"])
        }
        print(f"  stage {name:3s}: vs-full {rfull}", flush=True)


if __name__ == "__main__":
    main()
