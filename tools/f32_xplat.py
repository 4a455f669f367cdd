"""Compare the f32 assembly VJP computed on the accelerator vs CPU, identical inputs.

An accelerator whose f32 arithmetic (transcendentals, matmul precision)
is less accurate than the CPU's shows up here as a larger f32 assembly-VJP
error on the device than on the host.  This script runs in ONE process on
the accelerator backend, computes the reference cotangent pullback on the
CPU device (f64 and f32), then the same pullback on the accelerator (f64
and f32), and reports per-particle relative errors of each against
CPU/f64.

Run:  python tools/f32_xplat.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from phlash_tpu.params import PSMCParams
from phlash_tpu.sim import bottleneck_demography, simulate_hmm
from phlash_tpu.training import build_training


def assemble(mcp):
    return PSMCParams.from_dm(mcp.to_dm())


def cast(tree, dt):
    return jax.tree.map(lambda a: a.astype(dt), tree)


def main():
    cpu = jax.devices("cpu")[0]
    acc = jax.devices()[0]
    print("devices:", cpu, acc)

    from phlash_tpu.mcmc import init_mcmc_data

    with jax.default_device(cpu):
        truth = bottleneck_demography(theta=1e-2)
        contigs = [simulate_hmm(truth, L=200_000, key=i) for i in range(3)]
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
        # reference cotangent: HMM-term gradient w.r.t. pp via the dense f64
        # kernel (CPU)
        from phlash_tpu.kernel import get_kernel

        kern = get_kernel(M=16, data=np.asarray(prog.kern.data), backend="dense",
                          double_precision=True)
        inds = jnp.arange(prog.S, dtype=jnp.int32)
        warmup = prog.warmup[inds]

        def dens_of_pp(pps):
            pi = kern.filter_batched(pps, warmup)
            bc = lambda a: jnp.broadcast_to(  # noqa: E731
                a[:, None], (a.shape[0], len(inds)) + a.shape[1:]
            )
            ppc = PSMCParams(*[bc(l) for l in pps])._replace(pi=pi)
            return kern.loglik_batched(ppc, inds).sum()

        pp64 = jax.vmap(assemble)(P64)
        w_pp = jax.grad(dens_of_pp)(pp64)
    print("cotangent ready", flush=True)

    def pullback(dt):
        def f(P, w):
            Pc = cast(P, dt)
            wc = cast(w, dt)
            _, vjp = jax.vjp(jax.vmap(assemble), Pc)
            return cast(vjp(wc)[0], jnp.float64)
        return f

    P_host = jax.tree.map(np.asarray, P64)
    w_host = jax.tree.map(np.asarray, w_pp)

    outs = {}
    for plat, dev in (("cpu", cpu), (acc.platform, acc)):
        for dt in (jnp.float64, jnp.float32):
            with jax.default_device(dev):
                g = jax.jit(pullback(dt))(
                    jax.device_put(P_host, dev), jax.device_put(w_host, dev)
                )
            outs[(plat, dt.__name__)] = jax.tree.map(
                lambda a: np.asarray(a, np.float64), g
            )
            print(f"computed {plat}/{dt.__name__}", flush=True)

    ref = outs[("cpu", "float64")]

    def flat(t):
        B = len(jax.tree.leaves(t)[0])
        return np.concatenate(
            [np.asarray(l, np.float64).reshape(B, -1) for l in jax.tree.leaves(t)], 1
        )

    a2 = flat(ref)
    pn = np.linalg.norm(a2, axis=1) + 1e-12
    for key, g in outs.items():
        if key == ("cpu", "float64"):
            continue
        b2 = flat(g)
        relp = np.linalg.norm(b2 - a2, axis=1) / pn
        bias = np.linalg.norm(b2.mean(0) - a2.mean(0)) / (
            np.linalg.norm(a2.mean(0)) + 1e-12
        )
        print(
            f"{key[0]}/{key[1]:8s} vs cpu/f64: relerr med {np.median(relp):.2e} "
            f"p99 {np.quantile(relp, 0.99):.2e} max {relp.max():.2e} | bias {bias:.2e}",
            flush=True,
        )


if __name__ == "__main__":
    main()
