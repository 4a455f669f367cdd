#!/usr/bin/env python3
"""Smoke run of phlash_tpu on one NVIDIA GPU (or four with --four).

    python chip_smoke.py            # one card: phases 1-4 below
    python chip_smoke.py --four     # four cards: the sharded SVGD step only

Phases (one process, the only one on the card):

1. device check: JAX must see a GPU; the card's name and power limit come
   from nvidia-smi in a child process that does not import JAX;
2. compile and compare: the triton kernel at B=500, S=5, L=20,000 for
   M in {16, 32, 64}, forward and forward+gradient, against the float64
   scan oracle (values, rtol 1e-4) and the float64 dense backend
   (gradients, per-leaf max-normalised 1e-3);
3. timing: kernel vs what XLA makes of the plain `dense` and `scan`
   backends, the production SVGD step with each backend, and the median
   of the SVGD bandwidth;
4. the fit: `phlash_tpu.fit` at 500 particles, M=16, S=5, chunks of
   20,500 columns, a held-out contig, 30 SVGD iterations.

The last line of standard output is one JSON object naming the device.  Any
failure exits non-zero; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

B, S, L = 500, 5, 20_000  # kernel phases: particles, chunks, columns
VALUE_RTOL = 1e-4  # per (particle, chunk), against the f64 scan oracle
GRAD_TOL = 1e-3  # per leaf, max-normalised, against the f64 dense backend
N_GRAD_ORACLE = 100  # particles the f64 gradient oracle runs on
FIT_WINDOWS = 100_000  # 10 Mb contigs at 100 bp windows -> 20,000-window chunks
FIT_ITERS = 30
SHARDED_RTOL = 1e-4  # --four: sharded vs one-card step, particle coordinates


def card_info() -> str:
    "nvidia-smi's name and power limit, from a child that stays off JAX."
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def timed(fn, *args, reps: int):
    """(first-call seconds, steady per-call seconds) of fn(*args); every call
    ends in block_until_ready."""
    import jax

    t = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t)
    return first, min(times)


def particles(M: int, n: int, seed: int):
    "(n, S, M) PSMCParams of n perturbed size histories (float32)."
    import jax
    import jax.numpy as jnp
    import numpy as np

    from phlash_tpu.params import PSMCParams
    from phlash_tpu.size_history import DemographicModel, SizeHistory

    base = DemographicModel.default(pattern=f"{M}*1", theta=1e-2, rho=1e-2)
    rng = np.random.default_rng(seed)
    c = np.exp(0.5 * rng.standard_normal((n, M)))

    def one(ci):
        dm = base._replace(eta=SizeHistory(t=base.eta.t, c=ci))
        return PSMCParams.from_dm(dm)

    pp = jax.vmap(one)(jnp.asarray(c))
    return jax.tree.map(
        lambda a: jnp.broadcast_to(a[:, None].astype(jnp.float32), (n, S) + a.shape[1:]), pp
    )


def kernel_data(seed: int):
    "(8, L) int8 windows with missing runs; rows 0..S-1 form the minibatch."
    import numpy as np

    rng = np.random.default_rng(seed)
    data = rng.binomial(1, 0.02, size=(8, L)).astype(np.int8)
    data[1, 5_000:6_000] = -1  # missing block
    data[3, L - 777:] = -1  # missing tail
    return data


def leaf_errors(fields, got, want, M):
    "Per leaf: max-normalised error, and the deepest interval's own error."
    import numpy as np

    out = {}
    for name, a, b in zip(fields, got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if name != "pi":  # the kernel reads chunk-invariant leaves at chunk 0
            a, b = a.sum(1), b.sum(1)
        err = np.abs(a - b).max() / (np.abs(b).max() + 1e-300)
        deep = np.abs(a[..., M - 1] - b[..., M - 1]).max() / (
            np.abs(b[..., M - 1]).max() + 1e-300
        )
        out[name] = (float(err), float(deep))
    return out


def phase_compare(M: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from phlash_tpu.hmm import PureXLAKernel
    from phlash_tpu.kernel import get_kernel
    from phlash_tpu.ops.check import dense_f64_value_and_grad

    data = kernel_data(M)
    pps = particles(M, B, seed=M)
    inds = jnp.arange(S, dtype=jnp.int32)
    W = jnp.asarray(np.random.default_rng(1).uniform(0.5, 1.5, (B, S)), jnp.float32)
    kern = get_kernel(M=M, data=data, backend="triton")
    assert type(kern).__name__ == "TritonKernel"

    fwd = jax.jit(lambda p: kern.loglik_batched(p, inds))
    vg = jax.jit(jax.value_and_grad(lambda p: (kern.loglik_batched(p, inds) * W).sum()))
    for name, f in (("fwd", fwd), ("fwd+grad", vg)):
        t = time.perf_counter()
        compiled = f.lower(pps).compile()
        print(f"[compare M={M}] {name} compile {time.perf_counter() - t:.2f} s; "
              f"memory_analysis: {compiled.memory_analysis()}", flush=True)

    ll = np.asarray(fwd(pps))
    assert ll.shape == (B, S) and np.isfinite(ll).all(), "non-finite kernel values"
    oracle = PureXLAKernel(M=M, data=data, double_precision=True)
    want = np.asarray(jax.jit(oracle.loglik_batched)(
        jax.tree.map(lambda a: a.astype(jnp.float64), pps), inds))
    rel = float((np.abs(ll - want) / np.abs(want)).max())
    print(f"[compare M={M}] value max rel err {rel:.3e} (limit {VALUE_RTOL:.0e}) "
          f"over {B}x{S} (particle, chunk); ll range [{want.min():.1f}, {want.max():.1f}]",
          flush=True)
    assert rel <= VALUE_RTOL, f"M={M}: value error {rel:.3e} > {VALUE_RTOL}"

    val, g = vg(pps)
    n = N_GRAD_ORACLE
    sub = jax.tree.map(lambda a: a[:n], pps)
    _, gd = dense_f64_value_and_grad(data, sub, inds, W[:n], seg_len=256)
    errs = leaf_errors(pps._fields, [a[:n] for a in g], gd, M)
    for name, (err, deep) in errs.items():
        print(f"[compare M={M}] grad {name:5s} max-normalised err {err:.3e} "
              f"(limit {GRAD_TOL:.0e}); deepest interval, own scale {deep:.3e}", flush=True)
    worst = max(e for e, _ in errs.values())
    assert worst <= GRAD_TOL, f"M={M}: gradient error {worst:.3e} > {GRAD_TOL}"


def fit_data():
    "Training contigs + held-out contig from the exact continuous SMC'."
    from phlash_tpu.sim import bottleneck_demography, simulate_smc_continuous

    truth = bottleneck_demography(theta=1e-2)
    t = time.perf_counter()
    train = [simulate_smc_continuous(truth, L=FIT_WINDOWS, seed=i) for i in range(5)]
    test = simulate_smc_continuous(truth, L=FIT_WINDOWS, seed=99)
    het = sum(int((c.het_matrix == 1).sum()) for c in train)
    print(f"[data] {len(train)} training contigs + 1 held-out, {FIT_WINDOWS} windows "
          f"each (100 bp), {het} het windows in training; simulated in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    return truth, train, test


FIT_OPTS = dict(theta=1e-4, t1=1e-3, tM=15.0, alpha=1.0, num_workers=1, progress=False)


def training_program(train, backend, mesh=None, multiple_of=1):
    """The production SVGD program (500 particles, S=5) on the fit's chunks,
    their count cut to a multiple of `multiple_of` (a mesh's chunk axis
    must divide it)."""
    import jax

    from phlash_tpu.data import init_mcmc_data
    from phlash_tpu.training import build_training

    afs, chunks = init_mcmc_data(train, 100, 500, None, 20, 1)
    chunks = chunks[: len(chunks) - len(chunks) % multiple_of]
    opts = dict(FIT_OPTS, num_particles=B, minibatch_size=S, kernel_backend=backend,
                steps_per_call=1, niter=1000, mesh=mesh)
    prog = build_training(chunks, afs, window_size=100, overlap=500,
                          key=jax.random.PRNGKey(0), options=opts)
    return prog, chunks.shape


def phase_timing(train) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from phlash_tpu.kernel import get_kernel
    from phlash_tpu.svgd import median_bandwidth

    M = 16
    data = kernel_data(M)
    pps = particles(M, B, seed=M)
    inds = jnp.arange(S, dtype=jnp.int32)
    W = jnp.ones((B, S), jnp.float32)
    msites = B * S * L / 1e6
    for backend, reps in (("triton", 10), ("dense", 1), ("scan", 1)):
        kern = get_kernel(M=M, data=data, backend=backend)
        fwd = jax.jit(lambda p, k=kern: k.loglik_batched(p, inds))
        vg = jax.jit(jax.value_and_grad(lambda p, k=kern: (k.loglik_batched(p, inds) * W).sum()))
        for name, f in (("fwd", fwd), ("fwd+grad", vg)):
            first, dt = timed(f, pps, reps=reps)
            print(f"[timing] kernel {backend:6s} {name:8s} M={M} B={B} S={S} L={L}: "
                  f"{dt * 1e3:.3f} ms ({msites / dt:.1f} Msites/s); first call "
                  f"{first:.2f} s", flush=True)

    for backend, reps in (("triton", 10), ("dense", 1), ("scan", 1)):
        prog, shape = training_program(train, backend)
        step = jax.jit(prog.step)
        key = jax.random.PRNGKey(3)
        first, dt = timed(step, prog.state, key, reps=reps)
        print(f"[timing] SVGD step {backend:6s} P={B} S={S} chunks {shape}: "
              f"{dt * 1e3:.3f} ms; first call (compile) {first:.2f} s", flush=True)

    # the SVGD bandwidth's median at P=500 (a full sort of P^2 distances)
    x = np.random.default_rng(5).normal(size=(B, 19)).astype(np.float32)
    sq = jnp.asarray(((x[:, None] - x[None]) ** 2).sum(-1))
    _, dt = timed(jax.jit(lambda sq: median_bandwidth(sq, B)), sq, reps=20)
    print(f"[timing] SVGD median bandwidth P={B}: {dt * 1e3:.4f} ms", flush=True)


def phase_fit(truth, train, test) -> None:
    import jax
    import numpy as np

    import phlash_tpu

    compile_s = []

    def listen(event, secs, **_):
        if event.startswith("/jax/core/compile/"):
            compile_s.append(secs)

    jax.monitoring.register_event_duration_secs_listener(listen)
    t = time.perf_counter()
    post = phlash_tpu.fit(train, test_data=test, niter=FIT_ITERS, num_particles=B,
                          minibatch_size=S, elpd_cutoff=100,
                          key=jax.random.PRNGKey(7), **FIT_OPTS)
    wall = time.perf_counter() - t
    comp = sum(compile_s)
    # eta.c of each posterior sample at the truth's interval midpoints (the
    # fit's time grid differs from the truth's)
    t = np.asarray(truth.eta.t)
    grid = np.append(0.5 * (t[:-1] + t[1:]), 1.5 * t[-1])
    c = np.stack([np.asarray(dm.eta(grid)) for dm in post])
    assert len(post) == B and np.isfinite(c).all(), "non-finite posterior"
    print(f"[fit] {B} particles, M={post[0].M}, S={S}, {FIT_ITERS} iterations: wall "
          f"{wall:.2f} s = compile {comp:.2f} s + steps and host {wall - comp:.2f} s",
          flush=True)
    print(f"[fit] at t = {np.array2string(grid, precision=3)}", flush=True)
    print(f"[fit] posterior median eta.c: {np.array2string(np.median(c, 0), precision=3)}",
          flush=True)
    print(f"[fit] truth eta.c:            "
          f"{np.array2string(np.asarray(truth.eta(grid)), precision=3)}", flush=True)


def phase_four() -> None:
    import jax
    import numpy as np

    from phlash_tpu.parallel import make_mesh, shard_training_step

    assert len(jax.devices()) >= 4, "--four needs four GPUs"
    _, train, _ = fit_data()
    prog, shape = training_program(train, "triton", multiple_of=4)
    key = jax.random.PRNGKey(11)
    t = time.perf_counter()
    want = jax.block_until_ready(jax.jit(prog.step)(prog.state, key))
    print(f"[four] one-card step (first call) {time.perf_counter() - t:.2f} s", flush=True)

    mesh = make_mesh(4)
    prog4, _ = training_program(train, "triton", mesh=mesh, multiple_of=4)
    place, jit_step = shard_training_step(prog4.step, mesh)
    state = place(prog4.state)
    step = jit_step(state)
    first, dt = timed(step, state, key, reps=2)
    got = step(state, key)
    worst = 0.0
    for a, b in zip(jax.tree.leaves(got.particles), jax.tree.leaves(want.particles)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        worst = max(worst, float((np.abs(a - b) / (np.abs(b) + 1e-6)).max()))
    print(f"[four] mesh {dict(mesh.shape)} chunks {shape}: sharded step "
          f"{dt * 1e3:.3f} ms (first call {first:.2f} s); max rel diff vs one card "
          f"{worst:.3e} (limit {SHARDED_RTOL:.0e})", flush=True)
    assert worst <= SHARDED_RTOL, f"sharded step differs: {worst:.3e}"
    for _ in range(5):
        state = step(state, key := jax.random.split(key)[0])
    leaves = [np.asarray(x) for x in jax.tree.leaves(state.particles)]
    assert all(np.isfinite(x).all() for x in leaves), "non-finite sharded fit state"
    print("[four] 5 further sharded steps: particles finite", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded SVGD step and its comparison")
    ap.add_argument("--only", default="compare,timing,fit",
                    help="comma-separated one-card phases to run")
    args = ap.parse_args()

    import phlash_tpu  # noqa: F401  (fails outside a checkout of the repo)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX reports platform {dev.platform!r}", file=sys.stderr)
        return 2
    print(f"[device] {card_info()}", flush=True)
    print(f"[device] jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}; "
          f"compile cache {jax.config.jax_compilation_cache_dir}", flush=True)
    if args.four:
        phase_four()
    else:
        phases = args.only.split(",")
        if "compare" in phases:
            for M in (16, 32, 64):
                phase_compare(M)
        if "timing" in phases or "fit" in phases:
            truth, train, test = fit_data()
            if "timing" in phases:
                phase_timing(train)
            if "fit" in phases:
                phase_fit(truth, train, test)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
