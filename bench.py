"""Benchmark: HMM forward+gradient throughput at the reference workload.

Workload (from BASELINE.json / SURVEY.md §6): M=16 TMRCA states, B=500 SVGD
particles, minibatch of S=5 chunks, float32 — the shape of one SVGD
gradient step's dominant term.  Metric: Msites/sec/chip for the
value-and-gradient pass (sites = B * S * L observation columns); the
forward-only throughput is reported alongside in "extra".

Baseline: the reference's portable kernel semantics — the per-site
rematerialized O(M) `lax.scan` forward (reference src/phlash/hmm.py:68-82,
its fallback on any non-CUDA hardware) differentiated by JAX — measured on
the SAME chip.  (The reference publishes no numbers and its CUDA kernel
cannot run here; BASELINE.md directs that baselines be measured, not
copied.)

Every timing ends in `block_until_ready` after a warm-up call, and the
result names the device it ran on.

Prints exactly one JSON line:
    {"metric": ..., "value": N, "unit": "Msites/sec", "vs_baseline": N, ...}
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def _measure(fn, arg, sites: int, reps: int = 3):
    """Best per-call throughput over `reps` timed calls after a warm-up.

    Returns (best Msites/sec, [per-rep Msites/sec])."""
    jax.block_until_ready(fn(arg))  # compile + warm
    per_rep = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        per_rep.append(sites / (time.perf_counter() - t0) / 1e6)
    return max(per_rep), per_rep


def main():
    from phlash_tpu.hmm import PureXLAKernel
    from phlash_tpu.kernel import get_kernel
    from phlash_tpu.params import PSMCParams
    from phlash_tpu.size_history import DemographicModel

    B, S, L = 500, 5, 20_000
    L_base = 1_000  # the scan baseline is slow; measure it on fewer sites
    rng = np.random.default_rng(0)
    data = rng.binomial(1, 0.05, size=(max(8, S), L)).astype(np.int8)
    data[:, 1000:1100] = -1  # a missing stretch, so that path is in the timing
    dm = DemographicModel.default(pattern="16*1", theta=1e-2, rho=1e-2)
    pp = jax.tree.map(lambda a: a.astype(jnp.float32), PSMCParams.from_dm(dm))
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, S) + a.shape), pp)
    inds = jnp.arange(S)

    # --- our kernel (auto-selected for the platform) ---
    kern = get_kernel(M=16, data=data)

    def loss(p):
        return kern.loglik_batched(p, inds).sum()

    jit_loss, jit_grad = jax.jit(loss), jax.jit(jax.grad(loss))
    ours_fwd, fwd_reps = _measure(jit_loss, pps, B * S * L)
    ours, grad_reps = _measure(jit_grad, pps, B * S * L)

    # --- reference-equivalent scan kernel, same chip ---
    base_kern = PureXLAKernel(M=16, data=data[:, :L_base])

    def base_loss(p):
        per = jax.vmap(base_kern.loglik, (0, 0))
        return jax.vmap(per, (0, None))(p, inds).sum()

    base, _ = _measure(jax.jit(jax.grad(base_loss)), pps, B * S * L_base)

    # --- M=32 and M=64 (the reference's CUDA kernel compiles any M with a
    # perf warning).  Additive: failures land in extras, not the primary metric.
    m32_extra = {}
    for m_alt in (32, 64):
        try:
            dm_a = DemographicModel.default(pattern=f"{m_alt}*1", theta=1e-2, rho=1e-2)
            pp_a = jax.tree.map(lambda a: a.astype(jnp.float32), PSMCParams.from_dm(dm_a))
            pps_a = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, S) + a.shape), pp_a)
            kern_a = get_kernel(M=m_alt, data=data)

            def loss_a(p, kern_a=kern_a):
                return kern_a.loglik_batched(p, inds).sum()

            ma_grad, _ = _measure(jax.jit(jax.grad(loss_a)), pps_a, B * S * L, reps=2)
            ma_fwd, _ = _measure(jax.jit(loss_a), pps_a, B * S * L, reps=2)
            m32_extra.update({
                f"m{m_alt}_fwd_grad_Msites_per_sec": round(ma_grad, 1),
                f"m{m_alt}_fwd_only_Msites_per_sec": round(ma_fwd, 1),
                f"m{m_alt}_backend": type(kern_a).__name__,
            })
        except Exception as e:  # pragma: no cover - additive diagnostics only
            m32_extra[f"m{m_alt}_error"] = str(e)[:200]

    # --- full SVGD step rate (the BASELINE.md north-star "SVGD iters/sec"):
    # the production-shaped training program (500 particles, S=5, 2.5 kb
    # chunks, default steps_per_call) timed end to end.  Additive: any
    # failure is recorded in extras without touching the primary metric.
    step_extra = {}
    try:
        from phlash_tpu.training import build_training

        rng2 = np.random.default_rng(1)
        chunks = rng2.binomial(1, 0.05, size=(2000, 2500)).astype(np.int8)
        afs_arr = rng2.integers(100, 1000, size=9).astype(np.int64)
        prog = build_training(
            chunks,
            afs_arr,
            window_size=100,
            overlap=500,
            key=jax.random.PRNGKey(0),
            options=dict(num_particles=500, minibatch_size=5, niter=1000),
        )
        step = jax.jit(prog.step)
        key = jax.random.PRNGKey(1)
        jax.block_until_ready(step(prog.state, key))  # compile + warm
        spc = prog.steps_per_call
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(step(prog.state, key))
            best = min(best, (time.perf_counter() - t0) / spc)
        step_extra = {
            "svgd_step_ms_per_iter": round(best * 1e3, 2),
            "svgd_iters_per_sec": round(1.0 / best, 1),
            "svgd_steps_per_call": spc,
        }
    except Exception as e:  # pragma: no cover - additive diagnostics only
        step_extra = {"svgd_step_error": str(e)[:200]}

    print(
        json.dumps(
            {
                "metric": "HMM fwd+grad throughput (M=16, B=500, S=5, f32)",
                "value": round(ours, 1),
                "unit": "Msites/sec",
                "vs_baseline": round(ours / base, 2),
                "extra": {
                    "fwd_only_Msites_per_sec": round(ours_fwd, 1),
                    "baseline_fwd_grad_Msites_per_sec": round(base, 1),
                    # the scan baseline is too slow to time at the full
                    # production length; each kernel's L is recorded so the
                    # ratio's asymmetry is self-describing
                    "ours_L": L,
                    "baseline_L": L_base,
                    "fwd_grad_per_rep_Msites_per_sec": [round(x, 1) for x in grad_reps],
                    "fwd_per_rep_Msites_per_sec": [round(x, 1) for x in fwd_reps],
                    "platform": jax.devices()[0].platform,
                    "device_kind": jax.devices()[0].device_kind,
                    "device_count": len(jax.devices()),
                    **m32_extra,
                    **step_extra,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
