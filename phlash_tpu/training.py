"""Construction of the on-device SVGD training program.

Shared by the user-facing driver (phlash_tpu.mcmc.fit) and the multi-chip
entry points: given a chunk tensor and options, produce the initial particle
state and a pure `(state, key) -> state` step function that performs
minibatch sampling, warmup filtering, likelihood+gradient and the SVGD
update entirely on device.  The step closes over device-resident data so it
can be jitted once (optionally with mesh shardings; see
phlash_tpu.parallel).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.flatten_util import ravel_pytree

from phlash_tpu.afs import default_afs_transform
from phlash_tpu.kernel import get_kernel
from phlash_tpu.model import log_density_batched
from phlash_tpu.params import MCMCParams
from phlash_tpu.svgd import SVGD, SVGDState
from phlash_tpu.utils import Pattern

logger = logging.getLogger(__name__)


def make_multi_step(step: Callable, k: int) -> Callable:
    """Chain `k` SVGD steps into one dispatch via lax.scan.

    One jitted call advances the state by k iterations (fresh minibatch
    key per inner step), amortizing the per-call host/dispatch fixed cost
    — significant when the step graph is a few ms and the device sits
    behind a high-latency transport.  Exactly equivalent to calling
    `step` on the k keys `jax.random.split(key, k)` in sequence.
    """

    def multi(state, key):
        def body(s, kk):
            return step(s, kk), None

        return jax.lax.scan(body, state, jax.random.split(key, k))[0]

    return multi


def resolve_minibatch_size(options: dict, n_chunks: int, niter: int) -> int:
    """The minibatch size S: explicit option, else sized so that a run of
    `niter` steps visits each chunk about once (capped at 5).

    Shared by the driver's device-residency cap and the training program so
    the two can never disagree.
    """
    return options.get("minibatch_size") or max(1, min(5, int(n_chunks / niter)))


@dataclass
class TrainingProgram:
    state: SVGDState
    step: Callable  # (state, key) -> state, pure & jittable; advances
    # `steps_per_call` SVGD iterations per invocation (default 1)
    base_step: Callable  # the single-iteration step `step` wraps (for
    # remainder calls when steps_per_call does not divide niter)
    init: MCMCParams  # the center of the initial particle cloud
    kern: object  # the likelihood kernel (holds device-resident chunks)
    warmup: jax.Array  # (N, overlap) int8 warmup prefixes on device
    afs: jax.Array | None
    afs_transform: jax.Array | None
    N: int  # number of training chunks
    S: int  # minibatch size
    window_size: int
    mutation_rate: float | None
    steps_per_call: int = 1


def build_training(
    chunks: np.ndarray,
    afs: np.ndarray | None,
    *,
    window_size: int,
    overlap: int,
    key: jax.Array,
    options: dict,
) -> TrainingProgram:
    "Assemble particles, kernel and the one-step function from chunked data."
    niter = options.get("niter", 1000)
    mutation_rate = options.get("mutation_rate")
    if options.get("truth"):
        if mutation_rate:
            raise ValueError("mutation rate is already known from truth")
        mutation_rate = options["truth"].theta

    if options.get("afs_transform") is not None:
        afs_transform = options["afs_transform"]
    else:
        afs_transform = default_afs_transform(afs) if afs is not None else None
    if afs_transform is not None:
        afs_transform = jnp.asarray(afs_transform, dtype=jnp.float32)
    if afs is not None:
        afs = jnp.asarray(afs)

    # minibatch size: aim to visit each chunk about once over the run
    S = resolve_minibatch_size(options, len(chunks), niter)
    N = len(chunks)

    # Watterson-style estimate of the scaled mutation rate
    body = chunks[:, overlap:]
    observed = body[body > -1]
    if observed.size == 0 or observed.sum() == 0:
        raise ValueError(
            "the data contain no observed heterozygous sites (all columns "
            "missing or homozygous); cannot estimate theta — pass theta= "
            "explicitly if this is intended"
        )
    watterson = observed.mean() / window_size
    theta = options.get("theta", watterson)
    logger.info("scaled mutation rate theta=%.4g", theta)

    init = options.get("init")
    if init is None:
        if mutation_rate is not None:
            N0 = theta / mutation_rate
            options.setdefault("t1", 1e1 / 2 / N0)
            options.setdefault("tM", 1e6 / 2 / N0)
        t1 = options.get("t1", 1e-4)
        tM = options.get("tM", 15.0)
        rho = options.get("rho_over_theta", 1.0) * theta
        pattern = options.get("pattern", "14*1+1*2")
        init = MCMCParams.from_linear(
            pattern=pattern,
            rho=rho * window_size,
            t1=t1,
            tM=tM,
            c=jnp.ones(len(Pattern(pattern))),
            theta=theta * window_size,
            alpha=options.get("alpha", 0.0),
            beta=options.get("beta", 0.0),
        )
    assert isinstance(init, MCMCParams)

    # particle cloud: Gaussian around the init in flattened coordinates.
    # float32 parameters are the default: the transition assembly is
    # cancellation-free (transition._expQ2), assembly matmuls pin
    # Precision.HIGHEST (a reduced-precision f32 matmul corrupts the
    # scan-VJP gradients), and the remaining transcendentals go through
    # utils/accurate.py's faithfully-rounded f32 exp/expm1/log.
    # double_precision_params=True restores the f64 graph.
    pdtype = jnp.float64 if options.get("double_precision_params", False) else jnp.float32
    init = jax.tree.map(lambda a: jnp.asarray(a, pdtype), init)
    num_particles = options.get("num_particles", 500)
    x0, unravel = ravel_pytree(init)
    key, k_init = jax.random.split(key)
    cov = options.get("sigma", 1.0) * jnp.eye(len(x0), dtype=pdtype)
    draws = jax.random.multivariate_normal(k_init, x0, cov, shape=(num_particles,))
    particles = jax.vmap(unravel)(draws.astype(pdtype))

    opt = optax.amsgrad(learning_rate=options.get("learning_rate", 0.1))
    # one backward pass over the whole particle cloud: particles are
    # independent, so grad of the summed batched density = per-particle grads
    batched_grad = jax.grad(lambda P, **kw: log_density_batched(P, **kw).sum())
    svgd = SVGD(batched_grad, opt, batched_grad=True)
    state = svgd.init(particles)

    # device-resident data: warmup prefixes + likelihood chunks, uploaded
    # once; under a mesh both tensors shard row-wise over the chunk axis
    mesh = options.get("mesh")
    warmup_host, data_host = np.split(chunks, [overlap], axis=1)
    warmup_dev = jnp.asarray(np.ascontiguousarray(warmup_host), dtype=jnp.int8)
    if mesh is not None:
        from phlash_tpu.parallel import chunk_sharding

        warmup_dev = jax.device_put(warmup_dev, chunk_sharding(mesh))
    kern = get_kernel(
        M=init.M,
        data=np.ascontiguousarray(data_host),
        double_precision=options.get("double_precision", False),
        backend=options.get("kernel_backend"),
        mesh=mesh,
    )

    # unbiased minibatch gradients: HMM term scaled by N / S.  f32-pinned:
    # a bare jnp.array of Python floats is f64 under x64 and upcasts the
    # per-particle density combination (f32 * f64 promotes)
    weights = jnp.array([1.0, N / S, 1.0], dtype=jnp.float32)

    def one_step(state: SVGDState, key: jax.Array) -> SVGDState:
        "Sample a minibatch and take one SVGD step — fully on device."
        # int32 indices: x64 would otherwise make the gather int64
        inds = jax.random.choice(key, N, shape=(S,)).astype(jnp.int32)
        return svgd.step(
            state,
            c=weights,
            inds=inds,
            warmup=warmup_dev[inds],
            kern=kern,
            afs=afs,
            afs_transform=afs_transform,
        )

    spc_opt = options.get("steps_per_call")
    if spc_opt is None:
        # default: on accelerator backends, amortize per-call dispatch
        # latency by chaining 10 SVGD iterations inside one jitted call
        # (not yet measured against k=1 on the GPU).  10 matches the
        # default ELPD/finiteness cadence, so the periodic checks land
        # exactly on call boundaries.  CPU keeps per-iteration calls:
        # dispatch is cheap there and tests rely on iteration-granular
        # hooks.
        spc_opt = 10 if jax.devices()[0].platform != "cpu" else 1
    steps_per_call = max(1, min(int(spc_opt), niter))
    step = one_step
    if steps_per_call > 1:
        step = make_multi_step(one_step, steps_per_call)

    return TrainingProgram(
        state=state,
        step=step,
        base_step=one_step,
        init=init,
        kern=kern,
        warmup=warmup_dev,
        afs=afs,
        afs_transform=afs_transform,
        N=N,
        S=S,
        window_size=window_size,
        mutation_rate=mutation_rate,
        steps_per_call=steps_per_call,
    )
