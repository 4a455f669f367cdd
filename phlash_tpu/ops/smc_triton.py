"""Structured SMC' likelihood kernel for NVIDIA GPUs (Pallas, Triton route).

The SMC' transition has O(M) structure

    (x @ A)[j] = b[j] * S(x)[j] + d[j] * x[j] + v[j] * P(u * x)[j]

with S the strict suffix sum and P the strict prefix sum over states
(phlash_tpu.hmm.matvec_smc).  The whole site loop of one HMM runs inside
one launch, in float32 on the CUDA cores; no matrix product is involved.

Layout: a program owns a block of BH particles of one chunk and keeps
their state as one [M, BH] tile in registers; the grid is (chunks,
particle blocks) and nothing carries over between programs.  S and P are
built by pairwise recursion over the state axis (split into even/odd
rows, recurse on the pair sums, interleave back): log2(M) levels, exact
strict sums with no ``total - prefix`` subtraction, so the deep intervals
keep their relative accuracy.  Observations are read as int8 rows (S, L):
every thread of a program reads the same site code, so the branch on it
is uniform.

Forward: the filtered state is rescaled once per NORM_EVERY sites (eight
unnormalised steps cannot underflow float32 at the 1e-4 worst-case per-site
scale), and with residuals the period-start state is written to HBM:
S x L/NORM_EVERY x M x B_pad float32 (409.6 MB at S=5, L=20,000, M=16,
B_pad=512), linear in L and M.

Adjoint: one period at a time, newest first.  The period is rebuilt from
its stored start state (the per-site states go to a small per-program
workspace in HBM), then swept backwards.  Cotangents of the compressed
natural parameters (b, d, u, v, emis0, emis1, pi) are written per
(particle, chunk) and summed over chunks by XLA: no atomics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu
from jax.sharding import NamedSharding, PartitionSpec as P

from phlash_tpu.params import PSMCParams
from phlash_tpu.size_history import DemographicModel

SUPPORTED_M = (8, 16, 32, 64)  # powers of two: the normaliser is a pairwise tree
NORM_EVERY = 8  # sites between rescalings (and between adjoint checkpoints)
TINY_NORM = 1e-30  # normaliser clamp: keeps extreme particles finite
BLOCK_H = 4  # particles per program: many small programs keep the M x BH
# tile light on registers and put B*S/BH latency-bound chains in flight
# (the fastest or within 5% of it at M = 16, 32 and 64 on an H100)
_PARAM_ORDER = ("b", "d", "u", "v", "emis0", "emis1")
# identity-HMM padding: d=1 keeps the state, unit emissions -> ll exactly 0
_PAD_VALUES = (0.0, 1.0, 0.0, 0.0, 1.0, 1.0)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def block_shape(b_local: int) -> tuple[int, int]:
    """(particles per program, warps per program) for b_local particles.

    Triton blocks are powers of two; a block holds at most BLOCK_H
    particles, and one warp per 32 of them."""
    bh = min(BLOCK_H, _next_pow2(max(1, b_local)))
    return bh, max(1, bh // 32)


# ---------------------------------------------------------------------------
# per-site algebra on [M, BH] tiles
# ---------------------------------------------------------------------------


def _pairs(y):
    "(y[0::2], y[1::2]) of an [M, BH] tile."
    m, bh = y.shape
    a, b = jnp.split(y.reshape(m // 2, 2, bh), 2, axis=1)
    return a.reshape(m // 2, bh), b.reshape(m // 2, bh)


def _interleave(e, o):
    "Inverse of _pairs."
    h, bh = e.shape
    return jnp.transpose(jnp.stack([e, o], axis=-1), (0, 2, 1)).reshape(2 * h, bh)


def _prefix_strict(y):
    "P(y)[j] = sum_{k < j} y[k]: pairwise recursion, no subtraction."
    if y.shape[0] == 1:
        return jnp.zeros_like(y)
    a, b = _pairs(y)
    e = _prefix_strict(a + b)
    return _interleave(e, e + a)


def _suffix_strict(y):
    "S(y)[j] = sum_{k > j} y[k]: pairwise recursion, no subtraction."
    if y.shape[0] == 1:
        return jnp.zeros_like(y)
    a, b = _pairs(y)
    s = _suffix_strict(a + b)
    return _interleave(s + b, s)


def _transition(x, th):
    "v = x @ A via the structured form; also returns S(x) and P(u x)."
    b, d, u, vv = th[:4]
    sv = _suffix_strict(x)
    pv = _prefix_strict(u * x)
    return b * sv + d * x + vv * pv, sv, pv


class _Code:
    """One site's observation code as masks (uniform over the block):
    0 hom, 1 het, -1 missing (emission 1), -2 padding (state frozen)."""

    def __init__(self, ob, like):
        ob = jnp.broadcast_to(ob, like.shape)
        self.hom, self.het, self.live = ob == 0, ob == 1, ob >= -1
        self.zero, self.one = jnp.zeros_like(like), jnp.ones_like(like)

    def emission(self, e0, e1):
        return lax.select(self.hom, e0, lax.select(self.het, e1, self.one))


def _site(x, code, th):
    "One site: transition, emission; padding leaves the state frozen."
    v, _, _ = _transition(x, th)
    return lax.select(code.live, v * code.emission(th[4], th[5]), x)


def _obs(obs_ref, t):
    return obs_ref[t].astype(jnp.int32)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _fwd_kernel(th_ref, pi_ref, obs_ref, ll_ref, alpha_ref, *pst_ref):
    th = [th_ref[k] for k in range(len(_PARAM_ORDER))]
    n_per = obs_ref.shape[0] // NORM_EVERY

    def period(p, carry):
        x, ll = carry
        if pst_ref:
            pst_ref[0][p] = x
        t0 = p * NORM_EVERY

        def site(i, x):
            return _site(x, _Code(_obs(obs_ref, t0 + i), x), th)

        x = lax.fori_loop(jnp.int32(0), jnp.int32(NORM_EVERY), site, x)
        c = jnp.maximum(x.sum(axis=0), TINY_NORM)
        return x * (1.0 / c)[None], ll + jnp.log(c)

    x0 = pi_ref[...]
    ll0 = jnp.zeros(x0.shape[1:], x0.dtype)
    x, ll = lax.fori_loop(jnp.int32(0), jnp.int32(n_per), period, (x0, ll0))
    alpha_ref[...] = x
    ll_ref[...] = ll


def _bwd_kernel(th_ref, obs_ref, pst_ref, g_ref, abar_ref, dth_ref, dpi_ref, ws_ref):
    th = [th_ref[k] for k in range(len(_PARAM_ORDER))]
    b, d, u, vv, e0, e1 = th
    g = g_ref[...][None]
    n_per = obs_ref.shape[0] // NORM_EVERY

    def period(q, carry):
        ab, acc = carry
        p = jnp.int32(n_per - 1) - q
        t0 = p * NORM_EVERY

        # rebuild the period from its stored start state, keeping each
        # site's input state in the workspace
        def rebuild(i, x):
            ws_ref[i] = x
            return _site(x, _Code(_obs(obs_ref, t0 + i), x), th)

        x = lax.fori_loop(jnp.int32(0), jnp.int32(NORM_EVERY), rebuild, pst_ref[p])
        r = (1.0 / jnp.maximum(x.sum(axis=0), TINY_NORM))[None]
        # normalisation adjoint: the period emits x / c and log c
        ybar = (ab - (ab * x).sum(axis=0)[None] * r + g) * r

        # interior sites, reversed (unnormalised linear recursion)
        def sweep(k, carry):
            ybar, (db, dd, du, dvv, de0, de1) = carry
            i = jnp.int32(NORM_EVERY - 1) - k
            xi = ws_ref[i]
            code = _Code(_obs(obs_ref, t0 + i), xi)
            v, sv, pv = _transition(xi, th)
            yb = lax.select(code.live, ybar, code.zero)
            dfull = v * yb
            vbar = code.emission(e0, e1) * yb
            t1 = _suffix_strict(vv * vbar)
            acc = (
                db + sv * vbar,
                dd + xi * vbar,
                du + xi * t1,
                dvv + pv * vbar,
                de0 + lax.select(code.hom, dfull, code.zero),
                de1 + lax.select(code.het, dfull, code.zero),
            )
            xbar = _prefix_strict(b * vbar) + d * vbar + u * t1
            return lax.select(code.live, xbar, ybar), acc

        return lax.fori_loop(jnp.int32(0), jnp.int32(NORM_EVERY), sweep, (ybar, acc))

    ab0 = abar_ref[...]
    zeros = tuple(jnp.zeros_like(ab0) for _ in _PARAM_ORDER)
    ybar, acc = lax.fori_loop(jnp.int32(0), jnp.int32(n_per), period, (ab0, zeros))
    dpi_ref[...] = ybar
    for k, a in enumerate(acc):
        dth_ref[k] = a


def _i32(x):
    return lax.convert_element_type(x, jnp.int32)


_Z = np.int32(0)  # index-map literal: a python 0 traces as i64 under x64


def _call(kernel, name, grid, in_specs, out_specs, out_shape, num_warps, interpret):
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name=name,
    )


def forward(th, pi, obs, block_h: int, num_warps: int, interpret: bool = False,
            with_residuals: bool = True):
    """th (6, M, B_pad) f32; pi (S, M, B_pad) f32; obs (S, L_pad) int8 with
    L_pad a multiple of NORM_EVERY.  Returns (ll (S, B_pad), final filtered
    state (S, M, B_pad), period-start states (S, L_pad/NORM_EVERY, M, B_pad)
    or None without residuals)."""
    S, m, B_pad = pi.shape
    L_pad = obs.shape[1]
    assert m in SUPPORTED_M and L_pad % NORM_EVERY == 0 and B_pad % block_h == 0
    n_per = L_pad // NORM_EVERY
    bh = block_h
    vec = lambda s, g: (_i32(s), _i32(g))  # noqa: E731
    rows = lambda s, g: (_i32(s), _Z, _i32(g))  # noqa: E731
    out_specs = [pl.BlockSpec((None, bh), vec), pl.BlockSpec((None, m, bh), rows)]
    out_shape = [
        jax.ShapeDtypeStruct((S, B_pad), jnp.float32),
        jax.ShapeDtypeStruct((S, m, B_pad), jnp.float32),
    ]
    if with_residuals:
        out_specs.append(
            pl.BlockSpec((None, n_per, m, bh), lambda s, g: (_i32(s), _Z, _Z, _i32(g)))
        )
        out_shape.append(jax.ShapeDtypeStruct((S, n_per, m, B_pad), jnp.float32))
    outs = _call(
        _fwd_kernel,
        "smc_forward",
        (S, B_pad // bh),
        [
            pl.BlockSpec((len(_PARAM_ORDER), m, bh), lambda s, g: (_Z, _Z, _i32(g))),
            pl.BlockSpec((None, m, bh), rows),
            pl.BlockSpec((None, L_pad), lambda s, g: (_i32(s), _Z)),
        ],
        out_specs,
        out_shape,
        num_warps,
        interpret,
    )(th, pi, obs)
    return outs[0], outs[1], (outs[2] if with_residuals else None)


def backward(th, obs, pst, g, abar, block_h: int, num_warps: int, interpret: bool = False):
    """Adjoint of `forward`.  g (S, B_pad) cotangent of ll; abar (S, M, B_pad)
    cotangent of the final state.  Returns (dth (6, M, B_pad) summed over
    chunks, dpi (S, M, B_pad))."""
    S, n_per, m, B_pad = pst.shape
    L_pad = obs.shape[1]
    bh = block_h
    nk = len(_PARAM_ORDER)
    vec = lambda s, g_: (_i32(s), _i32(g_))  # noqa: E731
    rows = lambda s, g_: (_i32(s), _Z, _i32(g_))  # noqa: E731
    per_chunk4 = lambda s, g_: (_i32(s), _Z, _Z, _i32(g_))  # noqa: E731
    dth, dpi, _ = _call(
        _bwd_kernel,
        "smc_adjoint",
        (S, B_pad // bh),
        [
            pl.BlockSpec((nk, m, bh), lambda s, g_: (_Z, _Z, _i32(g_))),
            pl.BlockSpec((None, L_pad), lambda s, g_: (_i32(s), _Z)),
            pl.BlockSpec((None, n_per, m, bh), per_chunk4),
            pl.BlockSpec((None, bh), vec),
            pl.BlockSpec((None, m, bh), rows),
        ],
        [
            pl.BlockSpec((None, nk, m, bh), per_chunk4),
            pl.BlockSpec((None, m, bh), rows),
            pl.BlockSpec((None, NORM_EVERY, m, bh), per_chunk4),  # workspace
        ],
        [
            jax.ShapeDtypeStruct((S, nk, m, B_pad), jnp.float32),
            jax.ShapeDtypeStruct((S, m, B_pad), jnp.float32),
            jax.ShapeDtypeStruct((S, NORM_EVERY, m, B_pad), jnp.float32),
        ],
        num_warps,
        interpret,
    )(th, obs, pst, g, abar)
    return dth.sum(0), dpi


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def smc_op(th, pi, obs, block_h: int, num_warps: int, interpret: bool):
    "(ll (S, B_pad), final filtered state (S, M, B_pad)), differentiable in th, pi."
    ll, alpha, _ = forward(th, pi, obs, block_h, num_warps, interpret, with_residuals=False)
    return ll, alpha


def _smc_op_fwd(th, pi, obs, block_h, num_warps, interpret):
    ll, alpha, pst = forward(th, pi, obs, block_h, num_warps, interpret)
    return (ll, alpha), (th, obs, pst)


def _smc_op_bwd(block_h, num_warps, interpret, res, cot):
    th, obs, pst = res
    g, abar = cot
    dth, dpi = backward(th, obs, pst, g, abar, block_h, num_warps, interpret)
    return dth, dpi, None


smc_op.defvjp(_smc_op_fwd, _smc_op_bwd)


# ---------------------------------------------------------------------------
# kernel object
# ---------------------------------------------------------------------------


class TritonKernel:
    """Structured likelihood kernel over a device-resident int8 chunk tensor.

    With `mesh=` the kernel runs under `shard_map`: the particle axis of
    the packed parameters is split over every mesh device, and the gathered
    minibatch rows (S, L) are replicated, as the upstream multi-GPU scheme
    replicates its data.  `interpret=True` runs the Pallas interpreter (CPU
    tests); otherwise the kernel compiles for the GPU and fails loudly
    anywhere else.
    """

    def __init__(self, M: int, data, double_precision: bool = False, mesh=None,
                 interpret: bool = False):
        if M not in SUPPORTED_M:
            raise ValueError(
                f"the triton kernel supports M in {SUPPORTED_M}, got {M}; "
                "use backend='dense' for other M"
            )
        if double_precision:
            raise ValueError("the triton kernel is float32-only; use backend='dense'")
        self.M = M
        self.data = jnp.asarray(data, dtype=jnp.int8)
        self.mesh = mesh
        self.interpret = interpret

    @property
    def float_type(self):
        return jnp.float32

    def layout(self, B: int) -> tuple[int, int, int]:
        "(particles per program, warps per program, padded particle count)."
        n_dev = self.mesh.devices.size if self.mesh is not None else 1
        b_local = -(-B // n_dev)
        bh, nw = block_shape(b_local)
        return bh, nw, n_dev * _ceil_to(b_local, bh)

    def pack(self, pps: PSMCParams, S: int):
        """(th (6, M, B_pad), pi (S, M, B_pad), B, (bh, num_warps)).

        Non-pi leaves are chunk-invariant: their chunk 0 slice is used.
        Padding particles are identity HMMs with a uniform pi."""
        m = self.M
        pi = pps.pi
        if pi.ndim == 2:  # chunk-invariant initial distribution
            pi = jnp.broadcast_to(pi[:, None, :], (pi.shape[0], S, m))
        B = pi.shape[0]
        bh, nw, B_pad = self.layout(B)
        first = lambda a: a[:, 0] if a.ndim == 3 else a  # noqa: E731
        th = jnp.stack([
            jnp.pad(first(getattr(pps, name)).astype(jnp.float32),
                    [(0, B_pad - B), (0, 0)], constant_values=fill)
            for name, fill in zip(_PARAM_ORDER, _PAD_VALUES)
        ]).transpose(0, 2, 1)
        pi = jnp.pad(pi.astype(jnp.float32), [(0, B_pad - B), (0, 0), (0, 0)],
                     constant_values=1.0 / m).transpose(1, 2, 0)
        return th, pi, B, (bh, nw)

    def _rows(self, rows: jnp.ndarray) -> jnp.ndarray:
        "Pad (S, L) rows to a NORM_EVERY multiple; replicate under a mesh."
        L = rows.shape[-1]
        rows = jnp.pad(rows, [(0, 0), (0, _ceil_to(L, NORM_EVERY) - L)], constant_values=-2)
        if self.mesh is not None:
            rows = lax.with_sharding_constraint(rows, NamedSharding(self.mesh, P()))
        return rows

    def _run(self, pps: PSMCParams, rows: jnp.ndarray):
        "(ll (B, S), final state (B, S, M))."
        S = rows.shape[0]
        th, pi, B, (bh, nw) = self.pack(pps, S)
        op = functools.partial(smc_op, block_h=bh, num_warps=nw, interpret=self.interpret)
        if self.mesh is not None:
            axes = tuple(self.mesh.axis_names)
            op = jax.shard_map(
                op,
                mesh=self.mesh,
                in_specs=(P(None, None, axes), P(None, None, axes), P()),
                out_specs=(P(None, axes), P(None, None, axes)),
                # pallas_call outputs carry no varying-manual-axes metadata
                check_vma=False,
            )
        ll, alpha = op(th, pi, self._rows(rows))
        return ll[:, :B].T, alpha[:, :, :B].transpose(2, 0, 1)

    def loglik_batched(self, pps: PSMCParams, inds) -> jnp.ndarray:
        """(B, S) log-likelihoods; pps leaves (B, S, M) (non-pi leaves must be
        chunk-invariant), inds (S,) chunk indices."""
        rows = self.data[jnp.asarray(inds, dtype=jnp.int32)]
        return self._run(pps, rows)[0]

    def filter_batched(self, pps: PSMCParams, warmup: jnp.ndarray) -> jnp.ndarray:
        """Filtered state after the warmup prefixes: (B, S, M), differentiable.

        warmup: (S, overlap) int8 observations (shared across particles)."""
        return self._run(pps, jnp.asarray(warmup, dtype=jnp.int8))[1]

    def loglik(self, pp, index):
        "Single-HMM convenience (oracle tests); pp unbatched, index scalar."
        if isinstance(pp, DemographicModel):
            pp = PSMCParams.from_dm(pp)
        pps = jax.tree.map(lambda a: a[None, None], pp)
        return self.loglik_batched(pps, jnp.asarray(index)[None])[0, 0]

    def __call__(self, pp, index, grad: bool):
        index = jnp.asarray(index)
        assert index.ndim in (0, 1)
        f = self.loglik
        if grad:
            f = jax.value_and_grad(f)
        if index.ndim == 1:
            f = jax.vmap(f, in_axes=(None, 0))
        return f(pp, index)
