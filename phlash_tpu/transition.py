"""SMC' discretized transition matrix over TMRCA intervals.

Builds the M×M transition matrix of the discretized pair-coalescent HMM from
a demographic model, using the closed-form matrix exponential of the 3-state
(no-event / floating-lineage / recoalesced) SMC' generator composed across
time intervals with an associative scan.  Math contract identical to the
reference (/root/reference/src/phlash/transition.py:9-121); the oracle tests
check `expQ` against scipy.linalg.expm and the continuous transition density
`q_s` against quadrature.

The assembled matrix has the compressed structure exploited by the HMM
kernels (see phlash_tpu.params.PSMCParams):
    A[i, j] = b[j]           for i > j   (column-constant lower triangle)
    A[j, j] = d[j]                       (diagonal)
    A[i, j] = u[i] * v[j]    for i < j   (rank-one upper triangle)
"""

from __future__ import annotations

import os as _os

import jax
import jax.numpy as jnp

from phlash_tpu.size_history import DemographicModel
from phlash_tpu.utils import texp_mean
from phlash_tpu.utils.accurate import exp as aexp, expm1 as aexpm1, log as alog
from phlash_tpu.utils.accurate import matmul_hi


def expQ(r, c, n):
    """e^Q for the SMC' rate generator over one interval, in closed form.

    Q generates a 3-state chain: state 0 = lineages coalesced (no
    recombination event separating the two loci yet), state 1 = a floating
    (recombined, not yet re-coalesced) lineage, state 2 = re-coalesced at a
    different time (absorbing).  `r` is the scaled recombination distance and
    `c` the scaled coalescence intensity over the interval; `n` is the sample
    size (n=2 for the pairwise HMM).

    The 2x2 top-left block has eigen-decomposition expressible through
    cosh/sinh; the sinh(u)/u factor is series-expanded for small u so float32
    gradients stay finite.  (reference: transition.py:9-34)
    """
    u = jnp.sqrt((c * n) ** 2 - 2.0 * c * (n - 2) * r + r**2) / 2.0
    v = (r + c * n) / 2.0
    w = (r - c * n) / 2.0
    # e^{-v} cosh(u) and e^{-v} sinh(u)/u, overflow-safe via exp(u-v)
    ch = (aexp(u - v) + aexp(-(u + v))) / 2.0
    tiny = u < 1e-6
    u_ok = jnp.where(tiny, 1.0, u)
    sh_over_u = jnp.where(
        tiny,
        aexp(-v) * (1.0 + u_ok**2 / 6.0),
        (aexp(u - v) - aexp(-(u + v))) / (2.0 * u_ok),
    )
    p00 = ch - w * sh_over_u
    p01 = r * sh_over_u
    p10 = c * sh_over_u
    p11 = ch + w * sh_over_u
    return jnp.array(
        [
            [p00, p01, 1.0 - p00 - p01],
            [p10, p11, 1.0 - p10 - p11],
            [0.0, 0.0, 1.0],
        ]
    )


def _expQ2(r, c, n):
    """The 2×2 live block of e^Q plus stable per-row absorption.

    Returns (P2 (2, 2), p02, p12) where p02/p12 = P(absorbed | start 0/1).
    All quantities are computed without subtracting near-1 values, so the
    tiny absorption probabilities keep full *relative* accuracy in float32
    (the reason the original ``1 - p00 - p01`` form needed float64):

    * row 1: p12 = -[(u+κ)·expm1(u-v) + (u-κ)·expm1(-u-v)] / 2u with
      κ = c + (r - c·n)/2 — the leading terms reinforce, no cancellation;
    * row 0 has κ = v, where the two expm1 terms cancel to O(u·v); for
      small scales it switches to the exact series
      p02 = a·b · Σ_{k≥2} h_{k-2}(a, b) / k!,  a = u-v, b = -(u+v),
      with h_m the complete homogeneous polynomial and a·b = c·r·(n-1).
    """
    u = jnp.sqrt((c * n) ** 2 - 2.0 * c * (n - 2) * r + r**2) / 2.0
    v = (r + c * n) / 2.0
    w = (r - c * n) / 2.0
    ab = c * r * (n - 1)  # == -(u² - v²), exact
    # a = u - v would cancel catastrophically when u ≈ v (r << c); the
    # identity a = (u² - v²)/(u + v) is exact and well-conditioned
    upv = u + v
    a = -ab / jnp.where(upv == 0.0, 1.0, upv)
    b = -upv
    ea, eb = aexpm1(a), aexpm1(b)

    tiny = u < 1e-6
    u_ok = jnp.where(tiny, 1.0, u)
    exp_a, exp_b = aexp(a), aexp(b)  # both <= 1: a, b <= 0
    # (e^a - e^b) as expm1(a) - expm1(b): exact where both exps are near 1
    shu = jnp.where(
        tiny, aexp(-v) * (1.0 + u_ok**2 / 6.0), (ea - eb) / (2.0 * u_ok)
    )
    # u ± w: one of the pair cancels when |w| ≈ u (r << c·n or >>); recover
    # it from the exact identity u² - w² = c·r through the stable one.
    # The degenerate u = w = 0 case (then c·r = 0 too) is guarded with a
    # where, not a floor: a 1e-300 floor underflows to 0 in float32
    big_raw = u + jnp.abs(w)
    big = jnp.where(big_raw == 0.0, 1.0, big_raw)
    small = c * r / big
    s_plus = jnp.where(w <= 0, small, big)  # u + w
    s_minus = jnp.where(w <= 0, big, small)  # u - w
    p00 = jnp.where(
        tiny, aexp(-v) * (1.0 - w), (exp_a * s_minus + exp_b * s_plus) / (2.0 * u_ok)
    )
    p11 = jnp.where(
        tiny, aexp(-v) * (1.0 + w), (exp_a * s_plus + exp_b * s_minus) / (2.0 * u_ok)
    )
    P2 = jnp.array([[p00, r * shu], [c * shu, p11]])

    # row 0 absorption
    generic0 = (b * ea - a * eb) / (2.0 * u_ok)
    series, h, bp, fact = 0.0, jnp.ones_like(a), jnp.ones_like(a), 2.0
    for k in range(2, 8):  # truncation error O(scale^6 / 8!) — below f32 eps
        series = series + h / fact
        bp = bp * b
        h = a * h + bp
        fact = fact * (k + 1)
    p02 = jnp.where(jnp.maximum(jnp.abs(a), jnp.abs(b)) < 0.05, ab * series, generic0)

    # row 1 absorption
    kappa = c + w
    generic1 = -((u_ok + kappa) * ea + (u_ok - kappa) * eb) / (2.0 * u_ok)
    limit1 = -(aexpm1(-v) + kappa * aexp(-v))  # u -> 0
    p12 = jnp.where(tiny, limit1, generic1)
    return P2, p02, p12


def transition_matrix(dm: DemographicModel, n: int = 2) -> jax.Array:
    """M×M SMC' transition matrix between discretized TMRCA intervals.

    Strategy (reference: transition.py:37-85): augment the time grid with the
    per-interval expected coalescence times and propagate the 3-state chain
    across all sub-intervals.  Unlike the reference, only the 2×2 live block
    is scanned (absorption never flows back), and absorbed mass is
    accumulated per sub-interval as a0·p02 + a1·p12 from the stable per-row
    absorption probabilities — never as a difference of near-1 cumulative
    products.  This keeps every entry accurate in *relative* terms at
    float32 (the original formulation required float64 assembly).
    """
    eta = dm.eta
    c_adj = eta.c * (n - 1)
    t = eta.t
    dt = jnp.diff(t)

    # sub-interval lengths t_i->e_i and e_i->t_{i+1}, computed directly from
    # the truncated-exponential mean fraction (e_i = t_i + dt_i*g_i): a
    # float32 diff of the interleaved grid would cancel catastrophically
    # when dt << t
    gfrac = texp_mean(eta.c[:-1] * dt)
    d_te = jnp.append(jnp.maximum(dt * gfrac, 0.0), 1.0 / eta.c[-1])
    d_et = jnp.maximum(dt * (1.0 - gfrac), 0.0)
    dgrid = jnp.append(jnp.stack([d_te[:-1], d_et], axis=1).reshape(-1), d_te[-1])
    degenerate = jnp.isclose(dgrid, 0.0)
    dgrid_ok = jnp.where(degenerate, 1.0, dgrid)
    c_rep = jnp.repeat(eta.c, 2)[:-1]
    P2, p02, p12 = jax.vmap(_expQ2, (0, 0, None))(
        2.0 * dgrid_ok * dm.rho, dgrid_ok * c_rep, n
    )
    eye2 = jnp.eye(2, dtype=P2.dtype)  # dtype-pinned: jnp.eye defaults to
    # f64 under x64 and would silently promote an f32 assembly
    P2 = jnp.where(degenerate[:, None, None], eye2[None], P2)
    p02 = jnp.where(degenerate, 0.0, p02)
    p12 = jnp.where(degenerate, 0.0, p12)

    if _os.environ.get("PHLASH_TPU_SCAN_ELEMENTWISE", "1").lower() in (
        "0",
        "false",
    ):
        # opt-out fallback: the dot_general scan over tiny batched 2x2
        # matmuls (the tuple combine below is the default).
        cum2 = jax.lax.associative_scan(
            matmul_hi, jnp.concatenate([eye2[None], P2], axis=0)
        )
        a0, a1 = cum2[:, 0, 0], cum2[:, 0, 1]
    else:

        def mm2(x, y):
            # x @ y for 2×2 blocks carried as a 4-tuple of entry vectors:
            # exactly-rounded f32 elementwise mul/adds (so the precision
            # pin that motivated matmul_hi is moot here), with no tiny
            # batched dot_general over 2×2 blocks; carrying the entries as
            # a tuple (not a stacked array sliced inside the combine) keeps
            # the scan's VJP graph small.
            x00, x01, x10, x11 = x
            y00, y01, y10, y11 = y
            return (
                x00 * y00 + x01 * y10,
                x00 * y01 + x01 * y11,
                x10 * y00 + x11 * y10,
                x10 * y01 + x11 * y11,
            )

        one = jnp.ones_like(p02[:1])
        zero = jnp.zeros_like(p02[:1])
        a0, a1, _, _ = jax.lax.associative_scan(
            mm2,
            (
                jnp.concatenate([one, P2[:, 0, 0]]),
                jnp.concatenate([zero, P2[:, 0, 1]]),
                jnp.concatenate([zero, P2[:, 1, 0]]),
                jnp.concatenate([one, P2[:, 1, 1]]),
            ),
        )
    # a0/a1: live occupancy (row 0 of the cumulative product) entering
    # interval k
    # absorbed mass within sub-interval k; a trailing pseudo-interval with
    # p02 = p12 = 1 plays the reference's absorbing tail block
    inc = jnp.append(a0[:-1] * p02 + a1[:-1] * p12, a0[-1] + a1[-1])

    at_e0, at_e1 = a0[1::2], a1[1::2]  # live occupancy at each e_i

    i, j = jnp.ogrid[: dm.M, : dm.M]

    # lower triangle: absorption within full interval j = its two halves
    lower_j = inc[0::2] + inc[1::2]
    lower = lower_j[jnp.broadcast_to(j, (dm.M, dm.M))] * (i > j)

    # diagonal: no recombination by e_i, or floating at e_i but re-coalescing
    # before t_{i+1}, or already re-coalesced within [t_i, e_i]
    p_back = jnp.append(-aexpm1(-d_et * c_adj[:-1]), 1.0)
    diag = at_e0 + at_e1 * p_back + inc[0::2]

    # upper triangle: floating at e_i, survives to t_{i+1}, then survives each
    # intermediate interval l and finally coalesces in interval j
    esc = jnp.append(aexp(-d_et * c_adj[:-1]), 0.0)
    p_float_out = (at_e1 * esc).clip(1e-8, 1.0 - 1e-8)  # leaves interval i
    p_surv = jnp.append(aexp(-dt * c_adj[:-1]), 0.0).clip(1e-8, 1.0 - 1e-8)
    p_coal = jnp.append(-aexpm1(-dt * c_adj[:-1]), 1.0).clip(1e-8, 1.0 - 1e-8)
    # prod_{i < l < j} p_surv[l] via cumulative log sums (exclusive prefix)
    cls = jnp.concatenate([jnp.zeros_like(p_surv[:1]), jnp.cumsum(alog(p_surv))])
    log_span = cls[jnp.maximum(j, i + 1)] - cls[i + 1]  # sum over l in (i, j)
    upper = p_float_out[i] * aexp(log_span) * p_coal[j] * (j > i)

    return lower + jnp.diagflat(diag) + upper


def q_s(*, eta, s, r):
    """Continuous SMC' transition density from TMRCA=s to TMRCA=t at scaled
    recombination distance r.  Test oracle only (integrates to 1; checked by
    quadrature).  Returns (density q(t), atom weight P(stay at s)).

    Note: this is the *exact* density — for t < s the 3-state chain product
    is cut at t, so q(t<s) = eta(t) * P_{0->t}[0, 1].  The reference's
    version (transition.py:88-121) cuts at s instead, which is only correct
    in the r -> 0 limit (its own test uses r=1e-6); ours integrates to 1 for
    any r.
    """

    def chain_at(x):
        "3-state chain state after evolving over branch heights [0, x]."
        grid = jnp.sort(jnp.append(eta.t, x))
        k = jnp.searchsorted(grid, x, side="right")
        rates = eta(grid)
        dg = jnp.diff(grid)
        P = jax.vmap(expQ, (0, 0, None))(dg * r, dg * rates[:-1], 2)
        # Pcum[i] = product over intervals 0..i; intervals ending at x are
        # 0..k-2 (grid[k-1] == x after insertion)
        return jax.lax.associative_scan(matmul_hi, P)[k - 2]

    R = eta.R
    P_s = chain_at(s)

    def q(t):
        return eta(t) * jnp.where(
            t < s,
            chain_at(t)[0, 1],
            P_s[0, 1] * aexp(-(R(t) - R(s))),
        )

    return q, P_s[0, 0]
