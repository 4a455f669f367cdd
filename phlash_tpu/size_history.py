"""Piecewise-constant coalescent size histories and demographic models.

The central object is ``SizeHistory(t, c)``: a population-size trajectory
expressed as a piecewise-constant instantaneous pair-coalescence rate c(t)
with breakpoints t (t[0] == 0), so Ne(t) = 1 / (2 c(t)).  Everything the
inference stack needs — survival/coalescence densities, cumulative hazard,
expected coalescence times per interval, expected branch lengths for the AFS
likelihood (Polanski–Kimmel W matrix), and evaluation metrics (TV / L2
distances) — is computed in closed form with XLA-friendly (static-shape,
NaN-safe-gradient) code.

Capability parity with the reference
(/root/reference/src/phlash/size_history.py:17-369), re-derived for float32
execution on the accelerator.  demes/msprime interop is optional (gated imports).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import vmap

from phlash_tpu.ppoly import PPoly
from phlash_tpu.utils import Pattern, texp_mean
from phlash_tpu.utils.accurate import exp as aexp, expm1 as aexpm1, log as alog
from phlash_tpu.utils.accurate import matmul_hi


class SizeHistory(NamedTuple):
    t: jnp.ndarray  # epoch start times, t[0] == 0, shape (M,)
    c: jnp.ndarray  # coalescence rate within each epoch, shape (M,)

    # -- basic structure ---------------------------------------------------
    @property
    def M(self) -> int:
        assert len(self.t) == len(self.c)
        return len(self.t)

    @property
    def K(self) -> int:
        return len(self.c)

    @property
    def Ne(self):
        "Effective population size trajectory, Ne = 1/(2c)."
        return 0.5 / self.c

    @classmethod
    def default(cls, K: int) -> "SizeHistory":
        "Constant history with breakpoints at Exponential(1) quantiles."
        q = np.linspace(0.0, 1.0, K, endpoint=False)
        t = -np.log1p(-q)  # expon.ppf without scipy
        return cls(t=jnp.asarray(t), c=jnp.ones(K))

    @classmethod
    def from_pmf(cls, t, p) -> "SizeHistory":
        """Build a history whose coalescence-time pmf over the grid t is p.

        p[i] = P(coalescence in [t[i], t[i+1])).  The rate in the final
        (open) epoch is unidentifiable and set to 1.
        (reference: /root/reference/src/phlash/size_history.py:91-106)
        """
        t = np.asarray(t)
        p = np.asarray(p)
        R = 0.0
        c = []
        for dt, p_i in zip(np.diff(t), p[:-1]):
            c.append(-np.log1p(-p_i * np.exp(R)) / dt)
            R += c[-1] * dt
        c.append(1.0)
        return cls(t=jnp.asarray(t), c=jnp.asarray(c))

    # -- evaluation ---------------------------------------------------------
    def __call__(self, x, Ne: bool = False):
        "Evaluate c(x) (or Ne(x) if Ne=True) at points x."
        j = jnp.searchsorted(jnp.append(self.t, jnp.inf), x, side="right") - 1
        return 0.5 / self.c[j] if Ne else self.c[j]

    def to_pp(self) -> PPoly:
        return PPoly(x=jnp.append(self.t, jnp.inf), c=jnp.asarray(self.c)[None])

    @property
    def R(self) -> PPoly:
        "Cumulative coalescent hazard R(t) = int_0^t c(s) ds."
        return self.to_pp().antiderivative()

    def surv(self):
        "Survival function of the coalescence density at each breakpoint."
        hazard = jnp.cumsum(self.c[:-1] * jnp.diff(self.t))
        return jnp.append(aexp(-hazard), 0.0)

    def p_coal(self):
        "P(coalescence occurs within epoch k) for each epoch k."
        interior = -jnp.diff(self.surv())
        return jnp.concatenate([1.0 - interior.sum(keepdims=True), interior])

    @property
    def pi(self):
        "Alias for p_coal(): the prior over discretized TMRCA intervals."
        return self.p_coal()

    def density(self, c: float = 1.0) -> Callable:
        "Coalescence-time density (optionally with rate multiplier c)."
        R = self.R
        return lambda x: c * self(x) * aexp(-c * R(x))

    @property
    def sf(self) -> Callable:
        R = self.R
        return lambda x: aexp(-R(x))

    @property
    def cdf(self) -> Callable:
        R = self.R
        return lambda x: -aexpm1(-R(x))

    # -- moments ------------------------------------------------------------
    def ect(self):
        """Expected coalescence time conditional on coalescing in each epoch.

        Within a finite epoch [t0, t1) at rate c, T - t0 is an exponential
        truncated to [0, dt], so E[T | epoch] = t0 + dt * g(c*dt) where g is
        the unit-truncated-exponential mean (`texp_mean`, which owns the
        numeric guards: c*dt -> 0 gives the epoch midpoint, -> inf the left
        endpoint, with finite gradients throughout).  The final epoch is an
        untruncated exponential: t_{M-1} + 1/c.
        (capability match: reference size_history.py:170-193, which instead
        special-cases c > 100; the g() form stays exact there.)
        """
        t0, dt = self.t[:-1], jnp.diff(self.t)
        inner = t0 + dt * texp_mean(self.c[:-1] * dt)
        e = jnp.append(inner, self.t[-1] + 1.0 / self.c[-1])
        return jnp.maximum(e, 1e-20)  # zero expected times break downstream logs

    @property
    def mu(self):
        "Unconditional expected pairwise coalescence time."
        return self.to_pp().exp_integral()

    def etjj(self, n: int):
        """E[time while exactly j lineages remain], j = 2..n, for sample size n.

        Equals the integrated survival function with the rate rescaled by
        binom(j, 2).  All j share the unit-multiplier cumulative hazard, so
        the whole family is one (n-1, K) broadcast of the closed-form
        per-epoch exponential integral — per epoch k at rate m·c_k over
        width dt_k, starting from hazard m·H_k:

            exp(-m H_k) · (1 - exp(-m c_k dt_k)) / (m c_k),

        with the final (open) epoch contributing exp(-m H_last)/(m c_last).
        (A per-j vmap over .mu would build n-1 separate
        PPoly/exp_integral graphs of tiny ops.)
        """
        dt = jnp.diff(self.t)  # (K-1,) finite epochs
        haz = jnp.concatenate(
            [jnp.zeros(1, self.c.dtype), jnp.cumsum(self.c[:-1] * dt)]
        )  # (K,) unit-multiplier hazard at each left breakpoint
        j = jnp.arange(2, n + 1)
        m = (j * (j - 1) // 2).astype(self.c.dtype)  # (n-1,) exact in f32
        mh = m[:, None] * haz[None, :]  # (n-1, K)
        finite = (
            aexp(-mh[:, :-1])
            * -aexpm1(-m[:, None] * (self.c[:-1] * dt)[None, :])
            / (m[:, None] * self.c[None, :-1])
        )
        last = aexp(-mh[:, -1]) / (m * self.c[-1])
        return finite.sum(1) + last

    def etbl(self, n: int):
        """Expected total branch length subtending b = 1..n-1 leaves.

        This is the expected (unnormalized) site-frequency spectrum under the
        history; W is the exact Polanski–Kimmel rational-recurrence matrix.
        """
        etjj = self.etjj(n)
        # W in the working dtype: a f64 matmul here would silently promote
        # an otherwise-f32 model; W's entries are exact in f64 and fine
        # rounded to f32
        return matmul_hi(jnp.asarray(_W_matrix(n), dtype=etjj.dtype), etjj)

    # -- quantiles / metrics --------------------------------------------------
    def quantile(self, q: float) -> float:
        "Time at which the coalescence CDF reaches q (host-side bisection)."
        from scipy.optimize import root_scalar

        R = self.R

        def f(x):
            return -np.expm1(-float(R(x))) - q

        hi = float(self.t[-1]) or 1.0
        while f(hi) < 0:
            hi *= 2.0
        return root_scalar(f, bracket=(0.0, hi)).root

    def balance(self) -> "SizeHistory":
        "Re-grid so each epoch carries equal coalescence mass."
        t = np.array([self.quantile(q) for q in np.linspace(0, 1, self.K, endpoint=True)])
        return SizeHistory(t=t, c=self(t))

    def tv(self, other: "SizeHistory", n: int = 1):
        """Total-variation distance between the two coalescence densities for
        n diploid samples (reference: size_history.py:228-240)."""
        n2 = 2 * n
        rate_mult = n2 * (n2 - 1) / 2.0
        t = jnp.array(sorted(set(np.asarray(self.t).tolist()) | set(np.asarray(other.t).tolist())))
        assert t[0] == 0.0
        mids = jnp.append((t[:-1] + t[1:]) / 2.0, t[-1] + 1.0)
        R1 = SizeHistory(t=t, c=rate_mult * self(mids)).R
        R2 = SizeHistory(t=t, c=rate_mult * other(mids)).R
        return _tv_pwc(R1, R2)

    def l2(self, other: "SizeHistory", t_max):
        "L2 distance between the two Ne(t) trajectories on [0, t_max]."
        grid = np.array(
            sorted(set(np.asarray(self.t).tolist()) | set(np.asarray(other.t).tolist()) | {float(t_max)})
        )
        grid = grid[grid <= t_max]
        mid = (grid[:-1] + grid[1:]) / 2.0
        d2 = (self(mid, Ne=True) - other(mid, Ne=True)) ** 2 * jnp.diff(grid)
        return jnp.sqrt(d2.sum())

    # -- interop / plotting ---------------------------------------------------
    def to_demes(self, deme_name: str = "pop"):
        "Export as a demes.Graph (requires the optional `demes` package)."
        import demes  # gated: not a core dependency

        b = demes.Builder()
        epochs = [
            dict(end_time=float(ti), start_size=float(Ne), end_size=float(Ne), size_function="constant")
            for ti, Ne in zip(self.t, self.Ne)
        ]
        b.add_deme(deme_name, epochs=epochs[::-1])
        return b.resolve()

    @classmethod
    def from_demography(cls, demo) -> "SizeHistory":
        "Build from an msprime.Demography (requires optional `msprime`)."
        import msprime  # gated

        assert isinstance(demo, msprime.Demography)
        if demo.num_populations > 1:
            raise ValueError("only single-population demographies are supported")
        dbg = demo.debug()
        t = np.arange(1 + dbg.epoch_start_time.max())
        Ne = dbg.population_size_trajectory(steps=t).squeeze()
        keep = np.insert(Ne[1:] != Ne[:-1], 0, True)
        return cls(t=t[keep], c=1.0 / (2.0 * Ne[keep]))

    def draw(self, ax=None, density: bool = False, c: float = 1.0, **kwargs) -> None:
        "Plot Ne(t) (or the coalescence density) on a matplotlib axis."
        if ax is None:
            import matplotlib.pyplot as plt

            ax = plt.gca()
        if density:
            x = np.geomspace(float(self.t[1]), 2.0 * float(self.t[-1]), 1000)
            ax.plot(x, self.density(c)(x), **kwargs)
            return
        kw = dict(kwargs)
        kw.update(label=None, marker=".")
        ax.scatter(self.t[-1:], self.Ne[-1:], **kw)
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.spines[["right", "top"]].set_visible(False)
        ax.set_xlabel("Generations")
        ax.set_ylabel("$N_e$")
        kwargs.setdefault("drawstyle", "steps-post")
        ax.plot(self.t, self.Ne, **kwargs)


def _tv_pwc(R1: PPoly, R2: PPoly):
    """TV distance between two densities a·e^{-(a t + b)} given their
    piecewise-linear cumulative hazards (same breakpoints)."""
    per_piece = vmap(_tv_piece, (1, 1, 0))(R1.c, R2.c, jnp.diff(R1.x))
    return 0.5 * per_piece.sum()


def _tv_piece(ab1, ab2, T):
    "int_0^T |a1 e^{-(a1 t + b1)} - a2 e^{-(a2 t + b2)}| dt, exact."
    a1, b1 = ab1
    a2, b2 = ab2

    def F(a, b, U):
        "int_0^U a e^{-(a t + b)} dt; valid at U = +inf for a > 0."
        return aexp(-b) * jnp.where(jnp.isinf(U), 1.0, -aexpm1(-a * U))

    same = jnp.isclose(a1, a2)
    denom = jnp.where(same, 1.0, a1 - a2)
    # the two densities cross at most once on the piece
    t_x = jnp.clip((alog(a1 / a2) + b2 - b1) / denom, 0.0, T)
    t_x = jnp.where(same, 0.0, t_x)
    f1, f2 = F(a1, b1, t_x), F(a2, b2, t_x)
    return jnp.abs(f1 - f2) + jnp.abs((F(a1, b1, T) - f1) - (F(a2, b2, T) - f2))


def _psmc_time_grid(M: int, t_max: float = 15.0) -> np.ndarray:
    """Default discretization grid: 0 followed by geomspace(1e-3, t_max, M-1).

    (reference: /root/reference/src/phlash/size_history.py:303-310 — its
    PSMC-style exponential grid is computed then overridden by exactly this
    geometric grid, which we adopt directly.)
    """
    return np.concatenate([[0.0], np.geomspace(1e-3, t_max, M - 1)])


class DemographicModel(NamedTuple):
    eta: SizeHistory
    theta: float  # scaled mutation rate per window
    rho: float  # scaled recombination rate per window

    @classmethod
    def default(cls, pattern: str, theta: float, rho: float = None, t_max: float = 15.0):
        if rho is None:
            rho = theta
        M = Pattern(pattern).M
        eta = SizeHistory(t=jnp.asarray(_psmc_time_grid(M, t_max)), c=jnp.ones(M))
        return cls(eta=eta, theta=theta, rho=rho)

    def rescale(self, mu: float) -> "DemographicModel":
        """Convert from coalescent units to generations given the per-locus
        per-generation mutation rate mu (reference: size_history.py:328-343)."""
        N0 = (self.theta / 2.0) / mu
        eta = SizeHistory(t=N0 * self.eta.t, c=self.eta.c / N0)
        rho = self.rho / N0 if self.rho is not None else None
        return DemographicModel(eta=eta, theta=mu, rho=rho)

    @property
    def M(self) -> int:
        return self.eta.M


def _W_matrix(n: int) -> np.ndarray:
    """Polanski–Kimmel W matrix (Polanski & Kimmel 2003, eqs. 13–15).

    W[b-1, j-2] maps E[t_jj] (j = 2..n) to the expected total branch length
    subtending b = 1..n-1 leaves.  Each row b runs the three-term recurrence
    in j independently in exact rational arithmetic — floating point blows
    up for n beyond ~50 — and is cast to float64 once at the end.
    (capability match: reference size_history.py:350-369)
    """
    from fractions import Fraction as F

    if n == 1:
        return np.array([[]], dtype=np.float64)
    rows = []
    for b in range(1, n):
        w = [F(6, n + 1)]  # j = 2
        if n >= 3:
            w.append(F(30 * (n - 2 * b), (n + 1) * (n + 2)))  # j = 3
        for j in range(2, n - 1):  # recurrence emits column j + 2
            lead = F(3 + 2 * j, j * (n + j + 1))
            w.append(lead * ((n - 2 * b) * w[-1] - F((1 + j) * (n - j), 2 * j - 1) * w[-2]))
        rows.append([float(x) for x in w])
    return np.array(rows, dtype=np.float64)
