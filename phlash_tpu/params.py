"""Parameterizations: optimization coordinates vs. HMM natural parameters.

Two views of the same demographic model (reference:
/root/reference/src/phlash/params.py:16-131):

* ``MCMCParams`` — unconstrained coordinates used by the SVGD sampler:
  log-transformed time grid endpoints, inverse-softplus coalescence rates
  (tied across intervals by a PSMC pattern string), and a logit-squashed
  rho/theta ratio constrained to [0.1, 10].

* ``PSMCParams`` — the O(M) compressed natural parameters of the SMC'
  transition matrix (sub-/main-/super-diagonal b, d, u plus the rank-one
  column factor v), binomial emission probabilities, and the stationary
  initial distribution pi.  This is what the HMM kernels consume; see
  phlash_tpu.hmm.matvec_smc for the structure invariant and
  phlash_tpu.ops.packing.dense_transition for the dense reconstruction used
  by the `dense` backend.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

import phlash_tpu.size_history as size_history
import phlash_tpu.transition as transition
from phlash_tpu.utils import Pattern, softplus_inv
from phlash_tpu.utils import accurate as am


class PSMCParams(NamedTuple):
    b: jax.Array  # (M,) sub-diagonal (column-constant lower triangle factor)
    d: jax.Array  # (M,) diagonal
    u: jax.Array  # (M,) row factor of the rank-one upper triangle
    v: jax.Array  # (M,) column factor of the rank-one upper triangle
    emis0: jax.Array  # (M,) P(obs = 0 | state)
    emis1: jax.Array  # (M,) P(obs = 1 | state)
    pi: jax.Array  # (M,) initial / stationary distribution

    @property
    def M(self) -> int:
        M = self.d.shape[-1]
        assert all(a.shape[-1] == M for a in self)
        return M

    @classmethod
    def from_dm(cls, dm: size_history.DemographicModel) -> "PSMCParams":
        """Compress a demographic model into HMM natural parameters.

        Emissions are binomial in theta * E[coal time in interval]; the
        transition matrix is compressed by reading off its diagonals and
        factoring the rank-one upper triangle from its first row.
        (reference: params.py:32-55)
        """
        ect = dm.eta.ect()
        lam = dm.theta * ect
        emis0 = am.exp(-lam)
        emis1 = -am.expm1(-lam)
        pi = dm.eta.pi
        A = transition.transition_matrix(dm)
        emis0, emis1, pi, A = jax.tree.map(
            lambda a: a.clip(1e-20, 1.0 - 1e-20), (emis0, emis1, pi, A)
        )
        sub = jnp.diagonal(A, -1)
        diag = jnp.diagonal(A, 0)
        sup = jnp.diagonal(A, 1)
        v = A[0, 1:] / A[0, 1]
        u = sup / v
        return cls(
            b=jnp.append(sub, 0.0),
            d=diag,
            u=jnp.append(u, 0.0),
            v=jnp.insert(v, 0, 0.0),
            emis0=emis0,
            emis1=emis1,
            pi=pi,
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MCMCParams:
    """Unconstrained SVGD optimization coordinates.

    Trainable pytree leaves: t_tr, c_tr, rho_over_theta_tr.
    Static metadata: pattern, theta, alpha (smoothness), beta (ridge).
    """

    t_tr: jax.Array  # [log t1, log (tM - t1)]
    c_tr: jax.Array  # softplus^-1 of the tied coalescence rates
    rho_over_theta_tr: jax.Array  # logit((rho/theta - 0.1) / 9.9)
    pattern: str = dataclasses.field(metadata=dict(static=True))
    theta: float = dataclasses.field(metadata=dict(static=True))
    alpha: float = dataclasses.field(metadata=dict(static=True))
    beta: float = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_linear(
        cls,
        pattern: str,
        t1: float,
        tM: float,
        c: jax.Array,
        theta: float,
        rho: float,
        alpha: float = 0.0,
        beta: float = 0.0,
    ) -> "MCMCParams":
        assert len(Pattern(pattern)) == len(c), "one c entry per tied group"
        return cls(
            t_tr=jnp.array([jnp.log(t1), jnp.log(tM - t1)]),
            c_tr=softplus_inv(jnp.asarray(c)),
            rho_over_theta_tr=jax.scipy.special.logit((rho / theta - 0.1) / 9.9),
            pattern=pattern,
            # static numerics as plain python floats: a strongly-typed numpy
            # scalar (e.g. a np.float64 Watterson estimate) would otherwise
            # promote the whole f32 assembly graph back to f64
            theta=float(theta),
            alpha=float(alpha),
            beta=float(beta),
        )

    # -- constrained views ---------------------------------------------------
    @property
    def t(self):
        "Grid endpoints (t1, tM); parameterized so tM > t1 > 0 always."
        t1, dtM = am.exp(self.t_tr)
        return t1, t1 + dtM

    @property
    def c(self):
        return am.softplus(self.c_tr)

    @property
    def log_c(self):
        return am.log(self.c)

    @property
    def rho_over_theta(self):
        "Squashed to [0.1, 10] (reference: params.py:111-113)."
        return 0.1 + 9.9 * am.expit(self.rho_over_theta_tr)

    @property
    def rho(self):
        return self.rho_over_theta * self.theta

    @property
    def M(self) -> int:
        return Pattern(self.pattern).M

    def to_dm(self) -> size_history.DemographicModel:
        "Expand to a demographic model on a geometric time grid."
        pat = Pattern(self.pattern)
        t1, tM = self.t
        t = jnp.insert(am.geomspace(t1, tM, pat.M - 1), 0, 0.0)
        eta = size_history.SizeHistory(t=t, c=pat.expand(self.c))
        return size_history.DemographicModel(eta=eta, theta=self.theta, rho=self.rho)
