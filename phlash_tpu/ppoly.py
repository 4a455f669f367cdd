"""Jit/grad-safe piecewise polynomials (scipy.interpolate.PPoly work-alike).

Underlies the cumulative coalescent hazard R(t) and the closed-form
exponential integrals that feed expected coalescence times and branch
lengths.  Capability parity with the reference
(/root/reference/src/phlash/jax_ppoly.py:1-84); the implementation here keeps
the same (x breakpoints, c coefficient-matrix) convention so scipy.PPoly can
serve as the test oracle, but is written for static shapes / XLA tracing.

Convention: p(t) = sum_i c[i, j] * (t - x[j])**i  for x[j] <= t < x[j+1],
with c stored highest-degree-first (like numpy.polyval / scipy.PPoly).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import vmap

from phlash_tpu.utils.accurate import exp as aexp, expm1 as aexpm1


class PPoly(NamedTuple):
    x: jnp.ndarray  # breakpoints, shape (K+1,); last entry may be +inf
    c: jnp.ndarray  # coefficients, shape (deg+1, K), highest power first

    def scale(self, a):
        "Multiply the polynomial by a scalar constant."
        return self._replace(c=jnp.asarray(self.c) * a)

    def __call__(self, t):
        "Evaluate p(t); t may be scalar or an array."
        j = jnp.clip(jnp.searchsorted(self.x, t, side="right") - 1, 0, None)
        return jnp.polyval(self.c[:, j], t - self.x[j])

    def antiderivative(self) -> "PPoly":
        """Indefinite integral, continuous across breakpoints (zero at x[0])."""
        ci = vmap(jnp.polyint, in_axes=1, out_axes=1)(self.c)
        # value of each integrated piece at its right endpoint gives the
        # constant offset carried into the next piece
        piece_vals = jnp.polyval(ci[:, :-1], jnp.diff(self.x)[:-1])
        # dtype-pinned zero: under the global x64 policy a bare jnp.zeros is
        # float64, which would silently promote an f32 polynomial
        offsets = jnp.cumsum(
            jnp.concatenate([jnp.zeros(1, piece_vals.dtype), piece_vals])
        )
        return PPoly(x=self.x, c=jnp.concatenate([ci[:-1], offsets[None]]))

    def derivative(self) -> "PPoly":
        ci = vmap(jnp.polyder, in_axes=1, out_axes=1)(self.c)
        return PPoly(x=self.x, c=ci)

    def exp_integral(self, t=jnp.inf, const: float = 0.0):
        r"""Closed form of :math:`\int_0^t e^{-R(u) + const}\,du` where
        :math:`R(u)=\int_0^u p(s)\,ds`, for a *piecewise-constant* p.

        Used for expected coalescence times and total branch lengths
        (reference: /root/reference/src/phlash/jax_ppoly.py:44-84).  The last
        (possibly infinite) epoch is handled analytically so gradients stay
        finite.
        """
        assert self.c.ndim == 2 and self.c.shape[0] == 1, "piecewise constant only"
        rate = self.c[0]
        dt = jnp.diff(self.x)[:-1]
        # cumulative hazard at each left breakpoint (zero dtype-pinned: a
        # bare jnp.zeros is f64 under x64 and would promote the whole
        # integral — and with it the AFS term's per-particle graph — to f64)
        haz = jnp.concatenate([jnp.zeros(1, rate.dtype), jnp.cumsum(rate[:-1] * dt)])
        # integral over each finite epoch + the final (half-open) epoch
        per_epoch = jnp.concatenate(
            [
                aexp(-haz[:-1] + const) * -aexpm1(-rate[:-1] * dt) / rate[:-1],
                aexp(-haz[-1:] + const) / rate[-1:],
            ]
        )
        # keep the finite-t branch NaN-free even when t = inf (both where
        # branches are evaluated, and 0 * nan would poison gradients)
        finite = jnp.isfinite(t)
        t_safe = jnp.where(finite, t, 0.0)
        j = jnp.clip(jnp.searchsorted(self.x, t_safe, side="right") - 1, 0, len(rate) - 1)
        # partial epoch [x[j], t)
        tail = (
            aexp(-haz[j] + const)
            * -aexpm1(-rate[j] * (t_safe - self.x[j]))
            / rate[j]
        )
        full = (per_epoch * (jnp.arange(per_epoch.shape[0]) < j)).sum()
        return jnp.where(finite, full + tail, per_epoch.sum())
