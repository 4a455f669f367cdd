"""Numerically careful primitives shared across the coalescent math core.

The framework runs float32 end-to-end on device (the reference enables
global x64, upstream phlash/__init__.py:16).  Long
log-likelihood accumulations therefore use Kahan compensation
(`kahan_add`) instead of falling back to float64.
"""

from __future__ import annotations

import jax.numpy as jnp

from phlash_tpu.utils.accurate import (
    exp as aexp, expm1 as aexpm1, log1p as alog1p,
)


def softplus_inv(y):
    """Inverse of softplus for y > 0: log(exp(y) - 1), stable for large y.

    (reference: upstream phlash/util.py:49-51)
    """
    return y + alog1p(-aexp(-y))


def expm1inv(x):
    """Compute 1/expm1(x) without overflow for large x.

    For x > ~10, expm1(x) ~ e^x overflows gradients; rewrite as
    e^-x / (1 - e^-x) = -e^-x / expm1(-x).
    (reference: upstream phlash/size_history.py:17-22)
    """
    big = x > 10.0
    x_lo = jnp.where(big, 1.0, x)  # safe operand for the small-x branch
    return jnp.where(big, -aexp(-x) / aexpm1(-x), 1.0 / aexpm1(x_lo))


def texp_mean(x):
    """Mean of a rate-x exponential truncated to the unit interval.

    g(x) = 1/x - 1/expm1(x), with g(0) = 1/2 (uniform limit) and
    g(inf) = 0 (instant decay).  The generic form cancels catastrophically
    near 0, so |x| < 0.1 switches to the cubic Taylor expansion
    1/2 - x/12 + x^3/720 (error < 2e-9 at the boundary); large x is safe
    because expm1inv never overflows.  Gradients stay finite everywhere
    (both branches see a safe operand).
    """
    small = jnp.abs(x) < 0.1
    x_safe = jnp.where(small, 1.0, x)
    generic = 1.0 / x_safe - expm1inv(x_safe)
    taylor = 0.5 - x / 12.0 + x**3 / 720.0
    return jnp.where(small, taylor, generic)


def invert_cpwli(R):
    """Invert a continuous piecewise-linear increasing scipy PPoly.

    Used to map cumulative-hazard values back to times (reference:
    upstream phlash/util.py:54-61).  Host-side scipy only.
    """
    import numpy as np
    from scipy.interpolate import PPoly

    x = R.x
    assert np.isinf(x[-1])
    assert np.isclose(x[0], 0.0)
    slope, intercept = R.c
    return PPoly(
        x=np.append(intercept, np.inf),
        c=np.array([1.0 / slope, x[:-1]]),
        extrapolate=False,
    )


def kahan_add(sum_and_comp, x):
    """One step of Kahan (compensated) summation.

    Args:
        sum_and_comp: tuple (s, c) of running sum and running compensation.
        x: value(s) to add.

    Returns:
        Updated (s, c).
    """
    s, c = sum_and_comp
    y = x - c
    t = s + y
    c = (t - s) - y
    return t, c
