"""Faithfully-rounded float32 transcendentals for the parameter assembly.

An accelerator backend may lower f32 `exp` / `expm1` / `log` to fast
polynomial approximations a few ulp to ~1e-4 off.  That is harmless for
the HMM kernels, but the SMC' transition-assembly VJP cancels heavily
across sub-intervals and amplifies the transcendental noise ~1e5x into
O(1) *gradient* error (tools/f32_xplat.py compares the f32 assembly VJP
on the accelerator with the CPU's on identical inputs; whether the GPU's
native ops pass is not yet measured).

These drop-in replacements recover a-few-ulp f32 accuracy from exactly
rounded primitives (+, *, ldexp) via Cody-Waite argument reduction +
short Taylor series, and pin their derivatives with custom_jvp so the
differentiated assembly graph is built from the same faithful pieces.
They are used throughout the assembly modules (transition, size_history,
params, utils.numerics); the Pallas/HMM kernels keep the fast native ops.

In float64 (or on CPU) the native ops are already faithful; the wrappers
dispatch straight through for f64 inputs so the f64 path is unchanged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Cody-Waite split of ln 2: hi has 16 trailing zero bits, so k * LN2_HI is
# exact in f32 for |k| < 2^16; lo carries the remainder.
_LN2_HI = np.float32(0.693359375)
_LN2_LO = np.float32(-2.12194440e-4)
_INV_LN2 = np.float32(1.4426950408889634)


def _is_f32(x) -> bool:
    return jnp.result_type(x) == jnp.float32


def _exp_impl(x):
    "exp(x), f32, ~1-2 ulp: reduce to [-ln2/2, ln2/2], degree-7 Taylor."
    x = jnp.asarray(x, jnp.float32)
    # saturate before the reduction: f32 exp is exactly inf above ~88.73
    # and exactly 0 below ~-103.98, and inf/-inf inputs would otherwise
    # produce inf - inf = NaN in the Cody-Waite subtraction (NaN inputs
    # still propagate through clip)
    x = jnp.clip(x, -104.0, 89.0)
    k = jnp.round(x * _INV_LN2)
    r = (x - k * _LN2_HI) - k * _LN2_LO
    # Taylor to r^7: max truncation ~ (ln2/2)^8 / 8! ~ 5e-9 relative
    p = 1.0 / 5040.0
    for c in (1.0 / 720, 1.0 / 120, 1.0 / 24, 1.0 / 6, 0.5, 1.0, 1.0):
        p = p * r + c
    # clamp k so ldexp neither overflows the int path nor traps: beyond
    # +-150 the f32 result saturates to inf/0 anyway
    k = jnp.clip(k, -150.0, 150.0)
    return jnp.ldexp(p, k.astype(jnp.int32))


@jax.custom_jvp
def exp(x):
    "Faithful f32 exp; dispatches to the native op for f64 inputs."
    if not _is_f32(x):
        return jnp.exp(x)
    return _exp_impl(x)


@exp.defjvp
def _exp_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    y = exp(x)
    return y, y * dx


def _expm1_impl(x):
    "expm1(x), f32: series for |x| < ln2/2 (no cancellation beyond)."
    x = jnp.asarray(x, jnp.float32)
    small = jnp.abs(x) < 0.3465735902799726  # ln2 / 2
    xs = jnp.where(small, x, 0.0)
    # x * (1 + x/2 + ... + x^6/5040): truncation ~ x^7/40320, < 4e-10 rel
    p = 1.0 / 5040.0
    for c in (1.0 / 720, 1.0 / 120, 1.0 / 24, 1.0 / 6, 0.5, 1.0):
        p = p * xs + c
    series = xs * p
    big = jnp.where(small, 0.0, x)
    return jnp.where(small, series, _exp_impl(big) - 1.0)


@jax.custom_jvp
def expm1(x):
    "Faithful f32 expm1; native for f64."
    if not _is_f32(x):
        return jnp.expm1(x)
    return _expm1_impl(x)


@expm1.defjvp
def _expm1_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    if not _is_f32(x):
        return jnp.expm1(x), jnp.exp(x) * dx
    return _expm1_impl(x), _exp_impl(x) * dx


def _log_impl(x):
    "log(x), f32, ~1-2 ulp: frexp to [sqrt(2)/2, sqrt(2)), atanh series."
    x = jnp.asarray(x, jnp.float32)
    # subnormal inputs can break frexp's m-in-[0.5,1) contract on a
    # backend that flushes them, and XLA flushes subnormal *products* to
    # zero so rescaling by multiplication is also out.
    # Rebuild them from the bit pattern instead: a positive subnormal is
    # exactly mantissa * 2^-149, and the mantissa (< 2^23) converts to
    # f32 exactly.
    tiny = x < np.float32(2.0 ** -126)
    mant = jax.lax.bitcast_convert_type(jnp.abs(x), jnp.int32).astype(jnp.float32)
    xn = jnp.where(tiny, mant, x)
    m, e = jnp.frexp(xn)  # m in [0.5, 1), xn = m * 2^e
    shift = m < 0.7071067811865476
    m = jnp.where(shift, 2.0 * m, m)
    e = jnp.where(shift, e - 1, e).astype(jnp.float32)
    e = jnp.where(tiny, e - 149.0, e)
    s = (m - 1.0) / (m + 1.0)  # |s| <= 0.1716
    z = s * s
    # 2 artanh(s) = 2s(1 + z/3 + z^2/5 + z^3/7 + z^4/9); trunc ~ 2 s^11 / 11
    p = 1.0 / 9.0
    for c in (1.0 / 7, 1.0 / 5, 1.0 / 3, 1.0):
        p = p * z + c
    logm = 2.0 * s * p
    # e == 0 exactly on [sqrt(2)/2, sqrt(2)): no cancellation with logm
    val = e * _LN2_HI + (logm + e * _LN2_LO)
    # IEEE edges the reduction cannot represent: log(+-0) = -inf,
    # log(negative) = NaN, log(inf) = inf, log(NaN) = NaN.  Classifying
    # via float comparisons is unsound here: XLA flushes subnormals to
    # zero in f32 compares (`x > 0` is False for a positive subnormal),
    # and its simplifier rewrites the integer `bitcast(x) == 0` test
    # right back into the flushed float compare once fused.  Comparing
    # the *int->float converted* magnitude/sign fields against 0.5
    # survives both: the converted values are ordinary normal floats and
    # the pattern is not an equality-with-zero the simplifier touches.
    # The inf/NaN thresholds, however, must stay INTEGER comparisons: the
    # int->float conversion rounds the 63 largest finite magnitudes
    # (0x7F7FFFC1..0x7F7FFFFF, incl. FLT_MAX) up to float32(0x7F800000)
    # and low-payload NaNs down to it, so a converted-float equality
    # misclassifies both.  Equality with the exact inf bit pattern is not
    # a compare-with-zero, so the simplifier hazard above does not apply.
    xi = jax.lax.bitcast_convert_type(x, jnp.int32)
    mag_i = xi & jnp.int32(0x7FFFFFFF)
    mag_f = mag_i.astype(jnp.float32)
    sign_f = (jax.lax.shift_right_logical(xi, jnp.int32(31))).astype(jnp.float32)
    is_zero = mag_f < 0.5
    is_neg = (sign_f > 0.5) & ~is_zero
    is_inf = mag_i == jnp.int32(0x7F800000)
    is_nan = mag_i > jnp.int32(0x7F800000)
    val = jnp.where(is_inf, jnp.inf, val)
    val = jnp.where(is_zero, -jnp.inf, val)
    return jnp.where(is_neg | is_nan, jnp.nan, val)


@jax.custom_jvp
def log(x):
    "Faithful f32 log; native for f64."
    if not _is_f32(x):
        return jnp.log(x)
    return _log_impl(x)


@log.defjvp
def _log_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    if not _is_f32(x):
        return jnp.log(x), dx / x
    return _log_impl(x), dx / x


def _log1p_impl(x):
    x = jnp.asarray(x, jnp.float32)
    small = jnp.abs(x) < 0.2928932188134525  # 1 - sqrt(2)/2
    xs = jnp.where(small, x, 0.0)
    # log(1+x) = x(1 - x/2 + x^2/3 - ...): alternating to x^9
    p = -1.0 / 10.0
    for c in (1.0 / 9, -1.0 / 8, 1.0 / 7, -1.0 / 6, 1.0 / 5, -1.0 / 4,
              1.0 / 3, -1.0 / 2, 1.0):
        p = p * xs + c
    series = xs * p
    big = jnp.where(small, 1.0, 1.0 + x)
    return jnp.where(small, series, _log_impl(big))


@jax.custom_jvp
def log1p(x):
    "Faithful f32 log1p; native for f64."
    if not _is_f32(x):
        return jnp.log1p(x)
    return _log1p_impl(x)


@log1p.defjvp
def _log1p_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    if not _is_f32(x):
        return jnp.log1p(x), dx / (1.0 + x)
    return _log1p_impl(x), dx / (1.0 + x)


def matmul_hi(a, b):
    """matmul with precision pinned to HIGHEST — REQUIRED on every
    f32-critical assembly/dynamics product.

    XLA may run f32 matmuls at reduced precision by default (TF32 on an
    NVIDIA GPU keeps ~3 decimal digits); the transition
    associative_scan's VJP amplifies that through cross-interval
    cancellation into O(1) *gradient* error.  Every matmul on the parameter-assembly or SVGD-dynamics path must use this
    helper (or pass the precision explicitly); the products there are all
    tiny, so full f32 accuracy is free.
    """
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


# -- compositions used by the parameter transforms ---------------------------


def softplus(x):
    "log(1 + e^x) = max(x, 0) + log1p(e^-|x|), from the faithful pieces."
    return jnp.maximum(x, 0.0) + log1p(exp(-jnp.abs(x)))


def expit(x):
    "1 / (1 + e^-x), from the faithful exp and an IEEE division."
    return 1.0 / (1.0 + exp(-x))


def geomspace(a, b, n: int):
    "exp(linspace(log a, log b, n)) with the faithful exp/log."
    return exp(jnp.linspace(log(a), log(b), n))
