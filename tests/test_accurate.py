"""Faithful-f32 transcendentals (utils/accurate.py) vs float64 oracles.

These back the f32 parameter-assembly gradient path: a backend's native
f32 exp/expm1/log approximations may carry up to ~1e-4 relative error,
which the assembly VJP's cancellations amplify into O(1) gradient error
(tools/f32_xplat.py).  The accurate versions must stay within a few ulp of
f64 on every platform — this file pins the CPU half.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phlash_tpu.utils import accurate as am

RNG = np.random.default_rng(3)
XS = np.concatenate(
    [
        np.float32(10.0) ** RNG.uniform(-8, 1.5, 200),
        -(np.float32(10.0) ** RNG.uniform(-8, 1.5, 200)),
        RNG.uniform(-80.0, 80.0, 100),
    ]
).astype(np.float32)


@pytest.mark.parametrize(
    "name,fn,ref,domain",
    [
        ("exp", am.exp, np.exp, lambda x: x),
        ("expm1", am.expm1, np.expm1, lambda x: x),
        ("log", am.log, np.log, lambda x: np.abs(x) + np.float32(1e-30)),
        ("log1p", am.log1p, np.log1p, lambda x: np.maximum(x, np.float32(-0.5))),
    ],
)
def test_accurate_f32_few_ulp(name, fn, ref, domain):
    x = domain(XS)
    got = np.asarray(jax.jit(fn)(jnp.asarray(x)), dtype=np.float64)
    want = ref(x.astype(np.float64))
    rel = np.abs(got - want) / (np.abs(want) + 1e-300)
    assert rel.max() < 5e-7, (name, rel.max())


def test_accurate_ieee_edges():
    """0 / subnormal / +-inf / NaN / negative inputs follow IEEE log/exp
    semantics (they used to return silently-wrong finite values)."""
    inf, nan = np.float32(np.inf), np.float32(np.nan)
    sub = np.float32(1e-45)  # smallest positive f32 subnormal territory

    lg = np.asarray(jax.jit(am.log)(jnp.asarray([0.0, -1.0, inf, nan, sub, 1e-40], jnp.float32)))
    assert lg[0] == -np.inf
    assert np.isnan(lg[1]) and np.isnan(lg[3])
    assert lg[2] == np.inf
    # subnormals: correct finite magnitudes, not the old -4.27
    assert np.allclose(lg[4], np.log(np.float64(sub)), rtol=1e-6)
    assert np.allclose(lg[5], np.log(np.float64(np.float32(1e-40))), rtol=1e-6)

    ex = np.asarray(jax.jit(am.exp)(jnp.asarray([inf, -inf, nan, 89.0, -104.0], jnp.float32)))
    assert ex[0] == np.inf and ex[1] == 0.0 and np.isnan(ex[2])
    assert ex[3] == np.inf  # f32 exp overflows just below 89
    assert ex[4] <= 1e-44

    em = np.asarray(jax.jit(am.expm1)(jnp.asarray([-inf, inf, nan], jnp.float32)))
    assert em[0] == -1.0 and em[1] == np.inf and np.isnan(em[2])

    l1 = np.asarray(jax.jit(am.log1p)(jnp.asarray([-1.0, inf, nan, -2.0], jnp.float32)))
    assert l1[0] == -np.inf and l1[1] == np.inf
    assert np.isnan(l1[2]) and np.isnan(l1[3])

    # the composition the prior depends on: log(softplus(very negative))
    # must head to -inf-ish linearly, not flatline at a bogus constant
    from phlash_tpu.utils import softplus_inv

    sp = np.asarray(jax.jit(am.softplus)(jnp.asarray([-103.0], jnp.float32)))
    assert sp[0] == 0.0 or sp[0] < 2e-44
    si = np.asarray(jax.jit(softplus_inv)(jnp.asarray([1e-40], jnp.float32)))
    assert si[0] < -90.0


def test_accurate_log_near_inf_boundary():
    """The 63 largest finite magnitudes (incl. FLT_MAX) must NOT classify
    as inf, and low-payload NaNs must stay NaN: the int->float conversion
    of the magnitude bits rounds both onto the 0x7F800000 inf threshold,
    so the inf/NaN tests must be integer comparisons."""
    fmax = np.float32(np.finfo(np.float32).max)
    near = np.frombuffer(np.array([0x7F7FFFC1], np.int32).tobytes(), np.float32)[0]
    lg = np.asarray(jax.jit(am.log)(jnp.asarray([fmax, near, -fmax], jnp.float32)))
    assert np.isfinite(lg[0]) and np.allclose(lg[0], np.log(np.float64(fmax)), rtol=1e-6)
    assert np.isfinite(lg[1]) and np.allclose(lg[1], np.log(np.float64(near)), rtol=1e-6)
    assert np.isnan(lg[2])
    # NaN with payload 1 (0x7F800001): still NaN, not +inf
    nan1 = np.frombuffer(np.array([0x7F800001], np.int32).tobytes(), np.float32)[0]
    assert np.isnan(np.asarray(jax.jit(am.log)(jnp.float32(nan1))))


def test_accurate_f64_dispatches_native():
    x = jnp.asarray(XS, dtype=jnp.float64)
    np.testing.assert_array_equal(np.asarray(am.exp(x)), np.asarray(jnp.exp(x)))
    np.testing.assert_array_equal(np.asarray(am.log(jnp.abs(x) + 1e-30)),
                                  np.asarray(jnp.log(jnp.abs(x) + 1e-30)))


def test_accurate_gradients():
    "custom_jvp derivatives match the analytic forms to f32 accuracy."
    x = jnp.asarray(np.clip(XS, -30, 30))
    g_exp = np.asarray(jax.vmap(jax.grad(am.exp))(x), np.float64)
    g_expm1 = np.asarray(jax.vmap(jax.grad(am.expm1))(x), np.float64)
    want = np.exp(np.asarray(x, np.float64))
    for g in (g_exp, g_expm1):
        rel = np.abs(g - want) / (np.abs(want) + 1e-300)
        assert rel.max() < 5e-7
    xp = jnp.abs(x) + np.float32(1e-6)
    g_log = np.asarray(jax.vmap(jax.grad(am.log))(xp), np.float64)
    want = 1.0 / np.asarray(xp, np.float64)
    rel = np.abs(g_log - want) / np.abs(want)
    assert rel.max() < 5e-7


def test_accurate_compositions():
    x = jnp.asarray(np.clip(XS, -60, 60))
    sp = np.asarray(am.softplus(x), np.float64)
    want = np.logaddexp(0.0, np.asarray(x, np.float64))
    assert (np.abs(sp - want) / (np.abs(want) + 1e-30)).max() < 1e-6
    sig = np.asarray(am.expit(x), np.float64)
    want = 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))
    assert (np.abs(sig - want) / np.abs(want)).max() < 1e-6
    gs = np.asarray(am.geomspace(jnp.float32(1e-4), jnp.float32(15.0), 15), np.float64)
    want = np.geomspace(1e-4, 15.0, 15)
    assert (np.abs(gs - want) / want).max() < 1e-6
