"""PPoly vs scipy.interpolate.PPoly oracle (cf. reference tests/test_jax_ppoly.py)."""

import jax
import numpy as np
import scipy.integrate
import scipy.interpolate

from phlash_tpu.ppoly import PPoly


def _random_pwc(rng, K=8):
    "Random piecewise-constant positive rate function."
    x = np.concatenate([[0.0], np.sort(rng.uniform(0.1, 10.0, K - 1)), [np.inf]])
    c = rng.uniform(0.1, 3.0, K)[None]
    return PPoly(x=x, c=c), scipy.interpolate.PPoly(x=x, c=c)


def test_eval_matches_scipy(rng):
    ours, theirs = _random_pwc(rng)
    t = rng.uniform(0.0, 9.0, 50)
    np.testing.assert_allclose(ours(t), theirs(t), rtol=1e-12)


def test_antiderivative_matches_scipy(rng):
    ours, theirs = _random_pwc(rng)
    t = rng.uniform(0.0, 9.0, 50)
    np.testing.assert_allclose(
        ours.antiderivative()(t), theirs.antiderivative()(t), rtol=1e-10
    )


def test_derivative_matches_scipy(rng):
    x = np.concatenate([[0.0], np.sort(rng.uniform(0.1, 10.0, 5)), [np.inf]])
    c = rng.uniform(0.1, 3.0, (3, 6))
    ours = PPoly(x=x, c=c)
    theirs = scipy.interpolate.PPoly(x=x, c=c)
    t = rng.uniform(0.0, 9.0, 50)
    np.testing.assert_allclose(ours.derivative()(t), theirs.derivative()(t), rtol=1e-10)


def test_exp_integral_vs_quadrature(rng):
    ours, theirs = _random_pwc(rng)
    R = theirs.antiderivative()
    expected, _ = scipy.integrate.quad(
        lambda u: np.exp(-R(u)), 0.0, 50.0, points=ours.x[:-1], limit=200
    )
    np.testing.assert_allclose(float(ours.exp_integral()), expected, rtol=1e-6)


def test_exp_integral_finite_t(rng):
    ours, theirs = _random_pwc(rng)
    R = theirs.antiderivative()
    for t in [0.5, 2.7, 8.0]:
        expected, _ = scipy.integrate.quad(lambda u: np.exp(-R(u)), 0.0, t, limit=200)
        np.testing.assert_allclose(float(ours.exp_integral(t)), expected, rtol=1e-8)


def test_exp_integral_grad_finite(rng):
    "Gradients through exp_integral must not be NaN (last-epoch guard)."
    import jax.numpy as jnp

    def f(c):
        pp = PPoly(x=jnp.array([0.0, 1.0, jnp.inf]), c=c[None])
        return pp.exp_integral()

    g = jax.grad(f)(jnp.array([0.5, 1.5]))
    assert np.isfinite(np.asarray(g)).all()


def test_dtype_preserved_under_x64():
    """f32 polynomials stay f32 through antiderivative/exp_integral even with
    jax x64 enabled (a bare jnp.zeros is f64 and used to promote the whole
    graph to f64)."""
    import jax.numpy as jnp

    for dt in [jnp.float32, jnp.float64]:
        pp = PPoly(
            x=jnp.array([0.0, 1.0, 2.0, jnp.inf], dt),
            c=jnp.array([[0.5, 1.5, 0.7]], dt),
        )
        assert pp.antiderivative().c.dtype == dt
        assert pp.exp_integral().dtype == dt
        assert pp.exp_integral(1.3).dtype == dt
