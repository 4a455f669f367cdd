"""SVGD sampler sanity: converges to a known Gaussian posterior."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from phlash_tpu.svgd import SVGD, svgd_direction


def test_svgd_gaussian_convergence():
    "Particles should approach N(mu, 1) in mean and spread."
    mu = jnp.array([2.0, -1.0])

    def log_p(x):
        return -0.5 * jnp.sum((x - mu) ** 2)

    svgd = SVGD(jax.grad(log_p), optax.adam(0.1))
    key = jax.random.PRNGKey(0)
    particles = jax.random.normal(key, (100, 2)) * 0.1 - 3.0
    state = svgd.init(particles)
    step = jax.jit(svgd.step)
    for _ in range(300):
        state = step(state)
    got_mean = np.asarray(state.particles.mean(0))
    np.testing.assert_allclose(got_mean, np.asarray(mu), atol=0.2)
    # repulsion keeps particles spread out (variance near 1, definitely > 0.3)
    assert float(state.particles.std(0).min()) > 0.3


def test_svgd_direction_shape():
    x = jnp.zeros((7, 3)).at[:, 0].add(jnp.arange(7.0))
    g = jnp.ones((7, 3))
    phi = svgd_direction(x, g)
    assert phi.shape == (7, 3)
    assert np.isfinite(np.asarray(phi)).all()


def test_svgd_pytree_particles():
    "SVGD must work on dict-structured particles (like MCMCParams)."
    def log_p(p):
        return -0.5 * jnp.sum(p["a"] ** 2) - 0.5 * jnp.sum((p["b"] - 1.0) ** 2)

    svgd = SVGD(jax.grad(log_p), optax.adam(0.1))
    key = jax.random.PRNGKey(1)
    particles = {
        "a": jax.random.normal(key, (50, 2)) + 3.0,
        "b": jax.random.normal(key, (50,)) - 3.0,
    }
    state = svgd.init(particles)
    step = jax.jit(svgd.step)
    for _ in range(200):
        state = step(state)
    assert abs(float(state.particles["a"].mean())) < 0.3
    assert abs(float(state.particles["b"].mean()) - 1.0) < 0.3


def test_median_bandwidth_is_strict_lower_triangle_median():
    """The sort over the diagonal-masked full matrix must give exactly the
    strict-lower-triangle median (blackjax's convention) on every cloud
    shape, including heavy ties and fully-coincident particles (where the
    1e-12 floor applies)."""
    from phlash_tpu.svgd import median_bandwidth

    for trial in range(6):
        rng = np.random.default_rng(trial)
        x = rng.normal(size=(61, 7)).astype(np.float32)
        if trial == 3:
            x[10:40] = x[0]  # massive duplicates
        if trial == 4:
            x = np.round(x * 4) / 4  # quantized -> many tied distances
        if trial == 5:
            x[:] = 0.0  # all particles coincide -> median 0
        P = x.shape[0]
        sq = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1).astype(np.float32)
        h = float(median_bandwidth(jnp.asarray(sq), P))
        tri = np.sort(np.sqrt(sq)[np.tril_indices(P, k=-1)])
        m = len(tri)
        med = np.float32(0.5 * (np.float32(tri[(m - 1) // 2]) + np.float32(tri[m // 2])))
        want = max(float(np.float32(med * med) / np.float32(np.log(P))), 1e-12)
        np.testing.assert_allclose(h, want, rtol=1e-6, err_msg=str(trial))
