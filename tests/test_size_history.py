"""SizeHistory oracles (cf. reference tests/test_size_history.py:41-160)."""

import numpy as np
import pytest
import scipy.integrate

from phlash_tpu.size_history import DemographicModel, SizeHistory, _W_matrix


@pytest.fixture
def eta(rng):
    K = 8
    t = np.concatenate([[0.0], np.sort(rng.uniform(0.05, 8.0, K - 1))])
    c = rng.uniform(0.2, 3.0, K)
    return SizeHistory(t=t, c=c)


def test_density_integrates_to_one(eta):
    dens = eta.density()
    t_hi = float(eta.t[-1]) + 60.0 / float(np.min(eta.c))
    val, _ = scipy.integrate.quad(
        lambda x: float(dens(x)), 0.0, t_hi, points=list(eta.t), limit=200
    )
    np.testing.assert_allclose(val, 1.0, rtol=1e-6)


def test_surv_matches_R(eta):
    "surv()[k] is the survival at the *right* edge t[k+1] (last entry = 0)."
    np.testing.assert_allclose(
        np.asarray(eta.surv())[:-1], np.exp(-np.asarray(eta.R(eta.t[1:]))), rtol=1e-10
    )


def test_pi_sums_to_one(eta):
    np.testing.assert_allclose(float(eta.pi.sum()), 1.0, rtol=1e-10)
    assert (np.asarray(eta.pi) >= 0).all()


def test_ect_vs_quadrature(eta):
    "E[T | T in interval] from quadrature over the coalescence density."
    dens = eta.density()
    surv = np.asarray(eta.surv())
    ect = np.asarray(eta.ect())
    t = np.append(np.asarray(eta.t), np.inf)
    for k in range(eta.K - 1):
        num, _ = scipy.integrate.quad(lambda x: x * float(dens(x)), t[k], t[k + 1])
        mass = surv[k - 1] - surv[k] if k > 0 else 1.0 - surv[0]
        np.testing.assert_allclose(ect[k], num / mass, rtol=1e-6)


def test_mu_vs_quadrature(eta):
    t_hi = float(eta.t[-1]) + 60.0 / float(np.min(eta.c))
    expected, _ = scipy.integrate.quad(
        lambda x: float(eta.sf(x)), 0.0, t_hi, points=list(eta.t), limit=200
    )
    np.testing.assert_allclose(float(eta.mu), expected, rtol=1e-6)


def test_tv_identity(eta):
    assert abs(float(eta.tv(eta))) < 1e-12


def test_tv_vs_quadrature(rng):
    e1 = SizeHistory(t=np.array([0.0, 1.0]), c=np.array([1.0, 2.0]))
    e2 = SizeHistory(t=np.array([0.0, 0.5]), c=np.array([0.7, 1.3]))
    n = 1
    c = 2 * n * (2 * n - 1) / 2
    d1 = SizeHistory(t=e1.t, c=c * e1.c).density()
    d2 = SizeHistory(t=e2.t, c=c * e2.c).density()
    expected, _ = scipy.integrate.quad(
        lambda x: 0.5 * abs(float(d1(x)) - float(d2(x))),
        0,
        80.0,
        points=[0.5, 1.0],
        limit=500,
    )
    np.testing.assert_allclose(float(e1.tv(e2, n)), expected, rtol=1e-5)


def test_W_matrix_sanity():
    "Constant population: expected SFS proportional to 1/b (Fu 1995)."
    n = 10
    eta = SizeHistory(t=np.array([0.0]), c=np.array([1.0]))
    etbl = np.asarray(eta.etbl(n))
    b = np.arange(1, n)
    np.testing.assert_allclose(etbl, 2.0 / b, rtol=1e-6)


def test_W_matrix_shape():
    assert _W_matrix(2).shape == (1, 1)
    assert _W_matrix(10).shape == (9, 9)


def test_etjj_constant_pop():
    "E[t_jj] = 2/(j(j-1)) for constant unit coalescent."
    eta = SizeHistory(t=np.array([0.0]), c=np.array([1.0]))
    j = np.arange(2, 8)
    np.testing.assert_allclose(np.asarray(eta.etjj(7)), 2.0 / (j * (j - 1)), rtol=1e-8)


def test_quantile_balance(eta):
    q = eta.quantile(0.5)
    np.testing.assert_allclose(float(eta.cdf(q)), 0.5, atol=1e-6)


def test_rescale_roundtrip(dm):
    mu = 1.4e-8
    scaled = dm.rescale(mu)
    assert scaled.theta == mu
    # coalescence mass is invariant under rescaling
    np.testing.assert_allclose(
        np.asarray(scaled.eta.pi), np.asarray(dm.eta.pi), rtol=1e-8
    )


def test_from_pmf_roundtrip():
    t = np.array([0.0, 0.5, 1.0, 2.0])
    eta = SizeHistory(t=t, c=np.array([0.8, 1.6, 0.4, 1.0]))
    eta2 = SizeHistory.from_pmf(t, np.asarray(eta.pi))
    np.testing.assert_allclose(np.asarray(eta2.c[:-1]), np.asarray(eta.c[:-1]), rtol=1e-6)


# -- demes/msprime interop via fake modules (optional deps absent here) ------
#
# These exercise the gated import paths' own logic — the epoch ordering and
# piecewise-constant extraction — against stand-ins implementing just the
# slice of the external API each method touches.


def test_to_demes_epoch_layout(monkeypatch):
    import sys
    import types

    fake = types.ModuleType("demes")

    class Builder:
        def __init__(self):
            self.demes = []

        def add_deme(self, name, epochs):
            self.demes.append((name, epochs))

        def resolve(self):
            return self

    fake.Builder = Builder
    monkeypatch.setitem(sys.modules, "demes", fake)

    eta = SizeHistory(t=np.array([0.0, 1.0, 3.0]), c=np.array([0.5, 2.0, 1.0]))
    g = eta.to_demes("pop")
    ((name, epochs),) = g.demes
    assert name == "pop"
    # demes orders epochs oldest-first with strictly decreasing end_time;
    # epoch end_time == our interval start, size constant per interval
    assert [e["end_time"] for e in epochs] == [3.0, 1.0, 0.0]
    np.testing.assert_allclose(
        [e["start_size"] for e in epochs], np.asarray(eta.Ne)[::-1]
    )
    assert all(
        e["end_size"] == e["start_size"]
        and e["size_function"] == "constant"
        for e in epochs
    )


def test_from_demography_piecewise_extraction(monkeypatch):
    import sys
    import types

    fake = types.ModuleType("msprime")

    class Demography:
        pass

    fake.Demography = Demography
    monkeypatch.setitem(sys.modules, "msprime", fake)

    class _Dbg:
        epoch_start_time = np.array([0.0, 2.0, 5.0])

        def population_size_trajectory(self, steps):
            Ne = np.where(steps < 2, 100.0, np.where(steps < 5, 300.0, 200.0))
            return Ne[:, None]

    demo = Demography()
    demo.num_populations = 1
    demo.debug = _Dbg
    eta = SizeHistory.from_demography(demo)
    # only the change points of the step trajectory survive
    np.testing.assert_array_equal(np.asarray(eta.t), [0.0, 2.0, 5.0])
    np.testing.assert_allclose(
        np.asarray(eta.c), 1.0 / (2.0 * np.array([100.0, 300.0, 200.0]))
    )

    multi = Demography()
    multi.num_populations = 2
    with pytest.raises(ValueError, match="single-population"):
        SizeHistory.from_demography(multi)


def test_afs_moments_dtype_preserved():
    "etjj/etbl/mu must not promote an f32 history to f64."
    import jax.numpy as jnp

    for dt in [jnp.float32, jnp.float64]:
        eta = SizeHistory(
            t=jnp.asarray(np.r_[0.0, np.geomspace(1e-3, 15.0, 15)], dt),
            c=jnp.ones(16, dt),
        )
        assert eta.mu.dtype == dt
        assert eta.etjj(10).dtype == dt
        assert eta.etbl(10).dtype == dt


def test_etjj_matches_mu_path(eta):
    "The broadcast etjj equals integrating each rescaled history's .mu."
    import jax.numpy as jnp

    n = 8
    want = np.array(
        [float(SizeHistory(t=eta.t, c=j * (j - 1) / 2.0 * eta.c).mu)
         for j in range(2, n + 1)]
    )
    np.testing.assert_allclose(np.asarray(eta.etjj(n)), want, rtol=1e-8)


REF_TV_BUG = "/root/reference/tests/fixtures/tv_bug.pkl"


@pytest.mark.heavy  # the 101-breakpoint quadrature cross-check takes ~1 min
# (rebalanced from slow, r4 weak item 5; heavy runs in CI on every push)
@pytest.mark.skipif(not __import__("os").path.exists(REF_TV_BUG),
                    reason="reference fixture not present")
def test_tv_bug_regression():
    """The reference's pickled tv() bug case: symmetry, bounds, quadrature.

    (cf. reference tests/test_size_history.py::test_tv_bug; the pickle is
    unpickled through a shim so the reference package itself is never
    imported — only the two (t, c) arrays are read.)
    """
    import importlib
    import pickle

    class _Shim:
        def __new__(cls, *args):
            obj = super().__new__(cls)
            obj.t, obj.c = args
            return obj

        def __setstate__(self, state):
            pass

    class _U(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith("phlash"):
                assert name == "SizeHistory"
                return _Shim
            return getattr(importlib.import_module(module), name)

    with open(REF_TV_BUG, "rb") as f:
        s1, s2 = _U(f).load()
    eta1 = SizeHistory(t=np.asarray(s1.t), c=np.asarray(s1.c))
    eta2 = SizeHistory(t=np.asarray(s2.t), c=np.asarray(s2.c))
    tv12, tv21 = float(eta1.tv(eta2)), float(eta2.tv(eta1))
    np.testing.assert_allclose(tv12, tv21, rtol=1e-10)
    assert 0.0 <= tv12 <= 1.0
    # quadrature cross-check of the closed-form piecewise integral
    d1, d2 = eta1.density(), eta2.density()
    t = sorted({float(x) for eta in (eta1, eta2) for x in eta.t})
    f = lambda x: 0.5 * abs(float(d1(x)) - float(d2(x)))  # noqa: E731
    I1, _ = scipy.integrate.quad(f, 0.0, t[-1], points=t[1:-1], limit=2 * len(t))
    t_max = 2 * t[-1]
    while f(t_max) > 1e-20:
        t_max *= 2
    I2, _ = scipy.integrate.quad(f, t[-1], t_max)
    np.testing.assert_allclose(tv12, I1 + I2, rtol=1e-6)
