"""Shared fixtures (modeled on /root/reference/tests/conftest.py:14-41).

Tests run on a virtual 8-device CPU mesh so multi-device sharding logic
is exercised without GPUs; x64 is enabled so scipy quadrature oracles are
meaningful.  The env vars must be set before jax is imported.  The
`gpu`-marked tests run on a card with

    PHLASH_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import os

if not os.environ.get("PHLASH_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not os.environ.get("PHLASH_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

from phlash_tpu.params import MCMCParams, PSMCParams
from phlash_tpu.size_history import DemographicModel

# the suite's many small CPU programs gain nothing from the persistent
# cache, and parallel workers would write it concurrently
jax.config.update("jax_enable_compilation_cache", False)


def pytest_collection_modifyitems(config, items):
    """Auto-skip `heavy` tests unless explicitly selected.

    The fast lane (-m "not slow") and the slow lane (-m slow) each budget
    under ~10 minutes on a one-core host; the heavy artifacts (cross-package
    parity vs the reference sources ~18 min, the executable walkthrough,
    the longest fit e2e contracts) run only when asked for:

        python -m pytest tests/ -m heavy            # the whole heavy lane
        python -m pytest tests/test_ref_parity.py -m heavy
    """
    expr = config.option.markexpr or ""
    if "heavy" in expr:
        return
    skip = pytest.mark.skip(reason="heavy lane: select with -m heavy")
    for item in items:
        if "heavy" in item.keywords:
            item.add_marker(skip)


# One seed by default: the suite must stay fast on a single CPU core.
# PHLASH_TEST_SEEDS=all restores the reference's 3-seed sweep (CI slow lane).
_SEEDS = [1, 2, 3] if os.environ.get("PHLASH_TEST_SEEDS") == "all" else [1]


@pytest.fixture(params=_SEEDS)
def rng(request):
    return np.random.default_rng(request.param)


@pytest.fixture
def data(rng):
    "Random Bernoulli(0.05) observations, 10 chunks x 1000 sites."
    return rng.binomial(1, 0.05, size=(10, 1000)).astype(np.int8)


# session-scoped: these are immutable pytrees, and each eager reconstruction
# costs 1-2 s of op dispatch (f64 transition assembly) on one core
@pytest.fixture(scope="session")
def dm():
    return DemographicModel.default(pattern="16*1", theta=1e-2, rho=1e-2)


@pytest.fixture(scope="session")
def pp(dm):
    return PSMCParams.from_dm(dm)


@pytest.fixture(scope="session")
def mcp():
    return MCMCParams.from_linear(
        pattern="14*1+1*2",
        t1=1e-4,
        tM=15.0,
        c=np.ones(15),
        theta=1e-2,
        rho=1e-2,
        alpha=0.0,
        beta=0.0,
    )
