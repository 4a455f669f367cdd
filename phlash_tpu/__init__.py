"""phlash_tpu — Bayesian inference of ancestral population size in JAX.

A framework with the capability surface of
jthlab/phlash (Bayesian PSMC via SVGD over a pair-coalescent HMM).  The
public API matches the reference package
(upstream phlash/__init__.py:18-24): `fit`, `contig`, `psmc`,
`DemographicModel`, `SizeHistory`, `plot_posterior`.

Defaults: float32 end-to-end on device (long log-likelihood sums use
compensated accumulation), XLA never preallocates the whole device memory,
and the heavy compute paths are jitted, mesh-shardable programs with no
host callbacks.  On an NVIDIA GPU the likelihood runs in a Pallas-Triton
kernel (phlash_tpu.ops.smc_triton).
"""

import os

# keep XLA from grabbing all device memory before the data tensors are sized
os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")

import jax as _jax

# x64 stays enabled so f64 is *available* (quadrature oracles, the
# double_precision_params=True fallback, int64-safe host indexing), but
# the default parameter graph is float32: the assembly is
# cancellation-free (phlash_tpu.transition._expQ2), matmuls pin
# Precision.HIGHEST, and transcendentals use faithfully-rounded f32
# implementations (utils/accurate.py).  The reference instead requires
# f64 throughout (upstream phlash/__init__.py:16).
_jax.config.update("jax_enable_x64", True)


def compile_cache_dir() -> str:
    """Where compiled programs persist: JAX_COMPILATION_CACHE_DIR if set,
    else a fixed `.jax_cache` in the checkout (the path is part of the
    cache key, so it must not move between runs)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
    )


# JAX reads JAX_COMPILATION_CACHE_DIR only when it is imported, so the
# setting goes through jax.config
_jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

from phlash_tpu.data import contig
from phlash_tpu.mcmc import fit
from phlash_tpu.plot import plot_posterior
from phlash_tpu.psmc import psmc
from phlash_tpu.size_history import DemographicModel, SizeHistory

__all__ = [
    "fit",
    "contig",
    "psmc",
    "DemographicModel",
    "SizeHistory",
    "plot_posterior",
]

__version__ = "0.1.0"
