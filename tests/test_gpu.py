"""Compiled-kernel checks on an NVIDIA GPU.

Marked `gpu`; each test asks the `gpu` fixture for a card and skips where
there is none.  Run on a card with

    PHLASH_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX reports {dev.platform!r}")
    return dev


def _pps(m, B, S):
    from phlash_tpu.params import PSMCParams
    from phlash_tpu.size_history import DemographicModel

    dm = DemographicModel.default(pattern=f"{m}*1", theta=1e-2, rho=1e-2)
    pp = jax.tree.map(lambda a: a.astype(jnp.float32), PSMCParams.from_dm(dm))
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (B, S) + a.shape), pp)


def test_default_backend_is_triton(gpu):
    from phlash_tpu.kernel import get_kernel
    from phlash_tpu.ops.smc_triton import TritonKernel

    data = np.zeros((2, 64), np.int8)
    assert isinstance(get_kernel(M=16, data=data), TritonKernel)
    assert not get_kernel(M=16, data=data).interpret


@pytest.mark.parametrize("m", [8, 16, 32, 64])
def test_compiled_kernel_matches_f64(gpu, m):
    "Compiled values and gradients against the f64 scan and dense oracles."
    from phlash_tpu.hmm import PureXLAKernel
    from phlash_tpu.kernel import get_kernel
    from phlash_tpu.ops.check import assert_grads_match, dense_f64_value_and_grad

    rng = np.random.default_rng(m)
    data = rng.binomial(1, 0.05, size=(3, 1000)).astype(np.int8)
    data[1, 100:200] = -1
    B, S = 40, 3
    pps, inds = _pps(m, B, S), jnp.arange(S)
    W = jnp.asarray(rng.uniform(0.5, 1.5, (B, S)), jnp.float32)
    kern = get_kernel(M=m, data=data, backend="triton")
    val, g = jax.jit(jax.value_and_grad(lambda p: (kern.loglik_batched(p, inds) * W).sum()))(pps)
    ll = kern.loglik_batched(pps, inds)
    want = PureXLAKernel(M=m, data=data, double_precision=True).loglik_batched(
        jax.tree.map(lambda a: a.astype(jnp.float64), pps), inds)
    np.testing.assert_allclose(np.asarray(ll), np.asarray(want), rtol=1e-4)
    _, gd = dense_f64_value_and_grad(data, pps, inds, W, seg_len=128)
    assert_grads_match(pps._fields, g, gd, atol=1e-3)
