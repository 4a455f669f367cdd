"""Kernel-equivalence tests (cf. reference tests/test_gpu.py:26-66).

The dual-implementation pattern: every optimized backend must agree with the
O(M) scan oracle in value and gradient, with and without missing data.
"""

import jax
import jax.numpy as jnp
import jax.test_util
import numpy as np
import pytest

from phlash_tpu.hmm import PureXLAKernel
from phlash_tpu.kernel import get_kernel
from phlash_tpu.ops.kernel_dense import DenseKernel


@pytest.fixture
def kerns(data):
    oracle = PureXLAKernel(M=16, data=data, double_precision=True)
    dense = DenseKernel(M=16, data=data, double_precision=True, seg_len=128)
    return oracle, dense


def test_values_agree(kerns, pp):
    oracle, dense = kerns
    for i in [0, 3, 9]:
        np.testing.assert_allclose(
            float(oracle.loglik(pp, i)), float(dense.loglik(pp, i)), rtol=1e-8
        )


def test_values_agree_missing(data, pp):
    d = data.copy()
    d[:, 100:200] = -1
    oracle = PureXLAKernel(M=16, data=d, double_precision=True)
    dense = DenseKernel(M=16, data=d, double_precision=True, seg_len=128)
    np.testing.assert_allclose(
        float(oracle.loglik(pp, 0)), float(dense.loglik(pp, 0)), rtol=1e-8
    )


def test_grads_agree(kerns, pp):
    oracle, dense = kerns
    g1 = jax.grad(lambda p: oracle.loglik(p, 0))(pp)
    g2 = jax.grad(lambda p: dense.loglik(p, 0))(pp)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-10)


def test_value_and_grad_batch(kerns, pp):
    oracle, dense = kerns
    inds = np.array([0, 2, 5])
    v1, g1 = oracle(pp, inds, grad=True)
    v2, g2 = dense(pp, inds, grad=True)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-8)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-10)


def test_check_grads_fd(data, pp):
    """Finite differences on the dense kernel (cf. test_gpu.py:26-30).

    Differentiated in log-parameter space (as the reference kernel is) so FD
    perturbations cannot push probabilities negative.
    """
    dense = DenseKernel(M=16, data=data[:2, :200], double_precision=True, seg_len=64)
    log_pp = jax.tree.map(lambda a: np.log(np.maximum(np.asarray(a), 1e-30)), pp)
    jax.test_util.check_grads(
        lambda lp: dense.loglik(jax.tree.map(jnp.exp, lp), 0),
        (log_pp,),
        order=1,
        modes=["rev"],
        rtol=1e-4,
    )


def test_loglik_batched(kerns, pp):
    oracle, dense = kerns
    B, S = 3, 2
    pps = jax.tree.map(lambda a: np.broadcast_to(a, (B, S) + a.shape), pp)
    inds = np.array([1, 4])
    got = np.asarray(dense.loglik_batched(pps, inds))
    assert got.shape == (B, S)
    want = np.array([[float(oracle.loglik(pp, i)) for i in inds] for _ in range(B)])
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_get_kernel_dispatch(data):
    k = get_kernel(M=16, data=data, backend="dense")
    assert isinstance(k, DenseKernel)
    k = get_kernel(M=16, data=data, backend="scan")
    assert isinstance(k, PureXLAKernel)
    with pytest.raises(ValueError, match="unknown kernel backend"):
        get_kernel(M=16, data=data, backend="pallas")


def test_get_kernel_default_is_dense_on_cpu(data):
    "No backend named: the dense kernel on the CPU, at any M."
    from phlash_tpu.kernel import default_backend

    assert isinstance(get_kernel(M=16, data=data), DenseKernel)
    assert default_backend(16) == default_backend(24) == "dense"


def test_get_kernel_interpret_only_on_request(data):
    """The triton kernel compiles for the GPU unless the caller asks for the
    interpreter; on the CPU an uninterpreted call raises instead of falling
    back to another backend."""
    import jax.numpy as jnp

    from phlash_tpu.ops.smc_triton import TritonKernel
    from phlash_tpu.params import PSMCParams
    from phlash_tpu.size_history import DemographicModel

    kern = get_kernel(M=16, data=data, backend="triton")
    assert isinstance(kern, TritonKernel) and not kern.interpret
    assert get_kernel(M=16, data=data, backend="triton", interpret=True).interpret
    with pytest.raises(ValueError, match="triton backend only"):
        get_kernel(M=16, data=data, backend="dense", interpret=True)

    dm = DemographicModel.default(pattern="16*1", theta=1e-2, rho=1e-2)
    pp = jax.tree.map(lambda a: a.astype(jnp.float32), PSMCParams.from_dm(dm))
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (2, 1) + a.shape), pp)
    with pytest.raises(Exception, match="interpret"):
        kern.loglik_batched(pps, jnp.array([0]))
