"""HMM structure invariants (cf. reference tests/test_hmm.py:11-19).

The key invariant: the O(M) compressed product equals multiplication by the
dense transition matrix — this is what licenses the scan kernel, the dense
kernel and the triton kernel alike.
"""

import jax
import numpy as np

from phlash_tpu.hmm import matvec_smc, psmc_ll
from phlash_tpu.ops.packing import block_diag_pack, dense_transition
from phlash_tpu.transition import transition_matrix


def test_matvec_equals_dense_transition(rng, pp):
    v = rng.uniform(size=16)
    got = np.asarray(matvec_smc(v, pp))
    want = v @ np.asarray(dense_transition(pp))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_dense_transition_equals_transition_matrix(dm, pp):
    "The compressed params reconstruct the assembled SMC' matrix (mod clip)."
    A = np.asarray(transition_matrix(dm)).clip(1e-20, 1 - 1e-20)
    D = np.asarray(dense_transition(pp))
    np.testing.assert_allclose(D, A, rtol=1e-8)


def test_matvec_equals_transition_matrix(rng, dm, pp):
    v = rng.uniform(size=16)
    A = np.asarray(transition_matrix(dm))
    np.testing.assert_allclose(np.asarray(matvec_smc(v, pp)), v @ A, rtol=1e-8)


def test_block_diag_pack(rng, pp):
    As = np.stack([rng.uniform(size=(4, 4)) for _ in range(3)])
    blk = np.asarray(block_diag_pack(As))
    assert blk.shape == (12, 12)
    for g in range(3):
        np.testing.assert_allclose(blk[4 * g : 4 * g + 4, 4 * g : 4 * g + 4], As[g])
    # off-diagonal blocks vanish
    assert np.allclose(blk[0:4, 4:8], 0.0)


def test_psmc_ll_finite(pp, data):
    alpha, ll = psmc_ll(pp, data[0])
    assert np.isfinite(float(ll))
    np.testing.assert_allclose(float(alpha.sum()), 1.0, rtol=1e-8)


def test_psmc_ll_missing_data(pp, data):
    "Missing sites must contribute emission factor 1, not drop likelihood."
    d = data[0].copy()
    ll_full = float(psmc_ll(pp, d)[1])
    d_missing = d.copy()
    d_missing[::2] = -1
    ll_missing = float(psmc_ll(pp, d_missing)[1])
    assert np.isfinite(ll_missing)
    assert ll_missing > ll_full  # fewer informative sites => higher (less negative)


def test_psmc_ll_grad_finite(pp, data):
    g = jax.grad(lambda p: psmc_ll(p, data[0])[1])(pp)
    for leaf in jax.tree.leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()


def test_f32_particles_stay_f32_end_to_end():
    """A float32 particle (even with a numpy-f64 Watterson theta in the
    static fields) must produce an all-float32 PSMCParams and a float32
    psmc_ll — a single strongly-typed scalar used to promote the whole
    assembly graph back to f64 silently."""
    import jax
    import jax.numpy as jnp

    from phlash_tpu.params import MCMCParams, PSMCParams

    mcp = MCMCParams.from_linear(
        pattern="14*1+1*2",
        t1=1e-4,
        tM=15.0,
        c=jnp.ones(15),
        theta=np.float64(1e-2),  # numpy scalar on purpose
        rho=np.float64(1e-2),
        alpha=np.float64(0.0),
        beta=np.float64(0.0),
    )
    mcp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), mcp)
    pp32 = PSMCParams.from_dm(mcp32.to_dm())
    assert {str(leaf.dtype) for leaf in pp32} == {"float32"}
    alpha, ll = psmc_ll(pp32, jnp.zeros(32, jnp.int8))
    assert alpha.dtype == jnp.float32 and ll.dtype == jnp.float32
