"""Structured SMC' Triton kernel equivalence tests, interpret mode on CPU.

Most tests share ONE kernel configuration (L=160, S=2, B=3 -> one
program of BH=4 particles per chunk), so the interpret-mode programs
compile once per direction and every further test reuses them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# cross-checks through model.log_density / vmap paths each compile several
# more interpret-mode programs; the core value/grad/filter equivalences
# stay in the fast lane
CROSS = pytest.mark.slow

from phlash_tpu.hmm import PureXLAKernel, psmc_ll
from phlash_tpu.ops.kernel_dense import DenseKernel
from phlash_tpu.ops.smc_triton import TritonKernel

L = 160


@pytest.fixture(scope="module")
def sdata():
    rng = np.random.default_rng(0)
    d = rng.binomial(1, 0.05, size=(4, L)).astype(np.int8)
    d[1, 50:80] = -1  # missing block
    d[2, 150:] = -1  # missing tail
    return d


@pytest.fixture(scope="module")
def f32_pp():
    from phlash_tpu.params import PSMCParams
    from phlash_tpu.size_history import DemographicModel

    dm = DemographicModel.default(pattern="16*1", theta=1e-2, rho=1e-2)
    return jax.tree.map(lambda a: a.astype(jnp.float32), PSMCParams.from_dm(dm))


@pytest.fixture(scope="module")
def kern(sdata):
    return TritonKernel(M=16, data=sdata, interpret=True)


@pytest.fixture(scope="module")
def dkern(sdata):
    return DenseKernel(M=16, data=sdata, seg_len=32)


def test_instance_packing_occupancy(sdata):
    """(particle x chunk) instances fill the programs: at the production
    shape B=500, S=5 no particle slot idles on one device, and 12 of 512
    do when the particles split over the 8-device mesh."""
    from phlash_tpu.parallel import make_mesh

    B = 500
    bh, nw, B_pad = TritonKernel(M=16, data=sdata).layout(B)
    assert (bh, nw, B_pad) == (4, 1, 500)  # 125 programs per chunk

    mesh = make_mesh(8)
    bh8, _, B_pad8 = TritonKernel(M=16, data=sdata, mesh=mesh).layout(B)
    assert B_pad8 % (bh8 * mesh.devices.size) == 0  # whole programs per device
    assert (bh8, B_pad8) == (4, 512)  # 63 -> 64 particles on each device

    # tiny batches shrink the block to fit
    assert TritonKernel(M=16, data=sdata).layout(3) == (4, 1, 4)
    assert TritonKernel(M=16, data=sdata).layout(1) == (1, 1, 1)


def test_instance_packing_roundtrip(sdata, f32_pp):
    "pack lays leaves out as (6, M, B_pad) / (S, M, B_pad) with identity padding."
    from phlash_tpu.ops.smc_triton import _PAD_VALUES, _PARAM_ORDER

    B, S = 5, 3
    k = TritonKernel(M=16, data=sdata)
    rng = np.random.default_rng(7)
    pi = jnp.asarray(rng.random((B, S, 16)), dtype=jnp.float32)
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, S) + a.shape), f32_pp)._replace(pi=pi)
    th, pi_p, B_out, (bh, nw) = k.pack(pps, S)
    assert B_out == B and (bh, nw) == (4, 1)
    assert th.shape == (6, 16, 8) and pi_p.shape == (S, 16, 8)
    np.testing.assert_array_equal(np.asarray(pi_p[:, :, :B].transpose(2, 0, 1)), np.asarray(pi))
    for k_, (name, fill) in enumerate(zip(_PARAM_ORDER, _PAD_VALUES)):
        np.testing.assert_array_equal(
            np.asarray(th[k_, :, :B].T), np.asarray(getattr(f32_pp, name))[None].repeat(B, 0)
        )
        assert (np.asarray(th[k_, :, B:]) == fill).all(), name
    assert np.allclose(np.asarray(pi_p[:, :, B:]), 1 / 16)


def test_padding_particles_are_identity_hmms(sdata, f32_pp):
    "Padded particle slots contribute exactly zero log-likelihood."
    from phlash_tpu.ops.smc_triton import smc_op

    k = TritonKernel(M=16, data=sdata)
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (3, 2) + a.shape), f32_pp)
    th, pi, B, (bh, nw) = k.pack(pps, 2)
    rows = k._rows(jnp.asarray(sdata[:2]))
    assert rows.shape == (2, L)  # 160 is already a multiple of NORM_EVERY
    ll, alpha = smc_op(th, pi, rows, bh, nw, True)
    assert (np.asarray(ll[:, B:]) == 0.0).all()
    np.testing.assert_allclose(np.asarray(alpha[:, :, B:]), 1 / 16, rtol=1e-6)


@pytest.mark.parametrize("block_h", [4, 32, 128])
def test_block_shape_choice(monkeypatch, block_h):
    "Blocks are powers of two, at most BLOCK_H particles, one warp per 32."
    from phlash_tpu.ops import smc_triton

    monkeypatch.setattr(smc_triton, "BLOCK_H", block_h)
    for b_local in (1, 3, 17, 40, 100, 500):
        bh, nw = smc_triton.block_shape(b_local)
        assert bh & (bh - 1) == 0 and bh <= block_h  # a power of two
        assert bh >= min(b_local, block_h)  # covers the batch or is full
        assert nw == max(1, bh // 32)
    assert smc_triton.block_shape(3) == (4, 1)


def test_smc_values_match_oracle(sdata, kern, f32_pp):
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (3, 2) + a.shape), f32_pp)
    ll = np.asarray(kern.loglik_batched(pps, jnp.array([0, 3])))
    for s, i in enumerate([0, 3]):
        want = float(psmc_ll(f32_pp, jnp.asarray(sdata[i]))[1])
        np.testing.assert_allclose(ll[:, s], want, rtol=1e-5)


def test_smc_values_missing_data(sdata, kern, f32_pp):
    "Rows with missing blocks/tails against the scan oracle."
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (3, 2) + a.shape), f32_pp)
    ll = np.asarray(kern.loglik_batched(pps, jnp.array([1, 2])))
    for s, i in enumerate([1, 2]):
        want = float(psmc_ll(f32_pp, jnp.asarray(sdata[i]))[1])
        np.testing.assert_allclose(ll[:, s], want, rtol=1e-5)


def test_smc_grads_match_dense(sdata, kern, f32_pp):
    from phlash_tpu.ops.check import assert_grads_match, dense_f64_value_and_grad

    B, S = 3, 2
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, S) + a.shape), f32_pp)
    inds = jnp.array([0, 1])
    W = jnp.arange(1.0, B * S + 1).reshape(B, S).astype(jnp.float32)
    val, gp = jax.value_and_grad(lambda p: (kern.loglik_batched(p, inds) * W).sum())(pps)
    dval, gd = dense_f64_value_and_grad(sdata, pps, inds, W, seg_len=32)
    np.testing.assert_allclose(float(val), float(dval), rtol=1e-5)
    assert_grads_match(pps._fields, gp, gd)


def test_smc_deepest_interval_grads(sdata, kern, f32_pp):
    """The strict suffix sums run from the deep end, so the deepest
    intervals' gradients keep full relative accuracy: each interval is
    compared at its own scale, not the leaf's maximum."""
    from phlash_tpu.ops.check import dense_f64_value_and_grad

    B, S = 3, 2
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, S) + a.shape), f32_pp)
    inds = jnp.array([0, 1])
    W = jnp.arange(1.0, B * S + 1).reshape(B, S).astype(jnp.float32)
    gp = jax.grad(lambda p: (kern.loglik_batched(p, inds) * W).sum())(pps)
    _, gd = dense_f64_value_and_grad(sdata, pps, inds, W, seg_len=32)
    for name in ("b", "d", "v", "emis0", "emis1"):
        a = np.asarray(getattr(gp, name), np.float64).sum(1)[:, -4:]
        b = np.asarray(getattr(gd, name), np.float64).sum(1)[:, -4:]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-12 * np.abs(b).max(), err_msg=name)


def test_smc_filter_matches_oracle(sdata, kern, f32_pp):
    B = 3
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), f32_pp)
    warmup = jnp.asarray(sdata[:2])  # full-length rows: reuses the fwd compile
    alpha = np.asarray(kern.filter_batched(pps, warmup))
    assert alpha.shape == (B, 2, 16)
    for s in range(2):
        want = np.asarray(psmc_ll(f32_pp, warmup[s])[0])
        for bi in range(B):
            np.testing.assert_allclose(alpha[bi, s], want, rtol=1e-4, atol=1e-25)


def test_smc_filter_grad_matches_xla(sdata, kern, f32_pp):
    "Differentiating through the triton filter must match the XLA scan filter."
    xkern = PureXLAKernel(M=16, data=sdata)
    B = 3
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), f32_pp)
    warmup = jnp.asarray(sdata[:2])
    T = jnp.linspace(0.5, 1.5, B * 2 * 16).reshape(B, 2, 16)

    def loss(kern_):
        return lambda p: (kern_.filter_batched(p, warmup) * T).sum()

    gp = jax.grad(loss(kern))(pps)
    gx = jax.grad(loss(xkern))(pps)
    for name, a, b in zip(pps._fields, gp, gx):
        a, b = np.asarray(a), np.asarray(b)
        denom = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / denom, b / denom, atol=2e-5, err_msg=name)


@pytest.mark.heavy  # ~80 s; dense backend only
def test_log_density_batched_matches_per_particle(sdata, mcp):
    "log_density_batched == vmap(log_density) on the dense backend."
    from phlash_tpu.model import log_density, log_density_batched

    kern64 = DenseKernel(M=16, data=sdata, double_precision=True, seg_len=32)
    B = 3
    key = jax.random.PRNGKey(0)
    flat, unravel = jax.flatten_util.ravel_pytree(mcp)
    particles = jax.vmap(unravel)(flat[None] + 0.01 * jax.random.normal(key, (B, len(flat))))
    kw = dict(
        c=jnp.array([1.0, 1.0, 1.0]),
        inds=jnp.arange(2),
        warmup=jnp.asarray(sdata[:2]),
        kern=kern64,
        afs=jnp.array([30, 10, 5], dtype=jnp.int64),
        afs_transform=None,
    )
    got = log_density_batched(particles, **kw)
    want = jax.vmap(lambda m: log_density(m, **kw))(particles)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)
    g1 = jax.grad(lambda P: log_density_batched(P, **kw).sum())(particles)
    g2 = jax.grad(lambda P: jax.vmap(lambda m: log_density(m, **kw))(P).sum())(particles)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-8)


@CROSS
def test_vmap_loglik_structured_matches_dense(sdata, kern, dkern, f32_pp):
    """vmap(kern.loglik) over particles — the per-particle log_density path
    (model.py:61) — must work and agree with the dense backend."""
    B = 2
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), f32_pp)
    inds = jnp.array([0, 1])
    got = jax.vmap(kern.loglik, (0, None))(pps, inds[0])
    got2 = jax.vmap(jax.vmap(kern.loglik, (None, 0)), (0, None))(pps, inds)
    want = jax.vmap(dkern.loglik, (0, None))(pps, inds[0])
    want2 = jax.vmap(jax.vmap(dkern.loglik, (None, 0)), (0, None))(pps, inds)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got2), np.asarray(want2), rtol=1e-5)


@CROSS
def test_log_density_structured_kernel_per_particle(sdata, kern, dkern, mcp):
    "log_density (per-particle vmap path) with the triton kernel == dense."
    from phlash_tpu.model import log_density

    kw = dict(
        c=jnp.array([1.0, 1.0, 1.0]),
        inds=jnp.arange(2),
        warmup=jnp.asarray(sdata[:2]),
        afs=jnp.array([30, 10, 5], dtype=jnp.int64),
        afs_transform=None,
    )
    got = log_density(mcp, kern=kern, **kw)
    want = log_density(mcp, kern=dkern, **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_m_policy_unsupported_raises(sdata):
    """M outside SUPPORTED_M fails loudly, in the kernel and through
    get_kernel with the backend named: no silent fallback to dense."""
    from phlash_tpu.kernel import default_backend, get_kernel

    with pytest.raises(ValueError, match="supports M in"):
        TritonKernel(M=24, data=sdata)
    with pytest.raises(ValueError, match="supports M in"):
        get_kernel(M=24, data=sdata, backend="triton")
    with pytest.raises(ValueError, match="float32-only"):
        get_kernel(M=16, data=sdata, backend="triton", double_precision=True)
    assert default_backend(24) == "dense"


def _m_setup(sdata, m):
    from phlash_tpu.params import PSMCParams
    from phlash_tpu.size_history import DemographicModel

    dm = DemographicModel.default(pattern=f"{m}*1", theta=1e-2, rho=1e-2)
    pp = jax.tree.map(lambda a: a.astype(jnp.float32), PSMCParams.from_dm(dm))
    data = sdata[:, 40:64]  # 24 sites: three rescaling periods
    B, S = 2, 2
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, S) + a.shape), pp)
    return pp, pps, data, TritonKernel(M=m, data=data, interpret=True)


@pytest.mark.parametrize("m", [8, 32, 64])
def test_smc_m_generality(sdata, m):
    """The kernel at every non-default M of SUPPORTED_M, at a tiny length:
    forward values against the scan oracle, the full adjoint against the
    f64 dense backend."""
    from phlash_tpu.ops.check import assert_grads_match, dense_f64_value_and_grad
    from phlash_tpu.params import PSMCParams
    from phlash_tpu.size_history import DemographicModel

    dm = DemographicModel.default(pattern=f"{m}*1", theta=1e-2, rho=1e-2)
    pp = jax.tree.map(lambda a: a.astype(jnp.float32), PSMCParams.from_dm(dm))
    data = sdata[:, 40:64]  # 24 sites: three rescaling periods
    kern = TritonKernel(M=m, data=data, interpret=True)
    B, S = 2, 2
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, S) + a.shape), pp)
    inds = jnp.array([0, 1])
    W = jnp.arange(1.0, B * S + 1).reshape(B, S).astype(jnp.float32)
    val, gp = jax.value_and_grad(lambda p: (kern.loglik_batched(p, inds) * W).sum())(pps)
    want = sum(
        float(W[:, s].sum()) * float(psmc_ll(pp, jnp.asarray(data[s]))[1]) for s in range(S)
    )
    np.testing.assert_allclose(float(val), want, rtol=1e-5)
    _, gd = dense_f64_value_and_grad(data, pps, inds, W, seg_len=8)
    assert_grads_match(pps._fields, gp, gd)


@pytest.mark.parametrize("m", [8, 16, 32, 64])
def test_kernel_lowers_to_triton(m):
    """Forward and adjoint lower to Triton IR for the GPU at each supported
    M (the lowering runs here; only the GPU compiles the IR)."""
    from phlash_tpu.ops.smc_triton import smc_op

    S, B_pad, L_pad = 2, 32, 64
    th = jax.ShapeDtypeStruct((6, m, B_pad), jnp.float32)
    pi = jax.ShapeDtypeStruct((S, m, B_pad), jnp.float32)
    obs = jax.ShapeDtypeStruct((S, L_pad), jnp.int8)

    def loss(th, pi, obs):
        ll, alpha = smc_op(th, pi, obs, 32, 1, False)
        return ll.sum() + alpha.sum()

    text = (
        jax.jit(jax.grad(loss, argnums=(0, 1)))
        .trace(th, pi, obs)
        .lower(lowering_platforms=("cuda",))
        .as_text()
    )
    assert text.count("xla.gpu.triton") == 2  # forward with residuals + adjoint
