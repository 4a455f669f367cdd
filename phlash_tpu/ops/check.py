"""Shared oracle-comparison helpers for the sharded-kernel checks.

Used by the kernel tests (tests/test_smc_kernel.py, test_parallel.py,
test_gpu.py) and chip_smoke.py, which validate the triton kernel's value
and adjoint against the dense backend.  Centralised here
because the comparison has two easy-to-get-wrong ingredients:

* the oracle must actually run in float64 — DenseKernel casts its inputs
  to its own float_type, so ``double_precision=True`` is required or an
  f64-cast input is silently computed at f32 and an f32-specific gradient
  bug would compare equal to itself;
* the b/d/u/v/emis gradients are compared per-interval after summing the
  minibatch axis (the kernel accumulates over chunks), normalized by the
  leaf's own magnitude.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def dense_f64_value_and_grad(data, pps, inds, W, seg_len: int):
    """Value and per-leaf gradient of the weighted batched log-likelihood
    under the dense backend in TRUE float64 (the f32/f64 comparison
    oracle)."""
    from phlash_tpu.ops.kernel_dense import DenseKernel

    dkern = DenseKernel(
        M=pps.pi.shape[-1], data=data, seg_len=seg_len, double_precision=True
    )
    pps64 = jax.tree.map(lambda a: a.astype(jnp.float64), pps)
    return jax.value_and_grad(
        lambda p: (dkern.loglik_batched(p, inds) * W).sum()
    )(pps64)


def assert_grads_match(fields, got, want, atol: float = 2e-5):
    """Per-leaf comparison of two PSMCParams gradient pytrees, normalized
    by each leaf's own largest magnitude (the leaves span ~6 orders)."""
    for name, a, b in zip(fields, got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if name != "pi":
            a, b = a.sum(1), b.sum(1)
        denom = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / denom, b / denom, atol=atol, err_msg=name)
