"""Likelihood-kernel dispatch.

Mirrors the reference dispatch (upstream phlash/kernel.py:7-24):
the structured Pallas-Triton kernel on NVIDIA GPUs, the batched dense-XLA
kernel elsewhere, and the O(M) scan oracle always available for testing.
All backends share the interface::

    kern.loglik(pp, index) -> float      # jittable, differentiable
    kern(pp, index, grad)  -> ll or (ll, grads)
"""

from __future__ import annotations

import logging

import jax

logger = logging.getLogger(__name__)

BACKENDS = ("triton", "dense", "scan")


def default_backend(M: int) -> str:
    """The backend `get_kernel` picks when none is named.

    On a GPU that is the triton kernel for every M it supports; other M,
    and every other platform, get the dense XLA kernel."""
    from phlash_tpu.ops.smc_triton import SUPPORTED_M

    if jax.default_backend() == "gpu" and M in SUPPORTED_M:
        return "triton"
    return "dense"


def get_kernel(M: int, data, double_precision: bool = False, backend: str = None,
               mesh=None, interpret: bool = False):
    """Return a likelihood kernel for the int8 chunk tensor `data`.

    Args:
        M: number of TMRCA discretization intervals.  The triton backend
            takes M in ops/smc_triton.SUPPORTED_M (8, 16, 32, 64) and raises
            for any other M.
        data: int8 array (num_chunks, chunk_len).
        double_precision: float64 state (dense and scan only).
        backend: "triton" (GPU kernel), "dense" (batched XLA) or "scan"
            (O(M) oracle); None picks per platform (`default_backend`).
        mesh: optional jax.sharding.Mesh — the chunk tensor is sharded over
            the mesh's chunk axis, and the triton kernel runs under
            shard_map with its particle axis split over all devices.
        interpret: run the triton kernel in the Pallas interpreter (CPU
            tests).  Never chosen implicitly.
    """
    if backend is None:
        backend = default_backend(M)
    if backend == "triton":
        from phlash_tpu.ops.smc_triton import TritonKernel

        kern = TritonKernel(
            M=M, data=data, double_precision=double_precision, mesh=mesh,
            interpret=interpret,
        )
    elif backend == "dense":
        from phlash_tpu.ops.kernel_dense import DenseKernel

        kern = DenseKernel(M=M, data=data, double_precision=double_precision)
    elif backend == "scan":
        from phlash_tpu.hmm import PureXLAKernel

        kern = PureXLAKernel(M=M, data=data, double_precision=double_precision)
    else:
        raise ValueError(f"unknown kernel backend {backend!r}; expected one of {BACKENDS}")
    if interpret and backend != "triton":
        raise ValueError("interpret=True applies to the triton backend only")
    if mesh is not None:
        from phlash_tpu.parallel import chunk_sharding

        kern.data = jax.device_put(kern.data, chunk_sharding(mesh))
    return kern
