"""Optimized HMM compute kernels.

Backends (all sharing the interface defined in phlash_tpu.kernel):

* smc_triton — the GPU kernel: the structured O(M) recursion and its
  adjoint in Pallas on the Triton route, one HMM per thread, custom VJP.
* kernel_dense — batched dense-transition XLA implementation with
  segment-checkpointed autodiff; portable, and the correctness bridge
  between the O(M) scan oracle and the triton kernel.
"""

from phlash_tpu.ops.packing import dense_transition

__all__ = ["dense_transition"]
