"""Small shared utilities: pattern strings, pytree helpers, numerics.

Capability parity with the reference utility layer
(upstream phlash/util.py:1-61), re-implemented for this
codebase (no scipy dependency in the hot path, stdlib logging).
"""

from phlash_tpu.utils.pattern import Pattern
from phlash_tpu.utils.trees import tree_stack, tree_unstack
from phlash_tpu.utils.numerics import softplus_inv, expm1inv, texp_mean, kahan_add, invert_cpwli

__all__ = [
    "Pattern",
    "tree_stack",
    "tree_unstack",
    "softplus_inv",
    "expm1inv",
    "texp_mean",
    "kahan_add",
    "invert_cpwli",
]
