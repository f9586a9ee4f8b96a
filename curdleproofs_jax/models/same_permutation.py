"""Compatibility alias — implementation: protocol/products.py."""
from curdleproofs_jax.protocol.products import (  # noqa: F401
    SamePermutationProof,
    get_permutation,
)
