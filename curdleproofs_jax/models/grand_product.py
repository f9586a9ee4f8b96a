"""Compatibility alias — implementation: protocol/products.py."""
from curdleproofs_jax.protocol.products import GrandProductProof  # noqa: F401
