"""Compatibility alias — implementation: protocol/primitives.py."""
from curdleproofs_jax.protocol.primitives import CurdleproofsCrs  # noqa: F401
