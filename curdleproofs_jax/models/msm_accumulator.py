"""Compatibility alias — implementation: protocol/primitives.py."""
from curdleproofs_jax.protocol.primitives import MSMAccumulator  # noqa: F401
